"""The benchmark's command on the card: one short window of ci_l7.base,
and its last line parses to the contract's keys.  Run on the chip from the
repository root:

    python -m pytest -p no:cacheprovider \
        ocean_bench/tests/test_ocean_bench_card.py
"""
import json
import subprocess
import sys

import pytest

from ocean_bench import spec


@pytest.mark.cuda
def test_one_short_window_of_ci_l7_base_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "-m", "ocean_bench.run", "--workload", "ci_l7.base",
         "--seed", "2147483701", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=1500)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"sypd", "setup_s"}
    assert line["correct"] is True, res.stderr[-3000:]
