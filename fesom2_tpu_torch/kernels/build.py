"""Build the hand-written CUDA kernels into one shared library.

The sources are ``fesom2_tpu_torch/csrc/*.cu``; each exports a plain C
function (no PyTorch headers), so ``nvcc`` builds them in seconds.  The
library lands in ``build/fesom2_tpu_torch/`` at the repository root, named
by a hash of the sources and flags: a changed source builds a new library,
an unchanged one is reused.  A failed build raises with the compiler's
output.  ``nvcc`` must be on the PATH or under CUDA_HOME.

Run ``python -m fesom2_tpu_torch.kernels.build`` to build and print the
register and shared-memory use ``ptxas`` reports for each kernel.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fesom2_tpu_torch"

# sm_90a: Hopper with its architecture-specific instructions.  No
# --use_fast_math and no flush-to-zero: f32 subnormals must survive.
# -fmad=false keeps every product rounded on its own, as the plain torch
# versions round it, so kernel and plain agree to the last bits.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v"]


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None and os.path.exists(
                os.path.join(CUDA_HOME, "bin", "nvcc")):
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return nvcc


def library_path() -> Path:
    return BUILD_DIR / f"libfesom2_kernels_{source_hash()}.so"


def build() -> Path:
    """Return the path of the built library, compiling it if needed."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{SRC_DIR}", "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """The ptxas resource lines of the last build of these sources."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(ln for ln in log.read_text().splitlines()
                     if "ptxas info" in ln)


if __name__ == "__main__":
    print(build())
    print(ptxas_report())
