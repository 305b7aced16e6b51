"""Build the hand-written CUDA kernels into one shared library.

The sources are ``fesom2_tpu_torch/csrc/*.cu``; each exports a plain C
function (no PyTorch headers), so ``nvcc`` builds them in seconds.  Every
source is compiled to an object by its own ``nvcc``, all started together
(the build takes as long as its slowest source, not the sum), and the
objects are linked into one library.  The library lands in
``build/fesom2_tpu_torch/`` at the repository root, named by a hash of the
sources and flags: a changed source builds a new library, an unchanged one
is reused.  A failed build raises with the compiler's output.  ``nvcc``
must be on the PATH or under CUDA_HOME.

Run ``python -m fesom2_tpu_torch.kernels.build`` to build and print the
register and shared-memory use ``ptxas`` reports for each kernel.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fesom2_tpu_torch"

# sm_90a: Hopper with its architecture-specific instructions.  No
# --use_fast_math and no flush-to-zero: f32 subnormals must survive.
# -fmad=false keeps every product rounded on its own, as the plain torch
# versions round it, so kernel and plain agree to the last bits.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas=-v"]


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
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.so.tmp")
    cu = [p for p in sources() if p.suffix == ".cu"]
    objs = [str(BUILD_DIR / f"{tag}.{p.stem}.o") for p in cu]
    with ThreadPoolExecutor(len(cu)) as pool:
        runs = list(pool.map(_run, (
            [nvcc, *NVCC_FLAGS, f"-I{SRC_DIR}", "-c", "-o", o, str(p)]
            for p, o in zip(cu, objs))))
    if all(rc == 0 for _, rc in runs):
        runs.append(_run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]))
    for o in objs:
        Path(o).unlink(missing_ok=True)
    log = "\n".join(text for text, _ in runs)
    out.with_suffix(".log").write_text(log)
    if any(rc != 0 for _, rc in runs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, out)
    return out


def _run(cmd: list) -> tuple:
    res = subprocess.run(cmd, capture_output=True, text=True)
    return " ".join(cmd) + "\n" + res.stdout + res.stderr, res.returncode


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
