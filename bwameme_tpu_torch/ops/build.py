"""Build the port's CUDA kernels with nvcc into a shared library with a plain
C interface, bound with ctypes (no PyTorch headers: the build takes seconds,
not minutes).

The library is built at first use into ``bwameme_tpu_torch/build/`` (listed
in .gitignore) and rebuilt when a source is newer than it. Nothing here runs
at import time, so the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(PKG_DIR, "csrc", "banded_sw.cu"),)
BUILD_DIR = os.path.join(PKG_DIR, "build")
LIBRARY = os.path.join(BUILD_DIR, "libbwameme_kernels.so")

# sm_90a keeps Hopper-only instructions available to later kernels; no
# --use_fast_math: the band clamp's f32 division must round to nearest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when the library was already up to date
    log: str        # nvcc's output (ptxas registers, spills, shared memory)


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "bwameme_tpu_torch are built from csrc/ at first use")
    return found


def nvcc_command(nvcc: str, out: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, *SOURCES]


def build() -> BuildResult:
    """Compile the kernels unless the library is newer than every source."""
    newest = max(os.path.getmtime(s) for s in SOURCES)
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= newest:
        return BuildResult(LIBRARY, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(find_nvcc(), tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    # atomic: a concurrent build never loads half a file
    os.replace(tmp, LIBRARY)
    return BuildResult(LIBRARY, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)
