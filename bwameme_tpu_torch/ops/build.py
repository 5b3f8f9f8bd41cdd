"""Build the port's native libraries into ``bwameme_tpu_torch/build/``
(listed in .gitignore), at first use, each rebuilt when its source is newer
than it. Nothing here runs at import time, so the CPU tests import every
module without nvcc. A failed build raises.

* The CUDA kernels: nvcc builds each source under ``csrc/`` into a shared
  library with a plain C interface, bound with ctypes (no PyTorch headers: a
  build takes seconds, not minutes), all libraries at the same time; the
  seeding kernels as one library a memory mode (``LIBRARIES``).
* The host libraries: g++ builds ``native/*.cpp`` (sources shared with
  bwameme_tpu, which builds them into ``native/build/``, a directory the
  port never writes).

Every build writes a file of its own and renames it into place
(``os.replace``): a process never loads a half-written library, and never
truncates one that another process has loaded.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "build")
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")

# sm_90a keeps Hopper-only instructions available; no --use_fast_math: the
# band clamp's f32 division must round to nearest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library -> (its source under csrc/, extra nvcc flags). seed_smem: the P-RMI
# prediction must round its multiply and its add separately (the source also
# uses __fmul_rn/__fadd_rn); its variants build as a library a memory mode
# (SEED_MODE), four nvcc side by side instead of one that takes four times
# as long
LIBRARIES = {
    "banded_sw": ("banded_sw", ()),
    "gather_bench": ("gather_bench", ()),
    **{f"seed_smem_m{m}": ("seed_smem", ("-fmad=false", f"-DSEED_MODE={m}"))
       for m in (1, 2, 3, 4)},
    "sw_full": ("sw_full", ()),
}


def source_path(source: str) -> str:
    return os.path.join(PKG_DIR, "csrc", f"{source}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libbwameme_{name}.so")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    paths: dict     # library name -> shared library
    seconds: float  # 0.0 when every library was already up to date
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


def nvcc_command(nvcc: str, name: str, out: str) -> list[str]:
    source, flags = LIBRARIES[name]
    return [nvcc, *NVCC_FLAGS, *flags, "-o", out, source_path(source)]


def _stale(lib: str, src: str) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def build() -> BuildResult:
    """Compile every stale library, one nvcc a library, all at once."""
    paths = {name: library_path(name) for name in LIBRARIES}
    todo = [name for name in LIBRARIES
            if _stale(paths[name], source_path(LIBRARIES[name][0]))]
    if not todo:
        return BuildResult(paths, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        procs.append((name, tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
        else:
            # atomic: a concurrent build never loads half a file
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           + "\n".join(log))
    return BuildResult(paths, time.perf_counter() - t0, "\n".join(log))


def host_library(source: str, flags: tuple, build_dir: str = BUILD_DIR) -> str:
    """The shared library g++ builds from ``native/<source>.cpp`` with
    ``flags``, in ``build_dir``: built when missing or older than its
    source, and returned as a path."""
    src = os.path.join(NATIVE_DIR, f"{source}.cpp")
    lib = os.path.join(build_dir, f"lib{source}.so")
    if not _stale(lib, src):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{source}.", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *flags, "-shared", "-fPIC", src, "-o",
                               tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source}.cpp:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib
