"""bwameme_tpu_torch — the PyTorch + CUDA port of bwameme_tpu.

A second package beside the JAX reference that stands on its own: it keeps
its own copy of the host code (io, index build, P-RMI training, chaining,
the ctypes wrapper of native/*.cpp, the host seeding engine) under the same
sub-package and file names as bwameme_tpu, and replaces what ran on the TPU
with PyTorch and hand-written CUDA kernels for Hopper (sm_90a). It runs
``mem`` single-end and paired-end: learned-index seeding on the device (or
the host engine), native chaining, banded-SW extension on the GPU, for pairs
the insert-size statistics and mate rescue's full Smith-Waterman on the GPU,
native finalization. It imports neither JAX nor any module of bwameme_tpu.
"""

__version__ = "0.1.0"

from bwameme_tpu_torch.utils.config import MemOptions  # noqa: F401,E402
