"""bwameme_tpu_torch — the PyTorch + CUDA port of bwameme_tpu.

A second package beside the JAX reference: it reuses the reference's
JAX-free host code (io, index build, P-RMI training, chaining, the native
C++ host kernels, the host seeding engine) by import, and replaces what ran
on the TPU with PyTorch and hand-written CUDA kernels for Hopper (sm_90a).
This slice runs single-end ``mem --engine host``: host seeding and chaining,
banded-SW extension on the GPU, native finalization. It imports no JAX.
"""

__version__ = "0.1.0"

from bwameme_tpu.utils.config import MemOptions  # noqa: F401,E402
