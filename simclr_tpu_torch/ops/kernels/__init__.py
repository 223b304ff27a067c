"""Hand-written CUDA kernels for Hopper (``sm_90a``), bound with ctypes.

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter. The shared library is built on first use by ``_build``,
never on import. ``registry`` makes the eval forward's kernels (B4f, B5f,
B6f) PyTorch operators; it is imported here, so that their wrappers can
call them.
"""

from simclr_tpu_torch.ops.kernels import registry  # noqa: F401
