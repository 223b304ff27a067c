"""Hand-written CUDA kernels for Hopper (``sm_90a``), bound with ctypes.

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter. The shared library is built on first use by ``_build``,
never on import.
"""
