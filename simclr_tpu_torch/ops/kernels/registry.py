"""The eval forward's three kernels as PyTorch operators, so that
``torch.export`` traces them as single nodes of its graph.

Kernels B4f, B5f and B6f launch through ctypes on raw pointers, which a
trace's fake tensors do not have. Registered here, in the namespace
``simclr_tpu_torch``, each is an operator of its own:

* ``conv_c64(Tensor x, Tensor w) -> Tensor``: B4f (``conv64.py``);
* ``winograd_fwd(Tensor x, Tensor u) -> Tensor``: B5f
  (``winograd.py``; u is the transformed filter);
* ``bottleneck_fwd(Tensor x, Tensor w1, Tensor w2, Tensor w3, Tensor
  affines, Tensor packed) -> Tensor``: B6f (``bottleneck.py``; the six
  affines as one vector, ``pack_affines``, and the forward half of
  ``pack_weights``, empty on the CPU).

Each has a CUDA kernel, the wrapper module's launch (it launches or
raises, and it alone counts in the wrapper's ``launches``); a CPU kernel,
the plain version, its output in channels_last memory as the CUDA kernel
writes it; and a fake kernel that gives the output's shape, type and
strides. The kernel wrappers (``conv64.conv_c64``,
``winograd.winograd_fwd``, ``bottleneck.bottleneck_fwd``) call the
operators, and the autograd functions call the wrappers; the backward
kernels stay ctypes calls.

The package imports this module, so the operators exist as soon as any
kernel wrapper does. Importing it needs no CUDA and no model class: it is
all that an exported artifact holding these operators needs
(``utils/serving.py:load_forward``).
"""

import torch

from simclr_tpu_torch.ops.kernels import bottleneck, conv64, winograd


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _define(name: str, schema: str, cpu, cuda, fake):
    op = torch.library.custom_op(f"simclr_tpu_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


conv_c64 = _define(
    "conv_c64", "(Tensor x, Tensor w) -> Tensor",
    lambda x, w: _channels_last(conv64.conv3x3_c64_plain(x, w)),
    conv64.conv_c64_cuda,
    lambda x, w: torch.empty_like(x, memory_format=torch.channels_last))

winograd_fwd = _define(
    "winograd_fwd", "(Tensor x, Tensor u) -> Tensor",
    lambda x, u: _channels_last(winograd.winograd_fwd_plain(x, u)),
    winograd.winograd_fwd_cuda,
    lambda x, u: torch.empty((x.shape[0], u.shape[2], *x.shape[2:]),
                             dtype=x.dtype, device=x.device,
                             memory_format=torch.channels_last))


def _bottleneck_cpu(x, w1, w2, w3, affines, packed):
    c = w1.shape[0]
    return _channels_last(bottleneck.fused_bottleneck_plain(
        x, w1, w2, w3, affines.split(bottleneck.affine_sizes(c))))


bottleneck_fwd = _define(
    "bottleneck_fwd",
    "(Tensor x, Tensor w1, Tensor w2, Tensor w3, Tensor affines, "
    "Tensor packed) -> Tensor",
    _bottleneck_cpu, bottleneck.bottleneck_fwd_cuda,
    lambda x, *_: torch.empty_like(x, memory_format=torch.channels_last))
