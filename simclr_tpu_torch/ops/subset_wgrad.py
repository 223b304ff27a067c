"""Subset weight gradients for convolutions.

Counterpart of ``simclr_tpu/ops/subset_wgrad.py`` (``conv_subset_wgrad``,
``SubsetWgradConv``): a convolution whose forward and input gradient are
the plain ones, bit for bit, and whose weight gradient is contracted over
the centred row slice ``x[(n-k)//2 : (n-k)//2 + k]`` and scaled by n/k.
The slice is centred so that it spans both augmentation views of a
pretrain batch (rows [0, n/2) are view 1, [n/2, n) view 2). dw goes only
to the optimizer, never into dx, so the estimate's noise stays in its
layer.

k is a floor, as the JAX module computes it (``subset_wgrad.py:117``):
k = min(max(int(n * fraction), min_rows), n). At k >= n the caller runs
the plain convolution, with no custom Function. The JAX side holds no
Pallas kernel here; the products are the convolution library's (cuDNN on
the card), through ``aten.convolution_backward``, which is what autograd
of ``F.conv2d`` calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Pair = Tuple[int, int]


def subset_rows(n: int, fraction: float, min_rows: int = 64) -> int:
    """Rows whose weight gradient is kept out of an n-row batch."""
    return min(max(int(n * fraction), min_rows), n)


def conv_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  stride: Pair, padding: Pair, dx: bool, dw: bool):
    """(dx, dw) of ``F.conv2d(x, w, None, stride, padding)`` for the
    cotangent ``g``, each None where not asked for: the call autograd of
    the plain convolution makes."""
    return torch.ops.aten.convolution_backward(
        g, x, w, None, stride, padding, (1, 1), False, (0, 0), 1,
        [dx, dw, False])[:2]


class _ConvSubsetWgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, k):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, k)
        return F.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, k = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_x:
            dx = conv_backward(gy, x, w, stride, padding, True, False)[0]
        if need_w:
            n = x.shape[0]
            s0 = (n - k) // 2
            dw = conv_backward(gy[s0:s0 + k], x[s0:s0 + k], w, stride,
                               padding, False, True)[1]
            # JAX scales in w's dtype, n/k rounded to it (a device fill,
            # which a CUDA graph can capture).
            dw = dw * torch.full((), n / k, dtype=dw.dtype, device=dw.device)
        return dx, dw, None, None, None


def conv_subset_wgrad(x: torch.Tensor, w: torch.Tensor, stride: Pair,
                      padding: Pair, k: int) -> torch.Tensor:
    """NCHW/OIHW convolution, exact forward and dx, dw from the k centred
    rows scaled by n/k (k < n)."""
    return _ConvSubsetWgrad.apply(x, w, tuple(stride), tuple(padding), k)
