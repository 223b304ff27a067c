"""Layer1's 3x3 stride-1 SAME convolution at C_in = C_out = 64: CUDA
kernels B4f and B4w (``csrc/conv64.cu``), their plain PyTorch versions,
and the autograd function around them.

Replaces ``simclr_tpu/ops/pallas/conv64.py``, with its numerics: bf16
operands (the weight cast to the input's type), float32 sums, the output
rounded to bf16 once. The input gradient is the same convolution of the
cotangent with the filter rotated 180 degrees and in/out swapped
(``rot180_swap``); the weight gradient is float32 and is not rounded.

Layouts are the port's: x is (N, 64, H, W), normally in channels_last
memory (physically NHWC, as the kernels read it), and w is (64, 64, 3, 3)
as ``nn.Conv2d`` keeps it. A wrapper brings each operand to channels_last
first (a copy only where needed: autograd promises no layout).

GPU gate (``supports``): a 4-D bf16 tensor with 64 channels, at least one
image and pixel, fewer than 2**31 elements. Any batch and any H, W >= 1
(the kernel masks the ragged last tile and pads the border itself). The
JAX gate's batch % 256 and H, W >= 3 are rules of its batch-on-lanes TPU
layout and do not apply.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel, or raises ``ValueError`` for operands the kernel
cannot take; a build or launch failure propagates. Each launch adds one
to the wrapper's ``launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import _build

C = 64
_SHAPE_W = (C, C, 3, 3)


def supports(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x`` (after a layout copy if needed)."""
    return (x.dim() == 4 and x.shape[1] == C and x.dtype == torch.bfloat16
            and 0 < x.numel() < 2 ** 31)


def rot180_swap(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) filter of the input-gradient convolution: the window
    rotated 180 degrees and in/out channels swapped."""
    return w.flip(2, 3).transpose(0, 1)


def prep_filter(w: torch.Tensor) -> torch.Tensor:
    """(64, 64, 3, 3) -> the kernel's [tap = 3 ky + kx][co][ci] bf16."""
    return w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, C, C) \
        .contiguous()


# ---------------------------------------------------------------------------
# Plain versions. On the card they need cuDNN's TF32 off to be float32.
# ---------------------------------------------------------------------------

def conv3x3_c64_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B4f's plain version: a float32 convolution of the bf16 operands,
    rounded once to x's type."""
    return F.conv2d(x.float(), w.to(x.dtype).float(),
                    padding=1).to(x.dtype)


def wgrad_c64_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4w's plain version: float32 dW (64, 64, 3, 3) of conv3x3(x, w)
    for the cotangent g."""
    return torch.nn.grad.conv2d_weight(x.float(), _SHAPE_W, g.float(),
                                       padding=1)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def nhwc_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` in channels_last memory, 16-byte aligned, as the conv kernels
    read it (a copy only where needed)."""
    t = t.contiguous(memory_format=torch.channels_last)
    return (t if t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.channels_last))


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no conv64 kernel for device {x.device}")
    for t in (x, *others):
        if not supports(t) or t.shape != x.shape or t.device != x.device:
            raise ValueError(
                f"{name} does not support operands "
                f"{[(tuple(u.shape), u.dtype) for u in (x, *others)]} "
                f"(see conv64.supports)")


def conv_c64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B4f: conv3x3(x, w), stride 1, SAME, in x's type (bf16)."""
    if x.device.type == "cpu":
        return conv3x3_c64_plain(x, w)
    _check("conv64_fwd", x)
    if tuple(w.shape) != _SHAPE_W or w.device != x.device:
        raise ValueError(f"conv64_fwd needs a {_SHAPE_W} filter on "
                         f"{x.device}, got {tuple(w.shape)} on {w.device}")
    xs, wt = nhwc_operand(x), prep_filter(w)
    y = torch.empty_like(xs, memory_format=torch.channels_last)
    n, _, h, wd = x.shape
    with torch.cuda.device(x.device):
        status = _build.library().conv64_fwd(
            xs.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, wd,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "conv64_fwd")
    conv_c64.launches += 1
    return y


def wgrad_c64(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4w: float32 dW (64, 64, 3, 3) of conv3x3(x, w) for the cotangent
    g, both bf16 of x's shape."""
    if x.device.type == "cpu":
        return wgrad_c64_plain(x, g)
    _check("conv64_wgrad", x, g)
    xs, gs = nhwc_operand(x), nhwc_operand(g)
    lib = _build.library()
    partial = torch.empty((lib.conv64_wgrad_chunks(), 3, C, 3 * C),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty(_SHAPE_W, dtype=torch.float32, device=x.device)
    n, _, h, wd = x.shape
    with torch.cuda.device(x.device):
        status = lib.conv64_wgrad(xs.data_ptr(), gs.data_ptr(),
                                  partial.data_ptr(), dw.data_ptr(), n, h,
                                  wd, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "conv64_wgrad")
    wgrad_c64.launches += 1
    return dw


conv_c64.launches = 0
wgrad_c64.launches = 0


class _Conv3x3C64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv_c64(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_c64(g, rot180_swap(w).to(g.dtype))
        if ctx.needs_input_grad[1]:
            dw = wgrad_c64(x, g).to(w.dtype)
        return dx, dw


def conv3x3_c64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of bf16 x (N, 64, H, W) with w (64, 64, 3, 3)
    of any float type: forward and input gradient through B4f, weight
    gradient (float32, returned in w's type) through B4w."""
    return _Conv3x3C64.apply(x, w)
