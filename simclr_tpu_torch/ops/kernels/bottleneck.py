"""The fused identity bottleneck: CUDA kernels B6f and B6b
(``csrc/bottleneck.cu``), their plain PyTorch versions, and the autograd
function around them.

Replaces ``simclr_tpu/ops/pallas/bottleneck.py``, with its numerics. For
x (N, 4C, H, W) bf16, bf16 copies of the float32 weights, and six float32
per-channel affines (the folded BNs, ``FoldedBatchNorm``):

    y1 = x w1                a1 = bf16(relu(y1 A1 + B1))
    y2 = conv3x3(a1, w2)     a2 = bf16(relu(y2 A2 + B2))
    y3 = a2 w3               out = bf16(relu(y3 A3 + B3 + x))

with float32 sums of bf16 products and float32 y1, y2, y3; SAME padding
applies to a1. The backward recomputes that forward from x and returns dx
(bf16, rounded once: dy1 w1^T + u3), dw1, dw2, dw3 (float32) and the six
affine gradients (float32 sums over the batch), rounding dy3, dy2 and dy1
to bf16 and nothing else, as the Pallas ``_bwd_kernel`` does.

Layouts are the port's: x is (N, 4C, H, W), normally in channels_last
memory (physically NHWC, as the kernels read it); w1 (C, 4C, 1, 1), w2
(C, C, 3, 3) and w3 (4C, C, 1, 1) as ``nn.Conv2d`` keeps them. A wrapper
brings each operand to channels_last first (a copy only where needed:
autograd promises no layout, and the pooled cotangent has stride 0).

GPU gate (``supports``): a 4-D bf16 tensor with 4C channels, C in {64,
128, 256, 512} (the kernels give each of 8 warps 64 channels of a tile of
8192 / C pixels), W <= 8192 / C (a tile holds at least one image row),
any N and H >= 1, fewer than 2**31 elements. JAX's ``pick_tile`` (whole
images in a 9 MB VMEM budget, C % 8 and 4C % 128) is a TPU rule: it
refuses layer4 at batch 1024, which the CUDA kernels take.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel, or raises ``ValueError`` for operands the kernel
cannot take; a build or launch failure propagates. Each launch adds one
to the wrapper's ``launches``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import _build
from simclr_tpu_torch.ops.kernels.conv64 import nhwc_operand, rot180_swap

WIDTHS = (64, 128, 256, 512)   # C, the bottleneck width (csrc TILE_ELEMS)
TILE_ELEMS = 8192              # pixels x C of one tile


def supports(x: torch.Tensor, c: int) -> bool:
    """Whether the kernels take x (N, 4C, H, W) at width c (after a
    layout copy if needed)."""
    return (x.dim() == 4 and x.dtype == torch.bfloat16 and c in WIDTHS
            and x.shape[1] == 4 * c and x.shape[0] >= 1
            and x.shape[2] >= 1 and 1 <= x.shape[3] <= TILE_ELEMS // c
            and x.numel() < 2 ** 31)


def _bf16w(w: torch.Tensor) -> torch.Tensor:
    """A weight rounded to bf16, in float32 for the plain versions."""
    return w.to(torch.bfloat16).to(torch.float32)


def _cs(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _relu_affine(y, a, b):
    """relu(y A + B) in float32 (product, then sum: no fused multiply-add,
    as the kernels compute it)."""
    return torch.relu(y * _cs(a) + _cs(b))


def _recompute(x, w1, w2, w3, affines):
    """The forward's float32 y1, y2, y3 and bf16 a1, a2."""
    a1f, b1f, a2f, b2f, _, _ = affines
    y1 = F.conv2d(x.float(), _bf16w(w1))
    a1 = _relu_affine(y1, a1f, b1f).to(torch.bfloat16)
    y2 = F.conv2d(a1.float(), _bf16w(w2), padding=1)
    a2 = _relu_affine(y2, a2f, b2f).to(torch.bfloat16)
    y3 = F.conv2d(a2.float(), _bf16w(w3))
    return y1, a1, y2, a2, y3


def _pre3(x, y3, affines):
    return y3 * _cs(affines[4]) + _cs(affines[5]) + x.float()


# ---------------------------------------------------------------------------
# Plain versions. On the card they need cuDNN's and cuBLAS's TF32 off to be
# float32.
# ---------------------------------------------------------------------------

def fused_bottleneck_plain(x, w1, w2, w3, affines) -> torch.Tensor:
    """B6f's plain version: the block's forward as above, in x's type."""
    y3 = _recompute(x, w1, w2, w3, affines)[4]
    return torch.relu(_pre3(x, y3, affines)).to(x.dtype)


def fused_bottleneck_bwd_plain(x, w1, w2, w3, affines, g):
    """B6b's plain version: (dx, dw1, dw2, dw3, dA1, dB1, dA2, dB2, dA3,
    dB3) of the block for the cotangent g; the weight gradients in the
    weights' (C, 4C, 1, 1), (C, C, 3, 3), (4C, C, 1, 1) layouts."""
    a1f, b1f, a2f, b2f, a3f, _ = affines
    y1, a1, y2, a2, y3 = _recompute(x, w1, w2, w3, affines)
    red = (0, 2, 3)
    u3 = torch.where(_pre3(x, y3, affines) > 0, g.float(), 0.0)
    dA3, dB3 = (u3 * y3).sum(red), u3.sum(red)
    dy3 = (u3 * _cs(a3f)).to(torch.bfloat16).float()
    dw3 = torch.einsum("nfhw,nchw->fc", dy3, a2.float())
    da2 = F.conv2d(dy3, _bf16w(w3).transpose(0, 1))
    u2 = torch.where(y2 * _cs(a2f) + _cs(b2f) > 0, da2, 0.0)
    dA2, dB2 = (u2 * y2).sum(red), u2.sum(red)
    dy2 = (u2 * _cs(a2f)).to(torch.bfloat16).float()
    dw2 = torch.nn.grad.conv2d_weight(a1.float(), tuple(w2.shape), dy2,
                                      padding=1)
    da1 = F.conv2d(dy2, rot180_swap(_bf16w(w2)), padding=1)
    u1 = torch.where(y1 * _cs(a1f) + _cs(b1f) > 0, da1, 0.0)
    dA1, dB1 = (u1 * y1).sum(red), u1.sum(red)
    dy1 = (u1 * _cs(a1f)).to(torch.bfloat16).float()
    dw1 = torch.einsum("nchw,nfhw->cf", dy1, x.float())
    dx = (F.conv2d(dy1, _bf16w(w1).transpose(0, 1)) + u3).to(x.dtype)
    return (dx, dw1.view(w1.shape), dw2, dw3.view(w3.shape),
            dA1, dB1, dA2, dB2, dA3, dB3)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def pack_weights(w1, w2, w3, backward: bool) -> torch.Tensor:
    """The kernels' bf16 weight block: [w1 (C, 4C), w2 (C, 9C), w3 (4C,
    C)] with w2 as [co][tap = 3 ky + kx][ci], and for the backward also
    [w1^T (4C, C), rot180_swap(w2) likewise, w3^T (C, 4C)]; each matrix
    row-major with its reduction axis contiguous."""
    c = w1.shape[0]
    bf = torch.bfloat16
    m1 = w1.reshape(c, 4 * c).to(bf)
    m3 = w3.reshape(4 * c, c).to(bf)

    def taps(w):
        return w.to(bf).permute(0, 2, 3, 1).reshape(c, 9 * c)

    parts = [m1, taps(w2), m3]
    if backward:
        parts += [m1.t(), taps(rot180_swap(w2)), m3.t()]
    return torch.cat([p.reshape(-1) for p in parts])


def _pack_affines(affines: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([v.reshape(-1).to(torch.float32) for v in affines])


def _check(name: str, x: torch.Tensor, w1, w2, w3, affines, *others):
    if x.device.type != "cuda":
        raise ValueError(f"no bottleneck kernel for device {x.device}")
    c = w1.shape[0]
    shapes = ((c, 4 * c, 1, 1), (c, c, 3, 3), (4 * c, c, 1, 1))
    sizes = (c, c, c, c, 4 * c, 4 * c)
    if (not supports(x, c)
            or tuple(t.shape for t in (w1, w2, w3)) != shapes
            or tuple(v.numel() for v in affines) != sizes
            or any(t.device != x.device for t in (w1, w2, w3, *affines))
            or any(t.shape != x.shape or t.dtype != x.dtype
                   or t.device != x.device for t in others)):
        raise ValueError(
            f"{name} does not support operands "
            f"{[(tuple(u.shape), u.dtype) for u in (x, w1, w2, w3)]} "
            f"(see bottleneck.supports)")


def bottleneck_fwd(x, w1, w2, w3, affines) -> torch.Tensor:
    """B6f: the block's output (N, 4C, H, W) in bf16."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, w2, w3, affines)
    _check("bottleneck_fwd", x, w1, w2, w3, affines)
    xs = nhwc_operand(x)
    wp, aff = pack_weights(w1, w2, w3, False), _pack_affines(affines)
    out = torch.empty_like(xs, memory_format=torch.channels_last)
    n, f, h, w = x.shape
    with torch.cuda.device(x.device):
        status = _build.library().bottleneck_fwd(
            xs.data_ptr(), wp.data_ptr(), aff.data_ptr(), out.data_ptr(),
            n, h, w, f // 4, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "bottleneck_fwd")
    bottleneck_fwd.launches += 1
    return out


def bottleneck_bwd(x, w1, w2, w3, affines, g) -> Tuple[torch.Tensor, ...]:
    """B6b: (dx, dw1, dw2, dw3, dA1, dB1, dA2, dB2, dA3, dB3) for the
    cotangent g of the block's output; dx bf16, the rest float32, the
    weight gradients in the weights' layouts."""
    if x.device.type == "cpu":
        return fused_bottleneck_bwd_plain(x, w1, w2, w3, affines, g)
    _check("bottleneck_bwd", x, w1, w2, w3, affines, g)
    xs, gs = nhwc_operand(x), nhwc_operand(g)
    wp, aff = pack_weights(w1, w2, w3, True), _pack_affines(affines)
    n, f, h, w = x.shape
    c = f // 4
    lib = _build.library()
    dx = torch.empty_like(xs, memory_format=torch.channels_last)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw1, dw2, dw3 = (torch.empty(t.shape, **f32) for t in (w1, w2, w3))
    daff = torch.empty(aff.numel(), **f32)
    with torch.cuda.device(x.device):
        work = torch.empty(lib.bottleneck_bwd_workspace(n, h, w, c),
                           dtype=torch.uint8, device=x.device)
        status = lib.bottleneck_bwd(
            xs.data_ptr(), gs.data_ptr(), wp.data_ptr(), aff.data_ptr(),
            work.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            dw3.data_ptr(), daff.data_ptr(), n, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "bottleneck_bwd")
    bottleneck_bwd.launches += 1
    return (dx, dw1, dw2, dw3, *daff.split((c, c, c, c, f, f)))


bottleneck_fwd.launches = 0
bottleneck_bwd.launches = 0


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, *affines):
        ctx.save_for_backward(x, w1, w2, w3, *affines)
        return bottleneck_fwd(x, w1, w2, w3, affines)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, w3, *affines = ctx.saved_tensors
        grads = bottleneck_bwd(x, w1, w2, w3, affines, g.to(x.dtype))
        params = (x, w1, w2, w3, *affines)
        return tuple(d.to(p.dtype) if need else None
                     for d, p, need in zip(grads, params,
                                           ctx.needs_input_grad))


def fused_bottleneck(x, w1, w2, w3, affines) -> torch.Tensor:
    """The identity bottleneck of x (N, 4C, H, W) in bf16 with weights of
    any float type and the six float32 affines (A1, B1, A2, B2, A3, B3):
    forward through B6f, every gradient through B6b (the weight and
    affine gradients float32 sums, returned in their inputs' types)."""
    return _FusedBottleneck.apply(
        x.to(torch.bfloat16), w1, w2, w3,
        *(v.to(torch.float32) for v in affines))
