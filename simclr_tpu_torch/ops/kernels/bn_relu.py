"""Subset-statistics BN(+residual add)+ReLU with a single-pass backward:
CUDA kernels B3a-c (``csrc/bn_relu.cu``), their plain PyTorch versions,
and the autograd functions around them.

Replaces ``simclr_tpu/ops/pallas/bn_relu.py``. The forward is plain ops:
statistics from the leading k rows (``ops.subset_bn.bn_stats``), the
affine in the apply dtype (``bn_apply``), then the add and the ReLU, value for value as
``models.norm.SubsetBatchNorm`` computes them. The backward is one pass
over the layer-sized tensors, which writes dx (and dskip) and sums
S1 = sum(gy) and S2 = sum(gy * xhat) per channel. Every row outside the
k statistics rows has dx = gy * a with a = scale * rsqrt(var + eps), so
only those k rows need the sums; ``ops.subset_bn.head_correction`` fixes
them up afterwards. In 'relu' mode the pass sums S2' = sum(gy * out) instead and
S2 = (S2' - bias * S1) / scale, so x is not kept for the backward, only its
k-row slice.

Tensors are (N, C) or (N, C, H, W) with the channel axis 1, as in the
port's models. A kernel reads the 2-D (rows, C) view of a contiguous (N, C)
tensor or of a ``torch.channels_last`` (N, C, H, W) one; its wrapper brings
each operand to that layout first (autograd does not promise it: the
gradient of a global average pool has stride 0).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel, or raises ``ValueError`` if ``supports()`` refuses the
operands; a build or launch failure propagates. Each launch adds one to the
wrapper's ``launches``. ``impl="xla"`` and ``impl="xla_mask"`` (the names of
the JAX package's plain-op variants of the same math) select the plain
backward explicitly, on any device.
"""

from __future__ import annotations

import torch

from simclr_tpu_torch.ops.kernels import _build
from simclr_tpu_torch.ops.subset_bn import (
    bn_apply, bn_stats, channel_shape, elems_per_channel, head_correction,
    reduce_dims)

VEC = 8            # channels a kernel thread loads at once (csrc/bn_relu.cu)
MODES = ("relu", "add_relu", "none")
IMPLS = ("pallas", "xla", "xla_mask")
_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# Plain versions of the three backward passes (the JAX _xla_bwd_* twins).
# ---------------------------------------------------------------------------

def _relu_mask(g: torch.Tensor, out32: torch.Tensor) -> torch.Tensor:
    return torch.where(out32 > 0.0, g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device))


def bwd_relu_plain(g, out, a32):
    """B3a's plain version: (dx, S1, S2') with S2' = sum(gy * out)."""
    red = reduce_dims(g)
    out32 = out.to(torch.float32)
    gy = _relu_mask(g, out32)
    dx = gy * a32.to(g.dtype).view(channel_shape(g))
    gy32 = gy.to(torch.float32)
    return dx, gy32.sum(dim=red), (gy32 * out32).sum(dim=red)


def bwd_add_relu_plain(g, out, x, a32, mean, rsig):
    """B3b's plain version: (dx, dskip, S1, S2)."""
    red, cs = reduce_dims(g), channel_shape(g)
    gy = _relu_mask(g, out.to(torch.float32))
    dx = gy * a32.to(g.dtype).view(cs)
    gy32 = gy.to(torch.float32)
    xhat = (x.to(torch.float32) - mean.view(cs)) * rsig.view(cs)
    return dx, gy, gy32.sum(dim=red), (gy32 * xhat).sum(dim=red)


def bwd_norelu_plain(g, x, a32, mean, rsig):
    """B3c's plain version: (dx, S1, S2)."""
    red, cs = reduce_dims(g), channel_shape(g)
    dx = g * a32.to(g.dtype).view(cs)
    g32 = g.to(torch.float32)
    xhat = (x.to(torch.float32) - mean.view(cs)) * rsig.view(cs)
    return dx, g32.sum(dim=red), (g32 * xhat).sum(dim=red)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _layout(t: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if t.dim() == 4 else torch.contiguous_format


def supports(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` as it is: a contiguous 2-D (rows, C)
    tensor or a channels_last-contiguous 4-D one, bf16 or float32, C a
    multiple of 8 (16-byte loads), 16-byte aligned, with fewer than 2**31
    rows and at least one. Any row count is fine: the tail is masked."""
    if t.dim() not in (2, 4) or t.dtype not in _DTYPES or t.numel() == 0:
        return False
    c = t.shape[1]
    return (c % VEC == 0 and t.numel() // c < 2 ** 31
            and t.is_contiguous(memory_format=_layout(t))
            and t.data_ptr() % 16 == 0)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the layout the kernels read (a copy only where needed)."""
    if t.dim() not in (2, 4):
        raise ValueError(f"bn_relu kernels take 2-D or 4-D tensors, got "
                         f"{tuple(t.shape)}")
    fmt = _layout(t)
    t = t.contiguous(memory_format=fmt)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=fmt)


def _launch(entry: str, tensors, vectors, n_outputs: int):
    """Launch one backward kernel on CUDA tensors of one shape and type,
    with float32 (C,) ``vectors``; returns its ``n_outputs`` tensors
    followed by S1 and S2 (or S2')."""
    g = tensors[0]
    if g.device.type != "cuda":
        raise ValueError(f"no bn_relu kernel for device {g.device}")
    ts = [_operand(t) for t in tensors]
    for t in ts:
        if (t.shape != g.shape or t.dtype != g.dtype
                or t.device != g.device or not supports(t)):
            raise ValueError(
                f"bn_relu kernel {entry} does not support operands "
                f"{[(tuple(u.shape), u.dtype) for u in tensors]} (see "
                f"bn_relu.supports)")
    c = g.shape[1]
    rows = g.numel() // c
    vecs = [v.to(device=g.device, dtype=torch.float32).contiguous()
            for v in vectors]
    if any(v.shape != (c,) for v in vecs):
        raise ValueError(f"per-channel vectors must have shape ({c},)")
    outs = [torch.empty_like(ts[0]) for _ in range(n_outputs)]
    lib = _build.library()
    n_blocks = lib.bn_bwd_row_blocks(rows, c)
    partial = torch.empty((n_blocks, 2 * c), dtype=torch.float32,
                          device=g.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        status = getattr(lib, entry)(
            *[t.data_ptr() for t in ts + vecs + outs], partial.data_ptr(),
            sums.data_ptr(), rows, c, int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, entry)
    return (*outs, sums[0], sums[1])


def bwd_relu(g, out, a32):
    """B3a: (dx, S1, S2') for bn+relu from the cotangent g and the output."""
    if g.device.type == "cpu":
        return bwd_relu_plain(g, out, a32)
    result = _launch("bn_bwd_relu", (g, out), (a32,), 1)
    bwd_relu.launches += 1
    return result


def bwd_add_relu(g, out, x, a32, mean, rsig):
    """B3b: (dx, dskip, S1, S2) for bn+add+relu."""
    if g.device.type == "cpu":
        return bwd_add_relu_plain(g, out, x, a32, mean, rsig)
    result = _launch("bn_bwd_add_relu", (g, out, x), (a32, mean, rsig), 2)
    bwd_add_relu.launches += 1
    return result


def bwd_norelu(g, x, a32, mean, rsig):
    """B3c: (dx, S1, S2) for bn alone."""
    if g.device.type == "cpu":
        return bwd_norelu_plain(g, x, a32, mean, rsig)
    result = _launch("bn_bwd_norelu", (g, x), (a32, mean, rsig), 1)
    bwd_norelu.launches += 1
    return result


bwd_relu.launches = 0
bwd_add_relu.launches = 0
bwd_norelu.launches = 0


# ---------------------------------------------------------------------------
# The autograd functions.
# ---------------------------------------------------------------------------

def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown bn_relu impl {impl!r}; choose one of "
                         f"{IMPLS}")


def _with_head(dx, x_head, g_head, out_head, s1, s2, gmean, gvar, scale,
               mean, rsig, shape, k):
    """dx in x's type with its k statistics rows replaced by the exact
    head rows (gy * a recomputed from the k-row slices, plus the
    correction)."""
    dt = x_head.dtype
    dx = dx.to(dt)
    gy = g_head.to(dt)
    if out_head is not None:
        gy = torch.where(out_head.to(torch.float32) > 0.0, gy,
                         torch.zeros((), dtype=dt, device=gy.device))
    a_dt = (scale * rsig).to(dt).view(channel_shape(dx))
    dx[:k] = head_correction(x_head, gy * a_dt, s1, s2, gmean, gvar, scale,
                             mean, rsig, elems_per_channel(shape, k), dt)
    return dx


class _SubsetBNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, shift, k, eps, dt, impl):
        mean, var = bn_stats(x, shift, k)
        rsig = torch.rsqrt(var + eps)
        out = torch.relu(bn_apply(x, scale, bias, mean, var, eps, dt))
        # The output (the next conv's input anyway) and a copy of the
        # k-row slice of x: a view would keep all of x alive.
        ctx.save_for_backward(out, x[:k].clone(), scale, bias, mean, rsig)
        ctx.k, ctx.impl = k, impl
        return out, mean, var

    @staticmethod
    def backward(ctx, g, gmean, gvar):
        out, x_head, scale, bias, mean, rsig = ctx.saved_tensors
        k = ctx.k
        bwd = bwd_relu if ctx.impl == "pallas" else bwd_relu_plain
        dx, s1, s2p = bwd(g, out, scale * rsig)
        # sum(gy * xhat) = (sum(gy * out) - bias * S1) / scale where the
        # ReLU passed; a scale near 0 makes the recovery degenerate.
        small = scale.abs() < 1e-6
        s2 = torch.where(small, torch.zeros_like(scale),
                         (s2p - bias * s1) / torch.where(
                             small, torch.ones_like(scale), scale))
        dx = _with_head(dx, x_head, g[:k], out[:k], s1, s2, gmean, gvar,
                        scale, mean, rsig, out.shape, k)
        return dx, s2, s1, None, None, None, None, None


class _SubsetBNAddRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, scale, bias, shift, k, eps, dt, impl):
        mean, var = bn_stats(x, shift, k)
        rsig = torch.rsqrt(var + eps)
        y = bn_apply(x, scale, bias, mean, var, eps, dt)
        out = torch.relu(y + skip.to(y.dtype))
        # x itself is kept: out mixes in the skip, so xhat cannot be
        # recovered from it.
        ctx.save_for_backward(out, x, scale, mean, rsig)
        ctx.k, ctx.impl, ctx.skip_dtype = k, impl, skip.dtype
        return out, mean, var

    @staticmethod
    def backward(ctx, g, gmean, gvar):
        out, x, scale, mean, rsig = ctx.saved_tensors
        k = ctx.k
        bwd = bwd_add_relu if ctx.impl == "pallas" else bwd_add_relu_plain
        dx, dskip, s1, s2 = bwd(g, out, x.to(g.dtype), scale * rsig, mean,
                                rsig)
        dx = _with_head(dx, x[:k], g[:k], out[:k], s1, s2, gmean, gvar,
                        scale, mean, rsig, out.shape, k)
        return (dx, dskip.to(ctx.skip_dtype), s2, s1, None, None, None, None,
                None)


class _SubsetBNOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, shift, k, eps, dt, impl):
        mean, var = bn_stats(x, shift, k)
        rsig = torch.rsqrt(var + eps)
        y = bn_apply(x, scale, bias, mean, var, eps, dt)
        ctx.save_for_backward(x, scale, mean, rsig)
        ctx.k, ctx.impl = k, impl
        return y, mean, var

    @staticmethod
    def backward(ctx, g, gmean, gvar):
        x, scale, mean, rsig = ctx.saved_tensors
        k = ctx.k
        bwd = bwd_norelu if ctx.impl == "pallas" else bwd_norelu_plain
        dx, s1, s2 = bwd(g, x.to(g.dtype), scale * rsig, mean, rsig)
        dx = _with_head(dx, x[:k], g[:k], None, s1, s2, gmean, gvar, scale,
                        mean, rsig, x.shape, k)
        return dx, s2, s1, None, None, None, None, None


def subset_bn_relu(x, scale, bias, shift, k: int, eps: float,
                   apply_dtype: torch.dtype, impl: str = "pallas"):
    """relu(subset_bn(x)) -> (out, mean, var); backward through B3a."""
    _check_impl(impl)
    return _SubsetBNRelu.apply(x, scale, bias, shift, k, eps, apply_dtype,
                               impl)


def subset_bn_add_relu(x, skip, scale, bias, shift, k: int, eps: float,
                       apply_dtype: torch.dtype, impl: str = "pallas"):
    """relu(subset_bn(x) + skip) -> (out, mean, var); backward through
    B3b."""
    _check_impl(impl)
    return _SubsetBNAddRelu.apply(x, skip, scale, bias, shift, k, eps,
                                  apply_dtype, impl)


def subset_bn_only(x, scale, bias, shift, k: int, eps: float,
                   apply_dtype: torch.dtype, impl: str = "pallas"):
    """subset_bn(x) -> (y, mean, var); backward through B3c."""
    _check_impl(impl)
    return _SubsetBNOnly.apply(x, scale, bias, shift, k, eps, apply_dtype,
                               impl)
