"""Subset-statistics batch norm with the exact backward in closed form.

Counterpart of ``simclr_tpu/ops/subset_bn.py`` (``subset_bn_apply``). With
statistics from the leading k rows, the affine over all n rows, m the
elements per channel in those k rows, A = scale * rsqrt(var + eps), and
(gmean, gvar) the cotangents of the mean/var outputs:

    dbias  = S1 = sum(g)
    dscale = S2 = sum(g * xhat)
    dx_i   = A * g_i                                     for every row,
           - (1/m) * (A*S1 + A*xhat_i*S2
                      - gmean - 2*(x_i - mean)*gvar)     only for i < k

so rows k..n need no sums. Plain PyTorch: the JAX version is a custom VJP
of plain ops, not a Pallas kernel.

The module also holds the plain BN math the port's other BN paths share:
the shifted one-pass statistics (``bn_stats``), the application order in
the apply dtype (``bn_apply``) and the head rows' closed form
(``head_correction``), which kernel B3's backward uses as well
(``ops/kernels/bn_relu.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def reduce_dims(t: torch.Tensor) -> Tuple[int, ...]:
    """Every axis but the channel axis 1."""
    return (0,) + tuple(range(2, t.dim()))


def channel_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape that broadcasts a (C,) vector against ``t``."""
    return (1, -1) + (1,) * (t.dim() - 2)


def bn_stats(x: torch.Tensor, shift: torch.Tensor, k: int, mesh=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (mean, biased var) of x[:k] per channel: one pass around
    ``shift`` (the running mean), as ``SubsetBatchNorm`` computes them.
    With a ``mesh`` (``parallel/mesh.py``) the two shifted moments are
    averaged over its ranks, differentiably, before they combine (JAX's
    ``pmean`` over the BN axis): the statistics of all ranks' rows."""
    xs = x[:k].to(torch.float32)
    red = reduce_dims(xs)
    d = xs - shift.view(channel_shape(xs))
    mean_d = d.mean(dim=red)
    mean2_d = d.square().mean(dim=red)
    if mesh is not None:
        from simclr_tpu_torch.parallel.mesh import all_reduce_mean

        mean_d, mean2_d = all_reduce_mean(
            torch.stack([mean_d, mean2_d]), mesh).unbind()
    mean = mean_d + shift
    var = (mean2_d - mean_d.square()).clamp_min(0.0)
    return mean, var


def bn_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor, eps: float,
             dt: torch.dtype) -> torch.Tensor:
    """(x - mean) * (rsig * scale) + bias, each operand cast to ``dt``
    first."""
    cs = channel_shape(x)
    rsig = torch.rsqrt(var + eps)
    return (x.to(dt) - mean.to(dt).view(cs)) * (
        rsig.to(dt).view(cs) * scale.to(dt).view(cs)) + bias.to(dt).view(cs)


def elems_per_channel(shape: Sequence[int], k: int) -> int:
    """Elements per channel in the statistics rows of an (N, C, ...)
    tensor."""
    m = k
    for d in shape[2:]:
        m *= d
    return m


def head_correction(x_head, gy_head_a, s1, s2, gmean, gvar, scale, mean,
                    rsig, m: int, dt: torch.dtype) -> torch.Tensor:
    """dx of the k statistics rows: ``gy_head_a`` (their gy * a) plus the
    terms through the batch mean and variance, with (gmean, gvar) the
    cotangents of the mean/var outputs. Coefficients in float32, the
    per-element arithmetic in ``dt``."""
    cs = channel_shape(x_head)
    a32 = scale * rsig
    inv_m = 1.0 / m
    c1 = (-inv_m) * (a32 * s2)
    c2 = inv_m * 2.0 * gvar
    c0 = (-inv_m) * (a32 * s1 - gmean)
    xc = x_head.to(dt) - mean.to(dt).view(cs)
    xhat = xc * rsig.to(dt).view(cs)
    corr = (c0.to(dt).view(cs) + xhat * c1.to(dt).view(cs)
            + xc * c2.to(dt).view(cs))
    return gy_head_a + corr


class _SubsetBNApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, shift, k, eps, dt):
        mean, var = bn_stats(x, shift, k)
        rsig = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, scale, mean, rsig)
        ctx.k = k
        return bn_apply(x, scale, bias, mean, var, eps, dt), mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, rsig = ctx.saved_tensors
        k, dt = ctx.k, x.dtype
        cs, red = channel_shape(x), reduce_dims(x)
        a = (scale * rsig).to(dt).view(cs)
        xhat = (x - mean.to(dt).view(cs)) * rsig.to(dt).view(cs)
        s1 = gy.sum(dim=red, dtype=torch.float32)
        s2 = (gy * xhat).sum(dim=red, dtype=torch.float32)
        head = head_correction(x[:k], gy[:k] * a, s1, s2, gmean, gvar, scale,
                               mean, rsig, elems_per_channel(x.shape, k), dt)
        dx = torch.cat([head, gy[k:] * a])
        return dx, s2, s1, None, None, None, None


def subset_bn_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    shift: torch.Tensor, k: int, eps: float,
                    apply_dtype: torch.dtype):
    """Train-mode subset BN -> (y, mean, var): y in ``apply_dtype``, mean
    and var the float32 biased statistics of x[:k] (their cotangents are
    honoured)."""
    return _SubsetBNApply.apply(x, scale, bias, shift, k, eps, apply_dtype)
