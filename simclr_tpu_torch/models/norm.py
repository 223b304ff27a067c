"""Batch normalisation with subset statistics.

Counterpart of ``SubsetBatchNorm``, ``SubsetBNAct``, ``FoldedBatchNorm``
and ``BNScaleBias`` in ``simclr_tpu/models/norm.py``: the batch statistics
come from the leading k = min(max(int(n * fraction), 64), n) rows of the batch
(shuffled upstream, so the subset is uniform), or from ``x_subset`` when the
caller recomputes those rows itself. Inputs are (N, C) or (N, C, H, W); the
channel axis is 1.

Parameters and buffers are ``weight``, ``bias``, ``running_mean`` and
``running_var``. Running averages follow flax's ``momentum=0.9``
(new = 0.9 old + 0.1 batch, torch's momentum 0.1), and the running variance
takes the unbiased m/(m-1) estimate of the subset, m being the elements
reduced per channel.

``SubsetBatchNorm(axis_name=...)`` (data parallelism, JAX's ``axis_name``):
the shifted moments of each rank's statistics rows are averaged over the
ranks of the mesh bound to that name (``parallel/mesh.py``), with
gradient, and the running variance is unbiased over all ranks' elements;
the ``fused_vjp`` route is skipped under an axis, as in JAX. The other BNs
have no axis: under a mesh they take per-rank statistics, as JAX's
``FoldedBatchNorm``, ``BNScaleBias`` and ``SubsetBNAct`` do.

Remat (``models/resnet.py``'s checkpointed blocks) runs a block's forward
a second time in the backward. flax's ``nn.remat`` neither updates the
running statistics twice nor shifts the recompute's one-pass statistics
by the updated mean; ``RunningStats`` keeps that so here: while a block's
wrapper marks the recompute, ``shift()`` gives the value the forward read
and ``update_running`` writes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simclr_tpu_torch.ops import subset_bn
from simclr_tpu_torch.ops.kernels import bn_relu

# 'subset_st_nomean' and 'subset_st_w' are the JAX package's perf probes,
# not trainable modes (simclr_tpu/models/norm.py:204-213, 252-264).
GRAD_MODES = ("exact", "subset_st", "subset_st_nomean", "subset_st_w")
ST_SURROGATES = ("affine", "pad")


def stats_rows(n: int, fraction: float, min_rows: int = 64) -> int:
    """Rows that feed the batch statistics of an n-row batch."""
    return min(max(int(n * fraction), min_rows), n)


def subset_scale(n: int, k: int, dtype: torch.dtype,
                 device: "str | torch.device") -> torch.Tensor:
    """n / k in ``dtype``, the straight-through surrogate's scale: a device
    fill, the bits of ``torch.tensor(n / k, dtype=dtype)`` without its
    host-to-device copy, which a CUDA graph could not capture."""
    return torch.full((), n / k, dtype=dtype, device=device)


def _update_running(bn: nn.Module, mean: torch.Tensor, var: torch.Tensor,
                    m: int) -> None:
    """Flax-momentum running averages; the variance unbiased by m/(m-1)."""
    with torch.no_grad():
        unbiased = var * (m / max(m - 1, 1))
        bn.running_mean.copy_(bn.momentum * bn.running_mean
                              + (1.0 - bn.momentum) * mean)
        bn.running_var.copy_(bn.momentum * bn.running_var
                             + (1.0 - bn.momentum) * unbiased)


class RunningStats(nn.Module):
    """Base of the BNs: running mean and variance with flax's momentum.

    ``remat_phase`` is None outside remat; a checkpointed block sets it to
    'forward' around its forward and 'recompute' around the backward's
    rerun. ``shift()`` is the running mean before this step's update (the
    one-pass statistics' shift): a copy, which the forward keeps and the
    recompute reads back. ``update_running`` writes nothing in the
    recompute, so the statistics move once a step."""

    remat_phase = None
    _kept_shift = None

    def _stats_buffers(self, features: int) -> None:
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def shift(self) -> torch.Tensor:
        if self.remat_phase == "recompute":
            return self._kept_shift
        s = self.running_mean.clone()
        if self.remat_phase == "forward":
            self._kept_shift = s
        return s

    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       m: int) -> None:
        if self.remat_phase != "recompute":
            _update_running(self, mean, var, m)


class SubsetBatchNorm(RunningStats):
    """BatchNorm whose training statistics come from the leading rows.

    ``grad_mode='exact'`` differentiates the subset-statistics forward.
    ``grad_mode='subset_st'`` keeps the forward values and changes the
    backward: the variance and the affine parameters are detached in the
    value path (the mean stays differentiable, so sum(dx) == 0 per
    channel), and weight/bias get the unbiased straight-through estimate
    from the k statistics rows, (n/k) * sum_k. ``st_surrogate`` picks how
    that estimate enters the graph: 'affine' folds it into per-row affine
    coefficients, 'pad' adds a k-row surrogate padded with zeros (always
    used when ``x_subset`` is given). Both give the same values and
    gradients.

    Two perf probes of the JAX package, not trainable modes, share the
    forward values: ``'subset_st_nomean'`` also detaches the mean (the
    per-channel common mode leaks into dx; it collapsed training on the
    JAX side), and ``'subset_st_w'`` always takes the surrogate over all n
    rows weighted by an iota mask, never the affine or pad form.

    ``fused_vjp=True`` takes precedence over ``grad_mode``: training runs
    through ``ops.subset_bn.subset_bn_apply``, the same forward values with
    the exact backward in closed form (statistics from x[:k] only).
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 stats_fraction: float = 0.25, min_stats_samples: int = 64,
                 grad_mode: str = "exact", st_surrogate: str = "affine",
                 fused_vjp: bool = False, axis_name: Optional[str] = None):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {grad_mode!r}")
        if st_surrogate not in ST_SURROGATES:
            raise ValueError(f"unknown st_surrogate {st_surrogate!r}")
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.stats_fraction = stats_fraction
        self.min_stats_samples = min_stats_samples
        self.grad_mode = grad_mode
        self.st_surrogate = st_surrogate
        self.fused_vjp = fused_vjp
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self._stats_buffers(features)

    def forward(self, x: torch.Tensor, x_subset=None) -> torch.Tensor:
        """``x_subset``, when given, equals ``x[:k]`` mathematically (e.g.
        the producing conv applied to the leading k input rows); the
        statistics and the straight-through surrogate read it instead of
        slicing x."""
        dt = self.dtype
        if not self.training:
            return subset_bn.bn_apply(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.eps, dt)

        n = x.shape[0]
        mesh = None
        if self.axis_name is not None:
            from simclr_tpu_torch.parallel.mesh import axis_mesh

            mesh = axis_mesh(self.axis_name)
        if self.fused_vjp and mesh is None:
            if x_subset is not None:
                raise ValueError("fused_vjp takes its statistics from x[:k]; "
                                 "x_subset is not supported")
            k = stats_rows(n, self.stats_fraction, self.min_stats_samples)
            y, mean, var = subset_bn.subset_bn_apply(
                x, self.weight, self.bias, self.shift(), k, self.eps, dt)
            self.update_running(mean, var,
                                subset_bn.elems_per_channel(x.shape, k))
            return y
        if x_subset is not None:
            k, xs = x_subset.shape[0], x_subset
        else:
            k = stats_rows(n, self.stats_fraction, self.min_stats_samples)
            xs = x
        # One-pass variance around the running mean, a free shift that
        # keeps E[d^2] - E[d]^2 well conditioned in float32.
        mean, var = subset_bn.bn_stats(xs, self.shift(), k, mesh)
        self.update_running(mean, var,
                            subset_bn.elems_per_channel(xs.shape, k)
                            * (1 if mesh is None else mesh.size))
        if self.grad_mode == "exact":
            return subset_bn.bn_apply(x, self.weight, self.bias, mean, var,
                                      self.eps, dt)

        cshape = (1, -1) + (1,) * (x.dim() - 2)
        scale_dt = self.weight.to(dt).view(cshape)
        bias_dt = self.bias.to(dt).view(cshape)
        mean_dt = mean.to(dt).view(cshape)
        rsig_dt = torch.rsqrt(var + self.eps).to(dt).view(cshape)
        sg = torch.Tensor.detach
        mean_b = sg(mean_dt) if self.grad_mode == "subset_st_nomean" \
            else mean_dt
        est = subset_scale(n, k, dt, x.device)
        if (self.st_surrogate == "affine" and x_subset is None
                and self.grad_mode != "subset_st_w"):
            rows = (torch.arange(n, device=x.device) < k).to(dt) * est
            me = rows.view((n,) + (1,) * (x.dim() - 1))
            s_row = sg(rsig_dt * scale_dt) + me * (
                sg(rsig_dt) * (scale_dt - sg(scale_dt)))
            b_row = sg(bias_dt) + me * (bias_dt - sg(bias_dt))
            return (x.to(dt) - mean_b) * s_row + b_row
        y = (x.to(dt) - mean_b) * sg(rsig_dt * scale_dt) + sg(bias_dt)
        if self.grad_mode == "subset_st_w":
            w = (torch.arange(n, device=x.device) < k).to(dt).view(
                (n,) + (1,) * (x.dim() - 1))
            xhat = (x.to(dt) - sg(mean_dt)) * sg(rsig_dt)
            return y + (xhat * (scale_dt - sg(scale_dt))
                        + (bias_dt - sg(bias_dt))) * (w * est)
        xk = (x_subset if x_subset is not None else x[:k]).to(dt)
        xhat_k = (xk - sg(mean_dt)) * sg(rsig_dt)
        sur = (xhat_k * (scale_dt - sg(scale_dt))
               + (bias_dt - sg(bias_dt))) * est
        return y + F.pad(sur, (0, 0) * (x.dim() - 1) + (0, n - k))


class SubsetBNAct(RunningStats):
    """Subset-statistics BN fused with the activation around it. ``mode``:
    'relu' (bn1/bn2), 'add_relu' (bn3 plus the residual, given as
    ``skip``), 'none' (the downsample BN). Same parameters and buffers as
    ``SubsetBatchNorm``, so the two interchange weights.

    Training values and running statistics are those of
    ``SubsetBatchNorm(grad_mode='exact')`` followed by the add/ReLU; the
    backward is the exact subset-statistics backward as one pass of kernel
    B3 (``ops/kernels/bn_relu.py``), whatever the model's ``bn_grad_mode``.
    ``impl`` 'xla' or 'xla_mask' selects the plain version of the one-pass
    backward, an explicit choice and never a fallback. With 'pallas' CUDA
    tensors go through the kernel or raise. ``fused=False`` (JAX's
    ``SubsetBNAct.fused``) always takes autograd of the plain math
    instead, never kernel B3.
    """

    def __init__(self, features: int, *, mode: str = "relu",
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16,
                 stats_fraction: float = 0.25, min_stats_samples: int = 64,
                 impl: str = "pallas", fused: bool = True):
        super().__init__()
        if mode not in bn_relu.MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if impl not in bn_relu.IMPLS:
            raise ValueError(f"unknown bn_relu impl {impl!r}")
        self.mode = mode
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.stats_fraction = stats_fraction
        self.min_stats_samples = min_stats_samples
        self.impl = impl
        self.fused = fused
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self._stats_buffers(features)

    def _act(self, y: torch.Tensor, skip) -> torch.Tensor:
        if self.mode == "add_relu":
            return F.relu(y + skip.to(y.dtype))
        return F.relu(y) if self.mode == "relu" else y

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        if (skip is not None) != (self.mode == "add_relu"):
            raise ValueError("skip is given exactly in mode 'add_relu'")
        if not self.training:
            return self._act(subset_bn.bn_apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, self.dtype), skip)
        k = stats_rows(x.shape[0], self.stats_fraction,
                       self.min_stats_samples)
        if self.fused:
            args = (x,) if skip is None else (x, skip)
            op = {"relu": bn_relu.subset_bn_relu,
                  "add_relu": bn_relu.subset_bn_add_relu,
                  "none": bn_relu.subset_bn_only}[self.mode]
            y, mean, var = op(*args, self.weight, self.bias, self.shift(), k,
                              self.eps, self.dtype, self.impl)
        else:
            mean, var = subset_bn.bn_stats(x, self.shift(), k)
            y = self._act(subset_bn.bn_apply(x, self.weight, self.bias, mean,
                                             var, self.eps, self.dtype), skip)
        self.update_running(mean, var,
                            subset_bn.elems_per_channel(x.shape, k))
        return y


class FoldedBatchNorm(RunningStats):
    """BatchNorm that returns the folded per-channel affines (A, B) in
    float32, normalize(y) == y * A + B with A = weight * rsqrt(var + eps)
    and B = bias - mean * A, for the fused identity bottleneck
    (``ops/kernels/bottleneck.py``). Same parameters and buffers as
    ``SubsetBatchNorm``.

    In training ``y_subset`` is the already-sliced statistics rows of the
    pre-activations; mean and variance are the shifted one-pass statistics
    around the running mean, the running averages take the flax momentum
    and the variance unbiased over the subset's elements, and the gradient
    reaches y_subset, weight and bias exactly, by autograd. In eval the
    running statistics are folded and the input is ignored (may be None).
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self._stats_buffers(features)

    def forward(self, y_subset=None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            k = y_subset.shape[0]
            mean, var = subset_bn.bn_stats(y_subset, self.shift(), k)
            self.update_running(
                mean, var, subset_bn.elems_per_channel(y_subset.shape, k))
        a = self.weight * torch.rsqrt(var + self.eps)
        return a, self.bias - mean * a


class BNScaleBias(RunningStats):
    """Parameters and running statistics of a BN whose statistics are
    computed outside it, by ``ops.foldconv.conv_subset_bn`` (the
    weight-folded identity blocks). A call with no arguments returns
    (weight, bias, running_mean, running_var); a call with (mean, var, m)
    first writes the flax-momentum running update, the variance unbiased
    by m/(m-1) (m elements reduced per channel). Same parameters and
    buffers as ``SubsetBatchNorm``, so the two interchange weights."""

    def __init__(self, features: int, *, momentum: float = 0.9):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self._stats_buffers(features)

    def forward(self, mean=None, var=None, m: int = 1):
        if mean is not None:
            self.update_running(mean, var, m)
        return self.weight, self.bias, self.running_mean, self.running_var
