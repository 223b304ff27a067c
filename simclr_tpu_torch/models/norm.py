"""Batch normalisation with subset statistics.

Counterpart of ``SubsetBatchNorm`` in ``simclr_tpu/models/norm.py``: the
batch statistics come from the leading k = min(max(int(n * fraction), 64),
n) rows of the batch (shuffled upstream, so the subset is uniform), or
from ``x_subset`` when the caller recomputes those rows itself. Inputs are
(N, C) or (N, C, H, W); the channel axis is 1.

Parameters and buffers are ``weight``, ``bias``, ``running_mean`` and
``running_var``. Running averages follow flax's ``momentum=0.9``
(new = 0.9 old + 0.1 batch, torch's momentum 0.1), and the running variance
takes the unbiased m/(m-1) estimate of the subset, m being the elements
reduced per channel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

GRAD_MODES = ("exact", "subset_st")
ST_SURROGATES = ("affine", "pad")


def stats_rows(n: int, fraction: float, min_rows: int = 64) -> int:
    """Rows that feed the batch statistics of an n-row batch."""
    return min(max(int(n * fraction), min_rows), n)


class SubsetBatchNorm(nn.Module):
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
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 stats_fraction: float = 0.25, min_stats_samples: int = 64,
                 grad_mode: str = "exact", st_surrogate: str = "affine"):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise NotImplementedError(
                f"grad_mode {grad_mode!r} is ported in a later PR")
        if st_surrogate not in ST_SURROGATES:
            raise ValueError(f"unknown st_surrogate {st_surrogate!r}")
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.stats_fraction = stats_fraction
        self.min_stats_samples = min_stats_samples
        self.grad_mode = grad_mode
        self.st_surrogate = st_surrogate
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, x_subset=None) -> torch.Tensor:
        """``x_subset``, when given, equals ``x[:k]`` mathematically (e.g.
        the producing conv applied to the leading k input rows); the
        statistics and the straight-through surrogate read it instead of
        slicing x."""
        cshape = (1, -1) + (1,) * (x.dim() - 2)
        dt = self.dtype
        scale_dt = self.weight.to(dt).view(cshape)
        bias_dt = self.bias.to(dt).view(cshape)
        if not self.training:
            mean = self.running_mean.to(dt).view(cshape)
            rsig = torch.rsqrt(self.running_var + self.eps).to(dt).view(
                cshape)
            return (x.to(dt) - mean) * (rsig * scale_dt) + bias_dt

        n = x.shape[0]
        if x_subset is not None:
            k = x_subset.shape[0]
            xs = x_subset.to(torch.float32)
        else:
            k = stats_rows(n, self.stats_fraction, self.min_stats_samples)
            xs = x[:k].to(torch.float32)
        red = (0,) + tuple(range(2, xs.dim()))
        # One-pass variance around the running mean, a free shift that
        # keeps E[d^2] - E[d]^2 well conditioned in float32.
        shift = self.running_mean.clone()
        d = xs - shift.view(cshape)
        mean_d = d.mean(dim=red)
        mean2_d = d.square().mean(dim=red)
        mean = mean_d + shift
        var = (mean2_d - mean_d.square()).clamp_min(0.0)
        with torch.no_grad():
            m = xs.numel() // xs.shape[1]
            unbiased = var * (m / max(m - 1, 1))
            self.running_mean.copy_(self.momentum * self.running_mean
                                    + (1.0 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var
                                   + (1.0 - self.momentum) * unbiased)

        mean_dt = mean.to(dt).view(cshape)
        rsig_dt = torch.rsqrt(var + self.eps).to(dt).view(cshape)
        if self.grad_mode == "exact":
            return (x.to(dt) - mean_dt) * (rsig_dt * scale_dt) + bias_dt

        sg = torch.Tensor.detach
        est = torch.tensor(n / k, dtype=dt, device=x.device)
        if self.st_surrogate == "affine" and x_subset is None:
            rows = (torch.arange(n, device=x.device) < k).to(dt) * est
            me = rows.view((n,) + (1,) * (x.dim() - 1))
            s_row = sg(rsig_dt * scale_dt) + me * (
                sg(rsig_dt) * (scale_dt - sg(scale_dt)))
            b_row = sg(bias_dt) + me * (bias_dt - sg(bias_dt))
            return (x.to(dt) - mean_dt) * s_row + b_row
        y = (x.to(dt) - mean_dt) * sg(rsig_dt * scale_dt) + sg(bias_dt)
        xk = (x_subset if x_subset is not None else x[:k]).to(dt)
        xhat_k = (xk - sg(mean_dt)) * sg(rsig_dt)
        sur = (xhat_k * (scale_dt - sg(scale_dt))
               + (bias_dt - sg(bias_dt))) * est
        return y + F.pad(sur, (0, 0) * (x.dim() - 1) + (0, n - k))
