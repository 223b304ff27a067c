"""Convolution plus subset BatchNorm with a weight-space scale gradient.

Counterpart of ``simclr_tpu/ops/foldconv.py`` (``conv_subset_bn``). For
``y = conv(x, w)`` and a per-output-channel scale A, the activation-sized
inner product <g, y> per channel equals a weight-shaped one:

    sum_{n,h,w} g[n, f] * y[n, f]  ==  sum_{i,kh,kw} w[f] * WG[f],
    WG = wgrad(x, g)

so the backward computes one full weight gradient (which autograd pays
anyway), takes the scale, shift and statistics gradients from it in
weight space, and never reads y again: what is kept for the backward is x,
w and the k statistics rows of y in float32.

The forward is ``SubsetBatchNorm`` applied to the conv output: statistics
of the leading k rows, one pass around ``shift`` (the running mean),
normalised by the biased variance; the caller writes the running update
(``models.norm.BNScaleBias``). The mean and variance outputs carry no
gradient. Stride 1 only (the weight-folded identity blocks). The JAX side
holds no Pallas kernel here: these are plain convolutions, cuDNN's on the
card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.subset_wgrad import conv_backward

_CS = (1, -1, 1, 1)
_RED = (0, 2, 3)


def _wgrad(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
           pad: int) -> torch.Tensor:
    """dw of conv(x, w) for g, in x's dtype, then float32 (JAX's
    ``_wgrad``, ``foldconv.py:183-196``)."""
    return conv_backward(g, x, w, (1, 1), (pad, pad), False,
                         True)[1].to(torch.float32)


class _ConvSubsetBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, shift, pad, k, eps):
        y = F.conv2d(x, w.to(x.dtype), None, 1, pad)
        ys = y[:k].to(torch.float32)
        d = ys - shift.view(_CS)
        mean_d = d.mean(dim=_RED)
        mean2_d = d.square().mean(dim=_RED)
        mean = mean_d + shift
        raw_var = mean2_d - mean_d.square()
        var = raw_var.clamp_min(0.0)
        a = gamma * torch.rsqrt(var + eps)
        b = beta - mean * a
        out = (y.to(torch.float32) * a.view(_CS) + b.view(_CS)).to(x.dtype)
        ctx.save_for_backward(x, w, gamma, mean, var, raw_var, ys)
        ctx.conf = (pad, k, eps)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        x, w, gamma, mean, var, raw_var, ys = ctx.saved_tensors
        pad, k, eps = ctx.conf
        m = k * ys.shape[2] * ys.shape[3]
        r = torch.rsqrt(var + eps)
        a = gamma * r

        gf = g.to(torch.float32)
        s0 = gf.sum(dim=_RED)
        # y was computed with the weights rounded to x's dtype, so the
        # identity sum(g*y) == sum(w*wgrad) takes the same rounded weights.
        wb = w.to(x.dtype)
        wg = _wgrad(x, g, wb, pad)
        s1 = (wb.to(torch.float32) * wg).sum(dim=(1, 2, 3))

        g_a = s1 - mean * s0
        dgamma = g_a * r
        dbeta = s0
        dmean = -a * s0
        dvar = torch.where(raw_var > 0, -0.5 * g_a * gamma * r * r * r,
                           torch.zeros_like(raw_var))

        # The statistics rows also carry the statistics gradients, added in
        # float32 before the cast.
        gy_sub = (dmean.view(_CS) / m
                  + dvar.view(_CS) * 2.0 * (ys - mean.view(_CS)) / m)
        dy = gf * a.view(_CS)
        dy[:k] += gy_sub
        dy = dy.to(x.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv_backward(dy, x, wb, (1, 1), (pad, pad), True,
                               False)[0]
        dw = (a.view(-1, 1, 1, 1) * wg
              + _wgrad(x[:k], gy_sub.to(x.dtype), wb, pad))
        return (dx, dw.to(w.dtype), dgamma, dbeta, None, None, None, None)


def conv_subset_bn(pad: int, k: int, eps: float, x: torch.Tensor,
                   w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   shift: torch.Tensor):
    """Train-mode stride-1 conv + subset BN, no ReLU: returns (out, mean,
    var). out = conv(x, w) * A + B in float32, cast to x's dtype, with
    A = gamma * rsqrt(var + eps) and B = beta - mean * A; mean and var
    (float32, biased) come from the leading k rows of the conv output,
    around the non-differentiated ``shift``. ``pad`` is the spatial
    padding of both sides (0 for 1x1, 1 for 3x3)."""
    return _ConvSubsetBN.apply(x, w, gamma, beta, shift, pad, k, eps)
