"""ResNet encoder with subset-statistics BatchNorm.

Counterpart of ``simclr_tpu/models/resnet.py``, every path of it:
``Bottleneck`` (1x1 -> 3x3(stride) -> 1x1, expansion 4, with shadow
statistics for bn3 and for bn1/bn2, or with the block's BNs as
``SubsetBNAct``, conv2 through kernel B5 or B4 where the flags and the
block's shape select them, the whole identity block through kernels
B6f/B6b, or weight-folded identity blocks on ``ops/foldconv.py``; subset
weight gradients on ``ops/subset_wgrad.py``), ``ResNetEncoder`` with the
CIFAR stem (3x3 stride 1, no max-pool) or the STL stem (7x7 stride 2, 3x3
stride-2 max-pool), MC dropout, remat of whole stages, and the
supervised baseline's ``SupervisedResNet``.

Two flags of the JAX encoder change only how XLA schedules the step and
are accepted here with no effect: ``relu_from_output`` (PyTorch's ReLU
already masks its backward with its output: autograd saves the result
and calls ``threshold_backward(grad, result, 0)``) and ``relu_barrier``
(XLA's ``optimization_barrier`` after each ReLU; eager PyTorch keeps
every activation anyway and has no such barrier).

Inputs are NCHW, normally in ``torch.channels_last`` memory (physically
NHWC, as on the JAX side). Parameters are float32; convolutions run in
``dtype`` (bfloat16 by default), casting input and weight at the call as
flax's ``dtype`` does. Module names follow the JAX parameter tree
(``stem_conv``, ``layer1_0.conv1``, ``layer2_0.downsample_bn``, ...), so
``utils/weights.py`` maps the two one to one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from simclr_tpu_torch.models.norm import (
    BNScaleBias, FoldedBatchNorm, RunningStats, SubsetBatchNorm, SubsetBNAct,
    stats_rows)
from simclr_tpu_torch.ops.foldconv import conv_subset_bn
from simclr_tpu_torch.ops.kernels import bottleneck
from simclr_tpu_torch.ops.kernels.conv64 import conv3x3_c64
from simclr_tpu_torch.ops.kernels.winograd import winograd_conv3x3
from simclr_tpu_torch.ops.subset_wgrad import conv_subset_wgrad, subset_rows

# Truncated normal on [-2, 2] standard deviations has this std; flax's
# variance_scaling divides by it so the kept draws have the asked variance.
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float,
                   generator: Optional[torch.Generator]) -> None:
    std = std / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Conv(nn.Conv2d):
    """Bias-free conv computed in ``dtype``; kaiming-normal fan-out init
    (flax ``variance_scaling(2.0, 'fan_out', 'truncated_normal')``).

    ``wgrad_fraction`` below 1 (JAX's ``SubsetWgradConv``): in training,
    the weight gradient of an n-row input comes from its k centred rows,
    k = min(max(int(n * wgrad_fraction), min_rows), n), scaled n/k
    (``ops/subset_wgrad.py``); forward and dx are unchanged. Each call
    takes its own k, so a shadow call on a row slice takes the full
    gradient where its rows are at most ``min_rows``."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 wgrad_fraction: float = 1.0, min_rows: int = 64):
        super().__init__(in_ch, out_ch, ksize, stride=stride,
                         padding=padding, bias=False)
        self.dtype = dtype
        self.wgrad_fraction = wgrad_fraction
        self.min_rows = min_rows
        with torch.no_grad():
            _trunc_normal_(self.weight,
                           math.sqrt(2.0 / (out_ch * ksize * ksize)),
                           generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.training and self.wgrad_fraction < 1.0:
            k = subset_rows(x.shape[0], self.wgrad_fraction, self.min_rows)
            if k < x.shape[0]:
                return conv_subset_wgrad(x, w, self.stride, self.padding, k)
        return F.conv2d(x, w, None, self.stride, self.padding)


class WinogradConv3x3(Conv):
    """The stride-1 SAME 3x3 ``Conv`` (same ``weight``, init and name)
    computed by ``winograd_conv3x3`` (kernels B5f/B5w) in ``dtype``, with
    the weight rounded to ``dtype`` before its transform, as JAX's
    ``WinogradConv3x3`` passes ``w.astype(dtype)``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__(features, features, 3, 1, 1, dtype=dtype,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return winograd_conv3x3(x.to(self.dtype), self.weight.to(self.dtype))


class PallasConv3x3C64(Conv):
    """The stride-1 SAME 3x3 ``Conv`` at 64 channels (same ``weight``,
    init and name) computed by ``conv3x3_c64`` (kernels B4f/B4w) on the
    float32 weight, so its gradient stays float32, as in JAX's
    ``PallasConv3x3C64``."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__(64, 64, 3, 1, 1, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_c64(x.to(self.dtype), self.weight)


class Linear(nn.Linear):
    """Dense layer computed in ``dtype``; lecun-normal init and zero bias
    (flax ``nn.Dense`` defaults)."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_f, out_f, bias=bias)
        self.dtype = dtype
        with torch.no_grad():
            _trunc_normal_(self.weight, math.sqrt(1.0 / in_f), generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class MCDropout(nn.Module):
    """Always-on dropout with flax's arithmetic (reference:
    models/resnets.py:110-113 keeps it on at evaluation): keep each value
    with probability 1 - rate and scale it by 1 / (1 - rate); rate 0
    returns the input and rate 1 zeros, drawing nothing. Unlike
    ``nn.Dropout`` it stays on in eval mode, and it draws its mask from
    the ``generator`` passed to ``forward`` (raising without one, as flax
    raises without a ``'dropout'`` stream), so a CUDA graph that
    registers that generator draws new masks on every replay. A 4-D
    input is NCHW in channels_last memory: its mask is drawn in NHWC
    order, so that the output keeps that memory format.

    With ``record`` set, each call keeps its boolean mask in ``mask``
    (tests and the card's graph check compare them). A mask in the
    non-persistent buffer ``baked`` is used in place of a draw, and no
    generator is needed (``utils/serving.py`` bakes the masks of one
    draw into an exported forward)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.record = False
        self.mask: Optional[torch.Tensor] = None
        self.register_buffer("baked", None, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.baked is None and generator is None:
            raise ValueError("MC dropout draws its masks from a generator: "
                             "pass generator=")
        if self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        if self.baked is not None:
            mask = self.baked
        else:
            if x.dim() == 4:
                n, c, h, w = x.shape
                u = torch.rand((n, h, w, c), generator=generator,
                               device=x.device).permute(0, 3, 1, 2)
            else:
                u = torch.rand(x.shape, generator=generator,
                               device=x.device)
            mask = u < keep
        if self.record:
            self.mask = mask
        # flax divides by keep_prob in the input's dtype.
        scale = torch.full((), keep, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / scale, torch.zeros_like(x))


NormFactory = Callable[[int], SubsetBatchNorm]
BNActFactory = Callable[[int, str], SubsetBNAct]


def _affine_relu(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    """relu(y * A + B) in float32 with per-channel A, B, cast to dt."""
    cs = (1, -1, 1, 1)
    return F.relu(y.float() * a.view(cs) + b.view(cs)).to(dt)


def _eval_fold(x: torch.Tensor, conv: "Conv", bn: BNScaleBias, pad: int,
               eps: float) -> torch.Tensor:
    """conv(x) under eval BN with the running statistics folded into a
    float32 affine (JAX's ``fold_eval``)."""
    w, b, rm, rv = bn()
    a = w * torch.rsqrt(rv + eps)
    y = F.conv2d(x, conv.weight.to(x.dtype), None, 1, pad)
    return y.float() * a.view(1, -1, 1, 1) + (b - rm * a).view(1, -1, 1, 1)


def remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` keeping only its input for the backward, which runs the
    block again (JAX's ``nn.remat``). The rerun reads the running means the
    forward read and writes no running statistics (``RunningStats``), so
    it recomputes the forward's values and the statistics move once.
    ``preserve_rng_state=False``: no block draws randomness (MC dropout
    sits between stages and draws from an explicit generator), and saving
    the global CUDA RNG state is not allowed while a CUDA graph captures
    the step."""
    stats = [m for m in block.modules() if isinstance(m, RunningStats)]
    runs = []

    def run(inp):
        phase = "recompute" if runs else "forward"
        runs.append(phase)
        for m in stats:
            m.remat_phase = phase
        try:
            return block(inp)
        finally:
            for m in stats:
                m.remat_phase = None

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with identity or projection
    shortcut. The 3x3 conv2 carries the stride with explicit (1, 1)
    padding; the 1x1 convs pad nothing (SAME for a 1x1 kernel).

    ``shadow_bn3``: in training, bn3 and downsample_bn take their
    statistics from a second, parameter-shared conv call on the leading k
    input rows. The values are those of slicing the conv output; the
    gradients reach the same totals through the shadow call.
    ``shadow_bn12`` does the same for bn1 (``conv1(x[:k])``) and bn2
    (``conv2(y2_in[:k])``). Both only in training, without ``bnact`` and
    where k < n.

    ``wgrad_fraction`` goes to conv1, conv3, the downsample conv and a
    plain conv2 (not to conv2 on B5 or B4, nor to a fused or folded
    block's convs).

    ``bnact``: when given, it makes bn1 and bn2 (mode 'relu'),
    downsample_bn ('none') and bn3 with the residual ('add_relu'), and
    shadow statistics are off.

    conv2 is a ``WinogradConv3x3`` if ``winograd_conv2``, stride 1,
    ``features % 128 == 0`` and bf16 compute; else a ``PallasConv3x3C64``
    if ``conv64_pallas``, stride 1, ``features == 64`` and bf16 compute;
    else the plain ``Conv`` (the choice of JAX's ``Bottleneck``).

    ``fused`` (a stride-1 identity block only, in = out = 4 * features):
    the block's BNs are ``FoldedBatchNorm`` and conv2 the plain ``Conv``
    (whatever ``winograd_conv2`` and ``conv64_pallas`` say), and the
    block runs as JAX's ``Bottleneck._fused_block``. In training, pass A
    runs conv1/bn1/conv2/bn2/conv3 on the leading k statistics rows only
    (per-sample ops commute with row slicing) to get the three folded
    affines; in eval they fold the running statistics. The whole batch
    then goes through ``ops.kernels.bottleneck.fused_bottleneck`` (B6f,
    and B6b for every gradient) in bf16 where its gate takes the shape,
    and through the same math in plain ops otherwise (another compute
    dtype, or a shape the gate refuses), with every conv output rounded
    to the compute dtype as there.

    ``folded`` (a stride-1 identity block that ``fused`` did not take):
    JAX's ``Bottleneck._folded_block``. The BNs are ``BNScaleBias`` and
    in training each conv+BN pair is one ``ops.foldconv.conv_subset_bn``
    (the BN-scale gradient taken in weight space), its statistics
    written by ``BNScaleBias(mean, var, k * H * W)``; the residual add is
    in the compute dtype. In eval the running statistics fold into a
    float32 affine over plain convs."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int,
                 norm: NormFactory, dtype: torch.dtype,
                 stats_fraction: float, shadow_bn3: bool = False,
                 min_stats_samples: int = 64,
                 bnact: Optional[BNActFactory] = None,
                 winograd_conv2: bool = False, conv64_pallas: bool = False,
                 fused: bool = False, folded: bool = False,
                 shadow_bn12: bool = False, wgrad_fraction: float = 1.0,
                 wgrad_min_rows: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = features * self.expansion
        identity = stride == 1 and in_features == out
        self.stats_fraction = stats_fraction
        self.min_stats_samples = min_stats_samples
        self.fused = fused and identity
        self.folded = folded and identity and not self.fused
        self.fused_bn = bnact is not None and not (self.fused or self.folded)
        self.shadow_bn3 = shadow_bn3 and not self.fused_bn
        self.shadow_bn12 = shadow_bn12 and not self.fused_bn

        def bn(f, mode):
            if self.fused:
                return FoldedBatchNorm(f, momentum=0.9, eps=1e-5)
            if self.folded:
                return BNScaleBias(f, momentum=0.9)
            return norm(f) if bnact is None else bnact(f, mode)

        plain = not (self.fused or self.folded)

        def conv(i, o, ksize, s=1, pad=0):
            return Conv(i, o, ksize, s, pad, dtype=dtype, generator=generator,
                        wgrad_fraction=wgrad_fraction if plain else 1.0,
                        min_rows=wgrad_min_rows)

        self.conv1 = conv(in_features, features, 1)
        self.bn1 = bn(features, "relu")
        bf16 = dtype == torch.bfloat16 and plain
        if winograd_conv2 and stride == 1 and features % 128 == 0 and bf16:
            self.conv2 = WinogradConv3x3(features, dtype, generator)
        elif conv64_pallas and stride == 1 and features == 64 and bf16:
            self.conv2 = PallasConv3x3C64(dtype, generator)
        else:
            self.conv2 = conv(features, features, 3, stride, 1)
        self.bn2 = bn(features, "relu")
        self.conv3 = conv(features, out, 1)
        self.bn3 = bn(out, "add_relu")
        if not identity:
            self.downsample_conv = conv(in_features, out, 1, stride)
            self.downsample_bn = bn(out, "none")
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self._fused_block(x)
        if self.folded:
            return self._folded_block(x)
        if self.fused_bn:
            y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
            residual = x
            if self.downsample_conv is not None:
                residual = self.downsample_bn(self.downsample_conv(x))
            return self.bn3(self.conv3(y), residual)
        k = stats_rows(x.shape[0], self.stats_fraction,
                       self.min_stats_samples)
        shadow_ok = self.training and k < x.shape[0]
        shadow = self.shadow_bn3 and shadow_ok
        sh12 = self.shadow_bn12 and shadow_ok
        y = F.relu(self.bn1(self.conv1(x),
                            x_subset=self.conv1(x[:k]) if sh12 else None))
        y = F.relu(self.bn2(self.conv2(y),
                            x_subset=self.conv2(y[:k]) if sh12 else None))
        y3k = self.conv3(y[:k]) if shadow else None
        y = self.conv3(y)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(
                self.downsample_conv(x),
                x_subset=self.downsample_conv(x[:k]) if shadow else None)
        return F.relu(self.bn3(y, x_subset=y3k) + residual)

    def _fused_block(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.conv1.dtype
        x = x.to(dt)
        if self.training:
            k = stats_rows(x.shape[0], self.stats_fraction,
                           self.min_stats_samples)
            y1s = self.conv1(x[:k])
            a1f, b1f = self.bn1(y1s)
            y2s = self.conv2(_affine_relu(y1s, a1f, b1f, dt))
            a2f, b2f = self.bn2(y2s)
            a3f, b3f = self.bn3(self.conv3(_affine_relu(y2s, a2f, b2f, dt)))
        else:
            (a1f, b1f), (a2f, b2f), (a3f, b3f) = (self.bn1(), self.bn2(),
                                                  self.bn3())
        if dt == torch.bfloat16 and bottleneck.supports(
                x, self.conv1.out_channels):
            return bottleneck.fused_bottleneck(
                x, self.conv1.weight, self.conv2.weight, self.conv3.weight,
                (a1f, b1f, a2f, b2f, a3f, b3f))
        a1 = _affine_relu(self.conv1(x), a1f, b1f, dt)
        a2 = _affine_relu(self.conv2(a1), a2f, b2f, dt)
        cs = (1, -1, 1, 1)
        return F.relu(self.conv3(a2).float() * a3f.view(cs) + b3f.view(cs)
                      + x.float()).to(dt)

    def _folded_block(self, x: torch.Tensor) -> torch.Tensor:
        dt, eps = self.conv1.dtype, 1e-5
        x = x.to(dt)
        pairs = ((self.conv1, self.bn1, 0), (self.conv2, self.bn2, 1),
                 (self.conv3, self.bn3, 0))
        if not self.training:
            a1 = F.relu(_eval_fold(x, *pairs[0], eps)).to(dt)
            a2 = F.relu(_eval_fold(a1, *pairs[1], eps)).to(dt)
            return F.relu(_eval_fold(a2, *pairs[2], eps)
                          + x.float()).to(dt)
        k = stats_rows(x.shape[0], self.stats_fraction,
                       self.min_stats_samples)

        def step(inp, conv, bn, pad):
            w, b, _, _ = bn()
            out, mean, var = conv_subset_bn(pad, k, eps, inp, conv.weight,
                                            w, b, bn.shift())
            bn(mean, var, k * out.shape[2] * out.shape[3])
            return out

        a1 = F.relu(step(x, *pairs[0]))
        a2 = F.relu(step(a1, *pairs[1]))
        return F.relu(step(a2, *pairs[2]) + x)


class ResNetEncoder(nn.Module):
    """ResNet trunk producing pooled ``width * 32``-d float32 features.

    ``fuse_identity_blocks`` fuses every identity block whose width is at
    least ``fuse_min_width``; ``fold_bn_scales`` folds every other
    identity block (``Bottleneck.folded``). As in JAX
    (``resnet.py:555-617``), either switches ``bn_relu_fused`` off for the
    whole encoder, and folding also switches off the shadow statistics
    (bn3 and bn1/bn2), as ``bn_fused_vjp`` does. ``bn12_shadow_stats``
    shadows bn1/bn2 in every stage, and the stem's BN unless
    ``fold_bn_scales``, ``bn_fused_vjp`` or ``bn_relu_fused`` is set;
    ``bn12_shadow_stages`` shadows bn1/bn2 in the stages it names.
    ``conv_wgrad_fraction`` below 1 gives the stem and the blocks' plain convs
    subset weight gradients in training. ``remat_stages``: each block of those
    stages runs under ``remat`` in training. ``relu_from_output`` and
    ``relu_barrier`` have no effect (module docstring). ``mc_dropout``: an
    ``MCDropout(drop_prob)`` after the stem's ReLU (before the STL stem's
    max-pool) and after each of the four stages, on in train and eval mode
    alike; ``forward`` then takes the generator that draws the masks.
    ``bn_axis_name`` (data parallelism): every ``SubsetBatchNorm`` averages
    its statistics over the ranks of the mesh bound to that name, and
    ``bn_relu_fused`` is off, as in JAX (``resnet.py:573``); the fused and
    folded identity blocks keep per-rank statistics, as JAX's do under
    ``shard_map``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, low_quality_img: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.bfloat16,
                 bn_stats_fraction: float = 0.25,
                 bn_grad_mode: str = "exact",
                 bn_st_surrogate: str = "affine",
                 bn3_shadow_stats: bool = False,
                 bn_fused_vjp: bool = False,
                 bn_relu_fused: bool = False,
                 bn_relu_impl: str = "pallas",
                 winograd_conv2: bool = False,
                 conv64_pallas: bool = False,
                 fuse_identity_blocks: bool = False,
                 fuse_min_width: int = 0,
                 fold_bn_scales: bool = False,
                 relu_barrier: bool = False,
                 bn12_shadow_stats: bool = False,
                 bn12_shadow_stages: Sequence[int] = (),
                 relu_from_output: bool = False,
                 conv_wgrad_fraction: float = 1.0,
                 conv_wgrad_min_rows: int = 64,
                 remat_stages: Sequence[int] = (),
                 mc_dropout: bool = False,
                 drop_prob: float = 0.3,
                 bn_axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.low_quality_img = low_quality_img
        self.mc_dropout = mc_dropout
        self.bn_stats_fraction = bn_stats_fraction
        self.shadow_stem = (bn12_shadow_stats and not fold_bn_scales
                            and not bn_fused_vjp and not bn_relu_fused)

        def norm(features):
            return SubsetBatchNorm(
                features, momentum=0.9, eps=1e-5, dtype=bn_dtype,
                stats_fraction=bn_stats_fraction, grad_mode=bn_grad_mode,
                st_surrogate=bn_st_surrogate, fused_vjp=bn_fused_vjp,
                axis_name=bn_axis_name)

        bnact = None
        if (bn_relu_fused and bn_axis_name is None
                and not fuse_identity_blocks and not fold_bn_scales):
            def bnact(features, mode):
                return SubsetBNAct(
                    features, mode=mode, momentum=0.9, eps=1e-5,
                    dtype=bn_dtype, stats_fraction=bn_stats_fraction,
                    impl=bn_relu_impl)

        ksize, stride, pad = (3, 1, 1) if low_quality_img else (7, 2, 3)
        self.stem_conv = Conv(3, width, ksize, stride, pad, dtype=dtype,
                              generator=generator,
                              wgrad_fraction=conv_wgrad_fraction,
                              min_rows=conv_wgrad_min_rows)
        self.stem_bn = norm(width)
        if mc_dropout:
            self.stem_dropout = MCDropout(drop_prob)
        self.block_names = []
        self.remat_blocks = set()
        self.stage_ends = {}
        unshadowed = fold_bn_scales or bn_fused_vjp
        in_features = width
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                features = width * 2 ** stage
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(
                    in_features, features, stride, norm, dtype,
                    bn_stats_fraction,
                    shadow_bn3=bn3_shadow_stats and not unshadowed,
                    bnact=bnact, winograd_conv2=winograd_conv2,
                    conv64_pallas=conv64_pallas,
                    fused=(fuse_identity_blocks
                           and features >= fuse_min_width),
                    folded=fold_bn_scales,
                    shadow_bn12=((bn12_shadow_stats
                                  or stage in tuple(bn12_shadow_stages))
                                 and not unshadowed),
                    wgrad_fraction=conv_wgrad_fraction,
                    wgrad_min_rows=conv_wgrad_min_rows,
                    generator=generator))
                self.block_names.append(name)
                if stage in tuple(remat_stages):
                    self.remat_blocks.add(name)
                in_features = features * Bottleneck.expansion
            if mc_dropout and n_blocks:
                self.stage_ends[name] = f"layer{stage + 1}_dropout"
                self.add_module(self.stage_ends[name], MCDropout(drop_prob))
        self.out_features = in_features

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        n = x.shape[0]
        k = stats_rows(n, self.bn_stats_fraction)
        sub = None
        if self.shadow_stem and self.training and k < n:
            sub = self.stem_conv(x[:k])
        x = F.relu(self.stem_bn(self.stem_conv(x), x_subset=sub))
        if self.mc_dropout:
            x = self.stem_dropout(x, generator)
        if not self.low_quality_img:
            x = F.max_pool2d(x, 3, 2, 1)
        rematted = self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if rematted and name in self.remat_blocks:
                x = remat(block, x)
            else:
                x = block(x)
            if name in self.stage_ends:
                x = getattr(self, self.stage_ends[name])(x, generator)
        return x.mean(dim=(2, 3)).to(torch.float32)


class SupervisedResNet(nn.Module):
    """ResNet classifier: the trunk, named ``encoder``, then a float32
    ``Linear`` named ``fc`` (reference: models/resnets.py:54-89; JAX
    ``SupervisedResNet``). Like ``train_supervised`` on the JAX side, it
    takes only these fields of the config: its BNs run the exact
    full-gradient mode with no shadow statistics and no kernel, and it
    has no dropout. ``forward(x, generator=None) -> logits``; the
    generator is accepted so that every classifier of
    ``train/ssl.py:SupervisedEngine`` is called alike, and unused."""

    def __init__(self, num_classes: int = 10, low_quality_img: bool = True,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.bfloat16,
                 bn_stats_fraction: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = ResNetEncoder(
            stage_sizes=stage_sizes, width=width,
            low_quality_img=low_quality_img, dtype=dtype, bn_dtype=bn_dtype,
            bn_stats_fraction=bn_stats_fraction, generator=generator)
        self.fc = Linear(self.encoder.out_features, num_classes,
                         dtype=torch.float32, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.fc(self.encoder(x, generator))
