"""SimCLR model: encoder f and projection head g; ``forward(x) -> (h, z)``.

Counterpart of ``simclr_tpu/models/simclr.py``. The projection head is
``num_proj_layers - 1`` blocks of Linear(bias) -> BN -> ReLU, then a
bias-free Linear -> BN (reference: models/simclr.py:27-41).

Every ``ModelConfig`` the JAX package accepts builds here: the default
path, ``bn_relu_fused`` (the block BNs as ``SubsetBNAct``, backward
through kernel B3), ``bn_fused_vjp``, ``winograd_conv2`` (kernel B5),
``conv64_pallas`` (kernel B4), ``fuse_identity_blocks`` with
``fuse_min_width`` (kernels B6f/B6b), ``fold_bn_scales``, the bn1/bn2
shadow statistics, ``conv_wgrad_fraction``, ``remat_stages``, the
``bn_grad_mode`` probes, ``relu_from_output`` and ``relu_barrier`` (no
effect here, ``models/resnet.py``) and ``encoder='dropout'`` (MC dropout
after the stem, each stage and each hidden layer of the head, masks drawn
from the generator passed to ``forward``). The ``*_interpret`` twins are
unused (on the CPU the kernel wrappers run their plain versions). The
auto (None) flags resolve to False, as ``init_simclr`` resolves them on
one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models.norm import (
    GRAD_MODES, ST_SURROGATES, SubsetBatchNorm)
from simclr_tpu_torch.models.resnet import Linear, MCDropout, ResNetEncoder


def check_ported(cfg: ModelConfig) -> None:
    """Raise ValueError for an encoder, BN gradient mode or surrogate that
    no package knows."""
    if cfg.encoder not in ("no_dropout", "dropout"):
        raise ValueError(f"unknown encoder {cfg.encoder!r} (expected "
                         "'no_dropout' or 'dropout')")
    for mode in (cfg.bn_grad_mode, cfg.head_bn_grad_mode):
        if mode is not None and mode not in GRAD_MODES:
            raise ValueError(f"unknown bn_grad_mode {mode!r}")
    if cfg.bn_st_surrogate not in ST_SURROGATES:
        raise ValueError(f"unknown bn_st_surrogate {cfg.bn_st_surrogate!r}")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _make_encoder(cfg: ModelConfig, generator: Optional[torch.Generator],
                  bn_axis_name: Optional[str] = None) -> ResNetEncoder:
    check_ported(cfg)
    return ResNetEncoder(
        stage_sizes=cfg.stage_sizes,
        width=cfg.width,
        low_quality_img=cfg.low_quality_img,
        dtype=dtype_of(cfg.compute_dtype),
        bn_dtype=dtype_of(cfg.bn_dtype),
        bn_stats_fraction=cfg.bn_stats_fraction,
        bn_grad_mode=cfg.bn_grad_mode,
        bn_st_surrogate=cfg.bn_st_surrogate,
        bn3_shadow_stats=cfg.bn3_shadow_stats,
        bn_fused_vjp=bool(cfg.bn_fused_vjp),
        bn_relu_fused=bool(cfg.bn_relu_fused),
        bn_relu_impl=cfg.bn_relu_impl,
        winograd_conv2=bool(cfg.winograd_conv2),
        conv64_pallas=bool(cfg.conv64_pallas),
        fuse_identity_blocks=bool(cfg.fuse_identity_blocks),
        fuse_min_width=cfg.fuse_min_width,
        fold_bn_scales=bool(cfg.fold_bn_scales),
        relu_barrier=cfg.relu_barrier,
        bn12_shadow_stats=cfg.bn12_shadow_stats,
        bn12_shadow_stages=tuple(cfg.bn12_shadow_stages),
        relu_from_output=cfg.relu_from_output,
        conv_wgrad_fraction=cfg.conv_wgrad_fraction,
        conv_wgrad_min_rows=cfg.conv_wgrad_min_rows,
        remat_stages=tuple(cfg.remat_stages),
        mc_dropout=cfg.encoder == "dropout",
        drop_prob=cfg.drop_prob,
        bn_axis_name=bn_axis_name,
        generator=generator,
    )


class ProjectionHead(nn.Module):
    """MLP g(.) (reference: models/simclr.py:27-41). With ``mc_dropout``
    an ``MCDropout(drop_prob)`` follows each hidden ReLU (reference:
    models/simclr.py:35-36); ``forward`` then takes its generator."""

    def __init__(self, in_features: int, feature_dim: int = 2048,
                 output_dim: int = 128, num_layers: int = 2,
                 mc_dropout: bool = False, drop_prob: float = 0.3,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.bfloat16,
                 bn_stats_fraction: float = 0.25,
                 bn_grad_mode: str = "exact",
                 bn_st_surrogate: str = "affine",
                 bn_fused_vjp: bool = False,
                 bn_axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.mc_dropout = mc_dropout

        def norm(features):
            return SubsetBatchNorm(
                features, momentum=0.9, eps=1e-5, dtype=bn_dtype,
                stats_fraction=bn_stats_fraction, grad_mode=bn_grad_mode,
                st_surrogate=bn_st_surrogate, fused_vjp=bn_fused_vjp,
                axis_name=bn_axis_name)

        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"linear{i}", Linear(
                width, feature_dim, dtype=dtype, generator=generator))
            self.add_module(f"bn{i}", norm(feature_dim))
            if mc_dropout:
                self.add_module(f"dropout{i}", MCDropout(drop_prob))
            width = feature_dim
        last = num_layers - 1
        self.add_module(f"linear{last}", Linear(
            width, output_dim, bias=False, dtype=dtype, generator=generator))
        self.add_module(f"bn{last}", norm(output_dim))

    def forward(self, h: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = h.to(self.dtype)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"linear{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x))
            if self.mc_dropout:
                x = getattr(self, f"dropout{i}")(x, generator)
        last = self.num_layers - 1
        x = getattr(self, f"bn{last}")(getattr(self, f"linear{last}")(x))
        return x.to(torch.float32)


def _make_head(cfg: ModelConfig, in_features: int,
               generator: Optional[torch.Generator],
               bn_axis_name: Optional[str] = None) -> ProjectionHead:
    return ProjectionHead(
        in_features,
        feature_dim=cfg.feature_dim,
        output_dim=cfg.compressed_dim,
        num_layers=cfg.num_proj_layers,
        mc_dropout=cfg.encoder == "dropout",
        drop_prob=cfg.drop_prob,
        dtype=dtype_of(cfg.compute_dtype),
        bn_dtype=dtype_of(cfg.bn_dtype),
        bn_stats_fraction=cfg.bn_stats_fraction,
        bn_grad_mode=cfg.head_bn_grad_mode or cfg.bn_grad_mode,
        bn_st_surrogate=cfg.bn_st_surrogate,
        bn_fused_vjp=bool(cfg.bn_fused_vjp),
        bn_axis_name=bn_axis_name,
        generator=generator,
    )


class SimCLR(nn.Module):
    """Encoder + projection head; ``forward(x, generator=None) -> (h, z)``
    for NCHW images (reference: models/simclr.py:43-46). ``generator``
    draws the MC-dropout masks, the encoder's first; a model without
    dropout draws nothing from it. ``bn_axis_name`` names the data axis
    whose ranks the ``SubsetBatchNorm`` statistics of ``f`` and ``g`` are
    averaged over (``parallel/explicit.py:make_explicit_model``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.bn_axis_name = bn_axis_name
        self.f = _make_encoder(cfg, generator, bn_axis_name)
        self.g = _make_head(cfg, self.f.out_features, generator,
                            bn_axis_name)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h = self.f(x, generator)
        return h, self.g(h, generator)


class SimCLRFineTune(nn.Module):
    """Encoder + float32 linear supervised head; ``forward(x,
    generator=None) -> logits`` for NCHW images (reference:
    models/ssl.py:6-35); ``generator`` draws the encoder's MC-dropout
    masks.

    The projection head ``g`` is built so that the parameter tree is
    SimCLR's and a pretrained export loads whole, but the forward never
    runs it, as the reference's does not (models/ssl.py:32-35). The JAX
    module calls ``g`` on ``stop_gradient(h)`` with ``train=False`` only
    to create its parameters; XLA drops the unused result, so neither its
    parameters nor its running statistics change in training there, nor
    here, where ``g`` gets no gradient and SGD leaves it alone. From one
    seed, ``f`` and ``g`` start as ``SimCLR``'s do."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 num_classes: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.f = _make_encoder(cfg, generator)
        self.g = _make_head(cfg, self.f.out_features, generator)
        self.supervised_head = Linear(self.f.out_features, num_classes,
                                      dtype=torch.float32,
                                      generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.supervised_head(self.f(x, generator))
