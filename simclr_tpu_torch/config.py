"""Typed configuration for the PyTorch/CUDA port of the SimCLR framework.

The port's own copy of ``simclr_tpu/config.py``: the same frozen dataclass
tree with the same field names and defaults, so one JSON round-trips between
the two packages. Every model flag of the JAX package selects its path in
the port too (``models/simclr.py``).

Replaces the reference's single JSON blob (reference: utils/configs.json:1-39)
that is re-loaded at import time by three different modules
(reference: data.py:8-9, utils/model_utils.py:8-9, pretrain.py:65-66) with one
frozen dataclass tree constructed explicitly and passed down. Every key of the
reference config has a typed counterpart here; CLI entry points override
fields via `replace()`.

Defaults mirror reference utils/configs.json exactly where the semantics
carry over (lr, temperature, dims, weight decay, ...). Host paths default to
repo-local directories instead of the reference's hardcoded cluster paths
(reference: utils/configs.json:31-38).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """SimCLR augmentation-stack parameters.

    Mirrors reference utils/configs.json:2-5 ("augmentation_params") and the
    hardcoded constants inside compose_augmentation_train
    (reference: data.py:100-147).
    """

    # Strength s of the colour distortion; jitter = (0.8s, 0.8s, 0.8s, 0.2s)
    # (reference: data.py:125-130).
    color_distort_strength: float = 0.5
    # Probability of random grayscale conversion (reference: data.py:133-135).
    color_drop_prob: float = 0.2
    # Probability of applying colour jitter at all (reference: data.py:131).
    color_jitter_prob: float = 0.8
    # Probability of a horizontal flip (reference: data.py:122-123).
    flip_prob: float = 0.5
    # Inception-style crop area range (torchvision RandomResizedCrop default,
    # used at reference data.py:121).
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    # Aspect-ratio range of the random crop (torchvision default 3/4..4/3).
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    # Gaussian-blur sigma range (torchvision GaussianBlur default, reference
    # data.py:136-139). Kernel size is floor(0.1 * img_size), odd-snapped.
    blur_sigma: Tuple[float, float] = (0.1, 2.0)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Per-dataset constants (reference: utils/configs.json:14-15, 29-30)."""

    name: str = "cifar10"
    img_size: int = 32
    mean: Tuple[float, float, float] = (0.4914, 0.4822, 0.4465)
    std: Tuple[float, float, float] = (0.2023, 0.1994, 0.2010)
    num_classes: int = 10


CIFAR10 = DatasetConfig(
    name="cifar10",
    img_size=32,
    mean=(0.4914, 0.4822, 0.4465),
    std=(0.2023, 0.1994, 0.2010),
)

STL10 = DatasetConfig(
    name="stl10",
    img_size=96,
    mean=(0.4409, 0.4279, 0.3867),
    std=(0.2683, 0.2610, 0.2686),
)


def dataset_config(name: str) -> DatasetConfig:
    try:
        return {"cifar10": CIFAR10, "stl10": STL10}[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; choose cifar10 or stl10")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SimCLR model hyperparameters (reference: utils/configs.json:16-18, 28;
    models/simclr.py:6-41)."""

    # Encoder output width == input to projection head ("feature_dim").
    feature_dim: int = 2048
    # Projection output width ("compressed_dim").
    compressed_dim: int = 128
    # ResNet layout; (3, 4, 6, 3) x Bottleneck = ResNet-50
    # (reference: models/resnets.py:11). feature_dim must equal width * 32.
    stage_sizes: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    # Number of projection-head layers (reference: models/simclr.py:11).
    num_proj_layers: int = 2
    # 'no_dropout' or 'dropout' (MC-dropout encoder,
    # reference: models/resnets.py:116-152).
    encoder: str = "no_dropout"
    # MC-dropout probability ("drop_prob").
    drop_prob: float = 0.3
    # CIFAR-style 3x3/stride-1 stem without maxpool when True
    # (reference: models/resnets.py:16-19, 26-27).
    low_quality_img: bool = True
    # Compute dtype for conv/matmul; params always float32.
    compute_dtype: str = "bfloat16"
    # BatchNorm application dtype. Statistics are always accumulated in
    # float32; applying the normalization in bfloat16 keeps the
    # scale/shift fusable into the conv epilogue (measured -20% step time
    # on v5e vs float32 application).
    bn_dtype: str = "bfloat16"
    # Fraction of the batch used for BN batch statistics (models/norm.py).
    # Profiling showed stat reductions were ~50% of the step. Default
    # 0.0625 == 64 samples of a 1024-image two-view batch — the
    # reference's own statistics regime (utils/model_utils.py:109-114,
    # batch_size_small=64): the round-3 discriminative parity run
    # (results/parity/parity.md) measured it BEST on lin-eval (+0.41pp
    # vs 1/4-subset) and ~5% faster. 1.0 = exact full-batch stats.
    bn_stats_fraction: float = 0.0625
    # Bandwidth-shaped custom VJP for the subset BN (ops/subset_bn.py):
    # same forward numerics, backward restructured so the dgamma/dbeta
    # reductions and most of dx share one pass over the activations.
    bn_fused_vjp: bool = False
    # BN backward semantics (models/norm.py SubsetBatchNorm.grad_mode):
    # 'exact' = true autodiff of the subset-statistics forward;
    # 'subset_st' = variance stop-gradiented (mean stays differentiable,
    # preserving sum(dx)==0 per channel) + scale/bias gradients from the
    # unbiased straight-through k-sample estimator — the dgamma/dbeta
    # reductions then read k-row slices instead of the full layer
    # activations (pure-autodiff formulation, keeps every XLA cross-op
    # fusion; see models/norm.py). Default since the round-3 parity run:
    # 9.09 vs 8.75 steps/s with lin-eval 48.60 vs 48.18 mean
    # (results/parity_stgrad — equal-or-better accuracy, +4% speed).
    bn_grad_mode: str = "subset_st"
    # Projection-head override for bn_grad_mode (None = inherit). The
    # head's BN1d layers see (2N, 2048)/(2N, 128) tensors — exact
    # dgamma/dbeta reductions there are bandwidth-free compared with the
    # encoder's layer-sized activations, so 'exact' here buys back the
    # noisiest straight-through estimates (the aux-accuracy metric reads
    # z, downstream of these BNs) at zero measurable step cost. Gated by
    # scripts/parity_run.py variant 'head_exact'.
    head_bn_grad_mode: "str | None" = None
    # subset_st surrogate form (models/norm.py SubsetBatchNorm):
    # 'affine' = the k-sample straight-through surrogate folded into
    # per-row affine BN coefficients ([n,1,1,C] broadcast — no batch-dim
    # pad, keeps the apply input-fusable into the consuming conv at
    # every layer); 'pad' = the round-3 padded-k-rows form. Identical
    # VJP; forward identical in exact arithmetic (<=1 ulp on the k
    # stats rows under jit — tests/test_norm.py).
    bn_st_surrogate: str = "affine"
    # Run stride-1 identity bottlenecks as fused VMEM-resident Pallas
    # kernels (ops/pallas/bottleneck.py). None = auto: enabled on
    # single-chip TPU by init_simclr, off under meshes and on CPU.
    fuse_identity_blocks: "bool | None" = None
    # With fusion on, only fuse blocks whose bottleneck width (the 1x1/3x3
    # channel count) is >= this. Narrow stages (layer1 C=64) tile poorly on
    # the 128-lane MXU; wide stages (layer3/4, C>=256) are where VMEM
    # residency pays.
    fuse_min_width: int = 0
    # Interpret-mode Pallas (CPU testing of the fused path).
    fuse_interpret: bool = False
    # Fold BN scales into conv kernels for identity blocks (XLA-only path,
    # models/resnet.py Bottleneck._folded_block): turns the BN-scale
    # gradient into a weight-shaped reduction. None = auto (resolved by
    # init_simclr from measurement).
    fold_bn_scales: "bool | None" = None
    # Fuse BN(+residual)+ReLU backward into one Pallas pass
    # (ops/pallas/bn_relu.py): the dgamma/dbeta reductions, the ReLU
    # mask, the dx elementwise and the skip cotangent all share a single
    # read of the layer-sized activations. None = auto (resolved by
    # init_simclr from measurement).
    bn_relu_fused: "bool | None" = None
    # 'pallas' (layout-native one-pass kernel) or 'xla' (same
    # restructured math as plain ops; relies on XLA sibling fusion).
    bn_relu_impl: str = "pallas"
    # Fusion-rooting experiment: optimization_barrier after each ReLU.
    relu_barrier: bool = False
    # Shadow bn3/downsample statistics: recompute the k stats rows with a
    # parameter-shared conv on the sliced input so the block-output BN
    # apply(+add+relu) fuses into the conv's epilogue (models/resnet.py
    # Bottleneck.shadow_bn3). Mathematically exact vs the sliced-stats
    # path (tests/test_norm_shadow.py). Measured on v5e at batch 1024:
    # 9.61 vs 9.16 steps/s (+4.9%) — default ON.
    bn3_shadow_stats: bool = True
    # Extend shadow statistics to bn1/bn2 and the stem BN.
    bn12_shadow_stats: bool = False
    # Stage-gated bn1/bn2 shadow statistics (0-based stage indices; see
    # models/resnet.py ResNetEncoder.bn12_shadow_stages). (0,) targets
    # the one position where a bn-apply+relu still materializes as its
    # own pass at batch 1024 (layer1; the all-stage bool measured slower
    # in round 3 because stages 2-4 have nothing deletable). Measured on
    # v5e at batch 1024 (bench_variants.py 'shadow12_l1'): 9.47 vs 9.75
    # steps/s — NEGATIVE; the shadow k-row conv recomputes cost more
    # than the 1.34 ms relu pass they delete, so the default stays ().
    bn12_shadow_stages: tuple = ()
    # Subset weight gradients for the trunk convs (ops/subset_wgrad.py):
    # each conv's dw is contracted over a centered floor(fraction*2N)-row
    # slice of the batch (min 64 rows; the slice spans both augmentation
    # views) and scaled 2N/k; dx stays exact, so — unlike the removed
    # round-3 subset-BN-backward — the estimator noise never enters the
    # backward chain and cannot compound through depth. Statistically
    # this is "weight gradients from a batch of k": the torch reference
    # itself updates from 512-sample weight gradients at effective batch
    # 512 (8 accumulated micro-batches of 64,
    # utils/model_utils.py:109-123). 1.0 = exact (plain convs).
    conv_wgrad_fraction: float = 1.0
    # Floor on the wgrad slice (rows). Below this the conv short-circuits
    # to the exact path; 64 mirrors the reference's micro-batch.
    conv_wgrad_min_rows: int = 64
    # ReLU backward mask from the OUTPUT tensor (y > 0) instead of the
    # fused, never-materialized pre-activation (x > 0) — bit-identical
    # values and gradients (models/resnet.relu_vjp_from_output).
    relu_from_output: bool = False
    # Fused Winograd F(2x2,3x3) Pallas kernel for the stride-1
    # identity-block conv2 (layers with width % 128 == 0): 2.25x fewer
    # MXU FLOPs at identical HBM traffic (ops/pallas/winograd.py).
    # Only active with bfloat16 compute on a TPU backend (or with
    # winograd_interpret for CPU tests); everywhere else the standard
    # XLA conv runs. Parameter trees are identical either way.
    winograd_conv2: bool = False
    # Run the Winograd kernel in Pallas interpret mode (CPU tests).
    winograd_interpret: bool = False
    # Batch-on-lanes Pallas kernel for the C=64 3x3 convs (layer1 conv2,
    # ops/pallas/conv64.py): K=192 merged-tap contraction for forward /
    # input-gradient and a K=batch-lanes weight-gradient — the three ops
    # XLA's emitter leaves at 1.46-2.18x floor (64 channels underfill
    # the 128-wide MXU whichever way it slices). Shape-gated to
    # C==64, N % 256 == 0, bf16; everywhere else the XLA conv runs with
    # the same parameters. Only active on a TPU backend (or with
    # conv64_interpret for CPU tests).
    conv64_pallas: bool = False
    # Run the conv64 kernel in Pallas interpret mode (CPU tests).
    conv64_interpret: bool = False
    # Stages (0-based) whose bottlenecks run under jax.checkpoint —
    # backward recomputes intra-block activations instead of reading
    # saved ones (models/resnet.py remat_stages). Identical math.
    remat_stages: tuple = ()


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer settings (reference: utils/configs.json:10, 20-22, 24-25)."""

    lr: float = 1e-3                # Adam lr for pretraining.
    wt_decay: float = 1e-6          # L2-into-gradient (torch Adam semantics).
    lr_ssl: float = 0.02            # SGD lr for semi-supervised fine-tune.
    momentum_ssl: float = 0.98      # Nesterov momentum for fine-tune.
    mine_lr: float = 5e-4           # Adam lr for MINE.
    reg_wt_lin_eval: float = 1e-3   # L2 penalty in linear eval.
    lbfgs_max_iter: int = 20        # L-BFGS inner iterations per step.


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Pretraining-loop settings (reference: utils/configs.json:6-13, 19, 23,
    26-27; pretrain.py:9-53)."""

    n_epoch: int = 100
    batch_size: int = 512           # True global batch (was 64*accum_steps=512).
    micro_batch_size: int = 64      # Reference per-step batch ("batch_size_small").
    accum_steps: int = 1            # >1 enables reference-parity grad accumulation
    #                                 (reference: utils/model_utils.py:116-123).
    temperature: float = 0.5
    modified_loss: bool = False     # Probabilistic loss (reference: objective.py:58-98).
    val_fraction: float = 0.2       # 80/20 split (reference: data.py:315-317).
    save_ckpt: bool = True
    save_ckpt_every: int = 50       # Epochs between checkpoints.
    seed: int = 0                   # reference: pretrain.py:61 (torch.manual_seed(0)).
    n_epoch_ssl: int = 30
    ssl_label_size: float = 0.1     # Fraction of labels for fine-tune.
    n_epoch_lin_eval: int = 100
    mine_batch_size: int = 256
    mine_hidden_dim: int = 512
    log_every_fraction: float = 0.25  # print_every = len(loader)/4
    #                                  (reference: utils/model_utils.py:105).


@dataclasses.dataclass(frozen=True)
class Config:
    """Root config: the typed equivalent of reference utils/configs.json."""

    dataset: DatasetConfig = CIFAR10
    augment: AugmentConfig = AugmentConfig()
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    train: TrainConfig = TrainConfig()
    # Host paths (repo-local defaults; reference hardcodes cluster paths at
    # utils/configs.json:31-38).
    data_dir: str = "data"
    out_dir: str = "results"
    ckpt_dir: str = "checkpoints"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_reference_json(path: str) -> "Config":
        """Load a reference-style utils/configs.json (the flat key schema of
        reference utils/configs.json:1-39) into the typed tree — so existing
        reference configs carry over unchanged."""
        with open(path) as f:
            raw = json.load(f)
        aug_raw = raw.get("augmentation_params", {})
        aug = AugmentConfig(
            color_distort_strength=aug_raw.get(
                "color_distort_strength", 0.5),
            color_drop_prob=aug_raw.get("color_drop_prob", 0.2),
        )

        def ds(name_):
            ms = raw.get(f"{name_}_mean_std", {})
            base = dataset_config(name_)
            return dataclasses.replace(
                base,
                img_size=raw.get(f"{name_}_size", base.img_size),
                mean=tuple(ms.get("mean", base.mean)),
                std=tuple(ms.get("std", base.std)),
            )

        model = ModelConfig(
            feature_dim=raw.get("feature_dim", 2048),
            compressed_dim=raw.get("compressed_dim", 128),
            drop_prob=raw.get("drop_prob", 0.3),
        )
        optim = OptimConfig(
            lr=raw.get("lr", 1e-3),
            wt_decay=raw.get("wt_decay", 1e-6),
            lr_ssl=raw.get("lr_ssl", 0.02),
            momentum_ssl=raw.get("momentum_ssl", 0.98),
            mine_lr=raw.get("mine_lr", 5e-4),
            reg_wt_lin_eval=raw.get("reg_wt_lin_eval", 1e-3),
            lbfgs_max_iter=raw.get("lbfgs_max_iter", 20),
        )
        train = TrainConfig(
            n_epoch=raw.get("n_epoch", 100),
            batch_size=raw.get("default_batch_size", 512),
            micro_batch_size=raw.get("batch_size_small", 64),
            accum_steps=raw.get("accum_steps", 1),
            temperature=raw.get("temp", 0.5),
            save_ckpt_every=raw.get("save_ckpt_every", 50),
            ssl_label_size=raw.get("ssl_label_size", 0.1),
            n_epoch_ssl=raw.get("n_epoch_ssl", 30),
            n_epoch_lin_eval=raw.get("n_epoch_lin_eval", 100),
            mine_batch_size=raw.get("mine_batch_size", 256),
            mine_hidden_dim=raw.get("mine_hidden_dim", 512),
        )
        return Config(
            dataset=ds("cifar10"), augment=aug, model=model,
            optim=optim, train=train,
            data_dir=raw.get("data_dir", "data"),
            out_dir=raw.get("doc_path", "results"),
            ckpt_dir=raw.get("doc_ckpt_path", "checkpoints"),
        )

    @staticmethod
    def for_dataset(name: str, **train_overrides) -> "Config":
        ds = dataset_config(name)
        cfg = Config(dataset=ds)
        # STL-10 uses the standard 7x7/stride-2 stem (96x96 inputs):
        # reference pretrain.py:77 passes low_quality_img=(dataset=='cifar10').
        if name == "stl10":
            cfg = cfg.replace(
                model=dataclasses.replace(cfg.model, low_quality_img=False)
            )
        if train_overrides:
            cfg = cfg.replace(
                train=dataclasses.replace(cfg.train, **train_overrides)
            )
        return cfg
