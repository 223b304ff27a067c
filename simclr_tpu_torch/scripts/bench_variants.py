"""A/B-bench pretrain-step variants (fused stages, BN options) on the card.

Counterpart of ``scripts/bench_variants.py``, with its ``VARIANTS`` table,
its flags and ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions). Each variant builds ``Config(model=ModelConfig(**over))``
through ``init_simclr`` and ``build_engine`` and is timed by
``timed_epochs``: one untimed epoch (the eager warm-up steps and the CUDA
graph's capture), one warm epoch, then ``--reps`` timed epochs of
``--steps`` graph replays, each timed by the host clock up to one fetch of
its last loss. It prints one line a variant: the median steps/s, ms/step,
each rep's steps/s, the last loss, and the peak device memory allocated
and reserved (the captured graph's private pool counts in the second).
Each engine, with its graph, model and optimizer, is freed before the
next variant is built. This is the measurement behind the defaults of the
pretrain step (``train/pretrain.py:init_simclr``).

Run from the repository root:

    python -m simclr_tpu_torch.scripts.bench_variants unfused fuse128 \\
        fuse256
    python -m simclr_tpu_torch.scripts.bench_variants all --json out.json

``--stage_sizes`` and ``--width`` cut the ResNet-50 for a quick check,
``--n_images`` the dataset (CIFAR-10's training set, or its synthetic
stand-in where the binaries are absent).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import time
from typing import List, Optional, Sequence

import torch

from simclr_tpu_torch.config import Config, ModelConfig, TrainConfig
from simclr_tpu_torch.data.pipeline import epoch_permutation

VARIANTS = {
    "unfused": {},
    "fuse64": {"fuse_identity_blocks": True, "fuse_min_width": 64},
    "fuse128": {"fuse_identity_blocks": True, "fuse_min_width": 128},
    "fuse256": {"fuse_identity_blocks": True, "fuse_min_width": 256},
    "fuse512": {"fuse_identity_blocks": True, "fuse_min_width": 512},
    "exact_bn": {"bn_stats_fraction": 1.0},
    "folded": {"fold_bn_scales": True},
    # Reference-parity statistics size: the torch reference estimates BN
    # stats from 64-sample micro-batches (utils/model_utils.py:109-114).
    "stats64": {"bn_stats_fraction": 0.0625},
    # The round-1/2 default subset fraction (superseded by stats64).
    "stats25": {"bn_stats_fraction": 0.25},
    # Bandwidth-shaped BN backward (ops/subset_bn.py custom VJP). On the
    # TPU its concatenate-based dx broke XLA's fusion; superseded by the
    # bn_relu kernel below.
    "bnvjp": {"bn_fused_vjp": True},
    "bnvjp_stats64": {"bn_fused_vjp": True, "bn_stats_fraction": 0.0625},
    # Single-pass fused BN(+add)+ReLU backward (kernel B3,
    # ops/kernels/bn_relu.py). 'pallas' = the kernel; 'xla' = the same
    # restructure as plain ops.
    "bnrelu": {"bn_relu_fused": True, "bn_relu_impl": "pallas"},
    "bnrelu_xla": {"bn_relu_fused": True, "bn_relu_impl": "xla"},
    # Patch-free dx: the k-sample correction rides the full-row
    # elementwise pass behind an iota mask (no patch pass).
    "bnrelu_mask": {"bn_relu_fused": True, "bn_relu_impl": "xla_mask"},
    "bnrelu_off": {"bn_relu_fused": False},
    # Straight-through subset BN backward (models/norm.py grad_mode):
    # stats stop-gradiented, dscale/dbias from the k-sample estimator —
    # pure autodiff, reductions shrink to k-row slices.
    "stgrad": {"bn_grad_mode": "subset_st"},
    # PERF PROBE ONLY (collapses training): mean stop-gradiented too, to
    # measure the marginal cost of the per-BN full-tensor sum(gy) reduce.
    "stgrad_nomean": {"bn_grad_mode": "subset_st_nomean"},
    # subset_st with the surrogate as a full-row iota mask instead of a
    # k-row slice (tile-contiguous streams on batch-minor layouts; 16x the
    # surrogate's traffic).
    "stgrad_w": {"bn_grad_mode": "subset_st_w"},
    # The round-3 subset_st surrogate form: the k-row tensor padded to the
    # full batch and added (models/norm.py st_surrogate). The default is
    # 'affine' (the surrogate folded into [n,1,1,C] affine coefficients —
    # no pad, same value and VJP).
    "st_pad": {"bn_st_surrogate": "pad"},
    # A scheduling barrier after each ReLU, meant to split the backward
    # dgrad conv out of the recomputed mask/scale elementwise chain
    # (accepted with no effect in eager PyTorch).
    "barrier": {"relu_barrier": True},
    # Shadow bn3/downsample stats (k-row parameter-shared conv recompute)
    # so the block-output BN apply+add+relu does not wait for the raw
    # output's statistics. Exactly equivalent math (models/resnet.py
    # Bottleneck); the DEFAULT, 'noshadow' is the A/B off.
    "shadow": {"bn3_shadow_stats": True},
    "noshadow": {"bn3_shadow_stats": False},
    # Shadow stats on EVERY conv->BN pair (bn1/bn2/stem too). conv1/conv2
    # outputs feed the next conv, whose backward needs the post-ReLU
    # activation anyway, so the raw output is kept there and the three
    # extra k-row shadow convs are pure cost. bn3 is the special case: its
    # pre-BN output has no other consumer.
    "shadow_all": {"bn3_shadow_stats": True, "bn12_shadow_stats": True},
    # ReLU backward mask from the OUTPUT (models/resnet.py
    # relu_from_output): identical math; the backward mask reads the
    # activations instead of keeping the pre-activations.
    "reluout": {"relu_from_output": True},
    "reluout_off": {"relu_from_output": False},
    # Winograd conv2 (kernel B5, ops/kernels/winograd.py): 2.25x fewer
    # multiplies for the stride-1 layer2-4 conv2s.
    "winograd": {"winograd_conv2": True},
    # ... plus shadow bn1/bn2 statistics so the applies around the kernel
    # do not wait for statistics of its output.
    "winograd_sh12": {"winograd_conv2": True, "bn12_shadow_stats": True},
    # Checkpointing over the bandwidth-bound 32x32 layer1 bottlenecks
    # (models/resnet.py remat): relu1/relu2 are not kept, the backward
    # recomputes them from the block input it reads anyway.
    "remat1": {"remat_stages": (0,)},
    "remat12": {"remat_stages": (0, 1)},
    # Kernel B4 for layer1's C=64 conv2s (ops/kernels/conv64.py):
    # merged-tap forward/dgrad and the weight gradient.
    "conv64": {"conv64_pallas": True},
    "conv64_off": {"conv64_pallas": False},
    # Stage-gated shadow bn1/bn2: layer1 only — shadow statistics there
    # make the bn-apply+relu of each layer1 block statistics-independent,
    # at ~6% of layer1 conv1/conv2 flops in k-row recomputes; off by
    # default.
    "shadow12_l1": {"bn12_shadow_stages": (0,)},
    # Subset weight gradients (ops/subset_wgrad.py): dw from a centered
    # row slice scaled N/k, dx exact. Deletes (1 - k/N) of the bytes and
    # flops of every weight-gradient convolution.
    "swgrad50": {"conv_wgrad_fraction": 0.5},
    "swgrad25": {"conv_wgrad_fraction": 0.25},
    "swgrad125": {"conv_wgrad_fraction": 0.125},
}


def variant_config(name: str, batch: int,
                   stage_sizes: Optional[Sequence[int]] = None,
                   width: Optional[int] = None) -> Config:
    """The variant's ``Config``: ``VARIANTS[name]`` over the defaults at
    ``batch``, no checkpoints; ``stage_sizes`` and ``width`` cut the
    ResNet-50 (``feature_dim`` follows the width)."""
    over = dict(VARIANTS[name])
    if stage_sizes is not None:
        over["stage_sizes"] = tuple(stage_sizes)
    if width is not None:
        over.update(width=width, feature_dim=32 * width)
    return Config(train=TrainConfig(batch_size=batch, save_ckpt=False),
                  model=ModelConfig(**over))


def run_epoch(engine, state, images: torch.Tensor, steps: int,
              generator: torch.Generator):
    """One epoch of ``steps`` rows of a fresh permutation through
    ``engine.train_epoch`` (graph replays on a card); returns (state, the
    last loss), read back with one device fetch."""
    batch = engine.cfg.train.batch_size
    idx = epoch_permutation(generator, images.shape[0], batch)[:steps]
    state, (losses, _) = engine.train_epoch(state, images, idx, generator)
    return state, float(losses[-1])


@dataclasses.dataclass
class EpochTimes:
    """What ``timed_epochs`` measured."""

    rates: List[float]   # steps/s of each timed epoch
    loss: float          # the last loss of the last epoch
    first_s: float       # the untimed first epoch (warm-up, capture)
    state: object        # the TrainState after the last epoch

    @property
    def median(self) -> float:
        return statistics.median(self.rates) if self.rates else math.nan


def timed_epochs(engine, state, images: torch.Tensor, steps: int,
                 reps: int, generator: torch.Generator) -> EpochTimes:
    """The timing of the harnesses: one untimed epoch (on a card, the
    eager warm-up steps and the capture of the step), one warm epoch, then
    ``reps`` epochs of ``steps`` rows, each timed by the host clock from
    the epoch's call to one fetch of its last loss (JAX's warmed
    epoch-scan timing, ``scripts/bench_variants.py``). ``images`` is the
    device-resident uint8 NHWC dataset; ``generator`` draws the
    permutations and the augmentations."""
    start = time.perf_counter()
    state, loss = run_epoch(engine, state, images, steps, generator)
    first_s = time.perf_counter() - start
    state, loss = run_epoch(engine, state, images, steps, generator)
    rates = []
    for _ in range(reps):
        start = time.perf_counter()
        state, loss = run_epoch(engine, state, images, steps, generator)
        rates.append(steps / (time.perf_counter() - start))
    return EpochTimes(rates, loss, first_s, state)


def release(device: torch.device) -> None:
    """Return what a freed engine held to the device: its captured
    graphs' private pools, the cuBLAS workspaces of the streams it used
    (each new stream, such as an engine's warm-up stream, gets its own,
    which PyTorch keeps until asked) and the caching allocator's free
    blocks."""
    gc.collect()
    if device.type == "cuda":
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()


def bench_variant(name: str, images: torch.Tensor, batch: int, steps: int,
                  reps: int, seed: int = 0,
                  stage_sizes: Optional[Sequence[int]] = None,
                  width: Optional[int] = None) -> dict:
    """Build the variant on ``images``' device, time it (``timed_epochs``)
    and free it; returns its row."""
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    device = images.device
    cfg = variant_config(name, batch, stage_sizes, width)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    model, state, optimizer = init_simclr(cfg, seed=seed, device=device)
    engine = build_engine(cfg, model, optimizer)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    row = None
    try:
        t = timed_epochs(engine, state, images, steps, reps, generator)
        row = dict(name=name, steps_per_s=t.median,
                   ms_per_step=1e3 / t.median, reps=t.rates, loss=t.loss,
                   first_epoch_s=t.first_s, captures=len(engine.graphs))
        if cuda:
            row.update(
                peak_allocated_gib=torch.cuda.max_memory_allocated(device)
                / 2 ** 30,
                peak_reserved_gib=torch.cuda.max_memory_reserved(device)
                / 2 ** 30)
        return row
    finally:
        # The graph closes over the engine: break that cycle first.
        engine.graphs.clear()
        del engine, model, state, optimizer, generator
        t = None
        release(device)
        if cuda and row is not None:
            # What the freed variant left allocated (0 when all of it
            # went back).
            row["left_mib"] = (torch.cuda.memory_allocated(device)
                               - base) / 2 ** 20


def format_row(row: dict) -> str:
    """JAX's line (name, median steps/s, ms/step, reps, loss) and the
    peak device memory."""
    line = (f"{row['name']:14s} {row['steps_per_s']:8.3f} steps/s "
            f"({row['ms_per_step']:8.2f} ms/step) reps="
            f"{[round(r, 3) for r in row['reps']]} loss={row['loss']:.4f}")
    if "peak_allocated_gib" in row:
        line += (f" peak={row['peak_allocated_gib']:.2f} GiB allocated,"
                 f" {row['peak_reserved_gib']:.2f} GiB reserved")
    if "left_mib" in row:
        line += f", {row['left_mib']:.1f} MiB left allocated when freed"
    return line


def load_images(device: torch.device,
                n_images: Optional[int] = None) -> torch.Tensor:
    """CIFAR-10's training images under ``data/`` (or the synthetic
    stand-in), the first ``n_images`` of them, as a uint8 NHWC tensor on
    ``device``."""
    import warnings

    from simclr_tpu_torch.data.datasets import load_dataset

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the synthetic stand-in's note
        images, _ = load_dataset("cifar10", "train", "data",
                                 synthetic_size=n_images)
    if n_images is not None:
        images = images[:n_images]
    return torch.from_numpy(images).to(device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variants", nargs="+", choices=list(VARIANTS) + ["all"])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--stage_sizes", type=int, nargs="+", default=None,
                   help="blocks a stage (default ResNet-50's 3 4 6 3)")
    p.add_argument("--width", type=int, default=None,
                   help="the stem's width (default 64)")
    p.add_argument("--n_images", type=int, default=None,
                   help="use the first N training images (default all)")
    p.add_argument("--json", default=None,
                   help="also write the rows to this JSON file")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    from simclr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    names = list(VARIANTS) if "all" in args.variants else args.variants
    images = load_images(device, args.n_images)
    rows = []
    for name in names:
        rows.append(bench_variant(name, images, args.batch, args.steps,
                                  args.reps, stage_sizes=args.stage_sizes,
                                  width=args.width))
        print(format_row(rows[-1]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
