"""Accuracy-parity experiment: whether the throughput tricks move
linear-evaluation accuracy.

Counterpart of ``scripts/parity_run.py``, with the same flags, the same
``VARIANTS`` table and ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). Each variant pretrains on the same split with
its ``ModelConfig`` overrides and ``pretrain`` keywords, then runs linear
evaluation; the rows go to ``parity.json`` and ``parity.md`` under
``--out`` (by default the port's own ``results/parity_torch``), with
each variant's export ``model_<name>.pt``. The deviations from strict
torch semantics it quantifies:

  * ``SubsetBatchNorm`` statistics from the leading rows of the batch
    (``models/norm.py``) against exact full-batch statistics;
  * bfloat16-applied BN (float32 statistics) against float32;
  * one fused 2N forward for both views against the reference's two
    per-view forwards (model_utils.py:113-114);
  * the straight-through BN backward, the shadow bn3 statistics, exact
    head BNs and subset weight gradients.

Real CIFAR-10 is used where its binaries are on disk; otherwise the
synthetic stand-in, and the comparison is an A/B of the variants. Run
from the repository root:

    python -m simclr_tpu_torch.scripts.parity_run --variants default \
        exact_bn_stats --n_epoch 20
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from simclr_tpu_torch.config import Config

VARIANTS = {
    # name -> (model-config overrides, pretrain kwargs); the JAX
    # script's table (scripts/parity_run.py:36-80), whose comments say why
    # each variant exists.
    "default": ({}, {}),
    "exact_bn_stats": ({"bn_stats_fraction": 1.0}, {}),
    "f32_bn_apply": ({"bn_dtype": "float32"}, {}),
    "two_pass_views": ({}, {"two_pass_views": True}),
    # The reference's 64-sample statistics (model_utils.py:109-114).
    "stats64": ({"bn_stats_fraction": 0.0625}, {}),
    "stats25": ({"bn_stats_fraction": 0.25}, {}),
    # Straight-through subset BN backward (models/norm.py grad_mode).
    "stgrad": ({"bn_grad_mode": "subset_st"}, {}),
    # The shipped default's deviations one at a time.
    "exact_grad": ({"bn_grad_mode": "exact",
                    "bn3_shadow_stats": False}, {}),
    "stgrad_only": ({"bn_grad_mode": "subset_st",
                     "bn3_shadow_stats": False}, {}),
    "shadow_only": ({"bn_grad_mode": "exact",
                     "bn3_shadow_stats": True}, {}),
    # The default except the projection head's BNs, with exact gradients.
    "head_exact": ({"head_bn_grad_mode": "exact"}, {}),
    # Subset weight gradients (ops/subset_wgrad.py).
    "swgrad50": ({"conv_wgrad_fraction": 0.5}, {}),
    "swgrad25": ({"conv_wgrad_fraction": 0.25}, {}),
}

_HEADER = ("| variant | seed | lin-eval top-1 | Δ vs default "
           "| aux val acc | steps/sec |")
_AGG_HEADER = ("| variant | seeds | mean lin-eval top-1 | spread "
               "| mean aux val acc | spread |")
_RULE = "|---|---|---|---|---|---|"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--n_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out", default="results/parity_torch")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def run_rows(rows: List[dict]) -> List[str]:
    """The per-run table: each row's top-1 against the first 'default'
    row (or the first row)."""
    ref = next((r for r in rows if r["variant"] == "default"), rows[0])
    lines = [_HEADER, _RULE]
    for r in rows:
        delta = r["lin_eval_top1"] - ref["lin_eval_top1"]
        va = (f"{r['final_val_acc']:.2f}%"
              if r["final_val_acc"] is not None else "-")
        lines.append(
            f"| {r['variant']} | {r['seed']} | {r['lin_eval_top1']:.2f}% "
            f"| {delta:+.2f}% | {va} | {r['steps_per_sec']} |")
    return lines


def seed_rows(rows: List[dict]) -> List[str]:
    """The seed-aggregated table: mean and half-range per variant."""
    import numpy as np

    lines = [_AGG_HEADER, _RULE]
    for n in dict.fromkeys(r["variant"] for r in rows):
        rs = [r for r in rows if r["variant"] == n]
        t1 = np.array([r["lin_eval_top1"] for r in rs])
        va = np.array([r["final_val_acc"] for r in rs
                       if r["final_val_acc"] is not None])
        lines.append(
            f"| {n} | {len(rs)} | {t1.mean():.2f}% "
            f"| ±{(t1.max() - t1.min()) / 2:.2f} "
            f"| {va.mean():.2f}% | ±{(va.max() - va.min()) / 2:.2f} |"
            if va.size else
            f"| {n} | {len(rs)} | {t1.mean():.2f}% "
            f"| ±{(t1.max() - t1.min()) / 2:.2f} | - | - |")
    return lines


def variant_config(base: Config, name: str, n_epoch: int, batch_size: int,
                   seed: int) -> Config:
    model_over, _ = VARIANTS[name]
    return base.replace(
        model=dataclasses.replace(base.model, **model_over),
        train=dataclasses.replace(
            base.train, n_epoch=n_epoch, batch_size=batch_size,
            save_ckpt=False, seed=seed))


def run(args: argparse.Namespace, base: Config,
        splits: Callable[[str], object], device, real: bool,
        log=print) -> List[dict]:
    """Every (seed, variant) pretrain and linear evaluation; ``splits``
    maps a mode ('pretrain', 'lin_eval', 'test') to its ``Split``."""
    from simclr_tpu_torch.train.lin_eval import linear_evaluation
    from simclr_tpu_torch.train.pretrain import pretrain

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    split = splits("pretrain")
    le_split = splits("lin_eval")
    test_split = splits("test")
    rows = []
    # Seed-outer, so an interrupted run still leaves a complete variant
    # matrix for the seeds that finished.
    for seed in args.seeds:
        for name in args.variants:
            cfg = variant_config(base, name, args.n_epoch, args.batch_size,
                                 seed)
            log(f"=== variant {name} (seed {seed}) ===")
            res = pretrain(cfg, split=split, save_checkpoints=False,
                           save_plots=False, log=log, device=device,
                           export_path=str(out / f"model_{name}.pt"),
                           **VARIANTS[name][1])
            loss, acc = linear_evaluation(res.state.model, le_split.train,
                                          test_split.train, cfg, log=log)
            rows.append({
                "variant": name, "seed": seed,
                "lin_eval_top1": acc, "lin_eval_loss": loss,
                "final_val_acc": res.history.accuracy["valid"][-1]
                if res.history.accuracy["valid"] else None,
                "steps_per_sec": round(res.steps_per_sec, 3),
                "real_data": real,
            })
            log(f"{name}[{seed}]: top1={acc:.2f}% loss={loss:.4f} "
                f"({res.steps_per_sec:.2f} steps/s)")
            # Incremental write: a killed run keeps its finished rows.
            (out / "parity.json").write_text(json.dumps(rows, indent=2))

    lines = [
        "# Accuracy-parity results",
        "",
        f"Data: {'real ' + args.dataset if real else 'synthetic stand-in'}"
        f" | epochs {args.n_epoch} | batch {args.batch_size}",
        "",
    ] + run_rows(rows)
    names = list(dict.fromkeys(r["variant"] for r in rows))
    if any(len([r for r in rows if r["variant"] == n]) > 1 for n in names):
        lines += [""] + seed_rows(rows)
    (out / "parity.md").write_text("\n".join(lines) + "\n")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    from simclr_tpu_torch.data.datasets import is_real_data
    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    base = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir,
                                                    out_dir=args.out)
    real = is_real_data(args.dataset, args.data_dir)
    print(f"data: {'REAL ' + args.dataset if real else 'synthetic stand-in'}")
    run(args, base, lambda mode: make_split(base, mode, dev), dev, real)
    print(f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
