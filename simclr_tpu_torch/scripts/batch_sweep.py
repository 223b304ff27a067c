"""Batch-size-sweep experiment: the reference's flagship result.

Counterpart of ``scripts/batch_sweep.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): examples/varying_batch_size.png (reference README.md:19,
top-1 ~87-89% roughly flat over batch 32 -> 1024). Pretrain at each
effective batch size, then report the auxiliary-task validation metrics
and, with ``--lin_eval``, linear-evaluation top-1 and loss. Two
large-batch mechanisms:

  * ``global``: one 2N x 2N NT-Xent over the whole batch a step;
  * ``accum``: the reference's gradient accumulation
    (utils/model_utils.py:116-123): micro-batches of
    ``--micro_batch_size`` and an Adam step every batch / micro
    micro-steps (``TrainConfig.accum_steps``,
    ``train/common.py:GradAccumulation``), each micro-batch seeing only
    its own negatives.

Writes ``histories.json`` and each run's ``model_<mode>_bs<B>.pt`` under
``--out`` (by default the port's own ``results/batch_sweep_torch``), and
with matplotlib ``varying_batch_size.png``. Run from the repository root:

    python -m simclr_tpu_torch.scripts.batch_sweep --batch_sizes 256 512
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from simclr_tpu_torch.config import Config, TrainConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_sizes", type=int, nargs="+",
                   default=[32, 64, 128, 256, 512, 1024])
    p.add_argument("--modes", nargs="+", default=["global", "accum"],
                   choices=["global", "accum"])
    p.add_argument("--n_epoch", type=int, default=20)
    p.add_argument("--micro_batch_size", type=int, default=64)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out", default="results/batch_sweep_torch")
    p.add_argument("--lin_eval", action="store_true",
                   help="run L-BFGS linear evaluation after each pretrain "
                        "(the reference plot's top-1 metric)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def sweep_train(train: TrainConfig, batch: int, mode: str, n_epoch: int,
                micro: int) -> TrainConfig:
    """The run's training settings: 'global' steps on the whole batch;
    'accum' on micro-batches, ``max(batch // micro, 1)`` to an Adam step
    (``scripts/batch_sweep.py:40-48``)."""
    if mode == "accum":
        return dataclasses.replace(
            train, batch_size=micro, accum_steps=max(batch // micro, 1),
            n_epoch=n_epoch, save_ckpt=False)
    return dataclasses.replace(train, batch_size=batch, accum_steps=1,
                               n_epoch=n_epoch, save_ckpt=False)


def run_one(base: Config, split, batch: int, mode: str, n_epoch: int,
            micro: int, out: Path, splits: Optional[Callable] = None,
            device="cuda", log=print) -> dict:
    """One pretrain (and, where ``splits`` is given, linear evaluation
    on its 'lin_eval' and 'test' splits)."""
    from simclr_tpu_torch.train.lin_eval import linear_evaluation
    from simclr_tpu_torch.train.pretrain import pretrain

    cfg = base.replace(train=sweep_train(base.train, batch, mode, n_epoch,
                                         micro))
    # save_plots=False: the run's plot name ignores the mode, so the modes
    # would overwrite each other's figures; histories.json keeps the
    # curves.
    res = pretrain(cfg, split=split, save_checkpoints=False,
                   save_plots=False, log=log, device=device,
                   export_path=str(out / f"model_{mode}_bs{batch}.pt"))
    record = {
        "batch": batch,
        "mode": mode,
        "history": res.history.to_dict(),
        "steps_per_sec": res.steps_per_sec,
        "val_acc": res.history.accuracy["valid"][-1]
        if res.history.accuracy["valid"] else None,
        "val_loss": res.history.loss["valid"][-1]
        if res.history.loss["valid"] else None,
    }
    if splits is not None:
        # Batch-independent evaluation settings: the base config's.
        loss, acc = linear_evaluation(
            res.state.model, splits("lin_eval").train,
            splits("test").train, base, log=log)
        record["lin_eval_top1"] = acc
        record["lin_eval_loss"] = loss
    return record


def run(args: argparse.Namespace, base: Config,
        splits: Callable[[str], object], device, log=print) -> List[dict]:
    from simclr_tpu_torch.utils.visualizations import plotting_available

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    split = splits("pretrain")  # shared across runs
    records = []
    for mode in args.modes:
        for batch in args.batch_sizes:
            log(f"=== mode={mode} effective batch={batch} ===")
            rec = run_one(base, split, batch, mode, args.n_epoch,
                          args.micro_batch_size, out,
                          splits if args.lin_eval else None, device, log)
            records.append(rec)
            log(f"mode={mode} bs={batch}: val acc {rec['val_acc']} "
                f"({rec['steps_per_sec']:.2f} steps/s)")
    (out / "histories.json").write_text(json.dumps(records, indent=2))
    if plotting_available():
        draw(records, args.modes, args.lin_eval, out)
    else:
        log("matplotlib is not installed: histories.json only, no figure")
    return records


def draw(records: List[dict], modes: Sequence[str], lin_eval: bool,
         out: Path) -> None:
    from simclr_tpu_torch.utils.visualizations import _plt

    plt = _plt()
    fig, (ax_a, ax_l) = plt.subplots(1, 2, figsize=(12, 4))
    key_a = "lin_eval_top1" if lin_eval else "val_acc"
    key_l = "lin_eval_loss" if lin_eval else "val_loss"
    for mode in modes:
        recs = sorted((r for r in records if r["mode"] == mode),
                      key=lambda r: r["batch"])
        xs = [r["batch"] for r in recs]
        ax_a.plot(xs, [r[key_a] for r in recs], marker="o", label=mode)
        ax_l.plot(xs, [r[key_l] for r in recs], marker="o", label=mode)
    for ax, ylab in ((ax_a, "top-1 accuracy (%)"), (ax_l, "loss")):
        ax.set_xscale("log", base=2)
        ax.set_xlabel("effective batch size")
        ax.set_ylabel(ylab)
        ax.legend()
    fig.suptitle(
        f"{'Linear-eval' if lin_eval else 'Aux-task validation'} "
        "metrics vs batch size (global negatives vs grad accumulation)")
    fig.savefig(out / "varying_batch_size.png", bbox_inches="tight",
                dpi=150)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    base = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir,
                                                    out_dir=args.out)
    # Each run's linear evaluation reads the same splits: load them once.
    run(args, base, functools.cache(lambda mode: make_split(base, mode,
                                                            dev)), dev)
    print(f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
