"""Temperature-sweep experiment.

Counterpart of ``scripts/temp_sweep.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): the reference's headline experiment family
(examples/loss_acc_by_temp_{train,val}.png, tau in {0.1, 0.5, 1.0,
2.0}). Pretrain at each temperature on one shared split and write
``histories.json`` under ``--out`` (by default the port's own
``results/temp_sweep_torch``), with each run's export
``model_temp<T>.pt``; with matplotlib installed, also each run's
loss/accuracy curves and ``loss_acc_by_temp_{train,valid}.png``. Run from
the repository root:

    python -m simclr_tpu_torch.scripts.temp_sweep --temps 0.1 0.5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

from simclr_tpu_torch.config import Config


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--temps", type=float, nargs="+",
                   default=[0.1, 0.5, 1.0, 2.0])
    p.add_argument("--n_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out", default="results/temp_sweep_torch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def run(args: argparse.Namespace, base: Config,
        splits: Callable[[str], object], device,
        log=print) -> Dict[float, dict]:
    """One pretrain per temperature; returns {temperature: history}."""
    from simclr_tpu_torch.train.pretrain import pretrain
    from simclr_tpu_torch.utils.visualizations import plotting_available

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    split = splits("pretrain")  # shared across temperatures
    plots = plotting_available()
    histories = {}
    for temp in args.temps:
        cfg = base.replace(train=dataclasses.replace(
            base.train, temperature=temp, n_epoch=args.n_epoch,
            batch_size=args.batch_size, save_ckpt=False))
        log(f"=== temperature {temp} ===")
        res = pretrain(cfg, split=split, save_checkpoints=False,
                       save_plots=plots, log=log, device=device,
                       export_path=str(out / f"model_temp{temp}.pt"))
        histories[temp] = res.history.to_dict()
        log(f"temp {temp}: final val acc "
            f"{res.history.accuracy['valid'][-1]:.2f}% "
            f"({res.steps_per_sec:.2f} steps/s)")
    (out / "histories.json").write_text(json.dumps(histories, indent=2))
    if plots:
        draw(histories, out)
    else:
        log("matplotlib is not installed: histories.json only, no figures")
    return histories


def draw(histories: Dict[float, dict], out: Path) -> None:
    from simclr_tpu_torch.utils.visualizations import _plt

    plt = _plt()
    for split_name in ("train", "valid"):
        fig, (ax_l, ax_a) = plt.subplots(1, 2, figsize=(12, 4))
        for temp, h in histories.items():
            ax_l.plot(h["loss"][split_name], label=f"tau={temp}")
            ax_a.plot(h["accuracy"][split_name], label=f"tau={temp}")
        ax_l.set_xlabel("epoch")
        ax_l.set_ylabel(f"{split_name} loss")
        ax_a.set_xlabel("epoch")
        ax_a.set_ylabel(f"{split_name} aux top-1 (%)")
        ax_l.legend()
        ax_a.legend()
        fig.suptitle(f"NT-Xent by temperature ({split_name})")
        fig.savefig(out / f"loss_acc_by_temp_{split_name}.png",
                    bbox_inches="tight", dpi=150)
        plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    base = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir,
                                                    out_dir=args.out)
    run(args, base, lambda mode: make_split(base, mode, dev), dev)
    print(f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
