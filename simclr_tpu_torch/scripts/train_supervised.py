"""Supervised ResNet-50 baseline CLI.

Counterpart of ``scripts/train_supervised.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): train a ResNet-50 classifier from scratch on the supervised
view, then report the best validation and the test accuracy. Run from
the repository root:

    python -m simclr_tpu_torch.scripts.train_supervised --n_epoch 1

``--export_path`` writes the trained model as the port's ``.pt`` export
(its ``state_dict``, with the config JSON beside it).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from simclr_tpu_torch.config import Config


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--n_epoch", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--export_path", default=None,
                   help="save the trained model as a .pt export")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir)
    if args.batch_size is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, micro_batch_size=args.batch_size))
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.train.supervised import train_supervised
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    split = make_split(cfg, "supervised_bm", dev)
    test = make_split(cfg, "test", dev)
    result = train_supervised(cfg, split.train, val_ds=split.val,
                              test_ds=test.train, n_epochs=args.n_epoch)
    print(f"best val acc: {result.best_acc:.2f}% | "
          f"test acc: {result.test_acc:.2f}%")
    if args.export_path:
        from simclr_tpu_torch.utils.checkpoint import export_model

        export_model(args.export_path, result.state.model, cfg.to_json())
        print(f"exported model: {args.export_path}")


if __name__ == "__main__":
    main()
