"""Semi-supervised fine-tuning CLI.

Counterpart of ``scripts/train_ssl.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): fine-tune a pretrained export (the port's ``.pt`` or the JAX
package's ``.msgpack``) with 10% of the labels (``--ssl_label_size``),
then report the best validation and the test accuracy. Run from the
repository root:

    python -m simclr_tpu_torch.scripts.train_ssl --model_path <export>.pt
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
    p.add_argument("--model_path", required=True,
                   help="pretrained SimCLR export (.pt or JAX .msgpack)")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--n_epoch", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ssl_label_size", type=float, default=None,
                   help="label fraction (1.0 = transfer-learning mode "
                        "with a validation split)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir)
    train_kw = {}
    if args.batch_size is not None:
        train_kw["micro_batch_size"] = args.batch_size
    if args.ssl_label_size is not None:
        train_kw["ssl_label_size"] = args.ssl_label_size
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.train.ssl import train_ssl
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    split = make_split(cfg, "fine_tune", dev)
    test = make_split(cfg, "test", dev)
    result = train_ssl(
        cfg, split.train, val_ds=split.val, test_ds=test.train,
        pretrained_path=args.model_path, n_epochs=args.n_epoch)
    print(f"best val acc: {result.best_acc:.2f}% | "
          f"test acc: {result.test_acc:.2f}%")


if __name__ == "__main__":
    main()
