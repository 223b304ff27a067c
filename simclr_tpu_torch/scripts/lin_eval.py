"""Linear-evaluation CLI.

Counterpart of ``scripts/lin_eval.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): extract frozen features of a pretrained export (the port's
``.pt`` or the JAX package's ``.msgpack``), fit the L-BFGS linear head and
report test top-1. Run from the repository root:

    python -m simclr_tpu_torch.scripts.lin_eval results/<export>.pt
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
    p.add_argument("model_path",
                   help="pretrained SimCLR export (.pt or JAX .msgpack)")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--n_steps", type=int, default=None,
                   help="outer L-BFGS steps (n_epoch_lin_eval)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir)
    if args.n_steps is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, n_epoch_lin_eval=args.n_steps))
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    import torch  # deferred so --help is fast

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.lin_eval import linear_evaluation
    from simclr_tpu_torch.train.pretrain import resolve_model_config
    from simclr_tpu_torch.utils.checkpoint import load_pretrained
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    sd, _ = load_pretrained(args.model_path)
    model = SimCLR(resolve_model_config(cfg).model)
    model.load_state_dict(sd)
    model = model.to(dev, memory_format=torch.channels_last)
    split = make_split(cfg, "lin_eval", dev)
    test = make_split(cfg, "test", dev)
    _, acc = linear_evaluation(model, split.train, test.train, cfg)
    print(f"test top-1: {acc:.2f}%")


if __name__ == "__main__":
    main()
