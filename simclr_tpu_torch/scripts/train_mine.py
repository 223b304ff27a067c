"""MINE mutual-information estimator CLI.

Counterpart of ``scripts/train_mine.py`` (reference
training_others/train_mine.py:10-77), with the same arguments and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions): train MINE over a frozen pretrained SimCLR export (the port's
``.pt`` or the JAX package's ``.msgpack``) and report the final MI lower
bound. Run from the repository root:

    python -m simclr_tpu_torch.scripts.train_mine <export>.pt --n_iter 200
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from simclr_tpu_torch.config import Config


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("simclr_model_path",
                   help="pretrained SimCLR export (.pt or JAX .msgpack)")
    p.add_argument("--mine_bs", type=int, default=None)
    p.add_argument("--mine_lr", type=float, default=None)
    p.add_argument("--mine_hidden_dim", type=int, default=None)
    p.add_argument("--n_iter", type=int, default=5000)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--use_final_feat", action="store_true",
                   help="use z (projection output) instead of h")
    p.add_argument("--mi_with_orig", action="store_true",
                   help="estimate I(x; z) instead of I(z1; z2)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.train.mine import train_mine_from_export
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    split = make_split(cfg, "lin_eval", dev)
    result = train_mine_from_export(
        cfg, split.train, args.simclr_model_path,
        n_iter=args.n_iter,
        batch_size=args.mine_bs,
        hidden_size=args.mine_hidden_dim,
        lr=args.mine_lr,
        mi_between_repr=not args.mi_with_orig,
        use_hidden_feat=not args.use_final_feat,
        device=dev,
    )
    print(f"final MI lower bound: {result.final_mi:.4f}")


if __name__ == "__main__":
    main()
