"""SimCLR pretraining CLI.

Counterpart of ``scripts/pretrain.py``, with the same flags and defaults
and ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). Run from the repository root:

    python -m simclr_tpu_torch.scripts.pretrain --dataset cifar10

``--accum_steps`` above 1 accumulates the gradients of that many
micro-steps before each Adam step. Data parallelism (``--n_devices``
above 1, ``--engine explicit``) is not ported yet and raises
NotImplementedError naming its ROADMAP item.
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
    p.add_argument("--n_epoch", type=int, default=None,
                   help="number of epochs to train")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation steps (reference parity "
                        "mode; default 1 = true large batch)")
    p.add_argument("--save_every", type=int, default=None,
                   help="epochs between checkpoints")
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch size (the reference's 64*accum)")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--path_for_saving", default="results",
                   help="output dir for exported models")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--resume_training_path", default=None,
                   help="checkpoint path to resume from ('auto': the "
                        "newest in --ckpt_dir)")
    p.add_argument("--encoder_model", default="no_dropout",
                   choices=["no_dropout", "dropout"])
    p.add_argument("--temp", type=float, default=None,
                   help="NT-Xent temperature")
    p.add_argument("--modified_loss", action="store_true",
                   help="use the probabilistic contrastive loss")
    p.add_argument("--no_save_ckpt", action="store_true")
    p.add_argument("--two_pass_views", action="store_true",
                   help="reference-parity sequential per-view forwards")
    p.add_argument("--n_devices", type=int, default=None,
                   help="devices in the data mesh (only 1 is ported)")
    p.add_argument("--engine", default="pjit",
                   choices=["pjit", "explicit"],
                   help="collective strategy (only the single-device "
                        "'pjit' engine is ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics_path", default=None,
                   help="append-only JSONL metrics log")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of epoch 2 here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError for a flag whose path is not ported."""
    if args.n_devices is not None and args.n_devices > 1:
        raise NotImplementedError(
            "--n_devices > 1: data parallelism is ROADMAP Queue A item 11")
    if args.engine == "explicit":
        raise NotImplementedError(
            "--engine explicit: the shard_map engine is ROADMAP Queue A "
            "item 11")


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config.for_dataset(args.dataset)
    train_kw = dict(
        accum_steps=args.accum_steps,
        modified_loss=args.modified_loss,
        save_ckpt=not args.no_save_ckpt,
        seed=args.seed,
    )
    for field, value in [
        ("n_epoch", args.n_epoch), ("batch_size", args.batch_size),
        ("temperature", args.temp), ("save_ckpt_every", args.save_every),
    ]:
        if value is not None:
            train_kw[field] = value
    return cfg.replace(
        train=dataclasses.replace(cfg.train, **train_kw),
        model=dataclasses.replace(cfg.model, encoder=args.encoder_model),
        data_dir=args.data_dir,
        out_dir=args.path_for_saving,
        ckpt_dir=args.ckpt_dir,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    cfg = config_from_args(args)

    import torch  # deferred so --help is fast

    from simclr_tpu_torch.train.pretrain import pretrain
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name} | mesh: single-device | engine: {args.engine}")
    result = pretrain(
        cfg, resume_from=args.resume_training_path,
        two_pass_views=args.two_pass_views,
        metrics_path=args.metrics_path,
        profile_dir=args.profile_dir,
        engine=args.engine,
        device=dev,
    )
    print(f"done: {result.steps_per_sec:.2f} steps/sec | "
          f"export: {result.export_path}")


if __name__ == "__main__":
    main()
