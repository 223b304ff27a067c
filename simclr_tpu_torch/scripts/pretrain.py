"""SimCLR pretraining CLI.

Counterpart of ``scripts/pretrain.py``, with the same flags and defaults
and ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). Run from the repository root:

    python -m simclr_tpu_torch.scripts.pretrain --dataset cifar10

``--accum_steps`` above 1 accumulates the gradients of that many
micro-steps before each Adam step. Data parallelism runs one process per
device, started by torchrun, which sets the rank and the group's address:

    torchrun --nproc_per_node 4 -m simclr_tpu_torch.scripts.pretrain \
        --n_devices 4

Under a group of more than one rank, or with ``--engine explicit`` (a
one-rank group where ``--n_devices`` is 1, as JAX builds a one-device
mesh for it), each rank runs the explicit data-parallel step
(``parallel/explicit.py``) on its slice of the global batch; both engine
names run that step. NCCL on CUDA, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
                   help="devices in the data mesh: the ranks torchrun "
                        "starts (default: its WORLD_SIZE)")
    p.add_argument("--engine", default="pjit",
                   choices=["pjit", "explicit"],
                   help="collective strategy; under a group both run the "
                        "explicit step (hand-placed all-gather, BN "
                        "statistics and gradient all-reduces)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics_path", default=None,
                   help="append-only JSONL metrics log")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of epoch 2 here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


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


def n_devices(args: argparse.Namespace) -> int:
    """The mesh's size: ``--n_devices``, else the world torchrun set."""
    return args.n_devices or int(os.environ.get("WORLD_SIZE", 1))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    import torch  # deferred so --help is fast

    from simclr_tpu_torch.train.pretrain import pretrain
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    n_dev = n_devices(args)
    mesh = None
    if n_dev > 1 or args.engine == "explicit":
        from simclr_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_dev, device=dev)
        dev = mesh.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if mesh is None or mesh.is_main:
        print(f"device: {name} | mesh: "
              f"{'single-device' if mesh is None else f'{mesh.size} ranks'}"
              f" | engine: {args.engine}")
    result = pretrain(
        cfg, mesh=mesh, resume_from=args.resume_training_path,
        two_pass_views=args.two_pass_views,
        metrics_path=args.metrics_path,
        profile_dir=args.profile_dir,
        engine=args.engine,
        device=dev,
    )
    if mesh is None or mesh.is_main:
        print(f"done: {result.steps_per_sec:.2f} steps/sec | "
              f"export: {result.export_path}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
