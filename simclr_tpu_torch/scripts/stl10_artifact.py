"""STL-10 end-to-end artifact: pretrain at 96x96, measure, lin-eval.

Counterpart of ``scripts/stl10_artifact.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). ``Config.for_dataset("stl10")``: the 7x7 stride-2 stem with a
3x3 max-pool (``low_quality_img=False``), 96x96 views with the 9-tap
blur, batch 256. It runs

  * ``pretrain()`` on the unlabeled split (a synthetic 96x96 stand-in
    where the binaries are absent, as on the JAX side): kernel B1 for the
    loss and B2 twice a step on a CUDA device, each step a graph replay;
  * augmented pairs/s at 96x96: 20 ``augment_train_pair`` calls on one
    batch with one synchronisation, the median of 3 after a warm-up;
  * linear evaluation on the labelled train and test splits,

and writes ``stl10.json`` and ``README.md`` under ``--out``, by default
the port's own ``results/stl10_torch`` (``results/stl10/`` holds the JAX
package's artifact). The export goes there too. Run from the repository
root:

    python -m simclr_tpu_torch.scripts.stl10_artifact --n_epoch 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from simclr_tpu_torch.config import Config


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_unlabeled", type=int, default=20_000,
                   help="pretrain pool size (STL-10 real: 100k)")
    p.add_argument("--n_train", type=int, default=5_000)
    p.add_argument("--n_test", type=int, default=8_000)
    p.add_argument("--n_epoch", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--out", default="results/stl10_torch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace,
                     base: Optional[Config] = None) -> Config:
    """STL-10's config (or ``base``) with the run's epochs and batch, no
    checkpoints, and its outputs under ``--out``."""
    base = base or Config.for_dataset("stl10")
    return base.replace(
        out_dir=args.out,
        train=dataclasses.replace(
            base.train, n_epoch=args.n_epoch, batch_size=args.batch_size,
            save_ckpt=False))


def aug_pairs_per_sec(cfg: Config, batch, iters: int = 20,
                      reps: int = 3) -> float:
    """Augmented pairs/s of ``augment_train_pair`` on one uint8 NHWC
    device batch: ``iters`` calls queued, one synchronisation (a scalar
    read), the median of ``reps`` runs after one warm-up run."""
    import numpy as np
    import torch

    from simclr_tpu_torch.ops.augment import augment_train_pair

    gen = torch.Generator(device=batch.device)

    def run(seed):
        gen.manual_seed(seed)
        acc = torch.zeros((), device=batch.device)
        for _ in range(iters):
            v1, v2 = augment_train_pair(gen, batch, cfg.augment,
                                        cfg.dataset)
            acc = acc + v1.mean() + v2.mean()
        return float(acc)

    with torch.no_grad():
        run(0)
        rates = []
        for rep in range(reps):
            t0 = time.perf_counter()
            run(rep + 1)
            rates.append(iters * batch.shape[0]
                         / (time.perf_counter() - t0))
    return float(np.median(rates))


def run(args: argparse.Namespace, cfg: Config, device,
        log=print) -> Dict[str, Any]:
    """Pretrain, measure and evaluate; write the artifacts; return the
    result dict (``stl10.json``'s keys)."""
    import torch

    from simclr_tpu_torch.data.datasets import load_dataset
    from simclr_tpu_torch.data.pipeline import (
        DeviceDataset, Split, split_indices)
    from simclr_tpu_torch.train.lin_eval import linear_evaluation
    from simclr_tpu_torch.train.pretrain import pretrain

    name = cfg.dataset.name
    unl, unl_y = load_dataset(name, "unlabeled", cfg.data_dir,
                              synthetic_size=args.n_unlabeled)
    tr_x, tr_y = load_dataset(name, "train", cfg.data_dir,
                              synthetic_size=args.n_train)
    te_x, te_y = load_dataset(name, "test", cfg.data_dir,
                              synthetic_size=args.n_test)
    itr, iva = split_indices(unl.shape[0], cfg.train.val_fraction)
    split = Split(DeviceDataset.from_numpy(unl[itr], unl_y[itr], device),
                  DeviceDataset.from_numpy(unl[iva], unl_y[iva], device))

    size = cfg.dataset.img_size
    log(f"pretrain: {len(itr)} unlabeled {size}x{size}, batch "
        f"{args.batch_size}, {args.n_epoch} epochs")
    out = Path(args.out)
    # The export goes to cfg.out_dir (--out), named as pretrain names it.
    res = pretrain(cfg, split=split, save_checkpoints=False,
                   save_plots=False, log=log, device=device)

    aug_pairs = aug_pairs_per_sec(cfg, split.train.images[:args.batch_size])

    le_loss, le_top1 = linear_evaluation(
        res.state.model, DeviceDataset.from_numpy(tr_x, tr_y, device),
        DeviceDataset.from_numpy(te_x, te_y, device), cfg, log=log)

    dev = torch.device(device)
    result = {
        "config": {k: getattr(args, k) for k in
                   ("n_unlabeled", "n_train", "n_test", "n_epoch",
                    "batch_size")},
        "img_size": size,
        "steps_per_sec": round(res.steady_steps_per_sec, 3),
        "steps_per_sec_incl_compile": round(res.steps_per_sec, 3),
        "images_per_sec": round(
            res.steady_steps_per_sec * args.batch_size, 1),
        "aug_pairs_per_sec": round(aug_pairs, 1),
        "train_loss": [round(float(v), 4) for v in
                       res.history.loss["train"]],
        "val_loss": [round(float(v), 4) for v in
                     res.history.loss["valid"]],
        "lin_eval_top1": round(float(le_top1), 2),
        "lin_eval_loss": round(float(le_loss), 4),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    out.mkdir(parents=True, exist_ok=True)
    (out / "stl10.json").write_text(json.dumps(result, indent=2))
    (out / "README.md").write_text(f"""# STL-10 end-to-end artifact (PyTorch port)

`python -m simclr_tpu_torch.scripts.stl10_artifact`: pretrain on the
96x96 unlabeled split ({args.n_unlabeled} synthetic stand-in images; drop
the real `data/stl10_binary/` files in place to use them), standard
7x7/stride-2 stem + max-pool (reference pretrain.py:77
low_quality_img=False), full STL augmentation stack (kernel-9 gaussian
blur, 96x96 interpolation-matrix crops), then linear evaluation on the
labelled train/test splits. Each pretrain step is a CUDA-graph replay on
a card; the first epoch holds the warm-up steps and the capture.

| metric | value |
|---|---|
| pretrain steps/sec, steady state (batch {args.batch_size}, 96x96) | {result["steps_per_sec"]} |
| steps/sec incl. the first epoch (warm-up and capture) | {result["steps_per_sec_incl_compile"]} |
| images/sec | {result["images_per_sec"]} |
| aug-pairs/sec at 96x96 | {result["aug_pairs_per_sec"]} |
| train loss by epoch | {result["train_loss"]} |
| lin-eval top-1 | {result["lin_eval_top1"]}% |
| device | {result["device"]} |

Loss must descend across epochs (checked where there are two or more)
and lin-eval top-1 is a floor on synthetic data, not an accuracy.
""")
    log(json.dumps(result, indent=2))
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    from simclr_tpu_torch.utils.device import resolve_device

    result = run(args, cfg, resolve_device(args.device))
    losses = result["train_loss"]
    if len(losses) > 1:
        assert losses[-1] < losses[0], "pretrain loss did not descend"
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
