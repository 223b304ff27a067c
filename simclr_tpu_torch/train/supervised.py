"""Supervised ResNet-50 baseline.

Counterpart of ``simclr_tpu/train/supervised.py`` (reference
training_others/train_supervised.py:8-99): a ``SupervisedResNet`` trained
from scratch with torch-semantics Adam (lr 1e-3, weight decay 1e-6) on the
supervised view (flip, translate, colour jitter through kernel B2,
normalise), per-epoch validation with early stopping (patience 4) that
keeps the best parameters, then the test accuracy.

As in the reference (train_supervised.py:50-62) and the JAX side, each
batch takes two half-steps, each with its own view and its own optimizer
step: the epoch runs over the index matrix with every row repeated twice.
On a CUDA device that is one captured half-step replayed per row
(``train/common.py:graphed_epoch`` through ``SupervisedEngine``), as the
JAX epoch is one ``lax.scan`` over the same half-step body; the per-batch
loss and accuracy are the means of each pair.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Tuple

import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import DeviceDataset, epoch_permutation
from simclr_tpu_torch.models.resnet import SupervisedResNet
from simclr_tpu_torch.models.simclr import dtype_of
from simclr_tpu_torch.train.common import History, TrainState, adam_torch
from simclr_tpu_torch.train.pretrain import epoch_seed
from simclr_tpu_torch.train.ssl import SupervisedEngine, evaluate_classifier
from simclr_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SupervisedResult:
    state: TrainState
    history: History
    best_acc: float
    test_acc: Optional[float] = None
    # Wall seconds of each epoch's train_epoch and its host fetch (the
    # first carries the warm-up half-steps and the capture on a CUDA
    # device).
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)


def init_supervised(cfg: Config, seed: int = 0,
                    device: "str | torch.device" = "cuda"
                    ) -> Tuple[SupervisedResNet, TrainState,
                               torch.optim.Optimizer]:
    """Build the classifier from ``seed`` (on the CPU, so the weights do
    not depend on the device), move it to ``device`` in channels_last and
    wrap it with Adam (capturable on a CUDA device). Only these fields of
    ``cfg.model`` reach it, as on the JAX side (supervised.py:57-64):
    ``low_quality_img``, ``stage_sizes``, ``width``, ``compute_dtype``,
    ``bn_dtype`` and ``bn_stats_fraction``."""
    dev = resolve_device(device)
    m = cfg.model
    model = SupervisedResNet(
        num_classes=cfg.dataset.num_classes,
        low_quality_img=m.low_quality_img, stage_sizes=m.stage_sizes,
        width=m.width, dtype=dtype_of(m.compute_dtype),
        bn_dtype=dtype_of(m.bn_dtype),
        bn_stats_fraction=m.bn_stats_fraction,
        generator=torch.Generator().manual_seed(seed),
    ).to(dev, memory_format=torch.channels_last)
    optimizer = adam_torch(model.parameters(), cfg.optim.lr,
                           cfg.optim.wt_decay,
                           capturable=dev.type == "cuda")
    return model, TrainState(model, optimizer), optimizer


def train_supervised(
    cfg: Config,
    train_ds: DeviceDataset,
    val_ds: Optional[DeviceDataset] = None,
    test_ds: Optional[DeviceDataset] = None,
    n_epochs: Optional[int] = None,
    patience: int = 4,
    log: Callable[[str], None] = print,
) -> SupervisedResult:
    """The supervised baseline on the datasets' device, at
    ``micro_batch_size`` images a half-step: each epoch a permutation
    (remainder dropped) drawn from ``epoch_seed(seed, epoch)``, two
    half-steps a batch, then the validation accuracy (``eval_batch`` of
    the test view). The parameters of the best validation accuracy are
    restored at the end, in place, and the running statistics stay the
    last epoch's, as on the JAX side (supervised.py:137, 145-147);
    ``patience`` epochs without a better one stop the run. Then the test
    accuracy, if ``test_ds`` is given."""
    tcfg = cfg.train
    n_epochs = n_epochs or tcfg.n_epoch
    batch = tcfg.micro_batch_size
    dev = train_ds.images.device
    model, state, optimizer = init_supervised(cfg, tcfg.seed, dev)
    engine = SupervisedEngine(model, optimizer, cfg, augment="supervised")
    gen = torch.Generator(device=dev)
    eval_batch = functools.partial(engine.eval_batch, generator=gen)

    history = History()
    epoch_seconds: List[float] = []
    best_acc, best_params, patience_counter = 0.0, None, 0
    for epoch in range(n_epochs):
        t0 = time.perf_counter()
        gen.manual_seed(epoch_seed(tcfg.seed, epoch))
        idx_mat = epoch_permutation(gen, train_ds.n, batch)
        # Two views of each batch, each its own optimizer step.
        idx2 = idx_mat.repeat_interleave(2, dim=0)
        state, (losses, accs) = engine.train_epoch(
            state, train_ds.images, train_ds.labels, idx2, gen)
        losses = losses.reshape(-1, 2).mean(1).cpu().numpy()
        accs = accs.reshape(-1, 2).mean(1).cpu().numpy()
        epoch_seconds.append(time.perf_counter() - t0)
        history.append("train", losses.mean(), accs.mean())
        log(f"epoch {epoch + 1}: | Train Loss: {losses[-1]:.3f} | "
            f"Train Top 1 Accuracy: {accs[-1]:.3f}%")

        if val_ds is not None:
            val_loss, val_acc = evaluate_classifier(eval_batch, state,
                                                    val_ds)
            history.append("valid", val_loss, val_acc)
            if val_acc > best_acc:
                best_acc, patience_counter = val_acc, 0
                best_params = [p.detach().clone()
                               for p in model.parameters()]
                log("Found a better model. Saving...")
            else:
                patience_counter += 1
            if patience_counter == patience:
                log("Early stopping, reverting to the previous model ...")
                break

    if best_params is not None:
        # Parameters only, in place: a captured step keeps their addresses.
        with torch.no_grad():
            for p, best in zip(model.parameters(), best_params):
                p.copy_(best)

    test_acc = None
    if test_ds is not None:
        _, test_acc = evaluate_classifier(eval_batch, state, test_ds)
        log(f"Got ({test_acc:.2f}%) correct on test")
    return SupervisedResult(state=state, history=history, best_acc=best_acc,
                            test_acc=test_acc, epoch_seconds=epoch_seconds)
