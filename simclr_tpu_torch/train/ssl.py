"""Semi-supervised fine-tuning with 10% of the labels.

Counterpart of ``simclr_tpu/train/ssl.py`` (reference
utils/model_utils.py:300-407, training_others/train_ssl.py): a
``SimCLRFineTune`` grafted from a pretrained export, SGD with Nesterov
momentum (lr 0.02, momentum 0.98), weighted 10%-label sampling with
replacement, and an optional validation epoch with early stopping
(patience 5) that keeps the best parameters. As on the JAX side, the
pretrained weights are loaded (the reference CLI never loads them,
train_ssl.py:42 against models/ssl.py:7-12).

One step: gather a uint8 batch and its labels from the device-resident
dataset, the fine-tune view (random resized crop, flip, normalise; no
colour distortion, so no kernel B2), a train-mode forward (the BN running
statistics move; MC-dropout masks, where the encoder has them, from the
sampling generator), cross-entropy, backward and SGD. ``SupervisedEngine``
also runs the supervised baseline's half-step (``train/supervised.py``).
On a CUDA device an epoch replays one captured step per row of its index
matrix (``train/common.py:graphed_epoch``), as the JAX epoch is one
``lax.scan``; on the CPU it is the eager loop. No kernel runs on the
fine-tune path's default; with ``bn_relu_fused`` the block BNs' backward
is kernel B3. The supervised view's colour chain is kernel B2.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import (
    DeviceDataset, class_weights, epoch_permutation, weighted_sample_indices)
from simclr_tpu_torch.models.simclr import SimCLRFineTune
from simclr_tpu_torch.ops.augment import (
    CropParams, SupervisedParams, augment_fine_tune_apply,
    augment_supervised_apply, augment_test, sample_fine_tune_params,
    sample_supervised_params)
from simclr_tpu_torch.ops.losses import cross_entropy, top1_accuracy
from simclr_tpu_torch.train.common import (
    CapturedStep, History, Metrics, TrainState, graphed_epoch, sgd_nesterov)
from simclr_tpu_torch.train.pretrain import (
    _nchw, epoch_seed, resolve_model_config)
from simclr_tpu_torch.utils.checkpoint import load_pretrained
from simclr_tpu_torch.utils.device import resolve_device

EvalBatch = Callable[[TrainState, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]
ViewDraws = Optional["CropParams | SupervisedParams"]


def init_finetune(
    cfg: Config,
    seed: int = 0,
    pretrained_path: Optional[str] = None,
    num_classes: Optional[int] = None,
    device: "str | torch.device" = "cuda",
) -> Tuple[SimCLRFineTune, TrainState, torch.optim.Optimizer]:
    """Build the fine-tune model from ``seed`` (on the CPU, so the weights
    do not depend on the device), graft ``f`` and ``g`` with their running
    statistics from ``pretrained_path`` (a port ``.pt`` or a JAX
    ``.msgpack`` export; ``supervised_head`` stays fresh), move it to
    ``device`` in channels_last and wrap it with Nesterov SGD (reference:
    models/ssl.py:24-27 loads the whole SimCLR state dict)."""
    dev = resolve_device(device)
    cfg = resolve_model_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    model = SimCLRFineTune(cfg.model,
                           num_classes or cfg.dataset.num_classes,
                           generator=gen)
    if pretrained_path is not None:
        sd, _ = load_pretrained(pretrained_path)
        for name in ("f", "g"):
            prefix = name + "."
            getattr(model, name).load_state_dict(
                {k[len(prefix):]: v for k, v in sd.items()
                 if k.startswith(prefix)})
    model = model.to(dev, memory_format=torch.channels_last)
    optimizer = sgd_nesterov(model.parameters(), cfg.optim.lr_ssl,
                             cfg.optim.momentum_ssl)
    return model, TrainState(model, optimizer), optimizer


class SupervisedEngine:
    """Train and eval steps and epochs of a classifier (``model(x,
    generator) -> logits``) over a device-resident dataset. The view is
    'fine_tune' (crop, flip, normalise), 'supervised' (flip, translate,
    colour jitter and normalise through kernel B2) or 'none' (normalise).
    The generator that draws the views also draws the model's MC-dropout
    masks, after the view's draws; a model without dropout draws
    nothing from it."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: Config,
                 augment: str = "fine_tune"):
        if augment not in ("fine_tune", "supervised", "none"):
            raise ValueError(f"unknown augment {augment!r} (expected "
                             "'fine_tune', 'supervised' or 'none')")
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.augment = augment
        # Captured steps, keyed by the dataset tensors and the batch shape.
        self.graphs: Dict[tuple, CapturedStep] = {}

    def sample_params(self, generator: torch.Generator, n: int, in_h: int,
                      in_w: int) -> ViewDraws:
        """The view's draws; None in 'none' mode, which draws nothing."""
        if self.augment == "none":
            return None
        if self.augment == "supervised":
            return sample_supervised_params(generator, n, in_h, in_w)
        return sample_fine_tune_params(generator, n, in_h, in_w,
                                       self.cfg.augment)

    def _views(self, batch: torch.Tensor, params: ViewDraws) -> torch.Tensor:
        if params is None:
            return augment_test(batch, self.cfg.dataset)
        if isinstance(params, SupervisedParams):
            return augment_supervised_apply(batch, params, self.cfg.dataset)
        return augment_fine_tune_apply(batch, params, self.cfg.dataset)

    def _update(self, batch: torch.Tensor, targets: torch.Tensor,
                params: ViewDraws,
                generator: Optional[torch.Generator]) -> Metrics:
        """Forward, cross-entropy, backward and the optimizer's step on a
        uint8 NHWC batch with the given draws; returns (loss, accuracy %).
        Touches no host state, so a CUDA graph can capture it."""
        self.model.train()
        logits = self.model(_nchw(self._views(batch, params)), generator)
        loss = cross_entropy(logits, targets)
        acc = top1_accuracy(logits, targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), acc.detach()

    def train_step_on_params(self, state: TrainState, batch: torch.Tensor,
                             targets: torch.Tensor, params: ViewDraws,
                             generator: Optional[torch.Generator] = None):
        """One step on a uint8 NHWC batch with given view draws (and the
        generator of the MC-dropout masks, where the model has them);
        returns (state, (loss, accuracy %))."""
        metrics = self._update(batch, targets, params, generator)
        state.step += 1
        return state, metrics

    def train_step(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor, idx: torch.Tensor,
                   generator: torch.Generator):
        """One step on the rows ``idx`` of a device-resident dataset."""
        batch = images.index_select(0, idx)
        params = self.sample_params(generator, *batch.shape[:3])
        return self.train_step_on_params(
            state, batch, labels.index_select(0, idx), params, generator)

    def train_epoch(self, state: TrainState, images: torch.Tensor,
                    labels: torch.Tensor, idx_mat: torch.Tensor,
                    generator: torch.Generator):
        """One step per row of ``idx_mat``; returns (state, (losses,
        accs)) as device tensors of shape (steps,). On a CUDA device the
        steps are replays of one captured step."""
        if images.device.type == "cuda":
            def body(idx):
                batch = images.index_select(0, idx)
                params = self.sample_params(generator, *batch.shape[:3])
                return self._update(batch, labels.index_select(0, idx),
                                    params, generator), params

            return graphed_epoch(
                self.graphs, state, (images, labels), idx_mat, generator,
                lambda st, row: self.train_step(st, images, labels, row,
                                                generator),
                body)
        losses, accs = [], []
        for idx in idx_mat:
            state, (loss, acc) = self.train_step(state, images, labels, idx,
                                                 generator)
            losses.append(loss)
            accs.append(acc)
        return state, (torch.stack(losses), torch.stack(accs))

    @torch.no_grad()
    def eval_batch(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode forward of ``state.model`` over the test view (its
        MC-dropout masks, if any, from ``generator``); returns the mean
        NLL over the rows whose label is not negative (padding rows carry
        -1, as on the JAX side) and their number correct, as device
        scalars."""
        model = state.model
        training = model.training
        model.eval()
        try:
            logits = model(_nchw(augment_test(images, self.cfg.dataset)),
                           generator)
        finally:
            model.train(training)
        valid = labels >= 0
        log_probs = F.log_softmax(logits.float(), dim=-1)
        nll_each = -log_probs.gather(
            1, labels.clamp_min(0).long()[:, None])[:, 0]
        nll = (torch.where(valid, nll_each, torch.zeros_like(nll_each)).sum()
               / valid.sum().clamp_min(1))
        correct = ((logits.argmax(-1) == labels) & valid).sum()
        return nll, correct


def build_supervised_epoch_fns(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer, cfg: Config,
                               augment: str = "fine_tune"):
    """(train_epoch, eval_batch) of a ``SupervisedEngine``, the JAX
    function's pair. augment: 'fine_tune' (crop + flip, data.py:150-169),
    'supervised' (flip + translate + jitter, data.py:195-217) or 'none'
    (plain normalise)."""
    engine = SupervisedEngine(model, optimizer, cfg, augment)
    return engine.train_epoch, engine.eval_batch


def evaluate_classifier(eval_batch: EvalBatch, state: TrainState,
                        ds: DeviceDataset, batch_size: int = 512
                        ) -> Tuple[float, float]:
    """test_ssl parity (reference: model_utils.py:372-407): the mean of the
    batch losses and the accuracy % over every sample. The last batch is
    ragged; no sample counts twice. A model with MC dropout needs an
    ``eval_batch`` bound to its generator (``functools.partial``)."""
    losses, correct = [], 0
    for start in range(0, ds.n, batch_size):
        nll, corr = eval_batch(state, ds.images[start:start + batch_size],
                               ds.labels[start:start + batch_size])
        losses.append(nll)
        correct = correct + corr
    loss = float(torch.stack(losses).double().mean())
    return loss, 100.0 * int(correct) / ds.n


@dataclasses.dataclass
class FineTuneResult:
    state: TrainState
    history: History
    best_acc: float
    test_acc: Optional[float] = None
    # Wall seconds of each epoch's train_epoch and its host fetch (the
    # first carries the warm-up steps and the capture on a CUDA device).
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)


def train_ssl(
    cfg: Config,
    train_ds: DeviceDataset,
    val_ds: Optional[DeviceDataset] = None,
    test_ds: Optional[DeviceDataset] = None,
    pretrained_path: Optional[str] = None,
    n_epochs: Optional[int] = None,
    patience: int = 5,
    log: Callable[[str], None] = print,
) -> FineTuneResult:
    """Fine-tune driver (reference: model_utils.py:300-369 and
    train_ssl.py:34-60) on the datasets' device. With ``ssl_label_size <
    1`` an epoch is ``max(floor(ssl_label_size * n), micro_batch_size)``
    draws weighted by inverse class frequency with replacement, else a
    permutation; the remainder of a batch is dropped. Each epoch's draws
    come from ``epoch_seed(seed, epoch)``, as ``pretrain()``'s. With
    ``val_ds``, the parameters of the best validation accuracy are kept and
    restored at the end (the running statistics stay the last epoch's, as
    on the JAX side), and ``patience`` epochs without a better one stop
    the run. Then the test accuracy, if ``test_ds`` is given."""
    tcfg = cfg.train
    n_epochs = n_epochs or tcfg.n_epoch_ssl
    batch = tcfg.micro_batch_size
    dev = train_ds.images.device
    model, state, optimizer = init_finetune(cfg, tcfg.seed, pretrained_path,
                                            device=dev)
    engine = SupervisedEngine(model, optimizer, cfg, augment="fine_tune")
    gen = torch.Generator(device=dev)
    # Evaluation draws its MC-dropout masks, if any, from the epoch's
    # generator, after the epoch's own draws.
    eval_batch = functools.partial(engine.eval_batch, generator=gen)

    use_weighted = tcfg.ssl_label_size < 1.0
    if use_weighted:
        weights = torch.from_numpy(
            class_weights(train_ds.labels.cpu().numpy())).to(dev)
        n_draw = max(int(np.floor(tcfg.ssl_label_size * train_ds.n)),
                     batch)  # at least one optimizer step per epoch

    history = History()
    epoch_seconds: List[float] = []
    best_acc, best_params, patience_counter = 0.0, None, 0
    for epoch in range(n_epochs):
        t0 = time.perf_counter()
        gen.manual_seed(epoch_seed(tcfg.seed, epoch))
        if use_weighted:
            idx_mat = weighted_sample_indices(gen, weights, n_draw, batch)
        else:
            idx_mat = epoch_permutation(gen, train_ds.n, batch)
        state, (losses, accs) = engine.train_epoch(
            state, train_ds.images, train_ds.labels, idx_mat, gen)
        losses, accs = losses.cpu().numpy(), accs.cpu().numpy()
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
                log("Found a better model, saving...")
            else:
                patience_counter += 1
                if patience_counter == patience:
                    log("Early stopping ... ")
                    break

    if best_params is not None:
        # In place: a captured step keeps the parameters' addresses.
        with torch.no_grad():
            for p, best in zip(model.parameters(), best_params):
                p.copy_(best)

    test_acc = None
    if test_ds is not None:
        _, test_acc = evaluate_classifier(eval_batch, state, test_ds)
        log(f"Got ({test_acc:.2f}%) correct on test")
    return FineTuneResult(state=state, history=history, best_acc=best_acc,
                          test_acc=test_acc, epoch_seconds=epoch_seconds)
