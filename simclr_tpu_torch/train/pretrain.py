"""SimCLR pretraining engine.

Counterpart of ``init_simclr`` / ``build_engine`` in
``simclr_tpu/train/pretrain.py``. One step: gather a uint8 batch from the
device-resident dataset, augment two views (kernel B2 for the colour
chain), one forward over all 2N images in ``channels_last``, NT-Xent
(kernel B1 and its backward), backward, and torch-semantics Adam.

The JAX engine runs an epoch as one ``lax.scan`` dispatch. Here
``train_epoch`` is a Python loop over the index matrix; capturing the step
as one CUDA graph replayed over the epoch is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.augment import (
    ViewParams, augment_train_apply, sample_view_params)
from simclr_tpu_torch.ops.kernels.ntxent import nt_xent_loss_fused, supports
from simclr_tpu_torch.ops.losses import modified_contrastive_loss
from simclr_tpu_torch.train.common import (
    TrainState, adam_torch, with_grad_accumulation)
from simclr_tpu_torch.utils.device import resolve_device

LossFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def contrastive_fn(cfg: Config, device: "str | torch.device") -> LossFn:
    """Loss selector (reference: utils/model_utils.py:90-98): the modified
    loss when asked for, otherwise NT-Xent through kernel B1, whose
    wrappers run the plain version on CPU tensors. On a CUDA device a shape
    the kernel cannot run raises."""
    t = cfg.train.temperature
    if cfg.train.modified_loss:
        return lambda z1, z2: modified_contrastive_loss(z1, z2, t)
    n, d = cfg.train.batch_size, cfg.model.compressed_dim
    if torch.device(device).type == "cuda" and not supports(n, d):
        raise ValueError(f"NT-Xent kernel does not support batch {n} with "
                         f"compressed_dim {d} (see ntxent.supports)")
    return lambda z1, z2: nt_xent_loss_fused(z1, z2, t, normalize=True)


def resolve_model_config(cfg: Config) -> Config:
    """Resolve the auto (None) kernel flags to False, as the JAX
    ``init_simclr`` does on a single device."""
    m = cfg.model
    auto = {f: False for f in ("fuse_identity_blocks", "fold_bn_scales",
                               "bn_relu_fused") if getattr(m, f) is None}
    return cfg.replace(model=dataclasses.replace(m, **auto))


def init_simclr(cfg: Config, seed: int = 0,
                device: "str | torch.device" = "cuda"
                ) -> Tuple[SimCLR, TrainState, torch.optim.Optimizer]:
    """Build the model from ``seed`` (on the CPU, so the weights do not
    depend on the device), move it to ``device`` in channels_last, and
    wrap it with Adam."""
    dev = resolve_device(device)
    cfg = resolve_model_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    model = SimCLR(cfg.model, generator=gen).to(
        dev, memory_format=torch.channels_last)
    optimizer = with_grad_accumulation(
        adam_torch(model.parameters(), cfg.optim.lr, cfg.optim.wt_decay),
        cfg.train.accum_steps)
    return model, TrainState(model, optimizer), optimizer


def _forward_pair(model: SimCLR, v1: torch.Tensor, v2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward over both NHWC views; returns (z1, z2). The permute
    gives NCHW tensors whose memory is channels_last."""
    x = torch.cat([v1, v2], dim=0).permute(0, 3, 1, 2)
    _, z = model(x)
    return z.chunk(2, dim=0)


PairParams = Tuple[ViewParams, ViewParams]


class PretrainEngine:
    """Train steps and the epoch loop over a device-resident dataset."""

    def __init__(self, cfg: Config, model: SimCLR,
                 optimizer: torch.optim.Optimizer, loss_fn: LossFn):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accum = max(cfg.train.accum_steps, 1)

    def sample_pair_params(self, generator: torch.Generator, n: int,
                           in_h: int, in_w: int) -> PairParams:
        aug = self.cfg.augment
        return (sample_view_params(generator, n, in_h, in_w, aug),
                sample_view_params(generator, n, in_h, in_w, aug))

    def train_step_on_params(self, state: TrainState, batch: torch.Tensor,
                             params: PairParams):
        """One step on a uint8 NHWC batch with given augmentation draws;
        returns (state, (loss / accum_steps, accuracy %))."""
        ds = self.cfg.dataset
        self.model.train()
        v1 = augment_train_apply(batch, params[0], ds)
        v2 = augment_train_apply(batch, params[1], ds)
        z1, z2 = _forward_pair(self.model, v1, v2)
        loss, acc = self.loss_fn(z1, z2)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        state.step += 1
        # History parity: the reference logs loss / accum_steps
        # (model_utils.py:116-117).
        return state, (loss.detach() / self.accum, acc.detach())

    def train_step_on_batch(self, state: TrainState, batch: torch.Tensor,
                            generator: torch.Generator):
        params = self.sample_pair_params(generator, *batch.shape[:3])
        return self.train_step_on_params(state, batch, params)

    def train_step(self, state: TrainState, images: torch.Tensor,
                   idx: torch.Tensor, generator: torch.Generator):
        """One step on the rows ``idx`` of a device-resident dataset."""
        return self.train_step_on_batch(
            state, images.index_select(0, idx), generator)

    def train_epoch(self, state: TrainState, images: torch.Tensor,
                    idx_mat: torch.Tensor, generator: torch.Generator):
        """One step per row of ``idx_mat``; returns (state, (losses, accs))
        as device tensors of shape (steps,)."""
        losses, accs = [], []
        for idx in idx_mat:
            state, (loss, acc) = self.train_step(state, images, idx,
                                                 generator)
            losses.append(loss)
            accs.append(acc)
        return state, (torch.stack(losses), torch.stack(accs))


def build_engine(cfg: Config, model: SimCLR,
                 optimizer: torch.optim.Optimizer) -> PretrainEngine:
    device = next(model.parameters()).device
    return PretrainEngine(cfg, model, optimizer, contrastive_fn(cfg, device))
