"""MINE mutual-information estimation over learned representations.

Counterpart of ``simclr_tpu/train/mine.py`` (reference mine.py:21-171,
training_others/train_mine.py): a ``MineNet`` trained with the
Donsker-Varadhan bound, in log space with an EMA-debiased gradient
(``ops/losses.py:mine_loss``), on (joint, marginal) feature pairs from a
frozen pretrained ``SimCLR``.

  * ``repr`` mode (reference sample_joint_marginal, mine.py:21-56):
    joint = [f(v1), f(v2)] for two training views of one batch, marginal
    = [f(v1), f(vm)] for a view of an independent batch; three colour
    kernel (B2) launches a step.
  * ``orig`` mode (sample_joint_marginal_with_orig, mine.py:59-94):
    joint = [flatten(v), f(v)], marginal = [flatten(v), f(vm)]; two B2
    launches a step. The input is img_size^2 * 3 + feat_dim wide.

f is h or z (``use_hidden_feat``). The frozen model runs in eval mode
with no gradient, its MC dropout on where ``cfg.model.encoder ==
'dropout'``; its views go through one forward (eval-mode BN is per
sample, so that equals the JAX side's three). Each step draws ``batch``
joint and ``batch`` marginal indices with replacement, independently.

On a CUDA device the steps of a chunk are replays of one captured step
(``train/common.py:graphed_epoch``): its index row holds the joint and
then the marginal indices, the EMA state ``log_ma`` is a device tensor
updated in place, and the view and dropout draws come from the CUDA
generator registered with the graph. On the CPU it is the eager loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import DeviceDataset
from simclr_tpu_torch.models.mine import MineNet
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.augment import (
    ViewParams, augment_train_apply, sample_view_params)
from simclr_tpu_torch.ops.losses import log_mean_exp, mine_loss
from simclr_tpu_torch.train.common import (
    CapturedStep, TrainState, adam_torch, graphed_epoch)
from simclr_tpu_torch.train.pretrain import _nchw, resolve_model_config
from simclr_tpu_torch.utils.checkpoint import load_pretrained
from simclr_tpu_torch.utils.device import resolve_device

Draws = Tuple[ViewParams, ...]


class MineEngine:
    """The MINE step over a frozen ``SimCLR`` and its chunks of steps."""

    def __init__(self, cfg: Config, simclr: SimCLR, mine: MineNet,
                 optimizer: torch.optim.Optimizer, ma_rate: float = 5e-2,
                 mi_between_repr: bool = True,
                 use_hidden_feat: bool = True):
        self.cfg = cfg
        self.simclr = simclr.eval().requires_grad_(False)
        self.mine = mine
        self.optimizer = optimizer
        self.ma_rate = ma_rate
        self.mi_between_repr = mi_between_repr
        self.use_hidden_feat = use_hidden_feat
        # log(EMA of mean(exp(T_marginal))): a 0-d device tensor, updated
        # in place, so that a captured step reads and writes it.
        self.log_ma: Optional[torch.Tensor] = None
        # Captured steps, keyed by the dataset tensor and the row shape.
        self.graphs: Dict[tuple, CapturedStep] = {}

    def sample_params(self, generator: torch.Generator, n: int, in_h: int,
                      in_w: int) -> Draws:
        """The views' draws: v1, v2 and vm in ``repr`` mode, v and vm in
        ``orig`` mode."""
        k = 3 if self.mi_between_repr else 2
        return tuple(sample_view_params(generator, n, in_h, in_w,
                                        self.cfg.augment) for _ in range(k))

    def views(self, x_joint: torch.Tensor, x_marg: torch.Tensor,
              draws: Draws) -> List[torch.Tensor]:
        """SimCLR training views (kernel B2 for their colour chain) of the
        joint batch (one or two) and of the marginal batch (the last)."""
        ds = self.cfg.dataset
        *joint, marg = draws
        return ([augment_train_apply(x_joint, d, ds) for d in joint]
                + [augment_train_apply(x_marg, marg, ds)])

    @torch.no_grad()
    def pairs(self, views: List[torch.Tensor],
              generator: Optional[torch.Generator]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(joint, marginal) MineNet inputs from the views, through one
        eval-mode forward of the frozen model (its MC-dropout masks, if
        any, from ``generator``)."""
        h, z = self.simclr(_nchw(torch.cat(views)), generator)
        feats = (h if self.use_hidden_feat else z).float().chunk(len(views))
        if self.mi_between_repr:
            f1, f2, fm = feats
            return torch.cat([f1, f2], 1), torch.cat([f1, fm], 1)
        flat = views[0].reshape(views[0].shape[0], -1)
        return torch.cat([flat, feats[0]], 1), torch.cat([flat, feats[1]], 1)

    def _pairs(self, images: torch.Tensor, idx: torch.Tensor,
               generator: torch.Generator):
        b = idx.shape[0] // 2
        x_joint = images.index_select(0, idx[:b])
        x_marg = images.index_select(0, idx[b:])
        draws = self.sample_params(generator, *x_joint.shape[:3])
        return self.pairs(self.views(x_joint, x_marg, draws),
                          generator), draws

    @torch.no_grad()
    def init_log_ma(self, images: torch.Tensor, idx: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """The EMA's start, log mean exp(T) of a first marginal batch
        through the untrained MineNet (the first-step semantics of
        ``mine_loss(last_log_ma=None)``, as JAX's train_mine.py:161-170
        evaluates it eagerly); ``idx`` holds joint then marginal
        indices."""
        (_, marginal), _ = self._pairs(images, idx, generator)
        value = log_mean_exp(self.mine(marginal))
        if self.log_ma is None:
            self.log_ma = value.clone()
        else:
            self.log_ma.copy_(value)
        return self.log_ma

    def update_on_pairs(self, joint: torch.Tensor, marginal: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """MineNet's loss, backward and Adam step; the EMA moves in place.
        Returns (loss, MI lower bound). Touches no host state, so a CUDA
        graph can capture it."""
        t_j = self.mine(joint)
        t_m = self.mine(marginal)
        loss, mi, new_ma = mine_loss(t_j, t_m, self.log_ma, self.ma_rate)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.log_ma.copy_(new_ma.detach())
        return loss.detach(), mi.detach()

    def _update(self, images: torch.Tensor, idx: torch.Tensor,
                generator: torch.Generator):
        (joint, marginal), draws = self._pairs(images, idx, generator)
        return self.update_on_pairs(joint, marginal), draws

    def train_step(self, state: TrainState, images: torch.Tensor,
                   idx: torch.Tensor, generator: torch.Generator):
        """One step on the joint and marginal rows ``idx`` (the first and
        second half); returns (state, (loss, MI))."""
        metrics, _ = self._update(images, idx, generator)
        state.step += 1
        return state, metrics

    def train_chunk(self, state: TrainState, images: torch.Tensor,
                    rows: torch.Tensor, generator: torch.Generator):
        """One step per row of ``rows`` (steps, 2 * batch); returns
        (state, (losses, MIs)) as device tensors of shape (steps,). On a
        CUDA device the steps are replays of one captured step."""
        if self.log_ma is None:
            raise ValueError("init_log_ma first: the EMA has no start")
        if images.device.type == "cuda":
            return graphed_epoch(
                self.graphs, state, (images,), rows, generator,
                lambda st, row: self.train_step(st, images, row, generator),
                lambda idx: self._update(images, idx, generator))
        losses, mis = [], []
        for idx in rows:
            state, (loss, mi) = self.train_step(state, images, idx,
                                                generator)
            losses.append(loss)
            mis.append(mi)
        return state, (torch.stack(losses), torch.stack(mis))


@dataclasses.dataclass
class MineResult:
    state: TrainState
    loss_trace: np.ndarray      # each chunk's mean loss
    mi_trace: np.ndarray        # each chunk's mean MI lower bound
    final_mi: float
    # Wall seconds of each chunk and its host fetch (the first carries the
    # warm-up steps and the capture on a CUDA device).
    chunk_seconds: List[float] = dataclasses.field(default_factory=list)


def draw_rows(generator: torch.Generator, n: int, steps: int,
               batch: int) -> torch.Tensor:
    """(steps, 2 * batch) indices with replacement: each row's joint
    indices, then its marginal ones, drawn independently."""
    dev = generator.device
    joint = torch.randint(0, n, (steps, batch), generator=generator,
                          device=dev)
    marg = torch.randint(0, n, (steps, batch), generator=generator,
                         device=dev)
    return torch.cat([joint, marg], dim=1)


def build_mine(
    cfg: Config,
    simclr_state_dict: Dict[str, torch.Tensor],
    ma_rate: float = 5e-2,
    mi_between_repr: bool = True,
    use_hidden_feat: bool = True,
    hidden_size: Optional[int] = None,
    lr: Optional[float] = None,
    device: "str | torch.device" = "cuda",
) -> Tuple[MineEngine, TrainState]:
    """The frozen SimCLR (``cfg.model`` with ``simclr_state_dict``), a
    ``MineNet`` from ``cfg.train.seed`` (on the CPU, so the weights do not
    depend on the device) and Adam (capturable on a CUDA device), on
    ``device``; returns the engine and the MineNet's train state."""
    dev = resolve_device(device)
    hidden = hidden_size or cfg.train.mine_hidden_dim
    cfg = resolve_model_config(cfg)
    simclr = SimCLR(cfg.model)
    simclr.load_state_dict(simclr_state_dict)
    simclr = simclr.to(dev, memory_format=torch.channels_last)
    feat_dim = (cfg.model.feature_dim if use_hidden_feat
                else cfg.model.compressed_dim)
    in_features = (2 * feat_dim if mi_between_repr
                   else cfg.dataset.img_size ** 2 * 3 + feat_dim)
    mine = MineNet(in_features, hidden, generator=torch.Generator(
        ).manual_seed(cfg.train.seed)).to(dev)
    optimizer = adam_torch(mine.parameters(), lr or cfg.optim.mine_lr,
                           capturable=dev.type == "cuda")
    engine = MineEngine(cfg, simclr, mine, optimizer, ma_rate,
                        mi_between_repr, use_hidden_feat)
    return engine, TrainState(mine, optimizer)


def train_mine(
    cfg: Config,
    dataset: DeviceDataset,
    simclr_state_dict: Dict[str, torch.Tensor],
    n_iter: int = 1000,
    ma_rate: float = 5e-2,
    mi_between_repr: bool = True,
    use_hidden_feat: bool = True,
    batch_size: Optional[int] = None,
    hidden_size: Optional[int] = None,
    lr: Optional[float] = None,
    log: Callable[[str], None] = print,
    print_every: int = 50,
    take_avg_every: int = 50,
    device: "str | torch.device" = "cuda",
) -> MineResult:
    """Train the MI estimator (reference: mine.py:112-171) over the frozen
    SimCLR whose weights are ``simclr_state_dict`` (built from
    ``cfg.model``) on ``device``: ``max(n_iter // take_avg_every, 1)``
    chunks of ``take_avg_every`` steps, each chunk's losses and MI
    averaged into the traces, Adam at ``lr`` (``cfg.optim.mine_lr`` by
    default). The dataset's images are moved to ``device`` if they are
    elsewhere."""
    dev = resolve_device(device)
    batch = batch_size or cfg.train.mine_batch_size
    images = dataset.images.to(dev)
    n = images.shape[0]
    engine, state = build_mine(cfg, simclr_state_dict, ma_rate,
                               mi_between_repr, use_hidden_feat,
                               hidden_size, lr, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)

    engine.init_log_ma(images, draw_rows(gen, n, 1, batch)[0], gen)
    losses_all, mis_all, chunk_seconds = [], [], []
    chunk = take_avg_every
    for c in range(max(n_iter // chunk, 1)):
        t0 = time.perf_counter()
        rows = draw_rows(gen, n, chunk, batch)
        state, (losses, mis) = engine.train_chunk(state, images, rows, gen)
        losses, mis = losses.cpu().numpy(), mis.cpu().numpy()
        chunk_seconds.append(time.perf_counter() - t0)
        losses_all.append(losses.mean())
        mis_all.append(mis.mean())
        it = (c + 1) * chunk
        if it % print_every == 0:
            log(f"iteration #{it}: loss: {losses[-1]:.4f} | "
                f"MI: {mis[-1]:.4f}")
    return MineResult(state=state, loss_trace=np.asarray(losses_all),
                      mi_trace=np.asarray(mis_all),
                      final_mi=float(mis_all[-1]),
                      chunk_seconds=chunk_seconds)


def train_mine_from_export(cfg: Config, dataset: DeviceDataset,
                           export_path: str, **kw) -> MineResult:
    """CLI-facing wrapper: the frozen SimCLR from an export, the port's
    ``.pt`` or the JAX package's ``.msgpack`` (reference:
    train_mine.py:67 loads the TorchScript trace)."""
    sd, _ = load_pretrained(export_path)
    return train_mine(cfg, dataset, sd, **kw)
