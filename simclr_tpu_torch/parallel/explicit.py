"""Data-parallel SimCLR training with hand-placed collectives.

Counterpart of ``simclr_tpu/parallel/explicit.py`` on ``torch.distributed``
(``parallel/mesh.py``). One engine per rank; each step:

  * draws the augmentation parameters of the whole global batch from the
    step's generator, which every rank seeds alike, and applies them to
    this rank's contiguous slice of the batch (kernel B2 on the slice);
  * runs the rank's 2m images through a model whose ``SubsetBatchNorm``
    statistics are averaged over the ranks (``make_explicit_model``);
  * scores the rank's 2m anchor rows against the all-gathered columns
    ``[z2; z1]`` of all 2N global rows (``_local_nt_xent``, or
    ``_local_modified``), in plain PyTorch, as JAX keeps XLA's loss under
    a mesh; the gather's backward sums each row's cotangents over ranks;
  * differentiates the rank's share ``ce_sum / 2N`` and sums the
    parameter gradients over the ranks, so every rank steps Adam with the
    gradient of the global loss; loss and accuracy are summed over ranks
    and divided by 2N.

With NCCL on CUDA a step is a captured CUDA graph replayed per row, as on
one device (``train/common.py:graphed_epoch``): NCCL collectives can be
captured. A gloo group runs the same step eagerly. PyTorch has no
partitioner, so ``train/pretrain.py`` runs this step under a mesh for both
engine names, 'pjit' and 'explicit'.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.augment import ViewParams
from simclr_tpu_torch.ops.losses import (
    VERY_LARGE_NUM, l2_normalize, softplus_beta)
from simclr_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, all_gather, all_reduce_sum_, shard_batch)
from simclr_tpu_torch.train.common import TrainState
from simclr_tpu_torch.train.pretrain import (
    PretrainEngine, _nchw, contrastive_fn, init_simclr)


def make_explicit_model(cfg: Config,
                        generator: Optional[torch.Generator] = None
                        ) -> SimCLR:
    """SimCLR whose BN statistics are averaged over ``DATA_AXIS``."""
    return SimCLR(cfg.model, generator=generator, bn_axis_name=DATA_AXIS)


def _rows(mesh: Mesh, m: int, device) -> torch.Tensor:
    """Global ids of this rank's m view-1 rows."""
    return mesh.rank * m + torch.arange(m, device=device)


def _local_nt_xent(z_pair: torch.Tensor, n_global: int, temperature: float,
                   mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-row NT-Xent against all-gathered columns.

    ``z_pair`` is this rank's (2m, d) projections (m view-1 rows, then m
    view-2 rows), not yet normalised. Returns (sum of the cross-entropy
    over the local anchors, sum of top-1 hits): sum over ranks and divide
    by 2N outside."""
    m = z_pair.shape[0] // 2
    z_pair = l2_normalize(z_pair.float(), dim=1)
    gathered = all_gather(z_pair, mesh)                 # (ranks, 2m, d)
    z1_all = gathered[:, :m].reshape(mesh.size * m, -1)
    z2_all = gathered[:, m:].reshape(mesh.size * m, -1)
    cols = torch.cat([z2_all, z1_all])                  # [z2 ; z1]
    r1 = _rows(mesh, m, z_pair.device)
    rows = torch.cat([r1, n_global + r1])               # global row ids
    two_n = 2 * n_global
    sim = (z_pair @ cols.T) / temperature
    self_cols = (rows + n_global) % two_n
    sim = sim - VERY_LARGE_NUM * torch.nn.functional.one_hot(
        self_cols, two_n).to(sim.dtype)
    logp = torch.log_softmax(sim, dim=-1)
    ce = -logp.gather(1, rows[:, None])[:, 0]
    hits = (sim.argmax(dim=-1) == rows).float()
    return ce.sum(), hits.sum()


def _local_modified(z_pair: torch.Tensor, n_global: int, temperature: float,
                    mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-row modified ("probabilistic") contrastive loss against
    all-gathered columns (``ops/losses.py:modified_contrastive_loss`` on
    one device): softplus and L1 normalisation per row, the N x N logits
    sharded by rows. Returns (sum of the cross-entropy over the 2m local
    anchor rows, sum of top-1 hits)."""
    m = z_pair.shape[0] // 2
    x = softplus_beta(z_pair.float(), 0.8)
    x = x / x.abs().sum(dim=1, keepdim=True).clamp_min(1e-12)
    gathered = all_gather(x, mesh)
    x1_all = gathered[:, :m].reshape(mesh.size * m, -1)
    x2_all = gathered[:, m:].reshape(mesh.size * m, -1)
    labels = _rows(mesh, m, z_pair.device)

    def direction(rows, cols):
        logits = torch.log((rows @ cols.T * n_global).clamp_min(1e-4)) \
            / temperature
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(1, labels[:, None])[:, 0]
        hits = (logits.argmax(dim=-1) == labels).float()
        return ce.sum(), hits.sum()

    ce_ab, hit_ab = direction(x[:m], x2_all)
    ce_ba, hit_ba = direction(x[m:], x1_all)
    return ce_ab + ce_ba, hit_ab + hit_ba


def _slice_params(p: ViewParams, mesh: Mesh) -> ViewParams:
    """This rank's rows of a global batch's draws."""
    return ViewParams(tuple(shard_batch(b, mesh) for b in p.boxes),
                      shard_batch(p.flip, mesh),
                      shard_batch(p.factors, mesh),
                      shard_batch(p.schedule, mesh),
                      shard_batch(p.sigma, mesh))


def init_explicit(cfg: Config, seed: int, mesh: Mesh
                  ) -> Tuple[SimCLR, TrainState, torch.optim.Optimizer]:
    """``train.pretrain.init_simclr`` for the explicit engine: the same
    parameters and optimizer, a model whose BN statistics are averaged
    over the mesh, the state replicated from rank 0. On more than one rank
    the statistics are exact (``bn_stats_fraction=1.0``), as JAX's
    ``init_explicit`` sets them: a subset would take each rank's leading
    rows."""
    return init_simclr(cfg, seed, mesh.device, mesh=mesh)


class ExplicitEngine(PretrainEngine):
    """``PretrainEngine`` whose step is the explicit data-parallel step
    (module docstring). A step takes the global uint8 batch; its loss and
    accuracy are those of the global batch, the same on every rank."""

    def __init__(self, cfg: Config, model: SimCLR,
                 optimizer: torch.optim.Optimizer, mesh: Mesh):
        super().__init__(cfg, model, optimizer,
                         contrastive_fn(cfg, mesh.device, mesh))
        self.mesh = mesh
        self.local_loss = (_local_modified if cfg.train.modified_loss
                           else _local_nt_xent)

    def graphed(self, images: torch.Tensor) -> bool:
        return super().graphed(images) and self.mesh.backend == "nccl"

    def _update(self, batch: torch.Tensor, params, generator):
        mesh, n = self.mesh, batch.shape[0]
        self.model.train()
        v1, v2 = self._views(shard_batch(batch, mesh),
                             tuple(_slice_params(p, mesh) for p in params))
        _, z = self.model(_nchw(torch.cat([v1, v2])), generator)
        ce, hits = self.local_loss(z, n, self.cfg.train.temperature, mesh)
        self.optimizer.zero_grad(set_to_none=True)
        (ce / (2 * n)).backward()
        # Each rank holds the derivative of its own rows' share; the
        # gradient of the global loss is their sum.
        all_reduce_sum_([p.grad for p in self.model.parameters()
                         if p.grad is not None], mesh)
        self.optimizer.step()
        sums = torch.stack([ce.detach(), hits])
        all_reduce_sum_([sums], mesh)
        return sums[0] / (2 * n), sums[1] * (100.0 / (2 * n))


def build_explicit_engine(cfg: Config, model: SimCLR,
                          optimizer: torch.optim.Optimizer,
                          mesh: Mesh) -> ExplicitEngine:
    """The per-rank engine around the explicit step, with the
    ``PretrainEngine`` interface (``train_epoch``, ``eval_epoch``,
    ``train_step_direct``), so that ``train.pretrain.pretrain()`` drives it
    as it drives the one-device engine. ``model`` must come from
    ``init_explicit`` (or ``init_simclr(mesh=...)``, or
    ``make_explicit_model`` with the state replicated by
    ``parallel/mesh.py:put_replicated``). Evaluation runs the global batch
    on every rank through the eval-mode model (running statistics, no
    collective) and the plain loss."""
    if cfg.train.accum_steps > 1:
        # Each call consumes a full global batch and steps Adam once; an
        # accumulating optimizer would average unrelated full batches
        # (JAX: explicit.py:141-149).
        raise ValueError(
            "the explicit engine does not support accum_steps > 1 "
            f"(got {cfg.train.accum_steps}); its mesh sharding is the "
            "large-batch mechanism")
    if model.bn_axis_name != DATA_AXIS:
        raise ValueError("the explicit engine needs make_explicit_model's "
                         f"BN axis {DATA_AXIS!r}")
    return ExplicitEngine(cfg, model, optimizer, mesh)
