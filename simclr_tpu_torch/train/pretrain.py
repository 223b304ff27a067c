"""SimCLR pretraining engine and entry point.

Counterpart of ``simclr_tpu/train/pretrain.py``. One step: gather a uint8
batch from the device-resident dataset, augment two views (kernel B2 for
the colour chain), one forward over all 2N images in ``channels_last``,
NT-Xent (kernel B1 and its backward), backward, and torch-semantics Adam.
With ``encoder='dropout'`` the sampling generator also draws the
MC-dropout masks, after the views' draws. With ``accum_steps`` k > 1 a
step is a micro-step on a full batch (JAX's ``optax.MultiSteps``): BN
running statistics move every micro-step, Adam steps on the mean of k
micro-steps' gradients (``train/common.py:GradAccumulation``), and
``state.step`` counts micro-steps.

The JAX engine runs an epoch as one ``lax.scan`` dispatch. Here, on a
CUDA device, ``train_epoch`` captures the step once as a CUDA graph and
replays it for every row of the index matrix (``train/common.py:
graphed_epoch``, which the fine-tune engine shares); Adam is
``capturable`` (``init_simclr`` on a CUDA device). With accumulation two
steps are captured, one that accumulates and one that also steps Adam,
and the host picks one for each row. On the CPU ``train_epoch`` is the
eager loop.

Under a ``mesh`` (``parallel/mesh.py``: one process per device on
``torch.distributed``) ``init_simclr`` takes JAX's rule of exact BN
statistics on more than one device and replicates the state, and
``build_engine`` and ``pretrain`` run the explicit data-parallel step of
``parallel/explicit.py`` for both engine names: PyTorch has no
partitioner, and JAX's own tests hold its two engines equal. Rank 0 alone
writes checkpoints, the export, the metrics and the plots; a resume loads
on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import (
    DeviceDataset, Split, epoch_permutation, make_split)
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.augment import (
    ViewParams, augment_train_apply, sample_view_params)
from simclr_tpu_torch.ops.kernels.ntxent import nt_xent_loss_fused, supports
from simclr_tpu_torch.parallel.mesh import DATA_AXIS, put_replicated
from simclr_tpu_torch.ops.losses import (
    modified_contrastive_loss, nt_xent_loss)
from simclr_tpu_torch.train.common import (
    CapturedStep, GradAccumulation, History, TrainState, adam_torch,
    graphed_epoch, graphed_steps, with_grad_accumulation)
from simclr_tpu_torch.utils import checkpoint as ckpt_lib
from simclr_tpu_torch.utils.device import resolve_device
from simclr_tpu_torch.utils.profiling import MetricsLogger, annotate, trace
from simclr_tpu_torch.utils.weights import simclr_from_jax

LossFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]
PairParams = Tuple[ViewParams, ViewParams]

def contrastive_fn(cfg: Config, device: "str | torch.device",
                   mesh=None) -> LossFn:
    """Loss selector (reference: utils/model_utils.py:90-98): the modified
    loss when asked for, otherwise NT-Xent through kernel B1, whose
    wrappers run the plain version on CPU tensors. On a CUDA device a shape
    the kernel cannot run raises. Under a mesh NT-Xent is the plain
    version, as JAX keeps XLA's loss there."""
    t = cfg.train.temperature
    if cfg.train.modified_loss:
        return lambda z1, z2: modified_contrastive_loss(z1, z2, t)
    if mesh is not None:
        return lambda z1, z2: nt_xent_loss(z1, z2, t, normalize=True)
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


def mesh_config(cfg: Config, mesh=None) -> Config:
    """JAX's mesh rule (``simclr_tpu/train/pretrain.py:116-122``): exact
    BN statistics on a mesh of more than one device, since a subset would
    take each rank's leading rows."""
    if (mesh is not None and mesh.size > 1
            and cfg.model.bn_stats_fraction < 1.0):
        return cfg.replace(model=dataclasses.replace(
            cfg.model, bn_stats_fraction=1.0))
    return cfg


def init_simclr(cfg: Config, seed: int = 0,
                device: "str | torch.device" = "cuda", mesh=None
                ) -> Tuple[SimCLR, TrainState, torch.optim.Optimizer]:
    """Build the model from ``seed`` (on the CPU, so the weights do not
    depend on the device), move it to ``device`` in channels_last, and
    wrap it with Adam (capturable on a CUDA device), accumulated over
    ``cfg.train.accum_steps`` micro-steps where that is above 1.

    With a ``mesh`` the model lives on the mesh's device, its BN
    statistics are averaged over the mesh's ranks
    (``parallel/explicit.py:make_explicit_model``) and exact on more than
    one rank (``mesh_config``), and the state is broadcast from rank 0."""
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    cfg = mesh_config(resolve_model_config(cfg), mesh)
    gen = torch.Generator().manual_seed(seed)
    model = SimCLR(cfg.model, generator=gen,
                   bn_axis_name=None if mesh is None else DATA_AXIS).to(
        dev, memory_format=torch.channels_last)
    optimizer = with_grad_accumulation(
        adam_torch(model.parameters(), cfg.optim.lr, cfg.optim.wt_decay,
                   capturable=dev.type == "cuda"),
        cfg.train.accum_steps)
    put_replicated([model, optimizer], mesh)
    return model, TrainState(model, optimizer), optimizer


def _nchw(v: torch.Tensor) -> torch.Tensor:
    """An NHWC view as the NCHW tensor the model takes (its memory is
    channels_last)."""
    return v.permute(0, 3, 1, 2)


def _forward_pair(model: SimCLR, v1: torch.Tensor, v2: torch.Tensor,
                  two_pass: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward both NHWC views; returns (z1, z2). One forward over the 2N
    images, or with ``two_pass`` the reference's two sequential forwards,
    each with its own BN batch statistics (model_utils.py:113-114).
    ``generator`` draws the MC-dropout masks, if the model has them."""
    if two_pass:
        return (model(_nchw(v1), generator)[1],
                model(_nchw(v2), generator)[1])
    _, z = model(_nchw(torch.cat([v1, v2], dim=0)), generator)
    return z.chunk(2, dim=0)


class PretrainEngine:
    """Train and eval steps and epochs over a device-resident dataset."""

    def __init__(self, cfg: Config, model: SimCLR,
                 optimizer: torch.optim.Optimizer, loss_fn: LossFn,
                 two_pass_views: bool = False):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.two_pass_views = two_pass_views
        self.accum = max(cfg.train.accum_steps, 1)
        # Captured steps, keyed by the dataset tensor, the batch shape and
        # the kind of step (with accumulation, two).
        self.graphs: Dict[tuple, CapturedStep] = {}

    def sample_pair_params(self, generator: torch.Generator, n: int,
                           in_h: int, in_w: int) -> PairParams:
        aug = self.cfg.augment
        return (sample_view_params(generator, n, in_h, in_w, aug),
                sample_view_params(generator, n, in_h, in_w, aug))

    def _views(self, batch: torch.Tensor, params: PairParams):
        ds = self.cfg.dataset
        return (augment_train_apply(batch, params[0], ds),
                augment_train_apply(batch, params[1], ds))

    def _update(self, batch: torch.Tensor, params: PairParams,
                generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, loss, backward and Adam on a uint8 NHWC batch with the
        given view draws (and the MC-dropout masks, if the model has them,
        from ``generator``); returns (loss / accum_steps, accuracy %).
        Touches no host state, so a CUDA graph can capture it."""
        self.model.train()
        z1, z2 = _forward_pair(self.model, *self._views(batch, params),
                               two_pass=self.two_pass_views,
                               generator=generator)
        loss, acc = self.loss_fn(z1, z2)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        # History parity: the reference logs loss / accum_steps
        # (model_utils.py:116-117).
        return loss.detach() / self.accum, acc.detach()

    def train_step_on_params(self, state: TrainState, batch: torch.Tensor,
                             params: PairParams,
                             generator: Optional[torch.Generator] = None):
        """One step on a uint8 NHWC batch with given augmentation draws
        (and the generator of the MC-dropout masks, where the model has
        them); returns (state, (loss / accum_steps, accuracy %))."""
        metrics = self._update(batch, params, generator)
        state.step += 1
        return state, metrics

    def train_step_on_batch(self, state: TrainState, batch: torch.Tensor,
                            generator: torch.Generator):
        params = self.sample_pair_params(generator, *batch.shape[:3])
        return self.train_step_on_params(state, batch, params, generator)

    # One step on a device batch: the hot function of the host-streaming
    # path (JAX: train_step_direct).
    train_step_direct = train_step_on_batch

    def train_step(self, state: TrainState, images: torch.Tensor,
                   idx: torch.Tensor, generator: torch.Generator):
        """One step on the rows ``idx`` of a device-resident dataset."""
        return self.train_step_on_batch(
            state, images.index_select(0, idx), generator)

    def graphed(self, images: torch.Tensor) -> bool:
        """Whether an epoch over ``images`` replays a captured step."""
        return images.device.type == "cuda"

    def train_epoch(self, state: TrainState, images: torch.Tensor,
                    idx_mat: torch.Tensor, generator: torch.Generator):
        """One step per row of ``idx_mat``; returns (state, (losses, accs))
        as device tensors of shape (steps,). On a CUDA device the steps
        are replays of one captured step (module docstring)."""
        if self.graphed(images):
            return self._graphed_epoch(state, images, idx_mat, generator)
        losses, accs = [], []
        for idx in idx_mat:
            state, (loss, acc) = self.train_step(state, images, idx,
                                                 generator)
            losses.append(loss)
            accs.append(acc)
        return state, (torch.stack(losses), torch.stack(accs))

    def _body(self, batch: torch.Tensor, generator: torch.Generator):
        """The step as captured, on a static uint8 batch."""
        draws = self.sample_pair_params(generator, *batch.shape[:3])
        return self._update(batch, draws, generator), draws

    def _schedule(self) -> Optional[GradAccumulation]:
        return (self.optimizer
                if isinstance(self.optimizer, GradAccumulation) else None)

    def _graphed_epoch(self, state, images, idx_mat, generator):
        return graphed_epoch(
            self.graphs, state, (images,), idx_mat, generator,
            lambda st, row: self.train_step(st, images, row, generator),
            lambda idx: self._body(images.index_select(0, idx), generator),
            self._schedule())

    def train_stream(self, state: TrainState,
                     batches: Iterable[torch.Tensor], steps: int,
                     like: torch.Tensor, generator: torch.Generator):
        """One step per uint8 NHWC device batch of ``batches`` (``steps``
        of them, each shaped like ``like``), the host-streaming path's
        epoch; returns (state, (losses, accs)) as device tensors of shape
        (steps,). On a CUDA device the steps are replays of one captured
        step, as in ``train_epoch``: each batch is copied into the graph's
        static batch just before its replay."""
        if self.graphed(like):
            return graphed_steps(
                self.graphs, state, (), iter(batches), steps, like,
                generator,
                lambda st, b: self.train_step_on_batch(st, b, generator),
                lambda b: self._body(b, generator), self._schedule())
        losses, accs = [], []
        for batch in batches:
            state, (loss, acc) = self.train_step_on_batch(state, batch,
                                                          generator)
            losses.append(loss)
            accs.append(acc)
        return state, (torch.stack(losses), torch.stack(accs))

    @torch.no_grad()
    def eval_step_on_views(self, v1: torch.Tensor, v2: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode forwards of two NHWC views (MC-dropout masks, if
        any, from ``generator``), NT-Xent forward only (kernel B1f);
        returns (loss / accum_steps, accuracy %)."""
        training = self.model.training
        self.model.eval()
        try:
            _, z1 = self.model(_nchw(v1), generator)
            _, z2 = self.model(_nchw(v2), generator)
        finally:
            self.model.train(training)
        loss, acc = self.loss_fn(z1, z2)
        return loss / self.accum, acc

    def eval_step(self, state: TrainState, images: torch.Tensor,
                  idx: torch.Tensor, generator: torch.Generator):
        """test_auxi_classification parity (model_utils.py:12-38): an
        augmented pair of the rows ``idx`` through the eval-mode model."""
        batch = images.index_select(0, idx)
        params = self.sample_pair_params(generator, *batch.shape[:3])
        with torch.no_grad():
            views = self._views(batch, params)
        return self.eval_step_on_views(*views, generator=generator)

    def eval_epoch(self, state: TrainState, images: torch.Tensor,
                   idx_mat: torch.Tensor, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Means of loss / accum_steps and of accuracy over the rows, as
        device scalars."""
        losses, accs = zip(*(self.eval_step(state, images, idx, generator)
                             for idx in idx_mat))
        return torch.stack(losses).mean(), torch.stack(accs).mean()


def build_engine(cfg: Config, model: SimCLR,
                 optimizer: torch.optim.Optimizer,
                 two_pass_views: bool = False, mesh=None) -> PretrainEngine:
    """The one-device engine, or under a ``mesh`` the explicit
    data-parallel one (module docstring); ``model`` then comes from
    ``init_simclr(mesh=...)``."""
    if mesh is not None:
        if two_pass_views:
            raise ValueError("a mesh does not implement two_pass_views "
                             "(a single-device parity mode)")
        from simclr_tpu_torch.parallel.explicit import build_explicit_engine

        return build_explicit_engine(mesh_config(cfg, mesh), model,
                                     optimizer, mesh)
    device = next(model.parameters()).device
    return PretrainEngine(cfg, model, optimizer, contrastive_fn(cfg, device),
                          two_pass_views)


def evaluate_auxiliary(
    engine: PretrainEngine,
    state: TrainState,
    ds: DeviceDataset,
    batch_size: Optional[int] = None,
    seed: int = 0,
) -> Tuple[float, float]:
    """Auxiliary-task (positive-pair retrieval) evaluation over a dataset
    (reference: data.py:241-268 + utils/model_utils.py:12-38). Returns
    (mean loss / accum_steps, mean top-1 %)."""
    batch = batch_size or engine.cfg.train.batch_size
    gen = torch.Generator(device=ds.images.device).manual_seed(seed)
    idx_mat = epoch_permutation(gen, ds.n, batch)
    loss, acc = engine.eval_epoch(state, ds.images, idx_mat, gen)
    return float(loss), float(acc)


def epoch_seed(seed: int, epoch: int) -> int:
    """The sampling seed of one epoch, from (seed, epoch) alone, as JAX's
    ``fold_in(k_data, epoch)``: a resumed run draws what an uninterrupted
    one draws."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0])


@dataclasses.dataclass
class PretrainResult:
    state: TrainState
    history: History
    export_path: Optional[str]
    steps_per_sec: float
    # Median per-epoch rate EXCLUDING the first epoch (warm-up steps and
    # the capture); equals steps_per_sec when only one epoch ran.
    steady_steps_per_sec: float = 0.0


def _run_tag(cfg: Config) -> str:
    t = cfg.train
    return (f"{'mod_loss_' if t.modified_loss else ''}bs{t.batch_size}_"
            f"nepoch{t.n_epoch}_{cfg.dataset.name}_"
            f"temp{str(t.temperature).replace('.', '')}")


def pretrain(
    cfg: Config,
    split: Optional[Split] = None,
    mesh=None,
    resume_from: Optional[str] = None,
    two_pass_views: bool = False,
    log: Callable[[str], None] = print,
    save_checkpoints: Optional[bool] = None,
    export_path: Optional[str] = None,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    save_plots: bool = True,
    engine: str = "pjit",
    init_variables: Optional[dict] = None,
    device: "str | torch.device" = "cuda",
) -> PretrainResult:
    """Full pretraining loop (reference: pretrain.py:56-94 +
    utils/model_utils.py:41-173), with the JAX ``pretrain``'s arguments
    and behaviour on one device: resume from a checkpoint path or
    ``"auto"`` (the newest in ``cfg.ckpt_dir``), a validation epoch where
    the validation split holds a batch, checkpoints every
    ``save_ckpt_every`` epochs, a metrics JSONL, the export
    ``simclr_..._temp{T}.pt`` in ``cfg.out_dir``, loss plots, and a
    ``torch.profiler`` trace of the second epoch into ``profile_dir``.
    ``init_variables`` seeds the weights from JAX-layout numpy
    ``{'params', 'batch_stats'}`` trees.

    ``mesh`` (``parallel/mesh.py:make_mesh``): data parallelism, one call
    per rank, each with the whole dataset on its device; ``engine``
    'pjit' and 'explicit' both run the explicit step
    (``parallel/explicit.py``), and 'explicit' needs a mesh, as in JAX
    (a one-rank mesh is a group of one). Rank 0 alone logs and writes the
    checkpoints, the export, the metrics, the plots and the profile; a
    resume loads on every rank, and the ranks meet at the end."""
    if engine not in ("pjit", "explicit"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'pjit' or 'explicit')")
    if engine == "explicit" and mesh is None:
        raise ValueError("engine='explicit' requires a device mesh")
    main = mesh is None or mesh.is_main
    if not main:
        log, save_plots, metrics_path, profile_dir = (
            (lambda _: None), False, None, None)
    dev = resolve_device(device if mesh is None else mesh.device)
    tcfg = cfg.train
    if split is None:
        split = make_split(cfg, "pretrain", dev)
    model, state, opt = init_simclr(cfg, tcfg.seed, dev, mesh)
    eng = build_engine(cfg, model, opt, two_pass_views, mesh)
    if init_variables is not None:
        model.load_state_dict(simclr_from_jax(init_variables["params"],
                                              init_variables["batch_stats"]))
    gen = torch.Generator(device=dev)

    history = History()
    start_epoch = 0
    if resume_from == "auto":
        # Elastic restart: resume from the newest checkpoint if any exists
        # (the reference requires an explicit --resume_training_path,
        # pretrain.py:34-37).
        resume_from = ckpt_lib.latest_checkpoint(cfg.ckpt_dir)
        if resume_from is None:
            log("auto-resume: no checkpoint found, starting fresh")
    if resume_from:
        # Reference resume: model + optimizer + epoch + histories
        # (model_utils.py:75-86).
        state, meta = ckpt_lib.load_checkpoint(resume_from, state, gen)
        history = History.from_dict(meta.get("history"))
        start_epoch = meta["epoch"] + 1
        log(f"resumed from {resume_from} at epoch {start_epoch}")

    if save_checkpoints is None:
        save_checkpoints = tcfg.save_ckpt
    batch = tcfg.batch_size
    steps_per_epoch = split.train.n // batch
    print_every = max(int(steps_per_epoch * tcfg.log_every_fraction), 1)
    metrics = MetricsLogger(metrics_path) if metrics_path else None
    profiled = False

    total_steps = 0
    t_train = 0.0
    epoch_secs = []
    for epoch in range(start_epoch, tcfg.n_epoch):
        gen.manual_seed(epoch_seed(tcfg.seed, epoch))
        idx_mat = epoch_permutation(gen, split.train.n, batch)

        t0 = time.perf_counter()
        with annotate(f"train_epoch {epoch + 1}"):
            if profile_dir and not profiled and epoch > start_epoch:
                # Trace the second epoch (the first runs the warm-up
                # steps and the capture).
                profiled = True
                with trace(profile_dir):
                    state, (losses, accs) = eng.train_epoch(
                        state, split.train.images, idx_mat, gen)
                    losses, accs = losses.cpu().numpy(), accs.cpu().numpy()
            else:
                state, (losses, accs) = eng.train_epoch(
                    state, split.train.images, idx_mat, gen)
                losses, accs = losses.cpu().numpy(), accs.cpu().numpy()
        epoch_secs.append(time.perf_counter() - t0)
        t_train += epoch_secs[-1]
        total_steps += steps_per_epoch
        if metrics:
            metrics.log(
                total_steps, epoch=epoch + 1,
                train_loss=losses.mean(), train_acc=accs.mean(),
                epoch_seconds=time.perf_counter() - t0,
                steps_per_sec=steps_per_epoch
                / max(time.perf_counter() - t0, 1e-9))

        for s in range(0, steps_per_epoch, print_every):
            log(f"Epoch: {epoch + 1} | Iteration {s} | "
                f"Loss = {losses[s]:.4f} | Accuracy = {accs[s]:.4f}%")
        history.append("train", losses.mean(), accs.mean())

        if split.val is not None and split.val.n >= batch:
            with annotate(f"eval_epoch {epoch + 1}"):
                v_idx = epoch_permutation(gen, split.val.n, batch)
                v_loss, v_acc = eng.eval_epoch(state, split.val.images,
                                               v_idx, gen)
                v_loss, v_acc = float(v_loss), float(v_acc)
            log(f"Epoch: {epoch + 1} | avg valid loss: {v_loss:.4f} | "
                f"avg valid accuracy: {v_acc:.4f}%")
            history.append("valid", v_loss, v_acc)
            if metrics:
                metrics.log(total_steps, epoch=epoch + 1,
                            valid_loss=v_loss, valid_acc=v_acc)

        if (save_checkpoints and main
                and (epoch + 1) % tcfg.save_ckpt_every == 0):
            path = ckpt_lib.save_checkpoint(
                cfg.ckpt_dir, epoch, state, history.to_dict(),
                generator=gen)
            log(f"checkpoint saved: {path}")

    final_export = None
    if export_path is not None or tcfg.n_epoch > start_epoch:
        final_export = export_path or os.path.join(
            cfg.out_dir, f"simclr_{_run_tag(cfg)}.pt")
        if main:
            ckpt_lib.export_model(final_export, model, cfg.to_json())
            log(f"exported model: {final_export}")

    if save_plots and history.loss["train"]:
        # End-of-training loss/accuracy PNGs, like the reference
        # (utils/model_utils.py:158-163 calling visualizations.py:222-242).
        from simclr_tpu_torch.utils.visualizations import plot_loss_acc

        os.makedirs(cfg.out_dir, exist_ok=True)
        tag = _run_tag(cfg)
        plot_loss_acc(history.loss["train"], history.accuracy["train"],
                      title=f"train_{tag}", save_plot=True,
                      save_dir=cfg.out_dir)
        if history.loss["valid"]:
            plot_loss_acc(history.loss["valid"],
                          history.accuracy["valid"],
                          title=f"valid_{tag}", save_plot=True,
                          save_dir=cfg.out_dir)
        log(f"saved loss/accuracy plots to {cfg.out_dir}")

    if metrics:
        metrics.close()
    if mesh is not None:
        # Every rank returns after rank 0's files exist (a resume reads
        # them on every rank).
        torch.distributed.barrier(group=mesh.group)
    sps = total_steps / t_train if t_train > 0 else 0.0
    warm = epoch_secs[1:] or epoch_secs
    steady = (steps_per_epoch / float(np.median(warm))) if warm else sps
    return PretrainResult(state=state, history=history,
                          export_path=final_export, steps_per_sec=sps,
                          steady_steps_per_sec=steady)
