"""Shared training machinery: train state, torch-semantics optimizers, the
captured epoch and the metrics history.

Counterpart of ``simclr_tpu/train/common.py``. The JAX state is an
immutable pytree threaded through jitted steps; here the module and the
optimizer are updated in place and the state only bundles them.

The JAX trainers run an epoch as one ``lax.scan`` dispatch. Here, on a
CUDA device, ``graphed_epoch`` captures a trainer's step once as a CUDA
graph and replays it for every row of the epoch's index matrix:

  * the index row reaches the graph through a static buffer, and each
    replay's loss and accuracy are copied into the epoch's output rows,
    so the host never waits for the device inside the epoch;
  * the augmentation draws come from a CUDA generator registered with the
    graph: each replay advances it as the eager step would, so a replayed
    epoch draws what an eager one draws;
  * the first rows of the first epoch (``WARMUP_STEPS``) run eagerly on a
    side stream before the capture, as PyTorch asks: they build the kernel
    library, the per-device caches, cuDNN's plans and the optimizer's
    state (Adam's moments, SGD's momentum buffers, which ``step()``
    creates on its first call). They are real steps of the epoch, which
    takes each row exactly once.
  * with gradient accumulation (``GradAccumulation``) two steps are
    captured, one that accumulates and one that also steps the optimizer
    and clears the accumulator; the host picks one for each row from the
    micro-step count, and the warm-up goes on until the optimizer has
    stepped once.

A capture that fails raises; a CUDA epoch never falls back to the eager
loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence,
    Tuple)

import torch
import torch.nn as nn

# Eager steps before the capture (PyTorch's recipe warms up on a side
# stream); the first epoch's first rows.
WARMUP_STEPS = 2

Metrics = Tuple[torch.Tensor, torch.Tensor]  # (loss, accuracy %)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def adam_torch(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, capturable: bool = False
               ) -> torch.optim.Optimizer:
    """Adam with the L2 term added to the raw gradient before the moments
    (``torch.optim.Adam(weight_decay=...)``, not AdamW), as the JAX side's
    ``adam_torch`` chain does (reference: pretrain.py:80). ``capturable``
    keeps the step count and bias corrections on the device, so that a
    CUDA graph can capture ``step()``."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay, capturable=capturable)


def sgd_nesterov(params: Iterable[torch.nn.Parameter], lr: float,
                 momentum: float) -> torch.optim.Optimizer:
    """``torch.optim.SGD(momentum, nesterov=True)`` (reference:
    train_ssl.py:44-45), the trace of the JAX side's ``optax.sgd(lr,
    momentum, nesterov=True)``: the first step's buffer is the gradient,
    then ``buf = m * buf + g``, and each update is ``-lr * (g + m *
    buf)``. Parameters without a gradient are left alone. ``lr`` stays a
    Python float, so ``step()`` can be captured in a CUDA graph once its
    first call has made the buffers."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=True)


class GradAccumulation:
    """Gradient accumulation over ``k`` micro-steps around an optimizer,
    as the JAX side's ``optax.MultiSteps`` (``train/common.py:61-70``;
    reference: utils/model_utils.py:116-123).

    Each ``step()`` folds the parameters' gradients into a running mean
    held in static buffers the optimizer does not own, with optax's
    recurrence ``acc + (g - acc) / (i + 1)`` (i the micro-step within the
    cycle, 0-based); the k-th also copies the mean into the gradients,
    steps the optimizer (Adam's L2 term on the parameters at that moment,
    its step count advancing only then) and clears the accumulator.
    Between optimizer steps the parameters do not change.

    The micro-step count is kept twice: on the host (``mini``), which
    picks the kind of the next step, and on the device (``count``), which
    the running mean divides by, so that a CUDA graph of an accumulating
    step serves every i. ``state_dict`` is the optimizer's with the
    accumulator and ``mini`` added, so a run resumed mid-cycle goes on
    as an uninterrupted one. For ``graphed_epoch`` it is the schedule of
    two captured steps (``kinds``, ``next_kind``, ``capturing``,
    ``advance``, ``ready``)."""

    kinds = ("accumulate", "step")

    def __init__(self, optimizer: torch.optim.Optimizer, k: int):
        self.optimizer = optimizer
        self.k = k
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), device=self.params[0].device)
        self.mini = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def next_kind(self) -> str:
        return self.kinds[self.mini == self.k - 1]

    def advance(self) -> None:
        """Count one micro-step on the host (a replayed step)."""
        self.mini = (self.mini + 1) % self.k

    def ready(self) -> bool:
        """Whether the optimizer has made its state (stepped once), which
        a captured step must not create."""
        return bool(self.optimizer.state)

    @contextlib.contextmanager
    def capturing(self, kind: str) -> Iterator[None]:
        """The host count of a step of ``kind`` while it is captured,
        restored after: a capture takes no step."""
        mini = self.mini
        self.mini = self.k - 1 if kind == "step" else 0
        try:
            yield
        finally:
            self.mini = mini

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        diffs = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diffs, self.count + 1)
        torch._foreach_add_(self.acc, diffs)
        if self.next_kind() == "step":
            for p, a in zip(self.params, self.acc):
                if p.grad is None:
                    p.grad = a.clone()
                else:
                    p.grad.copy_(a)
            self.optimizer.step()
            torch._foreach_zero_(self.acc)
            self.count.zero_()
        else:
            self.count += 1
        self.advance()

    def state_dict(self) -> Dict[str, Any]:
        sd = self.optimizer.state_dict()
        sd["accumulation"] = {"k": self.k, "mini": self.mini,
                              "acc": [a.detach().cpu() for a in self.acc]}
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        sd = dict(sd)
        saved = sd.pop("accumulation", None)
        self.optimizer.load_state_dict(sd)
        with torch.no_grad():
            if saved is None:
                self.mini = 0
                torch._foreach_zero_(self.acc)
            else:
                if saved["k"] != self.k:
                    raise ValueError(f"checkpoint accumulates over "
                                     f"{saved['k']} steps, not {self.k}")
                self.mini = int(saved["mini"])
                for a, b in zip(self.acc, saved["acc"]):
                    a.copy_(b)
            self.count.fill_(self.mini)


def with_grad_accumulation(optimizer: torch.optim.Optimizer,
                           accum_steps: int):
    """The optimizer itself for ``accum_steps <= 1``, else a
    ``GradAccumulation`` of ``accum_steps`` micro-steps around it."""
    if accum_steps <= 1:
        return optimizer
    return GradAccumulation(optimizer, accum_steps)


@dataclasses.dataclass
class CapturedStep:
    """One train step captured as a CUDA graph, with the static tensors it
    reads and writes."""

    graph: Any                         # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]   # what it gathers from (kept alive)
    generator: torch.Generator         # registered with the graph
    idx: torch.Tensor                  # the index row of the next replay
    metrics: torch.Tensor              # (2,): loss and accuracy %
    draws: Any                         # the augmentation draws of the
    #                                    last replay


def graphed_epoch(
    graphs: Dict[tuple, CapturedStep],
    state: TrainState,
    inputs: Sequence[torch.Tensor],
    idx_mat: torch.Tensor,
    generator: torch.Generator,
    eager_step: Callable[[TrainState, torch.Tensor],
                         Tuple[TrainState, Metrics]],
    body: Callable[[torch.Tensor], Tuple[Metrics, Any]],
    schedule: Optional[GradAccumulation] = None,
) -> Tuple[TrainState, Metrics]:
    """One step per row of ``idx_mat`` on a CUDA device, replays of one
    captured step (module docstring); returns (state, (losses, accs)) as
    device tensors of shape (steps,).

    ``eager_step(state, row)`` takes one eager step on an index row and
    counts it in ``state.step``. ``body(idx)`` is the step as captured: it
    reads its row from the static buffer ``idx`` and returns its
    ``(loss, accuracy)`` and its augmentation draws. ``inputs`` are the
    device tensors the step gathers from; the capture, kept in ``graphs``,
    is keyed by them, the row shape and its kind, and holds them alive.

    ``schedule`` (gradient accumulation) names the captured steps
    (``kinds``) and the kind of the next one (``next_kind()``); each is
    captured under ``capturing(kind)``, after eager steps that leave the
    optimizer ``ready()`` (more than WARMUP_STEPS where its first step
    comes later), and each replay is counted by ``advance()``. All
    captures come right after the warm-up, before the first replay and
    also where the warm-up took every row: a capture waits for the
    device, a replay does not."""
    if any(t.device != idx_mat.device for t in inputs):
        raise ValueError("a CUDA epoch takes its index matrix on the "
                         "dataset's device")
    return graphed_steps(graphs, state, inputs, iter(idx_mat),
                         idx_mat.shape[0], idx_mat[0], generator,
                         eager_step, body, schedule)


def graphed_steps(
    graphs: Dict[tuple, CapturedStep],
    state: TrainState,
    inputs: Sequence[torch.Tensor],
    rows: Iterator[torch.Tensor],
    steps: int,
    like: torch.Tensor,
    generator: torch.Generator,
    eager_step: Callable[[TrainState, torch.Tensor],
                         Tuple[TrainState, Metrics]],
    body: Callable[[torch.Tensor], Tuple[Metrics, Any]],
    schedule: Optional[GradAccumulation] = None,
) -> Tuple[TrainState, Metrics]:
    """``graphed_epoch`` over ``steps`` rows taken one at a time from the
    iterator ``rows``, each a device tensor shaped like ``like``: index
    rows, or whole batches streamed from the host (``train/streaming.py``,
    with no ``inputs``). Each row is taken only when its step runs, on the
    stream that runs it: the warm-up's side stream, or the current stream,
    where it is copied into the captured step's static row."""
    dev = like.device
    if generator.device.type != "cuda":
        raise ValueError("a captured step draws from a CUDA generator")
    out = torch.empty((2, steps), device=dev)
    key = (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in inputs),
           tuple(like.shape), like.dtype)
    kinds = (None,) if schedule is None else schedule.kinds
    first = 0
    if (key, kinds[0]) not in graphs:
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            while first < steps and (first < WARMUP_STEPS or not (
                    schedule is None or schedule.ready())):
                state, metrics = eager_step(state, next(rows))
                out[:, first] = torch.stack(metrics)
                first += 1
        main.wait_stream(side)
        if schedule is not None and not schedule.ready():
            # Every row went eagerly and the optimizer has not stepped:
            # nothing can be captured yet.
            return state, (out[0], out[1])
        for kind in kinds:
            with (contextlib.nullcontext() if schedule is None
                  else schedule.capturing(kind)):
                graphs[key, kind] = _capture(inputs, like, generator, body)
    elif graphs[key, kinds[0]].generator is not generator:
        raise ValueError("the captured step draws from the generator "
                         "it was captured with")
    for i in range(first, steps):
        rec = graphs[key, None if schedule is None
                     else schedule.next_kind()]
        rec.idx.copy_(next(rows))
        rec.graph.replay()
        out[:, i].copy_(rec.metrics)
        if schedule is not None:
            schedule.advance()
    state.step += steps - first
    return state, (out[0], out[1])


def _capture(inputs: Sequence[torch.Tensor], like: torch.Tensor,
             generator: torch.Generator,
             body: Callable[[torch.Tensor], Tuple[Metrics, Any]]
             ) -> CapturedStep:
    idx = torch.zeros_like(like)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        metrics, draws = body(idx)
        metrics = torch.stack(metrics)
    return CapturedStep(graph, tuple(inputs), generator, idx, metrics, draws)


@dataclasses.dataclass
class History:
    """Loss/accuracy history dicts (reference: utils/model_utils.py:84-86,
    137-140), serialised into checkpoints."""

    loss: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {"train": [], "valid": []})
    accuracy: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {"train": [], "valid": []})

    def append(self, split: str, loss: float, acc: float) -> None:
        self.loss[split].append(float(loss))
        self.accuracy[split].append(float(acc))

    def to_dict(self) -> Dict[str, Any]:
        return {"loss": self.loss, "accuracy": self.accuracy}

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "History":
        h = History()
        if d:
            h.loss = {k: list(v) for k, v in d["loss"].items()}
            h.accuracy = {k: list(v) for k, v in d["accuracy"].items()}
        return h
