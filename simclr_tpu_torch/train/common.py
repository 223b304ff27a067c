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

A capture that fails raises; a CUDA epoch never falls back to the eager
loop.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple)

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


def with_grad_accumulation(optimizer: torch.optim.Optimizer,
                           accum_steps: int) -> torch.optim.Optimizer:
    """The optimizer itself for ``accum_steps <= 1``. Accumulating
    micro-batch gradients (reference: utils/model_utils.py:116-123) is
    ported in a later PR."""
    if accum_steps > 1:
        raise NotImplementedError(
            "gradient accumulation is ported in a later PR")
    return optimizer


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
) -> Tuple[TrainState, Metrics]:
    """One step per row of ``idx_mat`` on a CUDA device, replays of one
    captured step (module docstring); returns (state, (losses, accs)) as
    device tensors of shape (steps,).

    ``eager_step(state, row)`` takes one eager step on an index row and
    counts it in ``state.step``. ``body(idx)`` is the step as captured: it
    reads its row from the static buffer ``idx`` and returns its
    ``(loss, accuracy)`` and its augmentation draws. ``inputs`` are the
    device tensors the step gathers from; the capture, kept in ``graphs``,
    is keyed by them and the row shape, and holds them alive."""
    dev = idx_mat.device
    if (any(t.device != dev for t in inputs)
            or generator.device.type != "cuda"):
        raise ValueError("a CUDA epoch takes its index matrix on the "
                         "dataset's device and a CUDA generator")
    steps = idx_mat.shape[0]
    out = torch.empty((2, steps), device=dev)
    key = (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in inputs),
           tuple(idx_mat.shape[1:]), idx_mat.dtype)
    rec, first = graphs.get(key), 0
    if rec is None:
        first = min(WARMUP_STEPS, steps)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for i in range(first):
                state, metrics = eager_step(state, idx_mat[i])
                out[:, i] = torch.stack(metrics)
        main.wait_stream(side)
        rec = graphs[key] = _capture(inputs, idx_mat, generator, body)
    elif rec.generator is not generator:
        raise ValueError("the captured step draws from the generator "
                         "it was captured with")
    for i in range(first, steps):
        rec.idx.copy_(idx_mat[i])
        rec.graph.replay()
        out[:, i].copy_(rec.metrics)
    state.step += steps - first
    return state, (out[0], out[1])


def _capture(inputs: Sequence[torch.Tensor], idx_mat: torch.Tensor,
             generator: torch.Generator,
             body: Callable[[torch.Tensor], Tuple[Metrics, Any]]
             ) -> CapturedStep:
    idx = torch.zeros_like(idx_mat[0])
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
