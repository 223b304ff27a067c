"""Shared training machinery: train state, torch-semantics optimizers and
the metrics history.

Counterpart of ``simclr_tpu/train/common.py``. The JAX state is an
immutable pytree threaded through jitted steps; here the module and the
optimizer are updated in place and the state only bundles them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.nn as nn


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
