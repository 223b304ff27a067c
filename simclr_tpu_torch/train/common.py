"""Shared training machinery: train state and torch-semantics optimizers.

Counterpart of ``simclr_tpu/train/common.py``. The JAX state is an
immutable pytree threaded through jitted steps; here the module and the
optimizer are updated in place and the state only bundles them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

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
               eps: float = 1e-8) -> torch.optim.Optimizer:
    """Adam with the L2 term added to the raw gradient before the moments
    (``torch.optim.Adam(weight_decay=...)``, not AdamW), as the JAX side's
    ``adam_torch`` chain does (reference: pretrain.py:80)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def with_grad_accumulation(optimizer: torch.optim.Optimizer,
                           accum_steps: int) -> torch.optim.Optimizer:
    """The optimizer itself for ``accum_steps <= 1``. Accumulating
    micro-batch gradients (reference: utils/model_utils.py:116-123) is
    ported in a later PR."""
    if accum_steps > 1:
        raise NotImplementedError(
            "gradient accumulation is ported in a later PR")
    return optimizer
