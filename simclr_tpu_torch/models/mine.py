"""MINE statistics network T(x, z) (reference: mine.py:5-18).

Counterpart of ``simclr_tpu/models/mine.py``: a float32 MLP, input ->
hidden -> hidden -> 1 with ELU activations, its layers named ``fc1``,
``fc2`` and ``out`` as in the JAX parameter tree, so
``utils/weights.py`` carries the weights both ways. The default input is
two 2048-d representations side by side (reference:
training_others/train_mine.py:16-19).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simclr_tpu_torch.models.resnet import Linear


class MineNet(nn.Module):

    def __init__(self, in_features: int, hidden_size: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f32 = torch.float32
        self.fc1 = Linear(in_features, hidden_size, dtype=f32,
                          generator=generator)
        self.fc2 = Linear(hidden_size, hidden_size, dtype=f32,
                          generator=generator)
        self.out = Linear(hidden_size, 1, dtype=f32, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.fc1(x))
        x = F.elu(self.fc2(x))
        return self.out(x)
