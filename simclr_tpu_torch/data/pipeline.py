"""Device-resident data pipeline.

Counterpart of ``simclr_tpu/data/pipeline.py``: the whole dataset lives on
the device as uint8 NHWC, an epoch is an on-device permutation shaped into
an index matrix, and a batch is a row gather from it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from simclr_tpu_torch.utils.device import resolve_device

SPLIT_SEED = 42  # reference: data.py:304 (np.random.seed(42)).


@dataclasses.dataclass
class DeviceDataset:
    """A whole dataset living in device memory."""

    images: torch.Tensor  # (N, H, W, C) uint8
    labels: torch.Tensor  # (N,) int32

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @staticmethod
    def from_numpy(images: np.ndarray, labels: np.ndarray,
                   device: "str | torch.device" = "cuda") -> "DeviceDataset":
        dev = resolve_device(device)
        return DeviceDataset(
            torch.from_numpy(np.ascontiguousarray(images)).to(dev),
            torch.from_numpy(np.asarray(labels, np.int32)).to(dev))


def split_indices(n: int, val_fraction: float,
                  seed: int = SPLIT_SEED) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic 80/20-style split (reference: data.py:315-317); the
    same indices as the JAX package's."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = int(val_fraction * n)
    return perm[n_val:], perm[:n_val]


def epoch_permutation(generator: torch.Generator, n: int, batch_size: int,
                      drop_remainder: bool = True) -> torch.Tensor:
    """Shuffled index matrix (steps, batch_size) on the generator's
    device."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    steps = n // batch_size
    if not drop_remainder and steps * batch_size < n:
        pad = batch_size - (n - steps * batch_size)
        perm = torch.cat([perm, perm[:pad]])
        steps += 1
    return perm[: steps * batch_size].reshape(steps, batch_size)


def take_batch(ds: DeviceDataset, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather one batch by indices, on the dataset's device."""
    return ds.images.index_select(0, idx), ds.labels.index_select(0, idx)
