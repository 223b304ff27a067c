"""Device-resident data pipeline.

Counterpart of ``simclr_tpu/data/pipeline.py``: the whole dataset lives on
the device as uint8 NHWC, an epoch is an on-device permutation shaped into
an index matrix, and a batch is a row gather from it. ``make_split``
decides which samples live where for each training mode, with the JAX
package's indices; augmentation runs inside the engine's step.

``infinite_stream`` yields shuffled batches without end.

For datasets kept on the host there is ``host_stream``, a double-buffered
host-to-device feed (JAX: ``host_stream``, an asynchronous
``jax.device_put`` of the next batch while the current one computes):
each batch is gathered on the host into a pinned staging buffer and
copied with ``non_blocking`` on a side CUDA stream, and the consumer's
stream waits on that copy's event, so the copy of batch t + prefetch
overlaps step t.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.datasets import load_dataset
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


@dataclasses.dataclass
class Split:
    train: DeviceDataset
    val: Optional[DeviceDataset] = None


def split_indices(n: int, val_fraction: float,
                  seed: int = SPLIT_SEED) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic 80/20-style split (reference: data.py:315-317); the
    same indices as the JAX package's."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = int(val_fraction * n)
    return perm[n_val:], perm[:n_val]


def class_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample weights 1/class-count (reference: data.py:220-238)."""
    counts = np.bincount(labels, minlength=labels.max() + 1)
    return 1.0 / counts[labels]


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


def weighted_sample_indices(generator: torch.Generator,
                            weights: torch.Tensor, num_samples: int,
                            batch_size: int) -> torch.Tensor:
    """Weighted-with-replacement epoch indices shaped (steps, batch_size)
    on the generator's device, the remainder dropped (reference:
    data.py:383-392, WeightedRandomSampler semantics): each index is drawn
    with probability proportional to its weight."""
    idx = torch.multinomial(weights.to(generator.device), num_samples,
                            replacement=True, generator=generator)
    steps = num_samples // batch_size
    return idx[: steps * batch_size].reshape(steps, batch_size)


def take_batch(ds: DeviceDataset, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather one batch by indices, on the dataset's device."""
    return ds.images.index_select(0, idx), ds.labels.index_select(0, idx)


def iterate_epoch(
    ds: DeviceDataset, generator: torch.Generator, batch_size: int,
    drop_remainder: bool = True,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Shuffled batches of one epoch; ``generator`` lives on the dataset's
    device."""
    idx = epoch_permutation(generator, ds.n, batch_size, drop_remainder)
    for step in range(idx.shape[0]):
        yield take_batch(ds, idx[step])


def infinite_stream(
    ds: DeviceDataset, generator: torch.Generator, batch_size: int,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Shuffled batches of one epoch after another, without end (for
    MINE; fixes the reference's per-iteration DataLoader rebuild,
    mine.py:38-39)."""
    while True:
        yield from iterate_epoch(ds, generator, batch_size)


def iterate_sequential(
    ds: DeviceDataset, batch_size: int,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Unshuffled iteration incl. the final partial batch (test loaders,
    reference: data.py:425-434 shuffle=False)."""
    for start in range(0, ds.n, batch_size):
        stop = min(start + batch_size, ds.n)
        yield ds.images[start:stop], ds.labels[start:stop]


def host_stream(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    generator: torch.Generator,
    prefetch: int = 2,
    device: "str | torch.device" = "cuda",
    mesh=None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """One epoch of shuffled (images, labels) batches from host arrays, on
    ``device``, the remainder dropped.

    The permutation is ``epoch_permutation(generator, n, batch_size)``'s,
    drawn when this is called (so a resident epoch over the same generator
    takes the same rows, and the step draws that follow are the same). On
    CUDA each batch is gathered into one of ``prefetch + 1`` pinned staging
    buffers and copied on a side stream; a staging buffer is refilled only
    once the copy from it has finished (its CUDA event), and the stream
    current when a batch is taken waits for that batch's copy (the host
    does not). With a ``mesh`` (``parallel/mesh.py``) each batch is this
    rank's contiguous slice of the global batch."""
    dev = resolve_device(device)
    idx_mat = epoch_permutation(generator, images.shape[0],
                                batch_size).cpu().numpy()
    if mesh is not None and mesh.size > 1:
        from simclr_tpu_torch.parallel.mesh import shard_batch

        idx_mat = np.stack([shard_batch(row, mesh) for row in idx_mat])
    labels = np.asarray(labels, np.int32)
    if dev.type != "cuda":
        return ((torch.from_numpy(images[row]), torch.from_numpy(labels[row]))
                for row in idx_mat)
    return _cuda_stream(images, labels, idx_mat, prefetch, dev)


def _cuda_stream(images: np.ndarray, labels: np.ndarray, idx_mat: np.ndarray,
                 prefetch: int, dev: torch.device
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    m = idx_mat.shape[1]
    slots = [(torch.empty((m,) + images.shape[1:], dtype=torch.uint8,
                          pin_memory=True),
              torch.empty((m,), dtype=torch.int32, pin_memory=True))
             for _ in range(prefetch + 1)]
    copied: List[Optional[torch.cuda.Event]] = [None] * len(slots)
    side = torch.cuda.Stream(dev)

    def put(step):
        s = step % len(slots)
        if copied[s] is not None:
            copied[s].synchronize()
        host_imgs, host_labs = slots[s]
        np.take(images, idx_mat[step], axis=0, out=host_imgs.numpy())
        np.take(labels, idx_mat[step], axis=0, out=host_labs.numpy())
        with torch.cuda.stream(side):
            out = (host_imgs.to(dev, non_blocking=True),
                   host_labs.to(dev, non_blocking=True))
            copied[s] = torch.cuda.Event()
            copied[s].record(side)
        return out, copied[s]

    steps = idx_mat.shape[0]
    buf = [put(i) for i in range(min(prefetch, steps))]
    for step in range(steps):
        if step + prefetch < steps:
            buf.append(put(step + prefetch))
        batch, done = buf.pop(0)
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in batch:
            t.record_stream(consumer)
        yield batch


def make_split(cfg: Config, mode: str,
               device: "str | torch.device" = "cuda") -> Split:
    """The device-resident datasets of a training mode, as the JAX
    package's ``make_split`` chooses them (reference:
    get_cifar10_dataloader/get_stl10_dataloader, data.py:271-529):
    'pretrain', 'lin_eval', 'fine_tune', 'supervised_bm', 'test'."""
    name = cfg.dataset.name
    val_frac = cfg.train.val_fraction

    def split(images, labels):
        tr, va = split_indices(images.shape[0], val_frac)
        return Split(
            DeviceDataset.from_numpy(images[tr], labels[tr], device),
            DeviceDataset.from_numpy(images[va], labels[va], device))

    if mode == "pretrain":
        split_name = "unlabeled" if name == "stl10" else "train"
        return split(*load_dataset(name, split_name, cfg.data_dir))
    if mode in ("lin_eval", "supervised_bm"):
        return split(*load_dataset(name, "train", cfg.data_dir))
    if mode == "fine_tune":
        images, labels = load_dataset(name, "train", cfg.data_dir)
        if cfg.train.ssl_label_size >= 1.0:
            return split(images, labels)
        # 10%-label regime: the whole labelled pool on the device; the
        # trainer draws weighted samples per epoch (no val split -
        # reference: data.py:381-392).
        return Split(DeviceDataset.from_numpy(images, labels, device))
    if mode == "test":
        images, labels = load_dataset(name, "test", cfg.data_dir)
        return Split(DeviceDataset.from_numpy(images, labels, device))
    raise NotImplementedError(f"unknown mode {mode!r}")
