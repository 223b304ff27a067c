"""Host-streaming pretraining for datasets kept on the host.

Counterpart of ``simclr_tpu/train/streaming.py``. The default pipeline
keeps the whole dataset on the device (``data/pipeline.py``); here the
uint8 batches stay on the host, gathered by numpy into pinned staging
buffers (``data/pipeline.py:host_stream``) or assembled by the C++ data
plane's worker thread (``data/native``), and copied to the card on a side
stream while the previous step computes. The step is the engine's
gather-free ``train_step_direct``; on CUDA every streamed step is a replay
of one captured step (``PretrainEngine.train_stream``): the batch is
copied into the graph's static batch on the step's stream just before the
replay, a device-to-device copy, so the host-to-device copy still overlaps
the previous step.

Each epoch draws its permutation and its augmentation from
``train/pretrain.py:epoch_seed``, as the resident ``pretrain`` does (JAX
folds the epoch into a key). The host reads the losses once an epoch.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import host_stream
from simclr_tpu_torch.train.common import History
from simclr_tpu_torch.train.pretrain import (
    PretrainResult, build_engine, epoch_seed, init_simclr)
from simclr_tpu_torch.utils.device import resolve_device


def pretrain_streaming(
    cfg: Config,
    images: np.ndarray,                  # (N, H, W, C) uint8, host
    labels: Optional[np.ndarray] = None,
    n_epochs: Optional[int] = None,
    use_native_pipeline: bool = False,
    log: Callable[[str], None] = print,
    device: "str | torch.device" = "cuda",
) -> PretrainResult:
    """Pretrain from a host-resident uint8 dataset with double-buffered
    device feeding. ``use_native_pipeline=True`` assembles shuffled
    batches in the C++ data plane's worker thread (its own shuffle, seeded
    by ``cfg.train.seed``) instead of numpy gathers of a torch
    permutation. ``steps_per_sec`` counts every epoch, the first one's
    warm-up and capture included; ``steady_steps_per_sec`` is the median
    rate of the others (the first, where only one ran)."""
    dev = resolve_device(device)
    tcfg = cfg.train
    n_epochs = n_epochs or tcfg.n_epoch
    batch = tcfg.batch_size
    model, state, opt = init_simclr(cfg, tcfg.seed, dev)
    engine = build_engine(cfg, model, opt)
    if labels is None:
        labels = np.zeros((images.shape[0],), np.int32)

    native_pipe = None
    if use_native_pipeline:
        from simclr_tpu_torch.data.native import NativePipeline

        native_pipe = NativePipeline(images, labels, batch, seed=tcfg.seed,
                                     device=dev)
    gen = torch.Generator(device=dev)
    like = torch.empty((batch,) + images.shape[1:], dtype=torch.uint8,
                       device=dev)
    history = History()
    steps_per_epoch = images.shape[0] // batch
    total_steps, t_train, epoch_secs = 0, 0.0, []
    try:
        for epoch in range(n_epochs):
            gen.manual_seed(epoch_seed(tcfg.seed, epoch))
            t0 = time.perf_counter()
            if native_pipe is not None:
                batches = (native_pipe.next_device()[0]
                           for _ in range(steps_per_epoch))
            else:
                batches = (b for b, _ in host_stream(images, labels, batch,
                                                     gen, device=dev))
            state, (losses, accs) = engine.train_stream(
                state, batches, steps_per_epoch, like, gen)
            losses, accs = losses.cpu().numpy(), accs.cpu().numpy()
            epoch_secs.append(time.perf_counter() - t0)
            t_train += epoch_secs[-1]
            total_steps += steps_per_epoch
            history.append("train", losses.mean(), accs.mean())
            log(f"Epoch: {epoch + 1} | Loss = {losses.mean():.4f} | "
                f"Accuracy = {accs.mean():.4f}%")
    finally:
        if native_pipe is not None:
            native_pipe.close()

    sps = total_steps / t_train if t_train > 0 else 0.0
    warm = epoch_secs[1:] or epoch_secs
    steady = steps_per_epoch / float(np.median(warm)) if warm else sps
    return PretrainResult(state=state, history=history, export_path=None,
                          steps_per_sec=sps, steady_steps_per_sec=steady)
