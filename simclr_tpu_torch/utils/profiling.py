"""Tracing, profiling and structured metrics logging.

Counterpart of ``simclr_tpu/utils/profiling.py``:

  * ``trace(logdir)``: a ``torch.profiler`` trace (host and, on a card,
    device timelines) written as a Chrome trace into ``logdir``, which
    TensorBoard's profile plugin and chrome://tracing read.
  * ``annotate(name)`` / ``StepTimer``: named host regions, and wall-clock
    statistics over steps that wait for the device before stopping the
    clock (CUDA launches return before the work is done).
  * ``MetricsLogger``: an append-only JSONL log, one object per record,
    key for key the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``torch.profiler`` trace around a code region, written to
    ``logdir`` as ``<worker>.<ms>.pt.trace.json`` when the region ends."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Named host region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def block_on(tree: Any) -> None:
    """Wait for the device that holds the first tensor of ``tree`` (nested
    lists, tuples and dicts); a no-op for CPU tensors."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class StepTimer:
    """Wall-clock statistics over step durations."""

    def __init__(self) -> None:
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result_tree: Any = None) -> float:
        if result_tree is not None:
            block_on(result_tree)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.durations.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self, result_container: Optional[list] = None):
        self.start()
        yield
        self.stop(result_container)

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "n": int(d.size),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "steps_per_sec": float(1.0 / d.mean()),
        }


class MetricsLogger:
    """Append-only JSONL metrics stream. Numbers (Python, numpy, or
    one-element tensors) are written as floats, anything else as given."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.numel() == 1:
                v = v.item()
            rec[k] = float(v) if isinstance(
                v, (int, float, np.floating, np.integer)) else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
