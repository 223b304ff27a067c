"""ctypes bindings for the port's native data plane (``dataplane.cpp``).

Counterpart of ``simclr_tpu/data/native/__init__.py``, over the port's own
copy of the C++ source (same C ABI). The shared library is built with g++
at first use into the git-ignored ``simclr_tpu_torch/_build/``, in a
directory keyed by a hash of the source, the flags and the host's CPU, and
reused while that key holds; it is never built beside the source, and
nothing is built on import. ``-march=native`` is safe only because the
library is built on the machine that loads it: the host's CPU is part of
the key, so a copied build directory from another machine is rebuilt.

The decoders return None where the library cannot be built or loaded, and
``data/datasets.py`` then decodes in numpy. ``NativePipeline`` raises
there, as the JAX package's does.

``NativePipeline`` fills one of two host buffers per ``next()``. For a
CUDA consumer they are pinned, so that ``next_device()`` copies a batch to
the card asynchronously on a side stream; a buffer is not refilled until
the copy from it has finished (a CUDA event per buffer, waited for on the
host only when that buffer comes round again).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "dataplane.cpp"
BUILD_DIR = _HERE.parents[1] / "_build"
LIB_NAME = "libdataplane.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lib = None
_lib_lock = threading.Lock()


def _host_cpu() -> str:
    """The CPU's model name and feature flags, part of the build key."""
    fields = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    fields.append(line.strip())
                if len(fields) >= 3:
                    break
    except OSError:
        pass
    return "\n".join(fields)


def library_path() -> Path:
    """Where the library for this source, these flags and this host's CPU
    lives (built or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"dataplane-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the source if its library is not built yet; return its path.
    Raises where g++ fails."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = Path(tmp) / LIB_NAME
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(out)],
                       check=True, capture_output=True, timeout=300)
        os.replace(out, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.decode_cifar10_binary.restype = i64
    lib.decode_cifar10_binary.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          u8p, i32p]
    lib.decode_stl10.restype = i64
    lib.decode_stl10.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u8p, i32p]
    lib.pipeline_create.restype = ctypes.c_void_p
    lib.pipeline_create.argtypes = [u8p, i32p, i64, i64, i64,
                                    ctypes.c_uint64]
    lib.pipeline_next.restype = ctypes.c_int
    lib.pipeline_next.argtypes = [ctypes.c_void_p, u8p, i32p]
    lib.pipeline_steps_per_epoch.restype = i64
    lib.pipeline_steps_per_epoch.argtypes = [ctypes.c_void_p]
    lib.pipeline_destroy.restype = None
    lib.pipeline_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if it cannot be
    built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, subprocess.SubprocessError) as e:
                warnings.warn(f"native data plane unavailable ({e}); "
                              "using numpy fallbacks")
                return None
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def decode_cifar10_binary(
    bin_dir: str, train: bool
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native CIFAR-10 binary decode; None if the library is unavailable or
    the files do not decode (callers fall back to the numpy decoder in
    datasets.py)."""
    lib = load_library()
    if lib is None:
        return None
    n_max = 50_000 if train else 10_000
    images = np.empty((n_max, 32, 32, 3), np.uint8)
    labels = np.empty((n_max,), np.int32)
    n = lib.decode_cifar10_binary(
        bin_dir.encode(), int(train), _u8ptr(images), _i32ptr(labels))
    if n <= 0:
        return None
    return images[:n], labels[:n]


def decode_stl10(
    x_path: str, y_path: Optional[str], n_samples: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native STL-10 decode of ``n_samples`` images (labels -1 without a
    label file); None if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    images = np.empty((n_samples, 96, 96, 3), np.uint8)
    labels = np.full((n_samples,), -1, np.int32)
    n = lib.decode_stl10(
        x_path.encode(), (y_path or "").encode(),
        _u8ptr(images), _i32ptr(labels))
    if n <= 0:
        return None
    return images[:n], labels[:n]


class NativePipeline:
    """Double-buffered shuffled batch assembler backed by a C++ worker
    thread: the next batch is gathered while the caller consumes this one.
    Each epoch is a new shuffle of all rows (std::mt19937_64 from
    ``seed``); the remainder of n // batch_size is dropped.

    ``device``: where the batches go. For a CUDA device the two output
    buffers are pinned host tensors and ``next_device()`` copies from them
    asynchronously (module docstring)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0,
                 device: "str | torch.device" = "cpu"):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native data plane unavailable")
        self._lib = lib
        self._images = np.ascontiguousarray(images)  # kept alive (borrowed)
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        self.batch_size = batch_size
        self.sample_shape = tuple(images.shape[1:])
        self.device = torch.device(device)
        self._handle = lib.pipeline_create(
            _u8ptr(self._images), _i32ptr(self._labels), images.shape[0],
            int(np.prod(self.sample_shape)), batch_size, seed)
        if not self._handle:
            raise ValueError("pipeline_create failed (batch > n?)")
        self.steps_per_epoch = lib.pipeline_steps_per_epoch(self._handle)
        pin = self.device.type == "cuda"
        self._out = [
            (torch.empty((batch_size,) + self.sample_shape, dtype=torch.uint8,
                         pin_memory=pin),
             torch.empty((batch_size,), dtype=torch.int32, pin_memory=pin))
            for _ in range(2)]
        # The copy last issued from each buffer (CUDA consumers only).
        self._copied = [None, None]
        self._stream = None
        self._slot = 0

    def next(self, copy: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking; returns the next shuffled batch.

        By default an owned copy. ``copy=False`` returns views of one of
        the two internal buffers, valid until the second following call;
        a buffer is refilled only after the device copy last issued from
        it by ``next_device()`` has finished."""
        slot = self._slot
        self._slot ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
            self._copied[slot] = None
        imgs, labs = (t.numpy() for t in self._out[slot])
        self._lib.pipeline_next(self._handle, _u8ptr(imgs), _i32ptr(labs))
        if copy:
            return imgs.copy(), labs.copy()
        return imgs, labs

    def next_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The next batch as tensors on ``device``. On CUDA the copy runs
        from the pinned buffer on a side stream, and the caller's current
        stream waits for it: the host does not."""
        slot = self._slot
        imgs, labs = self.next(copy=False)
        if self.device.type != "cuda":
            return torch.from_numpy(imgs.copy()), torch.from_numpy(labs.copy())
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        host_imgs, host_labs = self._out[slot]
        with torch.cuda.stream(self._stream):
            d_imgs = host_imgs.to(self.device, non_blocking=True)
            d_labs = host_labs.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        consumer.wait_event(done)
        d_imgs.record_stream(consumer)
        d_labs.record_stream(consumer)
        return d_imgs, d_labs

    def close(self) -> None:
        if getattr(self, "_handle", None):
            for ev in self._copied:
                if ev is not None:
                    ev.synchronize()
            self._lib.pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
