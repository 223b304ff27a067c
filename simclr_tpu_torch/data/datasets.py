"""Dataset decoding: CIFAR-10 / STL-10 binaries -> uint8 NHWC arrays.

The port's copy of ``simclr_tpu/data/datasets.py``: the whole dataset is
decoded once into one contiguous uint8 NHWC array, and ``data/pipeline.py``
puts it on the device. The binary formats are decoded by the port's C++
data plane (``data/native``) first, as the JAX package does, and in numpy
where that library cannot be built; the two give the same bytes.

Supported on-disk formats:
  * CIFAR-10 python pickles  (cifar-10-batches-py/data_batch_*, test_batch)
  * CIFAR-10 binary          (cifar-10-batches-bin/data_batch_*.bin)
  * STL-10 binary            (stl10_binary/{train,test,unlabeled}_X.bin)

When no on-disk copy exists, `load_dataset` falls back to a deterministic
class-structured synthetic set, byte-identical to the JAX package's for the
same arguments.
"""

from __future__ import annotations

import os
import pickle
import warnings
import zlib
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]  # (images uint8 NHWC, labels int32)

CIFAR10_CLASSES = (
    "airplane automobile bird cat deer dog frog horse ship truck".split()
)
STL10_CLASSES = (
    "airplane bird car cat deer dog horse monkey ship truck".split()
)


# ---------------------------------------------------------------------------
# CIFAR-10
# ---------------------------------------------------------------------------

def _load_cifar10_python(batch_dir: str, train: bool) -> Arrays:
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    imgs, labels = [], []
    for name in files:
        with open(os.path.join(batch_dir, name), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        imgs.append(np.asarray(entry["data"], np.uint8))
        labels.extend(entry.get("labels", entry.get("fine_labels")))
    data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
    return (np.ascontiguousarray(data.transpose(0, 2, 3, 1)),
            np.asarray(labels, np.int32))


def _load_cifar10_binary(batch_dir: str, train: bool) -> Arrays:
    from simclr_tpu_torch.data import native

    decoded = native.decode_cifar10_binary(batch_dir, train)
    if decoded is not None:
        return decoded
    return _cifar10_binary_numpy(batch_dir, train)


def _cifar10_binary_numpy(batch_dir: str, train: bool) -> Arrays:
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    rows = []
    for name in files:
        raw = np.fromfile(os.path.join(batch_dir, name), np.uint8)
        rows.append(raw.reshape(-1, 3073))  # 1 label byte + 3072 pixels
    raw = np.concatenate(rows)
    labels = raw[:, 0].astype(np.int32)
    data = raw[:, 1:].reshape(-1, 3, 32, 32)
    return np.ascontiguousarray(data.transpose(0, 2, 3, 1)), labels


def load_cifar10(data_dir: str, train: bool = True) -> Optional[Arrays]:
    py_dir = os.path.join(data_dir, "cifar-10-batches-py")
    if os.path.isdir(py_dir):
        return _load_cifar10_python(py_dir, train)
    bin_dir = os.path.join(data_dir, "cifar-10-batches-bin")
    if os.path.isdir(bin_dir):
        return _load_cifar10_binary(bin_dir, train)
    return None


# ---------------------------------------------------------------------------
# STL-10
# ---------------------------------------------------------------------------

def load_stl10(data_dir: str, split: str = "unlabeled") -> Optional[Arrays]:
    """split: 'train' | 'test' | 'unlabeled'. STL-10 stores CHW
    *column-major within each channel* (i.e. transposed HW), which the
    reference undoes with np.transpose(img, (1, 2, 0)) on CHW data after
    torchvision's own reshape (reference: data.py:87)."""
    base = os.path.join(data_dir, "stl10_binary")
    x_path = os.path.join(base, f"{split}_X.bin")
    if not os.path.isfile(x_path):
        return None
    from simclr_tpu_torch.data import native

    y_path = os.path.join(base, f"{split}_y.bin")
    decoded = native.decode_stl10(
        x_path, y_path if os.path.isfile(y_path) else None,
        os.path.getsize(x_path) // (3 * 96 * 96))
    if decoded is not None:
        return decoded
    return _stl10_numpy(x_path, y_path)


def _stl10_numpy(x_path: str, y_path: str) -> Arrays:
    raw = np.fromfile(x_path, np.uint8).reshape(-1, 3, 96, 96)
    # Channels stored column-major: transpose each channel's axes, then CHW->HWC.
    imgs = np.ascontiguousarray(raw.transpose(0, 3, 2, 1))
    if os.path.isfile(y_path):
        labels = np.fromfile(y_path, np.uint8).astype(np.int32) - 1  # 1-based
    else:
        labels = np.full((imgs.shape[0],), -1, np.int32)
    return imgs, labels


def is_real_data(name: str, data_dir: str = "data") -> bool:
    """True when an on-disk copy of `name` exists under `data_dir` (i.e.
    `load_dataset` will NOT fall back to the synthetic stand-in)."""
    if name == "cifar10":
        return (os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py"))
                or os.path.isdir(
                    os.path.join(data_dir, "cifar-10-batches-bin")))
    if name == "stl10":
        return os.path.isfile(
            os.path.join(data_dir, "stl10_binary", "unlabeled_X.bin"))
    return False


# ---------------------------------------------------------------------------
# Synthetic fallback
# ---------------------------------------------------------------------------

def synthetic_dataset(
    n: int,
    img_size: int = 32,
    n_classes: int = 10,
    seed: int = 0,
    difficulty: str = "hard",
    intra_scale: float = 1.5,
    cache_dir: Optional[str] = None,
) -> Arrays:
    """Deterministic class-structured images.

    ``difficulty='easy'`` (the original stand-in): each class has a
    characteristic low-frequency colour pattern plus mild noise — nearly
    linearly separable, useful for pipeline-mechanics tests, but
    NON-discriminative for accuracy experiments: every model variant hits
    ~100% linear eval on it.

    ``difficulty='hard'`` (default, used by `load_dataset`): images are
    rendered from a 24-pattern low-frequency basis. Only 8 basis
    coefficients carry class signal (distinct class means); the other 16
    are large-amplitude per-sample nuisance. On top: per-sample
    class-mean-relative latent noise (``intra_scale``), random per-channel
    gain/bias (colour is unreliable), and pixel noise. Class overlap is
    real (Bayes error well above zero), so linear-eval accuracy lands in a
    regime where a 0.5%-level accuracy difference between model variants
    is measurable rather than saturated at 100%.

    The basis/class structure comes from a FIXED RandomState so train and
    test splits (different ``seed``) share the same classes.

    ``cache_dir``: if given, the generated arrays are memoized on disk —
    rendering 50k images takes minutes of float64 numpy on one core. The
    cache key pins every generation parameter, so the
    arrays stay bit-identical to an uncached run.
    """
    cache = None
    if cache_dir is not None:
        cache = os.path.join(
            cache_dir,
            f"synth_v1_n{n}_s{img_size}_c{n_classes}_seed{seed}"
            f"_{difficulty}_is{intra_scale:g}.npz")
        if os.path.isfile(cache):
            with np.load(cache) as z:
                return z["x"], z["y"]

    out = _synthetic_dataset_uncached(
        n, img_size, n_classes, seed, difficulty, intra_scale)
    if cache is not None:
        os.makedirs(cache_dir, exist_ok=True)
        # np.savez appends '.npz' unless the name already ends with it.
        tmp = cache + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, x=out[0], y=out[1])
        os.replace(tmp, cache)  # atomic: concurrent processes race safely
    return out


def _synthetic_dataset_uncached(
    n: int,
    img_size: int,
    n_classes: int,
    seed: int,
    difficulty: str,
    intra_scale: float,
) -> Arrays:
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:img_size, 0:img_size] / img_size

    if difficulty == "easy":
        proto = np.stack(
            [
                np.stack(
                    [
                        np.sin(2 * np.pi * ((c % 3 + 1) * xx + c)) * 0.5
                        + 0.5,
                        np.cos(2 * np.pi * ((c % 4 + 1) * yy - c)) * 0.5
                        + 0.5,
                        np.sin(2 * np.pi * ((c % 5 + 1) * (xx + yy))) * 0.5
                        + 0.5,
                    ],
                    axis=-1,
                )
                for c in range(n_classes)
            ]
        )  # (C, H, W, 3)
        imgs = proto[labels]
        imgs = imgs + rng.randn(n, 1, 1, 3) * 0.15  # per-sample colour shift
        imgs = imgs + rng.randn(n, img_size, img_size, 3) * 0.08
        return (np.clip(imgs * 255.0, 0, 255).astype(np.uint8), labels)
    if difficulty != "hard":
        raise ValueError(f"unknown difficulty {difficulty!r}")

    n_basis, n_signal = 24, 8
    frng = np.random.RandomState(0xC1FA)  # class structure: split-invariant
    freqs = frng.uniform(0.5, 3.5, size=(n_basis, 2))
    phases = frng.uniform(0, 2 * np.pi, size=(n_basis, 3))
    chan = frng.randn(n_basis, 3) / np.sqrt(3)
    # (n_basis, H, W, 3) smooth patterns.
    arg = 2 * np.pi * (freqs[:, 0, None, None] * xx
                       + freqs[:, 1, None, None] * yy)
    basis = (np.sin(arg[..., None] + phases[:, None, None, :])
             * chan[:, None, None, :]).astype(np.float32)
    class_means = frng.randn(n_classes, n_signal).astype(np.float32)

    coeff = np.zeros((n, n_basis), np.float32)
    coeff[:, :n_signal] = (class_means[labels]
                           + rng.randn(n, n_signal).astype(np.float32)
                           * intra_scale)
    # Nuisance dimensions: as large as the signal, class-independent.
    coeff[:, n_signal:] = rng.randn(n, n_basis - n_signal) * 1.5

    imgs = np.tensordot(coeff, basis, axes=(1, 0))  # (n, H, W, 3)
    imgs = imgs / 6.0 + 0.5
    # Per-sample channel gain/bias: colour statistics are unreliable.
    gain = 1.0 + rng.randn(n, 1, 1, 3).astype(np.float32) * 0.25
    bias = rng.randn(n, 1, 1, 3).astype(np.float32) * 0.12
    imgs = imgs * gain + bias
    imgs = imgs + rng.randn(n, img_size, img_size, 3) * 0.10
    return (np.clip(imgs * 255.0, 0, 255).astype(np.uint8), labels)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

_SYNTH_SIZES = {
    ("cifar10", "train"): 50_000,
    ("cifar10", "test"): 10_000,
    ("stl10", "train"): 5_000,
    ("stl10", "test"): 8_000,
    ("stl10", "unlabeled"): 100_000,
}


def load_dataset(
    name: str,
    split: str,
    data_dir: str = "data",
    synthetic_ok: bool = True,
    synthetic_size: Optional[int] = None,
) -> Arrays:
    """Load `name` in {'cifar10','stl10'}, split in
    {'train','test','unlabeled'} (unlabeled is STL-only)."""
    if name == "cifar10":
        out = load_cifar10(data_dir, train=split == "train")
        img_size = 32
    elif name == "stl10":
        out = load_stl10(data_dir, split=split)
        img_size = 96
    else:
        raise ValueError(f"unknown dataset {name!r}")
    if out is not None:
        return out
    if not synthetic_ok:
        raise FileNotFoundError(
            f"no on-disk copy of {name}/{split} under {data_dir!r}")
    n = synthetic_size or _SYNTH_SIZES.get((name, split), 10_000)
    warnings.warn(
        f"{name}/{split} not found under {data_dir!r}; using a synthetic "
        f"stand-in with {n} samples (place the real binaries there to use "
        "them automatically)."
    )
    # Distinct seeds per (name, split) so train/test don't overlap. crc32 is
    # stable across processes (Python's hash() is salted per interpreter,
    # which would make the "deterministic" fallback differ between the
    # pretrain and eval processes).
    seed = zlib.crc32(f"{name}/{split}".encode())
    return synthetic_dataset(n, img_size=img_size, seed=seed,
                             cache_dir=os.path.join(data_dir, "synth_cache"))
