"""Fused colour distortion: CUDA kernel B2 (``csrc/color.cu``) and its
plain PyTorch version. The per-image parameters it applies come from
``ops.augment.sample_color_params``.

Replaces ``simclr_tpu/ops/pallas/color.py`` (``_color_kernel``): colour
jitter in a per-image random op order, random grayscale and normalisation
in one pass over NHWC float32 images. One thread block owns one image, so
there is no tile over the batch and no fallback for a tile that does not
fit. The block stages the image by one bulk copy into shared memory, runs
the colour chain on registers and writes it back by one bulk store;
``csrc/color.cu`` says what bounds it on the H100 and how. ``geometry``
and ``pixels`` mirror its launch for the tests.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each kernel launch adds one to
``color_distort.launches``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from simclr_tpu_torch.ops.augment import (
    color_jitter, normalize, random_grayscale)
from simclr_tpu_torch.ops.kernels import _build

# Most pixels per image: the kernel keeps the image in shared memory.
MAX_HW = 16384
# The kernel's instantiations, smallest first: (most pixels an image,
# threads a block, pixels a thread).
SHAPES = ((1024, 256, 4), (9216, 1024, 9), (MAX_HW, 512, 32))


def geometry(hw: int, mis: int) -> Tuple[int, int, int, int, int]:
    """The launch for an image of ``hw`` pixels at an address that is
    ``mis`` (0, 4, 8 or 12) modulo 16, as the C entry ``color_geometry``
    gives it: threads a block, pixels a thread, the bytes [lo, hi) of the
    image's 12 hw that one bulk copy moves (the largest span with 16-byte
    aligned ends; lo == hi where there is none), and the block's dynamic
    shared memory (the image and 16 bytes to place it at ``mis``)."""
    if not 1 <= hw <= MAX_HW or mis not in (0, 4, 8, 12):
        raise ValueError(f"no colour launch for hw={hw}, mis={mis}")
    threads, per = next((t, p) for most, t, p in SHAPES if hw <= most)
    lo = (16 - mis) % 16
    hi = max(lo, (mis + 12 * hw) // 16 * 16 - mis)
    return threads, per, lo, hi, 12 * threads * per + 16


def pixels(hw: int) -> np.ndarray:
    """The pixels each thread owns, (threads, pixels a thread): thread t
    takes t + k * threads for k in order, -1 past the image."""
    threads, per = geometry(hw, 0)[:2]
    p = np.arange(threads)[:, None] + threads * np.arange(per)[None, :]
    return np.where(p < hw, p, -1)


def color_distort_plain(images: torch.Tensor, factors: torch.Tensor,
                        schedule: torch.Tensor, mean: Sequence[float],
                        std: Sequence[float]) -> torch.Tensor:
    """Plain version of the kernel: the ``ops.augment`` colour chain."""
    x = color_jitter(images, factors, schedule)
    x = random_grayscale(x, factors[:, 4] > 0.5)
    return normalize(x, mean, std)


def color_distort(images: torch.Tensor, factors: torch.Tensor,
                  schedule: torch.Tensor, mean: Sequence[float],
                  std: Sequence[float]) -> torch.Tensor:
    """Jitter (per-image order) + grayscale + normalise of (N, H, W, 3)
    float32 images in [0, 1]; returns normalised (N, H, W, 3) float32."""
    if images.device.type == "cpu":
        return color_distort_plain(images, factors, schedule, mean, std)
    if images.device.type != "cuda":
        raise ValueError(f"no colour kernel for device {images.device}")
    if (images.dtype != torch.float32 or images.dim() != 4
            or images.shape[3] != 3 or not images.is_contiguous()):
        raise ValueError("images must be contiguous (N, H, W, 3) float32")
    n, h, w, _ = images.shape
    if not 1 <= h * w <= MAX_HW:
        raise ValueError(f"colour kernel takes at most {MAX_HW} pixels an "
                         f"image, got {h}x{w}")
    if (factors.shape != (n, 8) or factors.dtype != torch.float32
            or schedule.shape != (n, 4) or schedule.dtype != torch.int32):
        raise ValueError("factors must be (N, 8) float32 and schedule "
                         "(N, 4) int32")
    for t in (factors, schedule):
        if t.device != images.device or not t.is_contiguous():
            raise ValueError("factors and schedule must be contiguous on "
                             f"{images.device}")
    out = torch.empty_like(images)
    lib = _build.library()
    with torch.cuda.device(images.device):
        status = lib.color_distort(
            images.data_ptr(), factors.data_ptr(), schedule.data_ptr(),
            out.data_ptr(), n, h * w, *map(float, mean), *map(float, std),
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "color_distort")
    color_distort.launches += 1
    return out


color_distort.launches = 0
