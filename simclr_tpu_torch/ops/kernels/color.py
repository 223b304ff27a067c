"""Fused colour distortion: CUDA kernel B2 (``csrc/color.cu``) and its
plain PyTorch version. The per-image parameters it applies come from
``ops.augment.sample_color_params``.

Replaces ``simclr_tpu/ops/pallas/color.py`` (``_color_kernel``): colour
jitter in a per-image random op order, random grayscale and normalisation
in one pass over NHWC float32 images. One thread block owns one image, so
there is no tile over the batch and no fallback for a tile that does not
fit; ``csrc/color.cu`` says what bounds it on the H100.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each kernel launch adds one to
``color_distort.launches``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from simclr_tpu_torch.ops.augment import (
    color_jitter, normalize, random_grayscale)
from simclr_tpu_torch.ops.kernels import _build

# Most pixels per image: the kernel keeps the image in shared memory.
MAX_HW = 16384


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
