"""On-device SimCLR training augmentation (NHWC float32 images).

Counterpart of the training, test and fine-tune paths of
``simclr_tpu/ops/augment.py``: random resized crop and flip as two batched
matmuls against tent-weight matrices, colour jitter in a per-image random
order, random grayscale, normalisation and a per-image-sigma Gaussian
blur; the test view (centre crop, normalise), the fine-tune view (crop,
flip, normalise) and the supervised baseline's view (flip, translate,
then colour jitter and normalisation through kernel B2).

Every random step is split in two: a ``sample_*`` function draws the
parameters from an explicit ``torch.Generator``, and an apply function takes
them. Tests feed both packages the same parameters; PyTorch's and JAX's
random streams differ, so only the distributions are compared.

In ``augment_train`` the colour chain (jitter, grayscale, normalise) runs
through kernel B2 (``ops/kernels/color.py``), before the blur. That order
is exact: the blur's weights sum to one, so it commutes with the
per-channel affine normalisation.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simclr_tpu_torch.config import AugmentConfig, DatasetConfig

Boxes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _uniform(generator: torch.Generator, n: int, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


# ---------------------------------------------------------------------------
# Crop / resize / flip as batched interpolation matmuls.
# ---------------------------------------------------------------------------

def _interp_matrix(src_pos: torch.Tensor, in_size: int,
                   support: torch.Tensor,
                   zero_outside: bool = False) -> torch.Tensor:
    """Normalised tent-filter weights (N, OUT, IN) for source coordinates
    (N, OUT), clamped to the image (edge replication, as PIL); with
    ``zero_outside`` unclamped, and a row whose weights all vanish stays
    all-zero (zero fill)."""
    k = torch.arange(in_size, dtype=torch.float32, device=src_pos.device)
    if not zero_outside:
        src_pos = src_pos.clamp(0.0, in_size - 1.0)
    d = (src_pos[..., None] - k).abs() / support[..., None]
    w = (1.0 - d).clamp_min(0.0)
    norm = w.sum(dim=-1, keepdim=True)
    if zero_outside:
        return torch.where(norm > 0, w / norm.clamp_min(1e-8),
                           torch.zeros_like(w))
    return w / norm.clamp_min(1e-8)


def _apply_separable(images: torch.Tensor, wh: torch.Tensor,
                     ww: torch.Tensor) -> torch.Tensor:
    """Per-sample separable resample: (N,H,W,C) x (N,O_h,H) x (N,O_w,W),
    returned contiguous NHWC (einsum may hand back a permuted view)."""
    out = torch.einsum("nuh,nhwc->nuwc", wh, images)
    return torch.einsum("nvw,nuwc->nuvc", ww, out).contiguous()


def sample_crop_boxes(
    generator: torch.Generator,
    n: int,
    in_h: int,
    in_w: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
) -> Boxes:
    """Inception-style boxes (top, left, height, width): area fraction
    ~ U(scale), aspect ~ exp(U(log ratio)), clamped to the image."""
    area = in_h * in_w * _uniform(generator, n, scale[0], scale[1])
    aspect = torch.exp(_uniform(generator, n, math.log(ratio[0]),
                                math.log(ratio[1])))
    w = torch.sqrt(area * aspect).clamp(1.0, float(in_w))
    h = torch.sqrt(area / aspect).clamp(1.0, float(in_h))
    top = _uniform(generator, n) * (in_h - h)
    left = _uniform(generator, n) * (in_w - w)
    return top, left, h, w


def sample_flips(generator: torch.Generator, n: int,
                 flip_prob: float) -> torch.Tensor:
    return _uniform(generator, n) < flip_prob


def crop_resize_flip(
    images: torch.Tensor,
    boxes: Boxes,
    out_size: Tuple[int, int],
    flip_mask: Optional[torch.Tensor] = None,
    antialias: bool = True,
) -> torch.Tensor:
    """Crop per-sample boxes, resize to ``out_size``, optionally h-flip."""
    n, in_h, in_w = images.shape[0], images.shape[1], images.shape[2]
    out_h, out_w = out_size
    top, left, h, w = boxes
    dev = images.device
    u = torch.arange(out_h, dtype=torch.float32, device=dev)
    v = torch.arange(out_w, dtype=torch.float32, device=dev)
    scale_h = (h / out_h)[:, None]
    scale_w = (w / out_w)[:, None]
    ys = top[:, None] + (u[None, :] + 0.5) * scale_h - 0.5
    xs = left[:, None] + (v[None, :] + 0.5) * scale_w - 0.5
    if flip_mask is not None:
        xs_flipped = (left[:, None] + w[:, None] - 1.0) - (xs - left[:, None])
        xs = torch.where(flip_mask[:, None], xs_flipped, xs)
    one = torch.ones((n, 1), dtype=torch.float32, device=dev)
    sup_h = scale_h.clamp_min(1.0) if antialias else one
    sup_w = scale_w.clamp_min(1.0) if antialias else one
    wh = _interp_matrix(ys, in_h, sup_h)
    ww = _interp_matrix(xs, in_w, sup_w)
    return _apply_separable(images, wh, ww)


def random_resized_crop_flip(
    generator: torch.Generator,
    images: torch.Tensor,
    out_size: Tuple[int, int],
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
    flip_prob: float = 0.5,
    antialias: bool = True,
) -> torch.Tensor:
    """RandomResizedCrop + RandomHorizontalFlip (reference: data.py:121-123)."""
    n, in_h, in_w = images.shape[0], images.shape[1], images.shape[2]
    boxes = sample_crop_boxes(generator, n, in_h, in_w, scale, ratio)
    flip = sample_flips(generator, n, flip_prob)
    return crop_resize_flip(images, boxes, out_size, flip, antialias)


def sample_translate(generator: torch.Generator, n: int, h: int, w: int,
                     max_translate: Tuple[float, float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel shifts (ty, tx), each (N,) float32: round(U(-t h,
    t h)) with t = ``max_translate[1]``, and round(U(-t w, t w)) with t =
    ``max_translate[0]`` (torchvision's RandomAffine translate; torch.round
    and jnp.round both round half to even)."""
    ty = torch.round(_uniform(generator, n, -max_translate[1] * h,
                              max_translate[1] * h))
    tx = torch.round(_uniform(generator, n, -max_translate[0] * w,
                              max_translate[0] * w))
    return ty, tx


def translate_apply(images: torch.Tensor, ty: torch.Tensor,
                    tx: torch.Tensor) -> torch.Tensor:
    """Shift NHWC images by (ty, tx) pixels with zero fill, as two batched
    matmuls against 0/1 tent matrices (exact for integer shifts)."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    u = torch.arange(h, dtype=torch.float32, device=dev)
    v = torch.arange(w, dtype=torch.float32, device=dev)
    one = torch.ones((n, 1), dtype=torch.float32, device=dev)
    wh = _interp_matrix(u[None, :] - ty[:, None], h, one, zero_outside=True)
    ww = _interp_matrix(v[None, :] - tx[:, None], w, one, zero_outside=True)
    return _apply_separable(images, wh, ww)


def random_translate(generator: torch.Generator, images: torch.Tensor,
                     max_translate: Tuple[float, float]) -> torch.Tensor:
    """RandomAffine(degrees=0, translate) with zero fill (reference:
    data.py:213-214, the supervised pipeline)."""
    ty, tx = sample_translate(generator, images.shape[0], images.shape[1],
                              images.shape[2], max_translate)
    return translate_apply(images, ty, tx)


# ---------------------------------------------------------------------------
# Colour ops (float [0,1], clamped after each op). ``factor`` tensors are
# per image, shape (N,).
# ---------------------------------------------------------------------------

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601-2, torchvision's L mode.


def _gray(images: torch.Tensor) -> torch.Tensor:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    return _GRAY_WEIGHTS[0] * r + _GRAY_WEIGHTS[1] * g + _GRAY_WEIGHTS[2] * b


def rgb_to_grayscale(images: torch.Tensor,
                     keep_channels: bool = True) -> torch.Tensor:
    gray = _gray(images)[..., None]
    return gray.expand(*gray.shape[:-1], 3) if keep_channels else gray


def adjust_brightness(images: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
    return (images * factor[:, None, None, None]).clamp(0.0, 1.0)


def adjust_contrast(images: torch.Tensor,
                    factor: torch.Tensor) -> torch.Tensor:
    mean = _gray(images).mean(dim=(1, 2))[:, None, None, None]
    f = factor[:, None, None, None]
    return (f * images + (1.0 - f) * mean).clamp(0.0, 1.0)


def adjust_saturation(images: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
    f = factor[:, None, None, None]
    return (f * images + (1.0 - f) * _gray(images)[..., None]).clamp(0.0, 1.0)


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``x % m`` with the divisor's sign, computed as XLA computes
    ``jnp.remainder``: the exact fmod, moved by m where the signs differ."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def rgb_to_hsv(images: torch.Tensor) -> torch.Tensor:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(maxc),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc),
                                        maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    # Ties: maxc == r wins, then maxc == g.
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = floor_mod(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(images: torch.Tensor) -> torch.Tensor:
    """Branch-free: channel(n) = v - v*s*clip(min(k, 4-k), 0, 1) with
    k = (n + 6h) mod 6."""
    h, s, v = images[..., 0], images[..., 1], images[..., 2]
    h6 = h * 6.0

    def channel(n):
        k = floor_mod(n + h6, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def adjust_hue(images: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    hsv = rgb_to_hsv(images)
    h = floor_mod(hsv[..., 0] + delta[:, None, None], 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


# The 24 permutations of (0..3), in itertools order: torchvision shuffles
# the op order per ColorJitter call.
_PERMS = np.array(list(itertools.permutations(range(4))), np.int32)


@functools.cache
def _perm_table(device: torch.device) -> torch.Tensor:
    """``_PERMS`` on ``device``, copied there once: a host-to-device copy
    in every step could not be captured in a CUDA graph."""
    return torch.from_numpy(_PERMS).to(device)


def sample_color_params(
    generator: torch.Generator,
    n: int,
    strength: float,
    apply_prob: float,
    gray_prob: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image factors (N, 8) = [fb, fc, fs, fh, gray_flag, 0, 0, 0] and
    op schedules (N, 4) int32, with the distributions of the JAX side's
    ``sample_color_params``: with probability ``apply_prob`` the factors
    are fb, fc, fs ~ U(max(0, 1 - 0.8s), 1 + 0.8s) and fh ~ U(-0.2s, 0.2s),
    else the identity; gray_flag is 1 with probability ``gray_prob``."""
    dev = generator.device

    def uniform(lo, hi):
        return _uniform(generator, n, lo, hi)

    half = 0.8 * strength
    hue = 0.2 * strength
    applied = uniform(0.0, 1.0) < apply_prob
    one = torch.ones(n, device=dev)
    fb, fc, fs = (torch.where(applied, uniform(max(0.0, 1.0 - half),
                                               1.0 + half), one)
                  for _ in range(3))
    fh = torch.where(applied, uniform(-hue, hue), torch.zeros(n, device=dev))
    gray = (uniform(0.0, 1.0) < gray_prob).float()
    pad = torch.zeros(n, device=dev)
    factors = torch.stack([fb, fc, fs, fh, gray, pad, pad, pad], dim=1)
    perm_idx = torch.randint(0, len(_PERMS), (n,), generator=generator,
                             device=dev)
    schedule = _perm_table(torch.device(dev))[perm_idx]
    return factors, schedule


def color_jitter(images: torch.Tensor, factors: torch.Tensor,
                 schedule: torch.Tensor) -> torch.Tensor:
    """ColorJitter with a per-image op order (reference: data.py:125-132).
    ``factors`` (N, >=4) holds [fb, fc, fs, fh]; ``schedule`` (N, 4) the op
    id (0 brightness, 1 contrast, 2 saturation, 3 hue) of each step. Both
    come from ``sample_color_params``."""
    fb, fc, fs, fh = (factors[:, i] for i in range(4))
    x = images
    for step in range(4):
        candidates = torch.stack([
            adjust_brightness(x, fb),
            adjust_contrast(x, fc),
            adjust_saturation(x, fs),
            adjust_hue(x, fh),
        ], dim=0)
        op = schedule[:, step].long()
        x = candidates[op, torch.arange(x.shape[0], device=x.device)]
    return x


def random_grayscale(images: torch.Tensor, flags: torch.Tensor
                     ) -> torch.Tensor:
    """RandomGrayscale (reference: data.py:133-135) for per-image bool
    ``flags``."""
    return torch.where(flags[:, None, None, None], rgb_to_grayscale(images),
                       images)


# ---------------------------------------------------------------------------
# Gaussian blur with per-sample sigma.
# ---------------------------------------------------------------------------

def gaussian_kernel_size(img_size: int) -> int:
    """floor(0.1 * img_size), snapped odd: 3 for CIFAR-10, 9 for STL-10."""
    k = int(math.floor(0.1 * img_size))
    if k % 2 == 0:
        k = max(k - 1, 1)
    return max(k, 1)


def sample_blur_sigma(generator: torch.Generator, n: int,
                      sigma_range: Tuple[float, float] = (0.1, 2.0)
                      ) -> torch.Tensor:
    return _uniform(generator, n, sigma_range[0], sigma_range[1])


def _reflect_pad(images: torch.Tensor, half: int) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    return F.pad(x, (half, half, half, half), mode="reflect").permute(
        0, 2, 3, 1)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  kernel_size: int) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images with per-image ``sigma``:
    reflect padding, weights exp(-x^2 / (2 sigma^2)) normalised, vertical
    pass then horizontal pass (torchvision GaussianBlur semantics)."""
    half = kernel_size // 2
    offsets = torch.arange(-half, half + 1, dtype=torch.float32,
                           device=images.device)
    w = torch.exp(-(offsets[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    w = w / w.sum(dim=1, keepdim=True)
    h, wdt = images.shape[1], images.shape[2]
    x = _reflect_pad(images, half)
    out = torch.zeros_like(images)
    for i in range(kernel_size):
        out = out + w[:, i, None, None, None] * x[:, i:i + h, half:half + wdt]
    x = _reflect_pad(out, half)
    out = torch.zeros_like(images)
    for i in range(kernel_size):
        out = out + w[:, i, None, None, None] * x[:, half:half + h, i:i + wdt]
    return out


# ---------------------------------------------------------------------------
# Normalisation and the composed training view.
# ---------------------------------------------------------------------------

@functools.cache
def _channel_constants(values: Tuple[float, ...],
                       device: torch.device) -> torch.Tensor:
    """``values`` as float32 on ``device``, copied there once: a
    host-to-device copy in every step could not be captured in a CUDA
    graph (the fine-tune step normalises inside its capture)."""
    return torch.tensor(values, dtype=torch.float32).to(device)


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    dev = images.device
    return ((images - _channel_constants(tuple(mean), dev))
            / _channel_constants(tuple(std), dev))


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1], staying NHWC."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


@dataclasses.dataclass
class ViewParams:
    """The random draws of one training view of N images."""

    boxes: Boxes            # (top, left, height, width), each (N,)
    flip: torch.Tensor      # (N,) bool
    factors: torch.Tensor   # (N, 8) colour factors, see sample_color_params
    schedule: torch.Tensor  # (N, 4) int32 colour-op order
    sigma: torch.Tensor     # (N,) blur sigma

    def to(self, device: "str | torch.device") -> "ViewParams":
        return ViewParams(tuple(b.to(device) for b in self.boxes),
                          self.flip.to(device), self.factors.to(device),
                          self.schedule.to(device), self.sigma.to(device))


def sample_view_params(generator: torch.Generator, n: int, in_h: int,
                       in_w: int, aug: AugmentConfig) -> ViewParams:
    boxes = sample_crop_boxes(generator, n, in_h, in_w, aug.crop_scale,
                              aug.crop_ratio)
    flip = sample_flips(generator, n, aug.flip_prob)
    factors, schedule = sample_color_params(
        generator, n, aug.color_distort_strength, aug.color_jitter_prob,
        aug.color_drop_prob)
    sigma = sample_blur_sigma(generator, n, aug.blur_sigma)
    return ViewParams(boxes, flip, factors, schedule, sigma)


def augment_train_apply(
    images: torch.Tensor,
    params: ViewParams,
    ds: DatasetConfig,
    out_size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One SimCLR training view of NHWC uint8 or float images with the
    given draws: crop+flip -> colour kernel (jitter, grayscale, normalise)
    -> blur. Returns (N, H, W, 3) float32."""
    # Imported here: the kernel module imports this one for its plain
    # version (as the JAX side imports its Pallas colour kernel).
    from simclr_tpu_torch.ops.kernels.color import color_distort

    out = out_size or (ds.img_size, ds.img_size)
    x = crop_resize_flip(to_float(images), params.boxes, out, params.flip)
    x = color_distort(x, params.factors, params.schedule, ds.mean, ds.std)
    return gaussian_blur(x, params.sigma, gaussian_kernel_size(ds.img_size))


def augment_train(
    generator: torch.Generator,
    images: torch.Tensor,
    aug: AugmentConfig,
    ds: DatasetConfig,
    out_size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One SimCLR training view (reference: compose_augmentation_train,
    data.py:100-147)."""
    params = sample_view_params(generator, images.shape[0], images.shape[1],
                                images.shape[2], aug)
    return augment_train_apply(images, params, ds, out_size)


def augment_train_pair(
    generator: torch.Generator,
    images: torch.Tensor,
    aug: AugmentConfig,
    ds: DatasetConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent views per image (reference: data.py:44-47)."""
    return (augment_train(generator, images, aug, ds),
            augment_train(generator, images, aug, ds))


def augment_anchor_pair_apply(
    images: torch.Tensor,
    params: ViewParams,
    ds: DatasetConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised original, training view with the given draws) of NHWC
    uint8 or float images."""
    return augment_test(images, ds), augment_train_apply(images, params, ds)


def augment_anchor_pair(
    generator: torch.Generator,
    images: torch.Tensor,
    aug: AugmentConfig,
    ds: DatasetConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor mode: (normalised original, augmented view) per image, the
    reference's ``anchor=True`` dataset mode that the representation
    analogy uses (reference: data.py:44-50, utils/metrics.py:232)."""
    return augment_test(images, ds), augment_train(generator, images, aug,
                                                   ds)


# ---------------------------------------------------------------------------
# Test and fine-tune views.
# ---------------------------------------------------------------------------

def center_crop(images: torch.Tensor, out_size: Tuple[int, int]
                ) -> torch.Tensor:
    """Static centre crop of NHWC images (reference: data.py:187-188,
    CenterCrop in the test transform)."""
    h, w = images.shape[1], images.shape[2]
    oh, ow = out_size
    top, left = (h - oh) // 2, (w - ow) // 2
    return images[:, top:top + oh, left:left + ow, :]


def augment_test(
    images: torch.Tensor,
    ds: DatasetConfig,
    crop_dim: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """ToTensor [+ CenterCrop] + Normalize (reference: data.py:172-192)."""
    x = to_float(images)
    if crop_dim is not None:
        x = center_crop(x, crop_dim)
    return normalize(x, ds.mean, ds.std)


@dataclasses.dataclass
class CropParams:
    """The random draws of one fine-tune view of N images."""

    boxes: Boxes            # (top, left, height, width), each (N,)
    flip: torch.Tensor      # (N,) bool


def sample_fine_tune_params(generator: torch.Generator, n: int, in_h: int,
                            in_w: int, aug: AugmentConfig) -> CropParams:
    boxes = sample_crop_boxes(generator, n, in_h, in_w, aug.crop_scale,
                              aug.crop_ratio)
    return CropParams(boxes, sample_flips(generator, n, aug.flip_prob))


def augment_fine_tune_apply(images: torch.Tensor, params: CropParams,
                            ds: DatasetConfig) -> torch.Tensor:
    """Crop + flip + normalise of NHWC uint8 or float images with the given
    draws; no colour distortion. Returns (N, S, S, 3) float32 at the
    dataset's image size S."""
    x = crop_resize_flip(to_float(images), params.boxes,
                         (ds.img_size, ds.img_size), params.flip)
    return normalize(x, ds.mean, ds.std)


def augment_fine_tune(
    generator: torch.Generator,
    images: torch.Tensor,
    aug: AugmentConfig,
    ds: DatasetConfig,
) -> torch.Tensor:
    """Crop + flip + normalise only (reference: data.py:150-169)."""
    params = sample_fine_tune_params(generator, images.shape[0],
                                     images.shape[1], images.shape[2], aug)
    return augment_fine_tune_apply(images, params, ds)


# ---------------------------------------------------------------------------
# The supervised baseline's view.
# ---------------------------------------------------------------------------

# RandomAffine translate of the supervised pipeline (reference:
# data.py:213-214), and ColorJitter(0.4, 0.4, 0.4, 0.1) under p = 0.5:
# strength 0.5 gives 0.8 s = 0.4 and 0.2 s = 0.1.
SUPERVISED_TRANSLATE = (0.3, 0.3)
SUPERVISED_JITTER = (0.5, 0.5)  # (strength, apply_prob)


@dataclasses.dataclass
class SupervisedParams:
    """The random draws of one supervised view of N images."""

    flip: torch.Tensor      # (N,) bool
    ty: torch.Tensor        # (N,) float32 integer row shifts
    tx: torch.Tensor        # (N,) float32 integer column shifts
    factors: torch.Tensor   # (N, 8) colour factors, gray flags all 0
    schedule: torch.Tensor  # (N, 4) int32 colour-op order


def sample_supervised_params(generator: torch.Generator, n: int, in_h: int,
                             in_w: int) -> SupervisedParams:
    flip = sample_flips(generator, n, 0.5)
    ty, tx = sample_translate(generator, n, in_h, in_w,
                              SUPERVISED_TRANSLATE)
    factors, schedule = sample_color_params(generator, n,
                                            *SUPERVISED_JITTER, 0.0)
    return SupervisedParams(flip, ty, tx, factors, schedule)


def augment_supervised_apply(images: torch.Tensor, params: SupervisedParams,
                             ds: DatasetConfig) -> torch.Tensor:
    """The supervised view of NHWC uint8 or float images with the given
    draws: flip -> translate -> colour kernel B2 (jitter with every
    grayscale flag 0, then normalise). Jitter comes before normalise, as
    on the JAX side, which fixes the reference's order (data.py:205-216).
    Returns (N, H, W, 3) float32."""
    from simclr_tpu_torch.ops.kernels.color import color_distort

    x = to_float(images)
    x = torch.where(params.flip[:, None, None, None], x.flip(2), x)
    x = translate_apply(x, params.ty, params.tx)
    return color_distort(x, params.factors, params.schedule, ds.mean, ds.std)


def augment_supervised(generator: torch.Generator, images: torch.Tensor,
                       ds: DatasetConfig) -> torch.Tensor:
    """Supervised-baseline stack (reference: data.py:195-217): flip p=0.5,
    RandomAffine translate (0.3, 0.3), ColorJitter(0.4, 0.4, 0.4, 0.1)
    p=0.5, normalise."""
    params = sample_supervised_params(generator, images.shape[0],
                                      images.shape[1], images.shape[2])
    return augment_supervised_apply(images, params, ds)
