"""The port's training augmentation against the JAX package's.

The apply side: the JAX draws of ``augment_train(key, ...,
use_pallas_color=False)`` are reproduced from the same key splits
(``ops/augment.py:416`` and ``:161-163``) and fed to the port's
``augment_train_apply``. Tolerance atol 2e-5 on normalised values of order
1: float32 on both sides, but the port normalises before the blur and the
JAX XLA path after it (exact in real arithmetic, since the blur weights sum
to one), and the crop matmuls sum in another order.

The sampling side: the port's ``torch.Generator`` draws and JAX's draws have
the same moments, within five standard errors of the difference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.config import CIFAR10, STL10, AugmentConfig
from simclr_tpu.ops import augment as ja
from simclr_tpu_torch.ops import augment as ta

ATOL = 2e-5
AUG = AugmentConfig()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_view_params(key, n, in_h, in_w, aug=AUG):
    """The draws augment_train(key, ..., use_pallas_color=False) makes, as
    the port's ViewParams. Compiled once a shape, as the JAX engines draw
    them inside their jitted steps (eager, each op compiles on its first
    call; the crop boxes can differ from the compiled ones by an ulp)."""
    boxes, flip, factors, schedule, sigma = _jax_draws(key, n, in_h, in_w,
                                                       aug)
    return ta.ViewParams(tuple(_t(b) for b in boxes), _t(flip), _t(factors),
                         _t(schedule).to(torch.int32), _t(sigma))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(key, n, in_h, in_w, aug):
    k_crop, k_jit, k_gray, k_blur = jax.random.split(key, 4)
    k_box, k_flip = jax.random.split(k_crop)
    boxes = ja.sample_crop_boxes(k_box, n, in_h, in_w, aug.crop_scale,
                                 aug.crop_ratio)
    flip = jax.random.uniform(k_flip, (n,)) < aug.flip_prob
    k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(k_jit, 6)
    s = aug.color_distort_strength
    applied = jax.random.uniform(k_apply, (n,)) < aug.color_jitter_prob

    def factor(k, half):
        f = jax.random.uniform(k, (n,), minval=max(0.0, 1.0 - half),
                               maxval=1.0 + half)
        return jnp.where(applied, f, 1.0)

    fh = jnp.where(applied, jax.random.uniform(
        k_h, (n,), minval=-0.2 * s, maxval=0.2 * s), 0.0)
    gray = (jax.random.uniform(k_gray, (n,)) < aug.color_drop_prob)
    zero = jnp.zeros((n,))
    factors = jnp.stack([factor(k_b, 0.8 * s), factor(k_c, 0.8 * s),
                         factor(k_s, 0.8 * s), fh,
                         gray.astype(jnp.float32), zero, zero, zero], axis=1)
    schedule = jnp.asarray(ja._PERMS)[
        jax.random.randint(k_perm, (n,), 0, len(ja._PERMS))]
    sigma = jax.random.uniform(k_blur, (n,), minval=aug.blur_sigma[0],
                               maxval=aug.blur_sigma[1])
    return boxes, flip, factors, schedule, sigma


def _u8(n, size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_train_matches_jax(seed):
    n = 12
    imgs = _u8(n, 32, seed)
    key = jax.random.key(seed)
    ref = ja.augment_train(key, jnp.asarray(imgs), AUG, CIFAR10,
                           use_pallas_color=False)
    params = jax_view_params(key, n, 32, 32)
    out = ta.augment_train_apply(torch.from_numpy(imgs), params, CIFAR10)
    assert out.shape == (n, 32, 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_augment_train_stl_matches_jax():
    n = 4
    imgs = _u8(n, 96, 7)
    key = jax.random.key(7)
    ref = ja.augment_train(key, jnp.asarray(imgs), AUG, STL10,
                           use_pallas_color=False)
    params = jax_view_params(key, n, 96, 96)
    out = ta.augment_train_apply(torch.from_numpy(imgs), params, STL10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("flip", [True, False])
def test_crop_resize_flip_matches_jax(antialias, flip):
    n = 8
    imgs = np.random.default_rng(1).uniform(0, 1, (n, 32, 32, 3)).astype(
        np.float32)
    boxes = ja.sample_crop_boxes(jax.random.key(1), n, 32, 32, (0.08, 1.0),
                                 (0.75, 4 / 3))
    mask = np.arange(n) % 2 == 0 if flip else None
    ref = ja.crop_resize_flip(jnp.asarray(imgs), boxes, (24, 40),
                              None if mask is None else jnp.asarray(mask),
                              antialias)
    out = ta.crop_resize_flip(torch.from_numpy(imgs),
                              tuple(_t(b) for b in boxes), (24, 40),
                              None if mask is None else torch.from_numpy(mask),
                              antialias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("size", [32, 96])
def test_gaussian_blur_matches_jax(size):
    n = 6
    imgs = np.random.default_rng(size).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)
    key = jax.random.key(size)
    ks = ja.gaussian_kernel_size(size)
    assert ks == ta.gaussian_kernel_size(size)
    ref = ja.gaussian_blur(key, jnp.asarray(imgs), ks, (0.1, 2.0))
    sigma = jax.random.uniform(key, (n,), minval=0.1, maxval=2.0)
    out = ta.gaussian_blur(torch.from_numpy(imgs), _t(sigma), ks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_color_jitter_and_grayscale_match_jax():
    n = 10
    imgs = np.random.default_rng(3).uniform(0, 1, (n, 8, 8, 3)).astype(
        np.float32)
    key = jax.random.key(3)
    params = jax_view_params(key, n, 8, 8)
    _, k_jit, k_gray, _ = jax.random.split(key, 4)
    ref = ja.random_grayscale(
        k_gray, ja.color_jitter(k_jit, jnp.asarray(imgs)), 0.2)
    out = ta.random_grayscale(
        ta.color_jitter(torch.from_numpy(imgs), params.factors,
                        params.schedule), params.factors[:, 4] > 0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_to_float_and_normalize_match_jax():
    imgs = _u8(3, 4, 0)
    ref = ja.normalize(ja.to_float(jnp.asarray(imgs)), CIFAR10.mean,
                       CIFAR10.std)
    out = ta.normalize(ta.to_float(torch.from_numpy(imgs)), CIFAR10.mean,
                       CIFAR10.std)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def _moments_agree(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 5 * se + 1e-12
    se2 = np.sqrt(((a - a.mean()) ** 2).var() / a.size
                  + ((b - b.mean()) ** 2).var() / b.size)
    assert abs(a.var() - b.var()) < 5 * se2 + 1e-12


@pytest.mark.parametrize("size", [32, 96])
def test_crop_box_distribution_matches_jax(size):
    n = 20_000
    jb = ja.sample_crop_boxes(jax.random.key(0), n, size, size,
                              AUG.crop_scale, AUG.crop_ratio)
    tb = ta.sample_crop_boxes(torch.Generator().manual_seed(0), n, size,
                              size, AUG.crop_scale, AUG.crop_ratio)
    for j, t in zip(jb, tb):
        _moments_agree(t.numpy(), j)
    for t in tb[2:]:
        assert t.min() >= 1.0 and t.max() <= size


def test_flip_and_sigma_distributions_match_jax():
    n = 20_000
    gen = torch.Generator().manual_seed(1)
    k1, k2 = jax.random.split(jax.random.key(1))
    _moments_agree(ta.sample_flips(gen, n, 0.5).float().numpy(),
                   (jax.random.uniform(k1, (n,)) < 0.5).astype(np.float32))
    ts = ta.sample_blur_sigma(gen, n, AUG.blur_sigma).numpy()
    _moments_agree(ts, jax.random.uniform(k2, (n,), minval=0.1, maxval=2.0))
    assert ts.min() >= 0.1 and ts.max() <= 2.0


def test_random_resized_crop_flip_is_sample_then_apply():
    imgs = torch.rand(6, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = ta.random_resized_crop_flip(torch.Generator().manual_seed(4), imgs,
                                      (24, 24))
    gen = torch.Generator().manual_seed(4)
    boxes = ta.sample_crop_boxes(gen, 6, 32, 32, (0.08, 1.0), (0.75, 4 / 3))
    flip = ta.sample_flips(gen, 6, 0.5)
    torch.testing.assert_close(out, ta.crop_resize_flip(imgs, boxes, (24, 24),
                                                        flip), rtol=0, atol=0)


def test_augment_train_pair_draws_two_views():
    gen = torch.Generator().manual_seed(0)
    imgs = torch.from_numpy(_u8(4, 32, 1))
    v1, v2 = ta.augment_train_pair(gen, imgs, AUG, CIFAR10)
    assert v1.shape == v2.shape == (4, 32, 32, 3)
    assert torch.isfinite(v1).all() and torch.isfinite(v2).all()
    assert not torch.equal(v1, v2)
