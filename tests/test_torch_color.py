"""The port's colour kernel (plain path on the CPU) against the JAX
package's Pallas colour kernel in interpret mode.

The factors and schedules are drawn on the JAX side with its
``sample_color_params`` (the same key ``color_distort_pallas`` uses) and fed
to the port's apply function. Tolerance atol 1e-5 on normalised values of
order 1: float32 on both sides; the contrast mean is a sum over all pixels
taken in another order, and the normalisation divides by std ~0.2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.config import CIFAR10, STL10, AugmentConfig
from simclr_tpu.ops import augment as ja
from simclr_tpu.ops.pallas import color as jc
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.ops.kernels import color as tc

ATOL = 1e-5
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


def _images(n, size, seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, size, size, 3)).astype(np.float32)
    if ties:
        # Pixels where two or three channels tie, black and white pixels:
        # the hue priority order and the division guards.
        x[:, 0::4, :, 1] = x[:, 0::4, :, 0]           # r == g
        x[:, 1::4, :, 2] = x[:, 1::4, :, 1]           # g == b
        x[:, 2::4, :, 2] = x[:, 2::4, :, 0]           # r == b
        x[:, 3::4, 0::2, :] = x[:, 3::4, 0::2, :1]    # grey (delta == 0)
        x[:, :, 0, :] = 0.0                           # maxc == 0
        x[:, :, 1, :] = 1.0
    return x


def _jax_params(key, n, aug=AUG):
    f, s = jc.sample_color_params(key, n, aug.color_distort_strength,
                                  aug.color_jitter_prob, aug.color_drop_prob)
    return np.array(f), np.array(s)


def _port(images, factors, schedule, ds):
    return tc.color_distort(torch.from_numpy(images),
                            torch.from_numpy(factors),
                            torch.from_numpy(schedule), ds.mean, ds.std)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_matches_pallas_kernel(seed, ties):
    n = 16
    imgs = _images(n, 32, seed, ties)
    key = jax.random.key(100 + seed)
    factors, schedule = _jax_params(key, n)
    assert (factors[:, 3] < 0).any() and (factors[:, 3] > 0).any()
    ref = jc.color_distort_pallas(key, jnp.asarray(imgs), AUG, CIFAR10,
                                  interpret=True)
    out = _port(imgs, factors, schedule, CIFAR10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_large_negative_hue_shift_matches_pallas():
    """Full-strength hue (|fh| up to 0.2): h + fh well below zero goes
    through the floor modulo."""
    aug = AugmentConfig(color_distort_strength=1.0, color_jitter_prob=1.0)
    n = 16
    imgs = _images(n, 16, 9, ties=True)
    key = jax.random.key(9)
    factors, schedule = _jax_params(key, n, aug)
    assert (factors[:, 3] < -0.1).any()
    ref = jc.color_distort_pallas(key, jnp.asarray(imgs), aug, CIFAR10,
                                  interpret=True)
    np.testing.assert_allclose(_port(imgs, factors, schedule,
                                     CIFAR10).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=0)


def test_stl_sized_images_match_pallas():
    n = 8
    imgs = _images(n, 96, 5)
    key = jax.random.key(5)
    factors, schedule = _jax_params(key, n)
    ref = jc.color_distort_pallas(key, jnp.asarray(imgs), AUG, STL10,
                                  interpret=True)
    np.testing.assert_allclose(_port(imgs, factors, schedule, STL10).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("op,name", [
    (0, "adjust_brightness"), (1, "adjust_contrast"),
    (2, "adjust_saturation"), (3, "adjust_hue")])
def test_single_ops_match_jax(op, name):
    imgs = _images(6, 8, op, ties=True)
    factor = np.linspace(-0.1, 0.1, 6).astype(np.float32) if op == 3 else \
        np.linspace(0.6, 1.4, 6).astype(np.float32)
    ref = getattr(ja, name)(jnp.asarray(imgs), jnp.asarray(factor))
    out = getattr(ta, name)(torch.from_numpy(imgs), torch.from_numpy(factor))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_hsv_round_trip_matches_jax():
    imgs = _images(4, 8, 3, ties=True)
    hsv_j = ja.rgb_to_hsv(jnp.asarray(imgs))
    hsv_t = ta.rgb_to_hsv(torch.from_numpy(imgs))
    np.testing.assert_allclose(hsv_t.numpy(), np.asarray(hsv_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ta.hsv_to_rgb(hsv_t).numpy(),
                               np.asarray(ja.hsv_to_rgb(hsv_j)), atol=1e-6,
                               rtol=0)


def test_floor_mod_takes_the_divisor_sign_like_jnp():
    x = np.array([-1e-9, -0.3, -1.0, 0.0, 5.9999995, 6.0, -6.0, 12.000001,
                  -2.5e-8, 0.99999994], np.float32)
    for m in (1.0, 6.0):
        np.testing.assert_array_equal(
            ta.floor_mod(torch.from_numpy(x), m).numpy(),
            np.asarray(jnp.asarray(x) % m))


def test_sampled_params_have_the_jax_distributions():
    """Moments of the port's torch.Generator draws against the stated
    distributions (n = 20000; bounds are > 5 standard errors)."""
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    f, s = ta.sample_color_params(gen, n, 0.5, 0.8, 0.2)
    f, s = f.numpy(), s.numpy()
    applied = f[:, 3] != 0
    assert abs(applied.mean() - 0.8) < 0.02
    for col in range(3):  # U(0.6, 1.4) when applied, else 1
        v = f[applied, col]
        assert v.min() >= 0.6 and v.max() <= 1.4
        assert abs(v.mean() - 1.0) < 0.01
        assert (f[~applied, col] == 1.0).all()
    h = f[applied, 3]
    assert h.min() >= -0.1 and h.max() <= 0.1 and abs(h.mean()) < 0.003
    assert abs(f[:, 4].mean() - 0.2) < 0.02
    assert set(np.unique(f[:, 4])) <= {0.0, 1.0}
    assert (f[:, 5:] == 0).all()
    assert s.dtype == np.int32
    assert (np.sort(s, axis=1) == np.arange(4)).all()
    counts = np.unique(s, axis=0, return_counts=True)[1]
    assert len(counts) == 24 and counts.min() > n / 24 * 0.8
    np.testing.assert_array_equal(ta._PERMS, jc._PERMS)


def test_identity_params_only_normalise():
    """Identity factors leave only the normalisation, up to the rounding
    of the hue step's HSV round trip (hence ATOL, not exact)."""
    n = 4
    imgs = _images(n, 8, 4)
    factors = np.zeros((n, 8), np.float32)
    factors[:, :3] = 1.0
    schedule = np.tile(np.arange(4, dtype=np.int32), (n, 1))
    out = _port(imgs, factors, schedule, CIFAR10).numpy()
    ref = (imgs - np.asarray(CIFAR10.mean, np.float32)) / np.asarray(
        CIFAR10.std, np.float32)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_wrapper_rejects_unknown_device():
    with pytest.raises(ValueError):
        tc.color_distort(torch.zeros(1, 2, 2, 3, device="meta"),
                         torch.zeros(1, 8), torch.zeros(1, 4,
                                                        dtype=torch.int32),
                         CIFAR10.mean, CIFAR10.std)
