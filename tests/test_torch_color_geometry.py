"""Kernel B2's launch and contrast sum, without the card (numpy and torch
only).

``color.geometry`` and ``color.pixels`` mirror ``csrc/color.cu`` (its
instantiations, pixel-to-thread map and bulk-copy span; chip_smoke.py
holds the mirror against the C side's ``color_geometry``): every pixel of
an image must be owned by one thread once and read from one place once,
from the bulk-copied bytes or, for the at most two pixels that cross the
copy's 16-byte aligned ends, from global memory. The contrast test
emulates the kernel's fixed-order sum of the grey in float32 and holds it
to the plain version's mean; the floor-modulo tests hold a numpy mirror of
the kernel's shortcuts for the hue step's small arguments to the plain
``floor_mod`` bit for bit (the CUDA functions themselves run only on the
card, where chip_smoke.py holds the kernel's output to 1e-4).
"""

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops import augment
from simclr_tpu_torch.ops.kernels import color as k

OFFSETS = (0, 4, 8, 12)   # an image's address modulo 16 (float32 data)
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block may take
# Image sizes at and around every instantiation's limit, ragged ones and
# ones far below a limit (4,096 pixels take STL-10's 1024 x 9 block).
SIZES = (1, 2, 3, 5, 63, 255, 256, 257, 1023, 1024, 1025, 4095, 4096, 4097,
         9215, 9216, 9217, 16383, 16384)


def test_one_instantiation_for_every_size():
    limits = [most for most, _, _ in k.SHAPES]
    assert limits == sorted(limits) and limits[-1] == k.MAX_HW
    for most, threads, per in k.SHAPES:
        assert threads % 32 == 0 and threads <= 1024
        assert threads * per == most   # the largest image fills the block
        assert 12 * most + 16 <= SMEM_LIMIT
    for hw in range(1, k.MAX_HW + 1):
        threads, per, _, _, smem = k.geometry(hw, 0)
        assert threads * per >= hw and smem == 12 * threads * per + 16
        smaller = [t * p for most, t, p in k.SHAPES if t * p < threads * per]
        assert all(s < hw for s in smaller)   # the smallest that holds hw


def test_geometry_refuses_what_the_kernel_refuses():
    for hw, mis in ((0, 0), (k.MAX_HW + 1, 0), (64, 2), (64, 16)):
        with pytest.raises(ValueError):
            k.geometry(hw, mis)


@pytest.mark.parametrize("hw", SIZES)
def test_pixel_map_covers_each_pixel_once(hw):
    own = k.pixels(hw)
    threads, per = k.geometry(hw, 0)[:2]
    assert own.shape == (threads, per)
    taken = np.sort(own[own >= 0])
    np.testing.assert_array_equal(taken, np.arange(hw))
    # A warp's 32 lanes read 32 consecutive pixels (words 3 p + c): each
    # of the three reads hits 32 distinct banks.
    for w in range(threads // 32):
        for kk in range(per):
            p = own[32 * w: 32 * w + 32, kk]
            p = p[p >= 0]
            assert (np.diff(p) == 1).all()
            for c in range(3):
                banks = (3 * p + c) % 32
                assert len(set(banks.tolist())) == len(p)


def _sources(hw, mis):
    """Per pixel, True where the kernel reads it from the bulk-copied
    bytes, False where its thread loads it from global memory."""
    lo, hi = k.geometry(hw, mis)[2:4]
    start = 12 * np.arange(hw)
    return (start >= lo) & (start + 12 <= hi)


def test_bulk_span_for_every_size_and_offset():
    for hw in range(1, k.MAX_HW + 1):
        n_bytes = 12 * hw
        for mis in OFFSETS:
            _, _, lo, hi, smem = k.geometry(hw, mis)
            assert 0 <= lo <= hi <= n_bytes
            # Aligned in global memory and, at offset mis, in shared.
            assert (mis + lo) % 16 == 0 and (hi - lo) % 16 == 0
            assert mis + hi <= smem
            # The largest aligned span: less than 16 bytes left at each end,
            # or none at all where no 16 aligned bytes fit.
            if hi > lo:
                assert lo < 16 and n_bytes - hi < 16
            else:
                first = (16 - mis) % 16
                assert first + 16 > n_bytes
            # Only the first and the last pixel can cross its ends.
            if hi > lo and hw > 2:
                assert 12 >= lo and 12 * (hw - 1) <= hi


@pytest.mark.parametrize("hw", [1, 2, 3, 4, 5, 7, 63, 64, 100, 257])
@pytest.mark.parametrize("mis", OFFSETS)
def test_each_byte_read_once_brute_force(hw, mis):
    """Bytes of the image by where they come from: the bulk copy, then a
    pixel taken from shared memory; or a plain load of its pixel. Every
    byte must come once, and the bulk copy's aligned span must be the
    largest one."""
    _, _, lo, hi, _ = k.geometry(hw, mis)
    n_bytes = 12 * hw
    aligned = [b for b in range(n_bytes + 1) if (mis + b) % 16 == 0]
    assert (lo, hi) == ((aligned[0], aligned[-1]) if len(aligned) > 1
                        else (aligned[0], aligned[0]))
    read = np.zeros(n_bytes, np.int32)
    for p, in_copy in enumerate(_sources(hw, mis)):
        read[12 * p: 12 * p + 12] += 1
        if in_copy:
            assert lo <= 12 * p and 12 * p + 12 <= hi
    np.testing.assert_array_equal(read, 1)
    direct = np.flatnonzero(~_sources(hw, mis))
    assert set(direct.tolist()) <= {0, hw - 1} or hi == lo


def _fixed_order_mean(gray: np.ndarray) -> np.float32:
    """The kernel's contrast mean of one image's float32 grey: each thread
    sums its pixels in k order, a warp's lanes by the xor shuffle tree,
    then the warp partials in warp order; divided by hw."""
    hw = gray.shape[0]
    own = k.pixels(hw)
    part = np.zeros(own.shape[0], np.float32)
    for kk in range(own.shape[1]):
        p = own[:, kk]
        part = np.where(p >= 0, part + gray[np.maximum(p, 0)], part)
    lanes = part.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    assert (lanes == lanes[:, :1]).all()   # every lane has the same bits
    total = np.float32(0.0)
    for w in range(lanes.shape[0]):
        total = np.float32(total + lanes[w, 0])
    return np.float32(total / np.float32(hw))


@pytest.mark.parametrize("hw", [63, 1024, 9216, 16384])
def test_contrast_mean_in_fixed_order(hw):
    rng = np.random.default_rng(hw)
    img = rng.uniform(0.0, 1.0, (1, 1, hw, 3)).astype(np.float32)
    gray = augment._gray(torch.from_numpy(img))
    plain = gray.mean(dim=(1, 2)).item()
    g = gray.numpy().reshape(hw)
    got = _fixed_order_mean(g)
    assert abs(float(got) - plain) <= 1e-6
    assert abs(float(got) - g.astype(np.float64).mean()) <= 1e-6
    assert _fixed_order_mean(g).tobytes() == got.tobytes()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _plain_floor_mod(x: np.ndarray, m: float) -> np.ndarray:
    return augment.floor_mod(torch.from_numpy(x), m).numpy()


def _near_values(m: float, n: int, seed: int) -> np.ndarray:
    """float32 values around 0, +-m and +-2m (the shortcut's edges and
    the fmod's multiples), and uniform ones within +-3m."""
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, m, 2 * m, m / 2, 1e-30, 1.5e-45], np.float32)
    edges = np.concatenate([edges, -edges])
    steps = [edges]
    for _ in range(4):
        steps.append(np.nextafter(steps[-1], np.float32(np.inf)))
        steps.append(np.nextafter(steps[-2], np.float32(-np.inf)))
    uniform = rng.uniform(-3 * m, 3 * m, n).astype(np.float32)
    return np.concatenate(steps + [uniform]).astype(np.float32)


def test_floor_mod1_of_small_is_fmod_bit_for_bit():
    """csrc/color.cu:floor_mod1_of_small on h / 6 (h in [-1, 5], or 0 for
    grey pixels): x + 1 where x < 0, else x."""
    rng = np.random.default_rng(1)
    h = np.concatenate([rng.uniform(-1, 5, 300_000),
                        [-1.0, 0.0, -0.0, 1e-30, -1e-30, 5.0]])
    h = h.astype(np.float32)
    h = np.concatenate([h, np.nextafter(h, np.float32(-1)),
                        np.nextafter(h, np.float32(5))])
    x = (h / np.float32(6)).astype(np.float32)
    got = np.where(x < 0, x + np.float32(1), x).astype(np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(_plain_floor_mod(x, 1.0)))


@pytest.mark.parametrize("m", [1.0, 6.0])
def test_floor_mod_near_is_fmod_bit_for_bit(m):
    """csrc/color.cu:floor_mod_near: x itself or |x| - m with x's sign
    where |x| < 2 m, then moved onto m's sign; fmod elsewhere."""
    x = _near_values(m, 200_000, int(m))
    a = np.abs(x)
    mm = np.float32(m)
    r = np.where(a >= mm, np.copysign(a - mm, x), x).astype(np.float32)
    r = np.where(r < 0, r + mm, r).astype(np.float32)
    got = np.where(a < 2 * mm, r, _plain_floor_mod(x, m))
    np.testing.assert_array_equal(_bits(got), _bits(_plain_floor_mod(x, m)))


def test_floor_mod6_of_positive_is_fmod_bit_for_bit():
    """csrc/color.cu:floor_mod6_of_positive on n + h6 (n in {1, 3, 5},
    h6 in [0, 6]): x - 6 where x >= 6, else x."""
    rng = np.random.default_rng(6)
    h6 = np.concatenate([rng.uniform(0, 6, 300_000),
                         [0.0, 1.0, 3.0, 5.0, 6.0]]).astype(np.float32)
    h6 = np.concatenate([h6, np.nextafter(h6, np.float32(0)),
                         np.nextafter(h6, np.float32(6))])
    for n in (1.0, 3.0, 5.0):
        x = (np.float32(n) + h6).astype(np.float32)
        got = np.where(x >= 6, x - np.float32(6), x).astype(np.float32)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_plain_floor_mod(x, 6.0)))
