"""What surrounds the Winograd kernels B5f/B5w (``csrc/winograd.cu``) on
the Python side: the packing of the transformed filter U that B5f copies
into shared memory, and the mirror of the kernels' tile blocks and TMA
boxes, checked against a brute-force enumeration of tiles. The kernels
themselves run only on the card (``chip_smoke.py``); the numerics of the
plain versions are held against JAX in ``tests/test_torch_conv.py``.
Tiny tensors only: every test here takes well under a second."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops.kernels import winograd as twg

# (C, K): the path's widths and a ragged pair (K not a multiple of 128).
_UWIDTHS = ((128, 128), (96, 160), (32, 32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _u(c, k, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((16, c, k)).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("c,k", _UWIDTHS)
def test_unpack_inverts_pack_u(c, k):
    u = _u(c, k)
    packed = twg.pack_u(u)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == 16 * c * -(-k // twg.FWD_K) * twg.FWD_K
    assert torch.equal(twg.unpack_u(packed, k), u)
    assert not torch.equal(packed.reshape(-1)[:u.numel()], u.reshape(-1))


def test_pack_u_layout_and_zero_padding():
    """Element (pos, c, k) sits where B5f's wgmma descriptors read it:
    block k // 128, step c // 16, position, then 8 x 8 core matrices
    [k / 8][c / 8][k % 8][c % 8]; the padded channels of the last block
    are zero."""
    c, k = 96, 160
    u = _u(c, k, seed=1)
    packed = twg.pack_u(u)
    flat = packed.reshape(-1)
    steps = c // twg.FWD_C
    rng = np.random.default_rng(2)
    for pos, cc, kk in zip(rng.integers(0, 16, 64), rng.integers(0, c, 64),
                           rng.integers(0, k, 64)):
        kb, kl, cs, cl = kk // 128, kk % 128, cc // 16, cc % 16
        off = (((kb * steps + cs) * 16 + pos) * 2048 + (kl // 8) * 128
               + (cl // 8) * 64 + (kl % 8) * 8 + cl % 8)
        assert flat[off] == u[pos, cc, kk]
    assert not twg.unpack_u(packed, 256)[:, :, k:].any()


def test_plain_version_gives_the_same_y_from_packed_and_unpacked_u():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 96, 6, 10)).astype(
        np.float32)).to(torch.bfloat16)
    u = _u(96, 160, seed=4)
    want = twg.winograd_fwd_plain(x, u)
    got = twg.winograd_fwd_plain(x, twg.unpack_u(twg.pack_u(u), 160))
    assert torch.equal(got, want)


# (N, H, W): the stride-1 conv2 of layer2-4 at batch 512 (1,024 images),
# chip_smoke.py's ragged shape, STL-10's layer1-sized input, tiny images,
# and rows wider than a block.
_GEOM_SHAPES = ((1024, 16, 16), (1024, 8, 8), (1024, 4, 4), (3, 6, 10),
                (2, 96, 96), (5, 2, 2), (2, 2, 300), (3, 40, 6))


@pytest.mark.parametrize("kernel", (0, 1))
@pytest.mark.parametrize("shape", _GEOM_SHAPES)
def test_tile_blocks_cover_every_tile_once_inside_one_box(shape, kernel):
    n, h, w = shape
    bt, max_px = twg.TILE_BLOCKS[kernel]
    geom = twg.tile_blocks(n, h, w, kernel)
    g, rb, cb, ng, nr, nc = geom
    bw, bh = 2 * cb + 2, 2 * rb + 2
    assert 1 <= g * rb * cb <= bt
    assert bw * bh * g <= max_px
    assert max(bw, bh, g) <= 256            # TMA's limit on a box side
    seen = np.zeros((n, h // 2, w // 2), dtype=np.int64)
    for b in range(ng * nr * nc):
        tiles = twg.block_tiles(geom, b)
        n0, ty0, tx0 = tiles[0]
        for img, ty, tx in tiles:
            if img >= n or ty >= h // 2 or tx >= w // 2:
                continue
            seen[img, ty, tx] += 1
            # The tile's 4x4 patch, from pixel (2 ty - 1, 2 tx - 1), lies
            # in the box that starts at (2 ty0 - 1, 2 tx0 - 1, n0).
            assert 0 <= img - n0 < g
            assert 0 <= 2 * (ty - ty0) and 2 * (ty - ty0) + 4 <= bh
            assert 0 <= 2 * (tx - tx0) and 2 * (tx - tx0) + 4 <= bw
    assert (seen == 1).all()
