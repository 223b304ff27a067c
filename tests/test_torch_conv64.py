"""What surrounds the C = 64 conv kernels B4f/B4w (``csrc/conv64.cu``) on
the Python side: the packing of the filter that B4f copies into shared
memory as it is, and the mirror of the kernels' tiles and row items,
checked against a brute-force enumeration of output pixels. The kernels
themselves run only on the card (``chip_smoke.py``); the numerics of the
plain versions are held against JAX's Pallas kernel in
``tests/test_torch_conv.py``. No JAX here, tiny tensors only: every test
takes well under a second."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops.kernels import conv64 as tc64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _filter(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(
        np.float32))


def test_unpack_inverts_pack_filter():
    w = _filter().to(torch.bfloat16)
    packed = tc64.pack_filter(w)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (9, 64, 8, 8) and packed.is_contiguous()
    assert torch.equal(tc64.unpack_filter(packed), w)
    # The swizzle moves chunks: the packing is not the plain [tap][co][ci].
    plain = w.permute(2, 3, 0, 1).reshape(9, 64, 64)
    assert not torch.equal(packed.reshape(9, 64, 64), plain)
    assert torch.equal(packed.reshape(9, 64, 64)[:, 0], plain[:, 0])


def test_pack_filter_takes_a_strided_view_and_casts_to_bf16():
    w = _filter(seed=6)                       # float32
    rot = tc64.rot180_swap(w)                 # a flipped, transposed view
    assert not rot.is_contiguous()
    assert torch.equal(tc64.pack_filter(rot),
                       tc64.pack_filter(rot.contiguous().to(torch.bfloat16)))
    assert torch.equal(tc64.unpack_filter(tc64.pack_filter(rot)),
                       rot.to(torch.bfloat16))


def test_pack_filter_layout_at_chosen_elements():
    """w[co, ci, ky, kx] sits where B4f's K-major 128-byte-swizzle
    descriptor reads it: tap 3 ky + kx, row co of 128 bytes, 16-byte chunk
    (ci // 8) ^ (co % 8), element ci % 8."""
    w = _filter(seed=1).to(torch.bfloat16)
    flat = tc64.pack_filter(w).reshape(-1)
    rng = np.random.default_rng(2)
    picks = rng.integers(0, 64, (64, 2)).tolist() + [[0, 0], [7, 63],
                                                      [63, 8], [9, 17]]
    for co, ci in picks:
        for ky in range(3):
            for kx in range(3):
                off = ((3 * ky + kx) * 64 + co) * 64 \
                    + ((ci // 8) ^ (co % 8)) * 8 + ci % 8
                assert flat[off] == w[co, ci, ky, kx]


def test_plain_version_gives_the_same_y_from_the_unpacked_filter():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 5, 7)).astype(
        np.float32)).to(torch.bfloat16)
    w = _filter(seed=4)
    want = tc64.conv3x3_c64_plain(x, w)
    got = tc64.conv3x3_c64_plain(x, tc64.unpack_filter(tc64.pack_filter(w)))
    assert torch.equal(got, want)


# (N, H, W): layer1 at batch 512 (1,024 images), chip_smoke.py's ragged
# shapes (W not a multiple of 8, W above 8 and not a multiple of 8, and W
# above 256, which needs column tiles), a single pixel (the gate takes
# it), STL-10's layer1 width and a tall narrow image.
_SHAPES = ((1024, 32, 32), (3, 5, 7), (5, 9, 17), (2, 3, 300), (1, 1, 1),
           (2, 96, 96), (1, 40, 3))


@pytest.mark.parametrize("kernel", (0, 1))
@pytest.mark.parametrize("shape", _SHAPES)
def test_tile_boxes_cover_every_output_pixel_once_inside_its_box(shape,
                                                                 kernel):
    n, h, w = shape
    wt, rows, nct, nrt, tiles = tc64.geometry(n, h, w, kernel)
    boxes = tc64.tile_boxes(n, h, w, kernel)
    assert len(boxes) == tiles == n * nrt * nct
    assert wt % (8 if kernel == 0 else 16) == 0 and wt <= tc64.MAX_COLS
    if kernel == 0:
        assert rows * wt <= tc64.FWD_TILE
        assert (rows + 2) * wt <= tc64.FWD_SLOT
    else:
        assert rows * wt <= tc64.WGRAD_ITEM
    b = np.array(boxes)
    img, r0, r1, c0, c1 = b.T
    assert ((0 <= img) & (img < n)).all()
    assert ((r1 - r0 == rows) & (c1 - c0 == wt)).all()
    assert ((r0 < h) & (c0 < w)).all()   # no tile lies wholly outside
    seen = np.zeros((n, h, w), dtype=np.int64)
    for i, y0, y1, x0, x1 in boxes:
        seen[i, y0:y1, x0:x1] += 1        # numpy clips at the image's edge
    assert (seen == 1).all()
    # Brute force at sampled pixels: exactly one tile holds the pixel, and
    # its 3x3 window lies in that tile's input box (one row and one column
    # of halo on each side).
    rng = np.random.default_rng(5)
    for i, y, x in zip(rng.integers(0, n, 64), rng.integers(0, h, 64),
                       rng.integers(0, w, 64)):
        hit = (img == i) & (r0 <= y) & (y < r1) & (c0 <= x) & (x < c1)
        assert hit.sum() == 1
        t = int(hit.argmax())
        assert r0[t] - 1 <= y - 1 and y + 1 <= r1[t]
        assert c0[t] - 1 <= x - 1 and x + 1 <= c1[t]


def test_geometry_at_the_path_shape_and_column_tiles():
    # Layer1 at batch 512: B4f tiles of 8 rows x 32 columns (two
    # warpgroups of 128 pixels), B4w items of two 32-column rows.
    assert tc64.geometry(1024, 32, 32, 0) == (32, 8, 1, 4, 4096)
    assert tc64.geometry(1024, 32, 32, 1) == (32, 2, 1, 16, 16384)
    # 300 columns: five column tiles of 60 columns, rounded up.
    assert tc64.geometry(2, 3, 300, 0) == (64, 3, 5, 1, 10)
    assert tc64.geometry(2, 3, 300, 1) == (64, 1, 5, 3, 30)
    assert tc64.geometry(5, 9, 17, 0) == (24, 9, 1, 1, 5)
    assert tc64.geometry(5, 9, 17, 1) == (32, 2, 1, 5, 25)
    assert tc64.geometry(3, 5, 7, 1) == (16, 4, 1, 2, 6)
    assert tc64.geometry(2, 96, 96, 1) == (48, 1, 2, 96, 384)
