"""The fused bottleneck kernels' plan (B6f/B6b, ``csrc/bottleneck.cu``) in
pure Python, no JAX and no card: the tiles of ``geometry`` and
``tile_pixels``, the halo each tile computes a1 on, conv1's rounds of x
boxes in a warpgroup's buffer, the weight-gradient pixel ranges, the
workspace, and the shapes the plan refuses, at the four ResNet-50 stage
shapes at batch 512 (1,024 images), ``chip_smoke.py``'s two ragged ones
and the widest rows the gate takes. ``chip_smoke.py``'s build phase holds
these mirrors against the C side (``bottleneck_geometry``,
``bottleneck_bwd_workspace``) on the card.
"""

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops.kernels import bottleneck as tk
from simclr_tpu_torch.ops.kernels import conv64 as tc64

# (N, C, H, W): layer1-4 at 1,024 images, the two ragged shapes, and rows
# as wide as the gate takes (W = 8192 / C), which need halos of two rows.
STAGES = ((1024, 64, 32, 32), (1024, 128, 16, 16), (1024, 256, 8, 8),
          (1024, 512, 4, 4))
RAGGED = ((5, 128, 7, 7), (3, 512, 7, 7))
WIDE = ((2, 64, 5, 128), (2, 128, 3, 64), (3, 256, 3, 32), (2, 512, 5, 16),
        (2, 512, 9, 9), (1, 64, 1, 65), (4, 128, 2, 40))
SHAPES = STAGES + RAGGED + WIDE
SMS = 132


def _pixel_coords(p, h, w):
    img, q = divmod(p, h * w)
    return img, q // w, q % w


@pytest.mark.parametrize("shape", SHAPES)
def test_every_pixel_in_exactly_one_tile_and_its_halo_inside_the_image(
        shape):
    n, c, h, w = shape
    t, whole, per_image, tiles, off, hb, groups = tk.geometry(n, h, w, c)
    hw = h * w
    assert 1 <= t <= tk.TILE and groups == -(-tiles // 2)
    assert t + 2 * off <= tk.HALO_CAP[c] and t + 2 * off <= 64 * hb
    assert 64 * hb <= tk.HALO_ROWS[c]
    seen = np.zeros(n * hw, dtype=np.int64)
    for p0, tp, lo in tk.tile_pixels(n, h, w, c):
        assert 1 <= tp <= t and lo == p0 - off
        seen[p0:p0 + tp] += 1
        if whole:
            # Whole images, no halo.
            assert off == 0 and p0 % hw == 0 and (tp % hw == 0)
            continue
        # One image; every in-image 3x3 neighbour of every pixel lies in
        # the halo [lo, lo + t + 2 off), and never in another image.
        img0 = p0 // hw
        assert (p0 + tp - 1) // hw == img0
        for p in range(p0, p0 + tp):
            _, y, x = _pixel_coords(p, h, w)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= y + dy < h and 0 <= x + dx < w:
                        q = p + dy * w + dx
                        assert lo <= q < lo + t + 2 * off
                        assert q // hw == img0
    assert (seen == 1).all()


def test_stage_shapes_tile_as_designed():
    # Layer1: tiles of two 32-pixel rows with a halo of one row on each
    # side (two 64-row blocks); layer2: four 16-pixel rows; layer3 one
    # 8x8 image, layer4 four 4x4 images, without halo.
    assert tk.geometry(1024, 32, 32, 64) == (64, 0, 16, 16384, 32, 2, 8192)
    assert tk.geometry(1024, 16, 16, 128) == (64, 0, 4, 4096, 16, 2, 2048)
    assert tk.geometry(1024, 8, 8, 256) == (64, 1, 0, 1024, 0, 1, 512)
    assert tk.geometry(1024, 4, 4, 512) == (64, 1, 0, 256, 0, 1, 128)
    assert tk.geometry(5, 7, 7, 128) == (49, 1, 0, 5, 0, 1, 3)
    assert tk.geometry(3, 7, 7, 512) == (49, 1, 0, 3, 0, 1, 2)
    # Two tiles share each weight chunk (128 pixels per weight byte
    # fetched): the two warpgroups of a block at C <= 128, the two blocks
    # of a cluster at C >= 256.
    assert tk.grid(1024, 4, 4, 512, SMS) == SMS
    assert tk.grid(1024, 32, 32, 64, SMS) == SMS
    assert tk.grid(5, 7, 7, 128, SMS) == 3
    assert tk.grid(3, 7, 7, 512, SMS) == 4


@pytest.mark.parametrize("shape", SHAPES)
def test_conv1_rounds_keep_x_boxes_off_written_a1(shape):
    n, c, h, w = shape
    hb = tk.geometry(n, h, w, c)[5]
    written = set()
    rows = tk.HALO_ROWS[c] // 64
    for own, slots in tk.conv1_rounds(c, hb):
        # At least two slots (the producer refills a slot only once the
        # consumers have released it, one step behind).
        assert len(slots) >= 2
        boxes = [b for slot in slots for b in slot]
        assert len(set(boxes)) == len(boxes)
        assert all(0 <= cb < c // 64 and 0 <= rb < rows
                   for cb, rb in boxes + own)
        assert not set(boxes) & written
        written |= set(own)
    # Every a1 box of the halo is written once.
    assert written == {(cb, rb) for cb in range(c // 64)
                       for rb in range(hb)}


@pytest.mark.parametrize("shape", SHAPES)
def test_weight_gradient_ranges_partition_the_pixels(shape):
    n, c, h, w = shape
    px, f = n * h * w, 4 * c
    # dw3 and dw1: 64-pixel items split into equal shares.
    ranges = tk.wgrad_ranges(f, c, px, SMS)
    items = -(-px // 64)
    assert 1 <= ranges <= items
    bounds = [items * r // ranges for r in range(ranges + 1)]
    assert bounds[0] == 0 and bounds[-1] == items
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert ranges * (f // 128) * (c // min(c, 256)) <= 2 * SMS
    # dw2: conv64.cu's row items over (c / 64)^2 channel tiles.
    r2 = tk.dw2_ranges(n, h, w, c, SMS)
    items2 = tc64.geometry(n, h, w, 1)[4]
    assert 1 <= r2 <= items2 and r2 * (c // 64) ** 2 <= SMS
    seen = np.zeros((n, h, w), dtype=np.int64)
    boxes = tc64.tile_boxes(n, h, w, 1)
    for r in range(r2):
        for i, y0, y1, x0, x1 in boxes[items2 * r // r2:
                                       items2 * (r + 1) // r2]:
            seen[i, y0:y1, x0:x1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", STAGES + RAGGED)
def test_workspace_bytes(shape):
    n, c, h, w = shape
    px, f = n * h * w, 4 * c
    up = lambda b: -(-b // 256) * 256
    tiles, groups = tk.geometry(n, h, w, c)[3], tk.geometry(n, h, w, c)[6]
    rows, cols = 4 * tiles, 4 * c + 2 * f   # a row a warp and tile
    partials = max(tk.wgrad_ranges(f, c, px, SMS) * f * c,
                   tk.dw2_ranges(n, h, w, c, SMS) * 9 * c * c) * 4
    want = (up(px * c * 2) * 4        # a1, a2, dy2, dy1
            + up(px * c * 4) * 2      # y1, y2
            + up(px * f * 2)          # dy3
            + up(groups * 2 * f * 8)  # u3's mask: a bit an element
            + up(rows * cols * 4)     # affine partials, summed in levels
            + up(-(-rows // 64) * cols * 4) + up(-(-rows // 4096) * cols * 4)
            + up(partials))
    assert tk.workspace_bytes(n, h, w, c, SMS) == want
    if shape == STAGES[0]:
        # Layer1: 1.87 GB (PR 6's design: 1.07 GB).
        assert 1.86e9 < want < 1.87e9


def test_plan_refuses_exactly_what_supports_refuses():
    bf = torch.bfloat16
    for c in (32, 64, 96, 128, 256, 512, 1024):
        for w in (1, 4, 16, 17, 32, 33, 64, 65, 128, 129):
            for n, h in ((1, 1), (3, 5), (0, 2)):
                x = torch.empty((n, 4 * c, h, w), dtype=bf, device="meta")
                assert ((tk.geometry(n, h, w, c) is not None)
                        == tk.supports(x, c)), (n, c, h, w)
                assert ((tk.workspace_bytes(n, h, w, c, SMS) > 0)
                        == tk.supports(x, c))
    # 2**31 elements: refused by both.
    big = torch.empty((8192, 256, 32, 32), dtype=bf, device="meta")
    assert tk.geometry(8192, 32, 32, 64) is None and not tk.supports(big, 64)
    assert tk.geometry(8191, 32, 32, 64) is not None
