"""Kernel B1's tiling and arithmetic, without the card (numpy and torch only).

``ntxent.geometry`` / ``ntxent.tiles`` mirror the tiling of
``csrc/ntxent.cu`` (chip_smoke.py holds the mirror against the C side's
``ntxent_geometry``): every (row, column) pair of S must be covered once,
every row combined over the cluster once, and every feature of z and dz
taken once. The arithmetic tests emulate the kernels' 3xTF32 products on
the CPU at the main path's shape (2N = 1024, D = 128, chip_smoke.py's
input recipe) and hold them to chip_smoke.py's tolerances against the
float32 plain versions; one TF32 product is shown to miss them.
"""

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops.kernels import ntxent as k

INV_T = 2.0
FWD_TOL = 2e-5   # chip_smoke.py: per-row loss and lse, absolute
BWD_TOL = 1e-4   # chip_smoke.py: dz, as a fraction of max |dz|


@pytest.mark.parametrize("kernel", [0, 1])
@pytest.mark.parametrize("d", [1, 40, 128, 2048])
@pytest.mark.parametrize("n2", [2, 16, 40, 64, 200, 256, 520, 1024, 2048,
                                1000])
def test_tiling_covers_each_pair_once(n2, d, kernel):
    br, row_tiles, cluster, cols, bc, fk, chunks, fblocks = k.geometry(
        n2, d, kernel)
    assert cluster == k.CLUSTER and br % cluster == 0
    assert row_tiles * br >= n2 > (row_tiles - 1) * br
    assert cols % bc == 0 and cluster * cols >= n2
    blocks = k.tiles(n2, d, kernel)
    assert len(blocks) == row_tiles * cluster * fblocks
    pairs = np.zeros((n2, n2), np.int32)
    combined = np.zeros(n2, np.int32)
    features = {}  # dz's features, by the (row tile, rank) that sums them
    chunk_cover = np.zeros(d, np.int32)
    for k0, k1 in blocks[0][3]:
        chunk_cover[k0:k1] += 1
    assert (chunk_cover == 1).all() and len(blocks[0][3]) == chunks
    for rows, rank, col_tiles, k_chunks, feats, comb in blocks:
        assert k_chunks == blocks[0][3]
        cover = features.setdefault((rows, rank), np.zeros(d, np.int32))
        cover[feats[0]:feats[1]] += 1
        if feats[0] > 0:
            continue  # the other feature blocks repeat block 0's pairs
        combined[comb[0]:comb[1]] += 1
        for c0, c1 in col_tiles:
            assert 0 < c1 - c0 <= bc and c0 % bc == 0
            pairs[rows[0]:rows[1], c0:c1] += 1
    assert (pairs == 1).all()
    assert (combined == 1).all()
    assert len(features) == row_tiles * cluster
    assert all((f == (1 if kernel else 0)).all() for f in features.values())


def test_main_shape_tiling():
    # 2N = 1024, D = 128: 16 clusters of 4 blocks (64 blocks), two column
    # tiles a block forward and four backward; one chunk of D.
    assert k.geometry(1024, 128, 0) == (64, 16, 4, 256, 128, 128, 1, 1)
    assert k.geometry(1024, 128, 1) == (64, 16, 4, 256, 64, 128, 1, 1)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest tf32 value, ties away from zero
    (cvt.rna.tf32.f32): add half of the 13 dropped bits to the magnitude,
    then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b.T as the kernels compute it: lo*hi + hi*lo, then hi*hi, float32
    sums."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def _mm1(a, b):
    """a @ b.T in one TF32 pass."""
    return _tf32(a) @ _tf32(b).T


def _forward(z, mm):
    n2 = z.shape[0]
    s = mm(z, z) * INV_T
    s = s.masked_fill(torch.eye(n2, dtype=torch.bool), k.NEG)
    m = s.max(dim=1).values
    lse = torch.log(torch.exp(s - m[:, None]).sum(dim=1)) + m
    pos = s[torch.arange(n2), k._positives(n2, "cpu")]
    return lse - pos, lse


def _backward(z, lse, g, mm):
    n2 = z.shape[0]
    s = mm(z, z) * INV_T
    s = s.masked_fill(torch.eye(n2, dtype=torch.bool), k.NEG)
    w = torch.exp(s - lse[:, None]) + torch.exp(s - lse[None, :])
    w[torch.arange(n2), k._positives(n2, "cpu")] -= 2.0
    return mm(w, z.T.contiguous()) * (g * INV_T / n2)


@pytest.fixture(scope="module")
def main_shape():
    """chip_smoke.py's inputs at 2N = 1024, D = 128: anchors and positives
    2.5 x noise away, L2-normalised; the plain versions' outputs."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 128), dtype=np.float32)
    b = a + 2.5 * rng.standard_normal((512, 128), dtype=np.float32)
    z = torch.from_numpy(np.concatenate([a, b]))
    z = (z / z.norm(dim=1, keepdim=True)).contiguous()
    loss, _, lse = k.ntxent_fwd_plain(z, INV_T)
    g = torch.full((1,), 0.7)
    dz = k.ntxent_bwd_plain(z, lse, INV_T, g)
    return z, loss, lse, g, dz


@pytest.mark.parametrize("mm, ok", [(_mm3, True), (_mm1, False)],
                         ids=["3xtf32", "one_tf32_pass"])
def test_forward_arithmetic_against_tolerance(main_shape, mm, ok):
    z, loss, lse, _, _ = main_shape
    got_loss, got_lse = _forward(z, mm)
    err = max((got_loss - loss).abs().max().item(),
              (got_lse - lse).abs().max().item())
    assert (err < FWD_TOL) == ok, err
    if ok:
        assert err < FWD_TOL / 4  # room for the tensor core's own sums


@pytest.mark.parametrize("mm, ok", [(_mm3, True), (_mm1, False)],
                         ids=["3xtf32", "one_tf32_pass"])
def test_backward_arithmetic_against_tolerance(main_shape, mm, ok):
    z, _, lse, g, dz = main_shape
    err = (_backward(z, lse, g, mm) - dz).abs().max().item()
    rel = err / dz.abs().max().item()
    assert (rel <= BWD_TOL) == ok, rel
    if ok:
        assert rel <= BWD_TOL / 4


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32 keeps 10 fraction bits
    x = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0])
    assert torch.equal(_tf32(x), want)
    hi, lo = _split(x)
    assert torch.equal(hi, _tf32(hi)) and torch.equal(lo, _tf32(lo))
