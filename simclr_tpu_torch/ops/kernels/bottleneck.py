"""The fused identity bottleneck: CUDA kernels B6f and B6b
(``csrc/bottleneck.cu``), their plain PyTorch versions, and the autograd
function around them.

Replaces ``simclr_tpu/ops/pallas/bottleneck.py``, with its numerics. For
x (N, 4C, H, W) bf16, bf16 copies of the float32 weights, and six float32
per-channel affines (the folded BNs, ``FoldedBatchNorm``):

    y1 = x w1                a1 = bf16(relu(y1 A1 + B1))
    y2 = conv3x3(a1, w2)     a2 = bf16(relu(y2 A2 + B2))
    y3 = a2 w3               out = bf16(relu(y3 A3 + B3 + x))

with float32 sums of bf16 products and float32 y1, y2, y3; SAME padding
applies to a1. The backward recomputes that forward from x and returns dx
(bf16, rounded once: dy1 w1^T + u3), dw1, dw2, dw3 (float32) and the six
affine gradients (float32 sums over the batch), rounding dy3, dy2 and dy1
to bf16 and nothing else, as the Pallas ``_bwd_kernel`` does.

Layouts are the port's: x is (N, 4C, H, W), normally in channels_last
memory (physically NHWC, as the kernels read it); w1 (C, 4C, 1, 1), w2
(C, C, 3, 3) and w3 (4C, C, 1, 1) as ``nn.Conv2d`` keeps them. A wrapper
brings each operand to channels_last first (a copy only where needed:
autograd promises no layout, and the pooled cotangent has stride 0).

GPU gate (``supports``): a 4-D bf16 tensor with 4C channels, C in {64,
128, 256, 512} (the kernels' instantiations), W <= 8192 / C (a tile and
its halo of one row and a pixel on each side fit a warpgroup's buffer),
any N and H >= 1, fewer than 2**31 elements. JAX's ``pick_tile`` (whole
images in a 9 MB VMEM budget, C % 8 and 4C % 128) is a TPU rule: it
refuses layer4 at batch 1024, which the CUDA kernels take.

The kernels (``csrc/bottleneck.cu``, whose header has the design) tile
the pixels in tiles of at most 64 (``geometry`` mirrors their plan), one
a warpgroup, multiply on wgmma and stream the weights, packed once by
``pack_weights`` into the chunks their ring copies, to two tiles at once
(two warpgroups of a block, or at C >= 256 the two blocks of a cluster).
B6b runs the tile kernel three times and three weight-gradient products
over a workspace (``workspace_bytes``).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel, or raises ``ValueError`` for operands the kernel
cannot take; a build or launch failure propagates. Each launch adds one
to the wrapper's ``launches``. B6f's wrapper is the operator
``simclr_tpu_torch::bottleneck_fwd`` (``registry``), so that
``torch.export`` traces it. Besides x and the weights it takes the six
affines as one vector (``pack_affines``) and the forward half of the
packed weights (``forward_half``: empty for CPU tensors, whose kernel,
the plain version, reads the weights); its CUDA kernel is
``bottleneck_fwd_cuda``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import _build, conv64
from simclr_tpu_torch.ops.kernels._cache import trace_safe_cache
from simclr_tpu_torch.ops.kernels.conv64 import nhwc_operand, rot180_swap

WIDTHS = (64, 128, 256, 512)   # C, the bottleneck width (csrc Cfg)
TILE_ELEMS = 8192              # the gate: W <= TILE_ELEMS / C
TILE = 64                      # output pixels of a tile (one wgmma M)
# Rows of a warpgroup's halo buffer, the largest halo a tile may have and
# the halo blocks of a conv1 round (csrc Cfg<C>::ROWS, CAP and G).
HALO_ROWS = {64: 384, 128: 192, 256: 128, 512: 64}
HALO_CAP = {64: 320, 128: 192, 256: 128, 512: 64}
ROUND_BLOCKS = {64: 2, 128: 1, 256: 1, 512: 1}


def supports(x: torch.Tensor, c: int) -> bool:
    """Whether the kernels take x (N, 4C, H, W) at width c (after a
    layout copy if needed)."""
    return (x.dim() == 4 and x.dtype == torch.bfloat16 and c in WIDTHS
            and x.shape[1] == 4 * c and x.shape[0] >= 1
            and x.shape[2] >= 1 and 1 <= x.shape[3] <= TILE_ELEMS // c
            and x.numel() < 2 ** 31)


def _bf16w(w: torch.Tensor) -> torch.Tensor:
    """A weight rounded to bf16, in float32 for the plain versions."""
    return w.to(torch.bfloat16).to(torch.float32)


def _cs(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _relu_affine(y, a, b):
    """relu(y A + B) in float32 (product, then sum: no fused multiply-add,
    as the kernels compute it)."""
    return torch.relu(y * _cs(a) + _cs(b))


def _recompute(x, w1, w2, w3, affines):
    """The forward's float32 y1, y2, y3 and bf16 a1, a2."""
    a1f, b1f, a2f, b2f, _, _ = affines
    y1 = F.conv2d(x.float(), _bf16w(w1))
    a1 = _relu_affine(y1, a1f, b1f).to(torch.bfloat16)
    y2 = F.conv2d(a1.float(), _bf16w(w2), padding=1)
    a2 = _relu_affine(y2, a2f, b2f).to(torch.bfloat16)
    y3 = F.conv2d(a2.float(), _bf16w(w3))
    return y1, a1, y2, a2, y3


def _pre3(x, y3, affines):
    return y3 * _cs(affines[4]) + _cs(affines[5]) + x.float()


# ---------------------------------------------------------------------------
# Plain versions. On the card they need cuDNN's and cuBLAS's TF32 off to be
# float32.
# ---------------------------------------------------------------------------

def fused_bottleneck_plain(x, w1, w2, w3, affines) -> torch.Tensor:
    """B6f's plain version: the block's forward as above, in x's type."""
    y3 = _recompute(x, w1, w2, w3, affines)[4]
    return torch.relu(_pre3(x, y3, affines)).to(x.dtype)


def fused_bottleneck_bwd_plain(x, w1, w2, w3, affines, g):
    """B6b's plain version: (dx, dw1, dw2, dw3, dA1, dB1, dA2, dB2, dA3,
    dB3) of the block for the cotangent g; the weight gradients in the
    weights' (C, 4C, 1, 1), (C, C, 3, 3), (4C, C, 1, 1) layouts."""
    a1f, b1f, a2f, b2f, a3f, _ = affines
    y1, a1, y2, a2, y3 = _recompute(x, w1, w2, w3, affines)
    red = (0, 2, 3)
    u3 = torch.where(_pre3(x, y3, affines) > 0, g.float(), 0.0)
    dA3, dB3 = (u3 * y3).sum(red), u3.sum(red)
    dy3 = (u3 * _cs(a3f)).to(torch.bfloat16).float()
    dw3 = torch.einsum("nfhw,nchw->fc", dy3, a2.float())
    da2 = F.conv2d(dy3, _bf16w(w3).transpose(0, 1))
    u2 = torch.where(y2 * _cs(a2f) + _cs(b2f) > 0, da2, 0.0)
    dA2, dB2 = (u2 * y2).sum(red), u2.sum(red)
    dy2 = (u2 * _cs(a2f)).to(torch.bfloat16).float()
    dw2 = torch.nn.grad.conv2d_weight(a1.float(), tuple(w2.shape), dy2,
                                      padding=1)
    da1 = F.conv2d(dy2, rot180_swap(_bf16w(w2)), padding=1)
    u1 = torch.where(y1 * _cs(a1f) + _cs(b1f) > 0, da1, 0.0)
    dA1, dB1 = (u1 * y1).sum(red), u1.sum(red)
    dy1 = (u1 * _cs(a1f)).to(torch.bfloat16).float()
    dw1 = torch.einsum("nchw,nfhw->cf", dy1, x.float())
    dx = (F.conv2d(dy1, _bf16w(w1).transpose(0, 1)) + u3).to(x.dtype)
    return (dx, dw1.view(w1.shape), dw2, dw3.view(w3.shape),
            dA1, dB1, dA2, dB2, dA3, dB3)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def weight_shapes(c: int) -> tuple:
    """Shapes of w1, w2, w3 at width c."""
    return (c, 4 * c, 1, 1), (c, c, 3, 3), (4 * c, c, 1, 1)


def _xor_index(device) -> torch.Tensor:
    """[row % 8][chunk] -> the chunk stored there: c ^ (row % 8)."""
    r = torch.arange(8, device=device)
    return r[:, None] ^ r[None, :]


def _ring_chunks(m: torch.Tensor, np_: int) -> torch.Tensor:
    """An [N][K] bf16 matrix as the kernels stream it: [pass of np_
    rows][64-deep step][np_ rows][64] with the 16-byte chunk c of row r
    stored at chunk c ^ (r % 8) (the 128-byte swizzle a K-major wgmma
    descriptor reads), flattened."""
    n, k = m.shape
    t = m.reshape(n // np_, np_ // 8, 8, k // 64, 8, 8)   # p, ra, rb, s, c, e
    t = t.permute(0, 3, 1, 2, 4, 5)                       # p, s, ra, rb, c, e
    idx = _xor_index(m.device)
    return t[:, :, :, torch.arange(8, device=m.device)[:, None], idx, :] \
        .reshape(-1)


def pass_widths(c: int) -> tuple:
    """Outputs a pass of each packed matrix of a half, in pack_weights'
    order (csrc Cfg: NP1, NP2 and NPB for the C-wide w1, w2, w3^T and the
    rotated w2; NP3 for the F-wide w3 and w1^T)."""
    return min(c, 128), min(c, 128), 128


def _pack_order(w1, w2, w3, backward: bool) -> torch.Tensor:
    """``pack_weights``' permutation applied to w1, w2, w3 as they are
    (any dtype): the chunks of each matrix at its pass width."""
    c = w1.shape[0]
    m1, m3 = w1.reshape(c, 4 * c), w3.reshape(4 * c, c)

    def taps(w):
        return w.permute(0, 2, 3, 1).reshape(c, 9 * c)

    parts = ([m3.t(), taps(rot180_swap(w2)), m1.t()] if backward
             else [m1, taps(w2), m3])
    return torch.cat([_ring_chunks(p.contiguous(), np_)
                      for p, np_ in zip(parts, pass_widths(c))])


@trace_safe_cache
def _pack_index(c: int, backward: bool, device: torch.device) -> torch.Tensor:
    """Where each packed element comes from in cat(w1, w2, w3) flattened:
    the packing run once on the positions themselves."""
    n1, n2 = 4 * c * c, 9 * c * c
    pos = torch.arange(2 * n1 + n2, dtype=torch.int32)
    order = _pack_order(pos[:n1].view(c, 4 * c, 1, 1),
                        pos[n1:n1 + n2].view(c, c, 3, 3),
                        pos[n1 + n2:].view(4 * c, c, 1, 1), backward)
    return order.to(device)


def pack_weights(w1, w2, w3, backward: bool) -> torch.Tensor:
    """The kernels' bf16 weight chunks (``_ring_chunks`` of each matrix
    at its ``pass_widths``, concatenated). Forward (``backward=False``):
    w1 as (C, 4C), w2 as (C, 9C) = [co][tap = 3 ky + kx][ci], w3 as
    (4C, C); each matrix's rows are its outputs, its columns the
    reduction. Backward: the transposed half alone, w3^T (C, 4C),
    ``rot180_swap(w2)`` like w2, w1^T (4C, C); B6b takes both halves, and
    the autograd function packs the forward half once a step for B6f and
    B6b. One gather with a cached index (three kernels a half)."""
    c = w1.shape[0]
    if c not in WIDTHS or tuple(t.shape for t in (w1, w2, w3)) != (
            weight_shapes(c)):
        raise ValueError(f"pack_weights: no kernel takes weights of shapes "
                         f"{[tuple(t.shape) for t in (w1, w2, w3)]}")
    flat = torch.cat([w.reshape(-1) for w in (w1, w2, w3)]).to(torch.bfloat16)
    return flat.index_select(
        0, _pack_index(w1.shape[0], backward, flat.device))


def unpack_matrix(chunks: torch.Tensor, n: int, k: int,
                  np_: int) -> torch.Tensor:
    """The inverse of ``_ring_chunks`` for an [n][k] matrix packed in
    passes of np_ rows."""
    t = chunks.reshape(n // np_, k // 64, np_ // 8, 8, 8, 8)
    idx = _xor_index(chunks.device)
    t = t[:, :, :, torch.arange(8, device=chunks.device)[:, None], idx, :]
    return t.permute(0, 2, 3, 1, 4, 5).reshape(n, k)


def geometry(n: int, h: int, w: int, c: int) -> tuple:
    """The kernels' tiles (csrc/bottleneck.cu ``make_geo``; the first seven
    entries of ``bottleneck_geometry``): (t, whole, per_image, tiles,
    halo_off, hb, groups). Images of at most 64 pixels go t / HW whole to
    a tile, with no halo; larger ones are cut into tiles of t <= 64
    pixels each, whose a1 is computed on [p0 - halo_off, p0 + t +
    halo_off) within the image (halo_off = W, or W + 1 where t is not a
    whole number of rows) in hb blocks of 64 rows; t shrinks where that
    would not fit the halo buffer. Tiles go in pairs (groups) that share
    the weight stream. None where the kernels refuse the shape."""
    if (n < 1 or h < 1 or w < 1 or c not in WIDTHS
            or w > TILE_ELEMS // c or n * h * w * 4 * c >= 2 ** 31):
        return None
    hw = h * w
    if hw <= TILE:
        t, whole, per_image = (TILE // hw) * hw, 1, 0
        tiles, off, hb = -(-n // (TILE // hw)), 0, 1
    else:
        t, off = TILE, w + (TILE % w != 0)
        if t + 2 * off > HALO_CAP[c]:
            t = HALO_CAP[c] - 2 * (w + 1)
            off = w + (t % w != 0)
        whole, per_image = 0, -(-hw // t)
        tiles, hb = n * per_image, -(-(t + 2 * off) // 64)
    return t, whole, per_image, tiles, off, hb, -(-tiles // 2)


def conv1_rounds(c: int, hb: int) -> list:
    """conv1's rounds at width c for hb halo blocks (csrc ``round_box``):
    for each round (a pass of min(c, 128) outputs over a group of at most
    ROUND_BLOCKS[c] blocks), (its own a1 boxes, the boxes that carry x
    through its A slots, slot by slot). A box is (64-channel block, block
    of 64 rows) of a warpgroup's halo buffer."""
    cb, g = c // 64, ROUND_BLOCKS[c]
    cbp, rb_n = min(c, 128) // 64, HALO_ROWS[c] // 64
    out = []
    for gi in range(-(-hb // g)):
        nb = min(g, hb - gi * g)
        for p in range(c // min(c, 128)):
            wide = cb - p * cbp
            free = ([(p * cbp + k % wide, gi * g + k // wide)
                     for k in range(nb * wide)]
                    + [(k % cb, gi * g + nb + k // cb)
                       for k in range((rb_n - gi * g - nb) * cb)])
            da = min(8, len(free) // nb)
            own = [(p * cbp + j, gi * g + b) for b in range(nb)
                   for j in range(cbp)]
            out.append((own, [free[s * nb:(s + 1) * nb] for s in range(da)]))
    return out


def tile_pixels(n: int, h: int, w: int, c: int) -> list:
    """(first pixel, pixels, halo start) of each tile, in the kernels'
    order (``tile_at``)."""
    t, whole, per_image, tiles, off, _, _ = geometry(n, h, w, c)
    hw, out = h * w, []
    for i in range(tiles):
        if whole:
            p0 = i * t
            out.append((p0, min(t, n * hw - p0), p0 - off))
        else:
            img, j = divmod(i, per_image)
            p0 = img * hw + j * t
            out.append((p0, min(t, hw - j * t), p0 - off))
    return out


def grid(n: int, h: int, w: int, c: int, sms: int) -> int:
    """Blocks of a tile kernel, up to one an SM: at C <= 128 a block of
    two warpgroups takes a pair of tiles; at C >= 256 a cluster of two
    blocks does, one tile a block. Either way the pair shares every
    weight chunk."""
    cl = 1 if c <= 128 else 2
    return cl * max(1, min(geometry(n, h, w, c)[6], sms // cl))


def wgrad_ranges(m: int, n: int, pixels: int, sms: int) -> int:
    """Pixel ranges of dw3 and dw1 (``plan_wgrad``): 128 x min(n, 256)
    output tiles, ranges that fill the SMs about once."""
    tiles = (m // 128) * (n // min(n, 256))
    return max(1, min(-(-pixels // 64), -(-sms // tiles)))


def dw2_ranges(n: int, h: int, w: int, c: int, sms: int) -> int:
    """Pixel ranges of dw2 (conv64.cu's weight-gradient kernel over
    (c / 64)^2 channel tiles)."""
    items = conv64.geometry(n, h, w, 1)[4]
    return max(1, min(items, sms // ((c // 64) ** 2)))


def workspace_bytes(n: int, h: int, w: int, c: int, sms: int) -> int:
    """Scratch of one B6b call (csrc ``plan_work``): a1, a2, dy2, dy1 (bf16,
    C wide), y1, y2 (float32), dy3 (bf16, 4C wide), u3's mask (a bit an
    element of each tile pair), the affine partial rows (one a warp and
    tile) and their sums in levels of 64 rows, and the largest
    weight-gradient partials; each rounded up to 256 bytes. 0 where the
    kernels refuse the shape."""
    geo = geometry(n, h, w, c)
    if geo is None:
        return 0
    px, f, groups = n * h * w, 4 * c, geo[6]

    def up(b):
        return -(-b // 256) * 256

    rows, cols = geo[3] * 4, 4 * c + 2 * f
    wpart = max(wgrad_ranges(f, c, px, sms) * f * c * 4,
                dw2_ranges(n, h, w, c, sms) * 9 * c * c * 4)
    return (4 * up(px * c * 2) + 2 * up(px * c * 4) + up(px * f * 2)
            + up(2 * groups * f * 8) + up(rows * cols * 4)
            + up(-(-rows // 64) * cols * 4)
            + up(-(-(-(-rows // 64)) // 64) * cols * 4) + up(wpart))


def affine_sizes(c: int) -> tuple:
    """Lengths of (A1, B1, A2, B2, A3, B3) at width c."""
    return (c, c, c, c, 4 * c, 4 * c)


def pack_affines(affines: Sequence[torch.Tensor], c: int) -> torch.Tensor:
    """The six affines as the kernels read them: one float32 vector."""
    if tuple(v.numel() for v in affines) != affine_sizes(c):
        raise ValueError(f"the affines of a block of width {c} have "
                         f"{affine_sizes(c)} entries, got "
                         f"{tuple(v.numel() for v in affines)}")
    return torch.cat([v.reshape(-1).to(torch.float32) for v in affines])


def _check(name: str, x: torch.Tensor, c: int, on_device, *others):
    """Raise unless the kernels take x at width c, the tensors
    ``on_device`` lie on x's device and ``others`` have x's shape and
    type. The weights' shapes and the affines' sizes are checked where
    they are packed (``pack_weights``, ``pack_affines``)."""
    if x.device.type != "cuda":
        raise ValueError(f"no bottleneck kernel for device {x.device}")
    if (not supports(x, c)
            or any(t.device != x.device for t in on_device)
            or any(t.shape != x.shape or t.dtype != x.dtype
                   or t.device != x.device for t in others)):
        raise ValueError(
            f"{name} does not support x {tuple(x.shape)} {x.dtype} at "
            f"width {c} (see bottleneck.supports)")


def bottleneck_fwd(x, w1, w2, w3, affines, packed=None) -> torch.Tensor:
    """B6f: the block's output (N, 4C, H, W) in bf16, through the operator
    ``simclr_tpu_torch::bottleneck_fwd``. ``packed``: the forward half of
    ``pack_weights``, if the caller has it."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bottleneck kernel for device {x.device}")
    aff = pack_affines(affines, w1.shape[0])
    if packed is None:
        packed = forward_half(x, w1, w2, w3)
    return torch.ops.simclr_tpu_torch.bottleneck_fwd(x, w1, w2, w3, aff,
                                                     packed)


def forward_half(x, w1, w2, w3) -> torch.Tensor:
    """B6f's packed-weights operand: for CUDA tensors the forward half of
    ``pack_weights``; for CPU ones, whose kernel (the plain version) reads
    the weights as they are, an empty tensor."""
    if x.device.type == "cuda":
        return pack_weights(w1, w2, w3, False)
    return torch.empty(0, dtype=torch.bfloat16)


def bottleneck_fwd_cuda(x, w1, w2, w3, aff, packed) -> torch.Tensor:
    """The operator's CUDA kernel: B6f's launch, counted in
    ``bottleneck_fwd.launches``; raises for operands it cannot take."""
    c = w1.shape[0]
    _check("bottleneck_fwd", x, c, (aff, packed))
    if ((aff.numel(), aff.dtype, packed.numel(), packed.dtype)
            != (sum(affine_sizes(c)), torch.float32, 17 * c * c,
                torch.bfloat16)):
        raise ValueError(f"bottleneck_fwd needs pack_affines' vector "
                         f"({sum(affine_sizes(c))} float32) and the forward "
                         f"half of pack_weights ({17 * c * c} bf16), got "
                         f"{aff.numel()} {aff.dtype} and {packed.numel()} "
                         f"{packed.dtype}")
    xs = nhwc_operand(x)
    aff, packed = aff.contiguous(), packed.contiguous()
    out = torch.empty_like(xs, memory_format=torch.channels_last)
    n, f, h, w = x.shape
    with torch.cuda.device(x.device):
        status = _build.library().bottleneck_fwd(
            xs.data_ptr(), packed.data_ptr(), aff.data_ptr(),
            out.data_ptr(), n, h, w, f // 4,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "bottleneck_fwd")
    bottleneck_fwd.launches += 1
    return out


def bottleneck_bwd(x, w1, w2, w3, affines, g,
                   packed=None) -> Tuple[torch.Tensor, ...]:
    """B6b: (dx, dw1, dw2, dw3, dA1, dB1, dA2, dB2, dA3, dB3) for the
    cotangent g of the block's output; dx bf16, the rest float32, the
    weight gradients in the weights' layouts. ``packed``: the forward
    half of ``pack_weights``, if the caller has it (the backward half is
    packed here)."""
    if x.device.type == "cpu":
        return fused_bottleneck_bwd_plain(x, w1, w2, w3, affines, g)
    aff = pack_affines(affines, w1.shape[0])
    _check("bottleneck_bwd", x, w1.shape[0], (w1, w2, w3, aff), g)
    xs, gs = nhwc_operand(x), nhwc_operand(g)
    wp = pack_weights(w1, w2, w3, False) if packed is None else packed
    wt = pack_weights(w1, w2, w3, True)
    n, f, h, w = x.shape
    c = f // 4
    lib = _build.library()
    dx = torch.empty_like(xs, memory_format=torch.channels_last)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw1, dw2, dw3 = (torch.empty(t.shape, **f32) for t in (w1, w2, w3))
    daff = torch.empty(aff.numel(), **f32)
    with torch.cuda.device(x.device):
        work = torch.empty(lib.bottleneck_bwd_workspace(n, h, w, c),
                           dtype=torch.uint8, device=x.device)
        status = lib.bottleneck_bwd(
            xs.data_ptr(), gs.data_ptr(), wp.data_ptr(), wt.data_ptr(),
            aff.data_ptr(),
            work.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            dw3.data_ptr(), daff.data_ptr(), n, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "bottleneck_bwd")
    bottleneck_bwd.launches += 1
    return (dx, dw1, dw2, dw3, *daff.split((c, c, c, c, f, f)))


bottleneck_fwd.launches = 0
bottleneck_bwd.launches = 0


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, *affines):
        # The forward half of the packed weights, once a step for B6f and
        # B6b.
        packed = forward_half(x, w1, w2, w3)
        ctx.save_for_backward(x, w1, w2, w3, *affines)
        ctx.packed = packed
        return bottleneck_fwd(x, w1, w2, w3, affines, packed)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, w3, *affines = ctx.saved_tensors
        grads = bottleneck_bwd(x, w1, w2, w3, affines, g.to(x.dtype),
                               ctx.packed)
        ctx.packed = None
        params = (x, w1, w2, w3, *affines)
        return tuple(d.to(p.dtype) if need else None
                     for d, p, need in zip(grads, params,
                                           ctx.needs_input_grad))


def fused_bottleneck(x, w1, w2, w3, affines) -> torch.Tensor:
    """The identity bottleneck of x (N, 4C, H, W) in bf16 with weights of
    any float type and the six float32 affines (A1, B1, A2, B2, A3, B3):
    forward through B6f, every gradient through B6b (the weight and
    affine gradients float32 sums, returned in their inputs' types)."""
    return _FusedBottleneck.apply(
        x.to(torch.bfloat16), w1, w2, w3,
        *(v.to(torch.float32) for v in affines))
