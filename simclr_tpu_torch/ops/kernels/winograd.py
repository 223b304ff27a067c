"""Winograd F(2x2, 3x3) convolution for the stride-1 conv2: CUDA kernels
B5f and B5w (``csrc/winograd.cu``), their plain PyTorch versions, and
the autograd function around them.

Replaces ``simclr_tpu/ops/pallas/winograd.py``, with its numerics: the
filter transform U = G w G^T in float32, rounded to bf16; the input
transform V = B^T d B in float32 from the input, rounded to bf16; the 16
per-position products V U in float32; the output transform Y = A^T M A
in float32, rounded once to the input's type. The input gradient is the
same function of the cotangent with U of the filter rotated 180 degrees
and in/out swapped. The weight gradient accumulates dU = V^T dM in
float32 (dM, the adjoint of the output transform of the cotangent, in
bf16) and returns G^T dU G in the filter's type.

Layouts are the port's: x is (N, C, H, W), normally channels_last, and w
is (K, C, 3, 3); ``transform_filter`` returns (16, C, K) as JAX's does.

GPU gate (``supported``): stride 1, a 3x3 filter over all of x's
channels, H and W even (any, not only equal), C and K multiples of 32
(the kernels' channel blocks), any batch, fewer than 2**31 elements in x
and y. The JAX gate's C % 128, N % 2 and H >= 4 are TPU tiling rules, and
its ``_pick_s`` sends layer4 (C = K = 512 at 4x4) to the direct
convolution for want of VMEM; the CUDA kernels take layer4. As in JAX,
``winograd_conv3x3`` runs the direct convolution exactly outside the
gate. The kernels take bf16 only: a CUDA tensor of another type that
passes the gate raises.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel or raises ``ValueError``. Each launch adds one to the
wrapper's ``launches``. B5f's wrapper is the operator
``simclr_tpu_torch::winograd_fwd`` (``registry``), so that
``torch.export`` traces it: its CPU kernel is the plain version, its CUDA
kernel ``winograd_fwd_cuda``; the filter transform before it stays
outside the operator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import _build
from simclr_tpu_torch.ops.kernels._cache import trace_safe_cache
from simclr_tpu_torch.ops.kernels.conv64 import nhwc_operand, rot180_swap

# F(2x2, 3x3) filter transform (Lavin & Gray 2015, arXiv:1509.09308); B^T
# and A^T are written out in the transforms below.
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
BLOCK = 32   # C and K are multiples of this (csrc/winograd.cu CH)
# B5f's blocking (csrc/winograd.cu): output channels a block (F_BK) and
# input channels a step (CC); U is packed to match.
FWD_K = 128
FWD_C = 16
# Tiles a block and pixels of its input box, B5f then B5w (F_BT, F_MAXPX;
# W_BT, W_MAXPX).
TILE_BLOCKS = ((64, 576), (16, 144))


def supported(x_shape, w_shape, stride) -> bool:
    """Shapes the kernels take: x (N, C, H, W), w (K, C, 3, 3)."""
    n, c, h, w = x_shape
    k, wc, kh, kw = w_shape
    return (tuple(stride) == (1, 1) and (kh, kw) == (3, 3) and wc == c
            and n >= 1 and h >= 2 and w >= 2 and h % 2 == 0 and w % 2 == 0
            and c % BLOCK == 0 and k % BLOCK == 0
            and n * h * w * max(c, k) < 2 ** 31)


@trace_safe_cache
def _gmat(device: torch.device) -> torch.Tensor:
    """G on ``device``, copied there once (a copy a call could not be
    captured in a CUDA graph)."""
    return torch.tensor(_G, dtype=torch.float32, device=device)


def transform_filter(w: torch.Tensor) -> torch.Tensor:
    """U = G w G^T per (c, k): (K, C, 3, 3) -> (16, C, K) float32."""
    g = _gmat(w.device)
    u = torch.einsum("ar,bs,kcrs->abck", g, g, w.to(torch.float32))
    return u.reshape(16, w.shape[1], w.shape[0])


def filter_grad(du: torch.Tensor) -> torch.Tensor:
    """dw = G^T dU G: (16, C, K) float32 -> (K, C, 3, 3)."""
    g = _gmat(du.device)
    c, k = du.shape[1:]
    return torch.einsum("ar,bs,abck->kcrs", g, g, du.reshape(4, 4, c, k))


def pack_u(u: torch.Tensor) -> torch.Tensor:
    """U (16, C, K) as B5f reads it: [K / 128][C / 16][16 positions]
    [k / 8][c / 8][k % 8][c % 8], K padded with zeros to a multiple of 128:
    each block's row of positions is one contiguous copy of 8 x 8 core
    matrices, wgmma's no-swizzle K-major layout."""
    _, c, k = u.shape
    kp = -(-k // FWD_K) * FWD_K
    u = F.pad(u, (0, kp - k))
    return u.reshape(16, c // FWD_C, 2, 8, kp // FWD_K, FWD_K // 8,
                     8).permute(4, 1, 0, 5, 2, 6, 3).contiguous()


def unpack_u(packed: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of ``pack_u``: (16, C, K)."""
    kb, cs = packed.shape[:2]
    return packed.permute(2, 1, 4, 6, 0, 3, 5).reshape(
        16, cs * FWD_C, kb * FWD_K)[:, :, :k]


def tile_blocks(n: int, h: int, w: int, kernel: int) -> tuple:
    """The kernels' tile blocks (csrc/winograd.cu ``geometry``), kernel 0
    for B5f and 1 for B5w: (g, rb, cb, ng, nr, nc). A block is g whole
    images, or rb whole tile rows of one image, or cb tiles of one tile
    row, with at most ``TILE_BLOCKS[kernel][0]`` tiles; its input box,
    [2 cb + 2 columns, 2 rb + 2 rows, g images], holds at most
    ``TILE_BLOCKS[kernel][1]`` pixels; (ng, nr, nc) blocks cover the
    batch."""
    bt, max_px = TILE_BLOCKS[kernel]
    th, tw = h // 2, w // 2
    if th * tw <= bt:
        rb, cb = th, tw
        g = max(1, min(bt // (th * tw), max_px // ((h + 2) * (w + 2)), n))
    elif tw <= bt:
        g, cb = 1, tw
        rb = max(1, min(bt // tw, max_px // (w + 2) // 2 - 1, th))
    else:
        g, rb, cb = 1, 1, bt
    return g, rb, cb, -(-n // g), -(-th // rb), -(-tw // cb)


def block_tiles(geom: tuple, b: int) -> list:
    """(image, tile row, tile column) of the rectangle of block b, in the
    kernels' local order; some may lie outside the batch or the image."""
    g, rb, cb, _, nr, nc = geom
    n0, ty0, tx0 = b // (nr * nc) * g, b // nc % nr * rb, b % nc * cb
    return [(n0 + gi, ty0 + ri, tx0 + ci)
            for gi in range(g) for ri in range(rb) for ci in range(cb)]


# ---------------------------------------------------------------------------
# Plain versions, on NHWC float32 views (the JAX kernels' arithmetic).
# ---------------------------------------------------------------------------

def _input_transform(x: torch.Tensor) -> torch.Tensor:
    """V = B^T d B over all tiles: (N, H, W, C) -> (16, N, H/2, W/2, C),
    row-major in the position (4 k + l)."""
    th, tw = x.shape[1] // 2, x.shape[2] // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    r0, r1, r2, r3 = (xp[:, i:i + 2 * th:2] for i in range(4))
    v = []
    for hk in (r0 - r2, r1 + r2, r2 - r1, r1 - r3):
        c0, c1, c2, c3 = (hk[:, :, j:j + 2 * tw:2] for j in range(4))
        v += [c0 - c2, c1 + c2, c2 - c1, c1 - c3]
    return torch.stack(v)


def _adj(a0, a1):
    """Adjoint of one axis of the output transform."""
    return a0, a0 + a1, a0 - a1, -a1


def _dm_transform(g: torch.Tensor) -> torch.Tensor:
    """dM, the adjoint of the output transform of the cotangent:
    (N, H, W, K) -> (16, N, H/2, W/2, K)."""
    n, h, w, k = g.shape
    y = g.reshape(n, h // 2, 2, w // 2, 2, k)
    h0 = _adj(y[:, :, 0, :, 0], y[:, :, 1, :, 0])
    h1 = _adj(y[:, :, 0, :, 1], y[:, :, 1, :, 1])
    return torch.stack([d for k4 in range(4) for d in _adj(h0[k4], h1[k4])])


def _output_transform(m: torch.Tensor) -> torch.Tensor:
    """Y = A^T M A: (16, N, H/2, W/2, K) -> (N, H, W, K)."""
    def out2(m0, m1, m2, m3):
        return m0 + m1 + m2, m1 - m2 - m3
    u0, u1 = zip(*(out2(m[l], m[4 + l], m[8 + l], m[12 + l])
                   for l in range(4)))
    y00, y01 = out2(*u0)
    y10, y11 = out2(*u1)
    _, n, th, tw, k = m.shape
    y = torch.stack([y00, y01, y10, y11]).reshape(2, 2, n, th, tw, k)
    return y.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * th, 2 * tw, k)


def _nhwc32(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).to(torch.float32)


def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def winograd_fwd_plain(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B5f's plain version: x (N, C, H, W), u (16, C, K) bf16 -> y
    (N, K, H, W) in x's type (channels_last memory)."""
    n, c = x.shape[:2]
    v = _bf16_rounded(_input_transform(_nhwc32(x)))
    m = torch.matmul(v.reshape(16, -1, c), u.to(torch.float32))
    y = _output_transform(m.reshape(16, *v.shape[1:4], u.shape[2]))
    return y.to(x.dtype).permute(0, 3, 1, 2)


def winograd_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B5w's plain version: dU (16, C, K) float32 of x (N, C, H, W) and
    the cotangent g (N, K, H, W)."""
    c, k = x.shape[1], g.shape[1]
    v = _bf16_rounded(_input_transform(_nhwc32(x))).reshape(16, -1, c)
    dm = _bf16_rounded(_dm_transform(_nhwc32(g))).reshape(16, -1, k)
    return torch.matmul(v.transpose(1, 2), dm)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, k: int, *others) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no Winograd kernel for device {x.device}")
    ok = supported(x.shape, (k, x.shape[1], 3, 3), (1, 1))
    for t in (x, *others):
        ok = ok and t.dtype == torch.bfloat16 and t.device == x.device
    if not ok:
        raise ValueError(
            f"{name} does not support operands "
            f"{[(tuple(t.shape), t.dtype) for t in (x, *others)]} "
            f"(see winograd.supported; the kernels take bf16)")


def winograd_fwd(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B5f: the Winograd convolution of x (N, C, H, W) with the
    transformed filter u (16, C, K) bf16, in x's type, through the
    operator ``simclr_tpu_torch::winograd_fwd``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Winograd kernel for device {x.device}")
    return torch.ops.simclr_tpu_torch.winograd_fwd(x, u)


def winograd_fwd_cuda(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA kernel: B5f's launch, counted in
    ``winograd_fwd.launches``; raises for operands it cannot take."""
    n, c, h, w = x.shape
    k = u.shape[2]
    _check("winograd_fwd", x, k, u)
    if tuple(u.shape) != (16, c, k):
        raise ValueError(f"u must be (16, {c}, K), got {tuple(u.shape)}")
    xs = nhwc_operand(x)
    ut = pack_u(u)
    y = torch.empty((n, k, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        status = _build.library().winograd_fwd(
            xs.data_ptr(), ut.data_ptr(), y.data_ptr(), n, h, w, c, k,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "winograd_fwd")
    winograd_fwd.launches += 1
    return y


def winograd_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B5w: dU (16, C, K) float32 of x (N, C, H, W) and the cotangent g
    (N, K, H, W), both bf16."""
    if x.device.type == "cpu":
        return winograd_dw_plain(x, g)
    n, c, h, w = x.shape
    k = g.shape[1]
    _check("winograd_dw", x, k, g)
    if tuple(g.shape) != (n, k, h, w):
        raise ValueError(f"g must be {(n, k, h, w)}, got {tuple(g.shape)}")
    xs, gs = nhwc_operand(x), nhwc_operand(g)
    lib = _build.library()
    ranges = lib.winograd_dw_ranges(n, h, w, c, k)
    du = torch.empty((16, c, k), dtype=torch.float32, device=x.device)
    partial = (torch.empty((ranges, 16, c, k), dtype=torch.float32,
                           device=x.device) if ranges > 1 else du)
    with torch.cuda.device(x.device):
        status = lib.winograd_dw(xs.data_ptr(), gs.data_ptr(),
                                 partial.data_ptr(), du.data_ptr(), n, h, w,
                                 c, k, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "winograd_dw")
    winograd_dw.launches += 1
    return du


winograd_fwd.launches = 0
winograd_dw.launches = 0


class _Winograd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return winograd_fwd(x, transform_filter(w).to(torch.bfloat16))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            u_rot = transform_filter(rot180_swap(w)).to(torch.bfloat16)
            dx = winograd_fwd(g, u_rot)
        if ctx.needs_input_grad[1]:
            dw = filter_grad(winograd_dw(x, g)).to(w.dtype)
        return dx, dw


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv of x (N, C, H, W) with w (K, C, 3, 3) through
    the Winograd kernels where ``supported()``; elsewhere the direct
    convolution of x and w cast to x's type, exactly."""
    if not supported(x.shape, w.shape, (1, 1)):
        return F.conv2d(x, w.to(x.dtype), padding=1)
    return _Winograd.apply(x, w)
