"""Layer1's 3x3 stride-1 SAME convolution at C_in = C_out = 64: CUDA
kernels B4f and B4w (``csrc/conv64.cu``), their plain PyTorch versions,
the packing of the filter and the mirror of the kernels' tiles, and the
autograd function around them.

Replaces ``simclr_tpu/ops/pallas/conv64.py`` (B4f: ``_kernel`` through
``_conv_hwcn``; B4w: ``_wgrad_kernel`` through ``_wgrad_hwcn``), with its
numerics: bf16 operands (the weight cast to the input's type), float32
sums, the output rounded to bf16 once. The input gradient is the same
convolution of the cotangent with the filter rotated 180 degrees and
in/out swapped (``rot180_swap``); the weight gradient is float32 and is
not rounded.

What bounds the kernels on the H100, at the path's [1024, 64, 32, 32]:
268 MB of bf16 in and out (0.080 ms) against 77.3 GFLOP (0.078 ms), so
loads and products must overlap and neither may repeat much. Both stage
image rows in shared memory by TMA, three times at column offsets -1, 0
and +1, whose zero fill is the SAME padding; a pixel (64 channels, 128
bytes) is one row of the 128-byte swizzle, so every tap is an aligned
wgmma descriptor into the staged rows and no pixel is gathered per tap.
B4f (persistent, one block of two consumer warpgroups and a loading warp
per SM) keeps the packed filter (``pack_filter``, 72 KB) in shared memory,
multiplies 64 output channels x 128 pixels a warpgroup and writes each
tile with one TMA store; its tiles are ``geometry(.., 0)``. B4w runs one
block per range of image rows (``geometry(.., 1)``'s items of 64 pixels
split into equal shares, one range per SM), a warpgroup per kernel row,
and writes a float32 partial dW per range (ranges x 9 x 64 x 64 x 4
bytes, 19.5 MB at 132 ranges) that a second kernel sums in a fixed
order. The source's header gives the byte and
clock counts and the shared-memory budget (229,440 and 229,568 bytes).

Layouts are the port's: x is (N, 64, H, W), normally in channels_last
memory (physically NHWC, as the kernels read it), and w is (64, 64, 3, 3)
as ``nn.Conv2d`` keeps it. A wrapper brings each operand to channels_last
first (a copy only where needed: autograd promises no layout).

GPU gate (``supports``): a 4-D bf16 tensor with 64 channels, at least one
image and pixel, fewer than 2**31 elements. Any batch and any H, W >= 1:
rows wider than 64 columns are cut into column tiles, each with its own
halo. The JAX gate's batch % 256 and H, W >= 3 are rules of its
batch-on-lanes TPU layout and do not apply.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel, or raises ``ValueError`` for operands the kernel
cannot take; a build or launch failure propagates. Each launch adds one
to the wrapper's ``launches``. B4f's wrapper is the operator
``simclr_tpu_torch::conv_c64`` (``registry``), so that ``torch.export``
traces it: its CPU kernel is the plain version, its CUDA kernel
``conv_c64_cuda``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import _build
from simclr_tpu_torch.ops.kernels._cache import trace_safe_cache

C = 64
TAPS = 9
_SHAPE_W = (C, C, 3, 3)
# csrc/conv64.cu's tiling: columns of a column tile, B4f's output pixels
# of a tile (two warpgroups of 128), pixels of one copy of its box, and
# the pixels of a B4w item's rows.
MAX_COLS = 64
FWD_TILE = 256
FWD_SLOT = 320
WGRAD_ITEM = 64


def supports(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x`` (after a layout copy if needed)."""
    return (x.dim() == 4 and x.shape[1] == C and x.dtype == torch.bfloat16
            and 0 < x.numel() < 2 ** 31)


def rot180_swap(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) filter of the input-gradient convolution: the window
    rotated 180 degrees and in/out channels swapped."""
    return w.flip(2, 3).transpose(0, 1)


@trace_safe_cache
def _pack_index(device: torch.device) -> torch.Tensor:
    """Flat index into a (64, 64, 3, 3) filter of each element of
    ``pack_filter``'s output, built once per device."""
    tap, co, chunk, e = torch.meshgrid(
        *(torch.arange(n) for n in (TAPS, C, 8, 8)), indexing="ij")
    ci = 8 * (chunk ^ (co % 8)) + e
    return (((co * C + ci) * 3 + tap // 3) * 3 + tap % 3).to(device)


def pack_filter(w: torch.Tensor) -> torch.Tensor:
    """(64, 64, 3, 3) -> B4f's filter operand, (9, 64, 8, 8) bf16:
    [tap = 3 ky + kx][co][16-byte chunk][8 ci] with chunk c of row co
    stored at c ^ (co % 8), so that each tap is one 8 KB block of 64 rows
    of 128 bytes in wgmma's K-major 128-byte-swizzle layout, copied as it
    is. One gather (``w`` may be a strided view, as ``rot180_swap``'s)."""
    return torch.take(w.to(torch.bfloat16), _pack_index(w.device))


def unpack_filter(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_filter``: (64, 64, 3, 3)."""
    w = torch.empty(C * C * 9, dtype=packed.dtype, device=packed.device)
    w[_pack_index(packed.device).reshape(-1)] = packed.reshape(-1)
    return w.reshape(_SHAPE_W)


def geometry(n: int, h: int, w: int, kernel: int) -> tuple:
    """The kernels' tiling (csrc/conv64.cu ``geometry``, the first five
    entries of ``conv64_geometry``): (wt, rows, column tiles, row tiles,
    tiles). An image row is cut evenly into ceil(W / 64) column tiles of
    wt columns, a multiple of 8 for B4f (kernel 0) and of 16 for B4w
    (kernel 1). A B4f tile is ``rows`` output rows of one column tile, at
    most 256 pixels, its box of rows + 2 rows at most 320 pixels; a B4w
    item is 64 // wt rows (one at wt = 48 or 64)."""
    nct = -(-w // MAX_COLS)
    cols, align = -(-w // nct), (8 if kernel == 0 else 16)
    wt = -(-cols // align) * align
    rows = (max(1, min(h, FWD_TILE // wt, FWD_SLOT // wt - 2))
            if kernel == 0 else max(1, WGRAD_ITEM // wt))
    nrt = -(-h // rows)
    return wt, rows, nct, nrt, n * nrt * nct


def tile_boxes(n: int, h: int, w: int, kernel: int) -> list:
    """(image, first row, end row, first column, end column) of the outputs
    of each tile (B4f) or item (B4w), in the kernel's order: B4f by
    (image, row tile, column tile), B4w by (image, column tile, row tile),
    the last fastest. Rows and columns may run past the image (computed from
    zeros, not stored); the tile reads its input from the box one row and
    one column wider on each side."""
    wt, rows, nct, nrt, tiles = geometry(n, h, w, kernel)
    out = []
    for t in range(tiles):
        if kernel == 0:
            ct, rt, img = t % nct, t // nct % nrt, t // (nct * nrt)
        else:
            rt, ct, img = t % nrt, t // nrt % nct, t // (nrt * nct)
        out.append((img, rt * rows, rt * rows + rows, ct * wt,
                    ct * wt + wt))
    return out


# ---------------------------------------------------------------------------
# Plain versions. On the card they need cuDNN's TF32 off to be float32.
# ---------------------------------------------------------------------------

def conv3x3_c64_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B4f's plain version: a float32 convolution of the bf16 operands,
    rounded once to x's type."""
    return F.conv2d(x.float(), w.to(x.dtype).float(),
                    padding=1).to(x.dtype)


def wgrad_c64_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4w's plain version: float32 dW (64, 64, 3, 3) of conv3x3(x, w)
    for the cotangent g."""
    return torch.nn.grad.conv2d_weight(x.float(), _SHAPE_W, g.float(),
                                       padding=1)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def nhwc_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` in channels_last memory, 16-byte aligned, as the conv kernels
    read it (a copy only where needed)."""
    t = t.contiguous(memory_format=torch.channels_last)
    return (t if t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.channels_last))


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no conv64 kernel for device {x.device}")
    for t in (x, *others):
        if not supports(t) or t.shape != x.shape or t.device != x.device:
            raise ValueError(
                f"{name} does not support operands "
                f"{[(tuple(u.shape), u.dtype) for u in (x, *others)]} "
                f"(see conv64.supports)")


def conv_c64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B4f: conv3x3(x, w), stride 1, SAME, in x's type (bf16), through the
    operator ``simclr_tpu_torch::conv_c64``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv64 kernel for device {x.device}")
    return torch.ops.simclr_tpu_torch.conv_c64(x, w)


def conv_c64_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA kernel: B4f's launch, counted in
    ``conv_c64.launches``; raises for operands it cannot take."""
    _check("conv64_fwd", x)
    if tuple(w.shape) != _SHAPE_W or w.device != x.device:
        raise ValueError(f"conv64_fwd needs a {_SHAPE_W} filter on "
                         f"{x.device}, got {tuple(w.shape)} on {w.device}")
    xs, wt = nhwc_operand(x), pack_filter(w)
    y = torch.empty_like(xs, memory_format=torch.channels_last)
    n, _, h, wd = x.shape
    with torch.cuda.device(x.device):
        status = _build.library().conv64_fwd(
            xs.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, wd,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "conv64_fwd")
    conv_c64.launches += 1
    return y


def wgrad_c64(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4w: float32 dW (64, 64, 3, 3) of conv3x3(x, w) for the cotangent
    g, both bf16 of x's shape."""
    if x.device.type == "cpu":
        return wgrad_c64_plain(x, g)
    _check("conv64_wgrad", x, g)
    xs, gs = nhwc_operand(x), nhwc_operand(g)
    lib = _build.library()
    n, _, h, wd = x.shape
    geom = (ctypes.c_int * 6)()
    with torch.cuda.device(x.device):
        _build.check(lib.conv64_geometry(n, h, wd, 1, geom),
                     "conv64_geometry")
        # One float32 partial dW per pixel range.
        partial = torch.empty((geom[5], TAPS, C, C), dtype=torch.float32,
                              device=x.device)
        dw = torch.empty(_SHAPE_W, dtype=torch.float32, device=x.device)
        status = lib.conv64_wgrad(xs.data_ptr(), gs.data_ptr(),
                                  partial.data_ptr(), dw.data_ptr(), n, h,
                                  wd, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "conv64_wgrad")
    wgrad_c64.launches += 1
    return dw


conv_c64.launches = 0
wgrad_c64.launches = 0


class _Conv3x3C64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv_c64(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_c64(g, rot180_swap(w).to(g.dtype))
        if ctx.needs_input_grad[1]:
            dw = wgrad_c64(x, g).to(w.dtype)
        return dx, dw


def conv3x3_c64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of bf16 x (N, 64, H, W) with w (64, 64, 3, 3)
    of any float type: forward and input gradient through B4f, weight
    gradient (float32, returned in w's type) through B4w."""
    return _Conv3x3C64.apply(x, w)
