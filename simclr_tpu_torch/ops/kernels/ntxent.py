"""Fused NT-Xent loss: CUDA kernels B1f and B1b (``csrc/ntxent.cu``), their
plain PyTorch versions, and the autograd function around them.

Replaces ``simclr_tpu/ops/pallas/ntxent.py`` (``_fwd_kernel`` and
``_bwd_kernel``). The kernels run z z^T on the tensor cores in 3xTF32 (each
operand split into two tf32 halves, three products into a float32
accumulator), which keeps the loss and dz as close to the float32 plain
versions as float32 itself is, where one TF32 product would not. A block
owns 64 rows; a cluster of 4 blocks splits the columns into ranges and
combines the rows' statistics (forward) or partial dz (backward) in
rank order through distributed shared memory, so the result has the same
bits on every run. ``geometry`` and ``tiles`` mirror that tiling; the source
note in ``csrc/ntxent.cu`` says what bounds the kernels on the H100.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each kernel launch adds one to the
wrapper's ``launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from simclr_tpu_torch.ops.kernels import _build
from simclr_tpu_torch.ops.losses import VERY_LARGE_NUM, l2_normalize

NEG = -VERY_LARGE_NUM
# Largest feature dimension the gate takes (csrc/ntxent.cu's MAX_DIM). The
# kernels loop over 128-wide feature blocks and need no limit; this is the
# width chip_smoke.py checks them at.
MAX_DIM = 2048
# The kernels' tiling (csrc/ntxent.cu): rows a block, blocks a cluster (one
# column range each), features a staged chunk and a block of dz, and the
# column tile of the forward (0) and the backward (1).
ROW_TILE = 64
CLUSTER = 4
FEATURE_BLOCK = 128
COL_TILE = (128, 64)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def geometry(n2: int, d: int, kernel: int) -> Tuple[int, ...]:
    """The tiling of kernel 0 (forward) or 1 (backward), as the C entry
    ``ntxent_geometry`` gives it: rows a block, row tiles (clusters),
    blocks a cluster, columns a range (ceil(n2 / CLUSTER) rounded up to the
    column tile), column tile, features a chunk, feature chunks, and the
    blocks of dz's features (grid.y; 1 for the forward)."""
    bc = COL_TILE[kernel]
    chunks = _cdiv(d, FEATURE_BLOCK)
    return (ROW_TILE, _cdiv(n2, ROW_TILE), CLUSTER,
            _cdiv(_cdiv(n2, CLUSTER), bc) * bc, bc, FEATURE_BLOCK, chunks,
            chunks if kernel else 1)


def tiles(n2: int, d: int, kernel: int):
    """What each block does, in the kernels' loop order: one tuple a block
    (row range, cluster rank, column tiles, feature chunks of the product,
    features of dz it sums, rows it combines over the cluster), all as
    half-open ranges clipped to the matrix. A block whose column range
    lies past the end has no column tiles but still combines its rows."""
    br, row_tiles, cluster, cols, bc, fk, chunks, fblocks = geometry(
        n2, d, kernel)
    k_chunks = [(k, min(k + fk, d)) for k in range(0, d, fk)]
    out = []
    for rt in range(row_tiles):
        rows = (rt * br, min(rt * br + br, n2))
        for rank in range(cluster):
            start, end = rank * cols, min(rank * cols + cols, n2)
            col_tiles = [(c, min(c + bc, end)) for c in range(start, end, bc)]
            per = br // cluster
            combined = (min(rows[0] + rank * per, n2),
                        min(rows[0] + rank * per + per, n2))
            for fb in range(fblocks):
                feats = ((fb * fk, min(fb * fk + fk, d)) if kernel
                         else (0, 0))
                out.append((rows, rank, col_tiles, k_chunks, feats,
                            combined))
    return out


def _masked_similarity(z: torch.Tensor, inv_t: float) -> torch.Tensor:
    n2 = z.shape[0]
    s = (z @ z.T) * inv_t
    return s.masked_fill(torch.eye(n2, dtype=torch.bool, device=z.device),
                         NEG)


def _positives(n2: int, device) -> torch.Tensor:
    return (torch.arange(n2, device=device) + n2 // 2) % n2


def ntxent_fwd_plain(z: torch.Tensor, inv_t: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: per-row loss, correctness and
    lse. On the card the comparison runs with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` so that z z^T is full
    float32 on both sides."""
    n2 = z.shape[0]
    s = _masked_similarity(z, inv_t)
    row_max = s.max(dim=1).values
    lse = torch.log(torch.exp(s - row_max[:, None]).sum(dim=1)) + row_max
    pos_logit = s.gather(1, _positives(n2, z.device)[:, None])[:, 0]
    return lse - pos_logit, (pos_logit >= row_max).float(), lse


def ntxent_bwd_plain(z: torch.Tensor, lse: torch.Tensor, inv_t: float,
                     g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: dz of g * mean(row_loss)."""
    n2 = z.shape[0]
    p = torch.exp(_masked_similarity(z, inv_t) - lse[:, None])
    y = torch.zeros_like(p)
    y[torch.arange(n2, device=z.device), _positives(n2, z.device)] = 1.0
    grad_s = p - y
    grad_s = grad_s + grad_s.T
    return (grad_s @ z) * (g.reshape(()) * inv_t / n2)


def _check_z(z: torch.Tensor) -> None:
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("z must be a contiguous (2N, D) float32 tensor")
    if not supports(z.shape[0] // 2, z.shape[1]) or z.shape[0] % 2:
        raise ValueError(f"NT-Xent kernel does not support z {tuple(z.shape)}")


def ntxent_fwd(z: torch.Tensor, inv_t: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (loss, correct, lse), each of shape (2N,) float32."""
    if z.device.type == "cpu":
        return ntxent_fwd_plain(z, inv_t)
    if z.device.type != "cuda":
        raise ValueError(f"no NT-Xent kernel for device {z.device}")
    _check_z(z)
    n2, d = z.shape
    row_loss, correct, lse = (torch.empty(n2, device=z.device)
                              for _ in range(3))
    lib = _build.library()
    with torch.cuda.device(z.device):
        status = lib.ntxent_fwd(
            z.data_ptr(), row_loss.data_ptr(), correct.data_ptr(),
            lse.data_ptr(), n2, d, float(inv_t),
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "ntxent_fwd")
    ntxent_fwd.launches += 1
    return row_loss, correct, lse


ntxent_fwd.launches = 0


def ntxent_bwd(z: torch.Tensor, lse: torch.Tensor, inv_t: float,
               g: torch.Tensor) -> torch.Tensor:
    """dz (2N, D) of ``g * mean(row_loss)``; ``g`` is a one-element
    float32 tensor on z's device (read by the kernel, no host sync)."""
    if z.device.type == "cpu":
        return ntxent_bwd_plain(z, lse, inv_t, g)
    if z.device.type != "cuda":
        raise ValueError(f"no NT-Xent kernel for device {z.device}")
    _check_z(z)
    n2, d = z.shape
    for name, t in (("lse", lse), ("g", g)):
        if (t.device != z.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{z.device}")
    if lse.shape != (n2,) or g.numel() != 1:
        raise ValueError("lse must be (2N,) and g one element")
    dz = torch.empty_like(z)
    lib = _build.library()
    with torch.cuda.device(z.device):
        status = lib.ntxent_bwd(
            z.data_ptr(), lse.data_ptr(), g.data_ptr(), dz.data_ptr(),
            n2, d, float(inv_t), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "ntxent_bwd")
    ntxent_bwd.launches += 1
    return dz


ntxent_bwd.launches = 0


class NTXentCore(torch.autograd.Function):
    """(mean loss, 100 * mean correct) of L2-normalised z (2N, D) float32;
    the accuracy carries no gradient."""

    @staticmethod
    def forward(ctx, z, inv_t):
        row_loss, correct, lse = ntxent_fwd(z, inv_t)
        ctx.save_for_backward(z, lse)
        ctx.inv_t = inv_t
        acc = 100.0 * correct.mean()
        ctx.mark_non_differentiable(acc)
        return row_loss.mean(), acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        z, lse = ctx.saved_tensors
        g = g_loss.reshape(1).to(torch.float32).contiguous()
        return ntxent_bwd(z, lse, ctx.inv_t, g), None


def supports(n: int, d: int) -> bool:
    """True where the kernels run: a batch of n >= 1 pairs (no upper limit,
    the columns are streamed), 1 <= d <= MAX_DIM, and int32 element
    offsets."""
    return n >= 1 and 1 <= d <= MAX_DIM and 2 * n * d < 2 ** 31


def nt_xent_loss_fused(
    z1: torch.Tensor,
    z2: torch.Tensor,
    temperature: float = 1.0,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.losses.nt_xent_loss`` through kernel B1 (no
    ``weight``: the training path never passes one)."""
    if normalize:
        z1 = l2_normalize(z1, dim=1)
        z2 = l2_normalize(z2, dim=1)
    z = torch.cat([z1, z2], dim=0).to(torch.float32).contiguous()
    return NTXentCore.apply(z, 1.0 / temperature)
