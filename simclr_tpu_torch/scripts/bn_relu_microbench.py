"""Microbenchmark kernel B3b (the BN+add+ReLU backward) alone.

Counterpart of ``scripts/bn_relu_microbench.py``, with its flag and
``--device`` (default ``cuda``). The kernel
(``ops/kernels/bn_relu.py:bwd_add_relu``) gets already-2-D bf16 operands
at the four bn3 shapes of ResNet-50 at 1,024 images, so no layout
interacts with it, and is timed against its plain PyTorch version
(``bwd_add_relu_plain``), ``torch.compile`` of that plain version (the
counterpart of JAX's jitted plain ops; a comparator printed here, on no
path of the port) and the HBM floor of its bytes. Before any timing the
kernel's (dx, dskip, S1, S2) are held against the plain version at every
shape: dx and dskip equal, the sums within 2e-5 of the sum of their
|terms| (``chip_smoke.py``'s bn_relu phase), and the kernel must have
launched.

    python -m simclr_tpu_torch.scripts.bn_relu_microbench --reps 50

Each call is timed between CUDA events around ``--reps`` calls (the mean
a call; on the CPU by the host clock); effective GB/s is JAX's byte
count, 3 reads and 2 writes of rows x C bf16. ``--rows_scale`` divides
the rows for a quick check.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from simclr_tpu_torch.ops.kernels import bn_relu as k

HBM_BYTES_PER_S = 3.35e12
# bn3-position shapes (2-D views as the model produces them).
SHAPES = (
    (1024 * 32 * 32, 256),   # layer1 bn3: 512 MiB a tensor
    (1024 * 16 * 16, 512),   # layer2 bn3
    (1024 * 8 * 8, 1024),    # layer3 bn3
    (1024 * 4 * 4, 2048),    # layer4 bn3
)
SUM_TOL = 2e-5   # of the per-channel sum of |terms|, plus 1e-6


def make_inputs(rows: int, c: int, device, seed: int = 0) -> dict:
    """JAX's operands from a numpy seed: g, out = |N(0,1)| - 0.3 and x in
    bf16; a ~ N(1, 0.1), mean ~ N(0, 1), rsig = |N(1, 0.1)| in float32."""
    rng = np.random.default_rng(seed)

    def big(a):
        return torch.from_numpy(a).to(device).to(torch.bfloat16)

    g = big(rng.standard_normal((rows, c), dtype=np.float32))
    out = big(np.abs(rng.standard_normal((rows, c), dtype=np.float32))
              - np.float32(0.3))
    x = big(rng.standard_normal((rows, c), dtype=np.float32))
    vec = [torch.from_numpy(v.astype(np.float32)).to(device) for v in (
        rng.normal(1.0, 0.1, (c,)), rng.normal(size=(c,)),
        np.abs(rng.normal(1.0, 0.1, (c,))))]
    return dict(g=g, out=out, x=x, a32=vec[0], mean=vec[1], rsig=vec[2])


def abs_sums(i: dict):
    """Per-channel sums of |terms| of S1 and S2: the scale of their
    float32 summation error."""
    gy = i["g"].float() * (i["out"].float() > 0)
    xhat = (i["x"].float() - i["mean"]) * i["rsig"]
    return gy.abs().sum(0), (gy * xhat).abs().sum(0)


def check(i: dict) -> float:
    """The kernel's (dx, dskip, S1, S2) against the plain version's: dx
    and dskip equal, the sums within ``SUM_TOL`` of sum|terms|; returns
    the largest difference of the sums. Raises on a disagreement, and
    where the wrapper did not launch its kernel on CUDA tensors."""
    before = k.bwd_add_relu.launches
    args = (i["g"], i["out"], i["x"], i["a32"], i["mean"], i["rsig"])
    got = k.bwd_add_relu(*args)
    if i["g"].is_cuda and k.bwd_add_relu.launches != before + 1:
        raise AssertionError("bwd_add_relu did not launch its kernel")
    want = k.bwd_add_relu_plain(*args)
    for a, b, what in zip(got[:2], want[:2], ("dx", "dskip")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs from the plain version by"
                                 f" {(a.float() - b.float()).abs().max()}")
    worst = 0.0
    for a, b, scale, what in zip(got[2:], want[2:], abs_sums(i),
                                 ("S1", "S2")):
        err = (a - b).abs()
        if not bool((err <= SUM_TOL * scale + 1e-6).all()):
            raise AssertionError(f"{what} differs from the plain version "
                                 f"by {err.max().item()}")
        worst = max(worst, err.max().item())
    return worst


def mean_ms(fn: Callable[[], object], reps: int, device: torch.device,
            warmup: int = 2) -> float:
    """Mean ms of fn() over ``reps`` calls: between two CUDA events on a
    card, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(reps: int, device="cuda", shapes: Sequence = SHAPES,
        compiled: bool = True,
        out: Callable[[str], None] = print) -> List[Dict]:
    """Check, then time, B3b at each shape: rows of (shape, call, ms,
    GB/s), the bound and, for the kernel, its launches while timed."""
    dev = torch.device(device)
    plain = k.bwd_add_relu_plain
    fused = torch.compile(plain) if compiled and dev.type == "cuda" else None
    rows = []
    for n, c in shapes:
        i = make_inputs(n, c, dev)
        err = check(i)
        out(f"({n:9d},{c:5d}) kernel equal to the plain version (dx, "
            f"dskip), sums within {err:.2e}")
        args = (i["g"], i["out"], i["x"], i["a32"], i["mean"], i["rsig"])
        n_bytes = 5 * n * c * 2   # 3 reads + 2 writes, bf16
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        calls = [("kernel", k.bwd_add_relu), ("plain", plain)]
        if fused is not None:
            calls.append(("compiled", fused))
        for name, fn in calls:
            before = k.bwd_add_relu.launches
            ms = mean_ms(lambda: fn(*args), reps, dev)
            row = dict(shape=(n, c), call=name, ms=ms,
                       gbps=n_bytes / ms / 1e6, bound_ms=bound,
                       launches=k.bwd_add_relu.launches - before,
                       max_abs_err=err if name == "kernel" else None)
            if (dev.type == "cuda" and name == "kernel"
                    and row["launches"] != reps + 2):
                raise AssertionError(f"B3b launched {row['launches']} times"
                                     f" in {reps + 2} calls")
            out(f"({n:9d},{c:5d}) {name:8s} {ms:8.4f} ms "
                f"{row['gbps']:7.1f} GB/s effective (bound {bound:.4f} ms "
                f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
            rows.append(row)
        del i, args
    return rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rows_scale", type=int, default=1,
                   help="divide each shape's rows by this (a quick check)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernel) or 'cpu' (the wrapper takes "
                        "the plain version; host-clock times)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    from simclr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    shapes = [(max(n // args.rows_scale, 1), c) for n, c in SHAPES]
    return run(args.reps, device, shapes)


if __name__ == "__main__":
    main()
