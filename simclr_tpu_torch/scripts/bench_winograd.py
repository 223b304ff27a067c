"""Microbenchmark: the Winograd conv2 kernels (B5f, B5w) against cuDNN's
direct convolution.

Counterpart of ``scripts/bench_winograd.py``, with its flag and
``--device`` (default ``cuda``). Times forward and forward+backward
(autograd: dx and dW) of ``ops/kernels/winograd.py:winograd_conv3x3``
and of ``F.conv2d(padding=1)`` at the stride-1 identity-block conv2
shapes of the CIFAR-stem ResNet-50 (batch 1,024 = two 512-image views),
bf16 in channels_last. Each timing is the median of 3 replays of one
CUDA graph of ``--iters`` iterations between two CUDA events (JAX's
scanned loop in one dispatch): device time, without the host's time to
launch the wrapper's small ops (the filter transform). TF/s count the
direct convolution's flops.

Before timing, the forward is held against cuDNN's (its error against a
float32 direct convolution within 4x the bf16 direct convolution's own,
plus 1e-3: ``tests/test_winograd.py``'s bound). ``winograd_conv3x3``
takes ``F.conv2d`` for a shape its kernels refuse, so the harness
asserts that B5f and B5w launched as often as the calls ask: it never
times cuDNN twice. An error raises.

    python -m simclr_tpu_torch.scripts.bench_winograd --iters 50
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from simclr_tpu_torch.ops.kernels import winograd as wk

SHAPES = (
    ("layer2", 1024, 16, 128),
    ("layer3", 1024, 8, 256),
    ("layer4", 1024, 4, 512),
)


def direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, padding=1)


def make_inputs(rng: np.random.RandomState, n: int, h: int, c: int,
                device) -> tuple:
    """JAX's operands: x and the cotangent gy ~ N(0, 1) (N, C, H, H) and
    w ~ 0.1 N(0, 1) (C, C, 3, 3), bf16, channels_last, from ``rng``."""
    def nchw(a):
        return (torch.from_numpy(a).to(device).permute(0, 3, 1, 2)
                .to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last))

    x = nchw(rng.randn(n, h, h, c).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.randn(3, 3, c, c)).astype(
        np.float32).transpose(3, 2, 0, 1).copy()).to(device).to(
        torch.bfloat16)
    gy = nchw(rng.randn(n, h, h, c).astype(np.float32))
    return x, w, gy


@contextlib.contextmanager
def _exact_float32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def check_forward(x: torch.Tensor, w: torch.Tensor) -> Dict[str, float]:
    """Winograd's forward against cuDNN's, both against a float32 direct
    convolution: max |error| of each; raises where Winograd's exceeds 4x
    the direct bf16 convolution's plus 1e-3, or where B5f did not run."""
    before = wk.winograd_fwd.launches
    got = wk.winograd_conv3x3(x, w).float()
    if x.is_cuda and wk.winograd_fwd.launches != before + 1:
        raise AssertionError(f"{tuple(x.shape)}: winograd_conv3x3 took the "
                             "direct convolution")
    with _exact_float32():
        ref = direct(x.float(), w.float())
    err_direct = (direct(x, w).float() - ref).abs().max().item()
    err_wino = (got - ref).abs().max().item()
    if not err_wino <= 4.0 * err_direct + 1e-3:
        raise AssertionError(f"{tuple(x.shape)}: Winograd's error "
                             f"{err_wino} over 4x cuDNN's {err_direct}")
    return dict(err_winograd=err_wino, err_direct=err_direct)


WARMUP = 2   # eager calls before the capture


def loop_ms(fn: Callable[[], object], iters: int, device: torch.device,
            reps: int = 3) -> float:
    """Median over ``reps`` of the ms an iteration takes in a loop of
    ``iters`` calls of fn(). On a card the loop is captured once as a CUDA
    graph (after ``WARMUP`` eager calls on a side stream) and each rep is
    one replay between two CUDA events: device time, as JAX's scanned loop
    in one dispatch, not the host's time to launch the wrapper's small
    ops. On the CPU, the host clock around the loop."""
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
        return statistics.median(times)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def run(iters: int, device="cuda", batch: Optional[int] = None,
        shapes: Sequence = SHAPES,
        out: Callable[[str], None] = print) -> List[Dict]:
    """Check, then time, both convolutions at each shape; one row each
    (shape, conv, fwd and fwd+bwd ms and TF/s, launches while timed)."""
    dev = torch.device(device)
    rng = np.random.RandomState(0)
    rows = []
    for name, n, h, c in shapes:
        n = batch or n
        x, w, gy = make_inputs(rng, n, h, c, dev)
        errs = check_forward(x, w)
        out(f"{name} winograd forward within 4x cuDNN's error against "
            f"float32 (max |err| {errs['err_winograd']:.4f} vs "
            f"{errs['err_direct']:.4f})")
        flops = 2.0 * n * h * h * 9 * c * c
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        for tag, conv in (("direct", direct),
                          ("winograd", wk.winograd_conv3x3)):
            def fwd():
                with torch.no_grad():
                    return conv(x, w)

            def fwd_bwd():
                return torch.autograd.grad(conv(xg, wg), (xg, wg), gy)

            before = (wk.winograd_fwd.launches, wk.winograd_dw.launches)
            tf = loop_ms(fwd, iters, dev)
            tb = loop_ms(fwd_bwd, iters, dev)
            launches = dict(fwd=wk.winograd_fwd.launches - before[0],
                            dw=wk.winograd_dw.launches - before[1])
            if dev.type == "cuda":
                # B5f once a forward; twice (y, dx) and B5w once a
                # forward+backward; counted in the eager calls and the
                # capture, not in replays.
                calls = WARMUP + iters
                want = (0, 0) if tag == "direct" else (3 * calls, calls)
                if (launches["fwd"], launches["dw"]) != want:
                    raise AssertionError(
                        f"{name} {tag}: B5f/B5w launched {launches} times, "
                        f"expected {want} in {calls} calls of each")
            rows.append(dict(shape=name, n=n, h=h, c=c, conv=tag,
                             fwd_ms=tf, fwd_bwd_ms=tb,
                             fwd_tflops=flops / tf / 1e9,
                             fwd_bwd_tflops=3 * flops / tb / 1e9,
                             launches=launches, **errs))
            out(f"{name} {tag:9s} fwd {tf * 1e3:8.1f} us "
                f"({flops / tf / 1e9:6.1f} TF/s-equiv) | fwd+bwd "
                f"{tb * 1e3:8.1f} us ({3 * flops / tb / 1e9:6.1f} "
                f"TF/s-equiv)")
        del x, w, gy, xg, wg
    return rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--batch", type=int, default=None,
                   help="images (default 1,024: two views of 512)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions; host-clock times)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    from simclr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    return run(args.iters, resolve_device(args.device), args.batch)


if __name__ == "__main__":
    main()
