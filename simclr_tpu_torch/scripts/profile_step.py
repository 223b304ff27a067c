"""Profile the pretrain step kernel by kernel on the card.

Counterpart of ``scripts/profile_step.py``, with its flags and
``--device`` (default ``cuda``). The variant (a ``bench_variants``
name) warms up as ``bench_variants.timed_epochs`` does (the eager steps
and the capture, then a warm epoch); then ``--steps`` graph replays run
under ``utils/profiling.py:trace``, which writes a Chrome trace
(``*.pt.trace.json``) into ``--logdir``. ``parse_trace`` reads it back
and prints the device's busy ms a step, its time by kernel category
(``CATEGORIES``) and the top ``--top`` kernel families with ms a step,
share of device time, calls a step, GB/s, TF/s and how far each is above
its roofline floor.

A replayed kernel has no PyTorch op in the trace to charge bytes or
flops to, so they come from one eager step of the same engine
(``op_costs``): every aten op's inputs and outputs (bytes) and PyTorch's
flop formulas (``torch.utils.flop_counter``), matched to the kernels the
op launched and, by family, to the replays. A family no aten op launched
(the port's own kernels, launched through ctypes) prints ``-``: PERF.md's
kernel table holds their bounds. The costs are written beside the trace
(``op_costs.json``), so ``--parse_only`` prints the same table again.

    python -m simclr_tpu_torch.scripts.profile_step --variant unfused \\
        --steps 20 --top 20
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3,
# bf16 / tf32 on the tensor cores, float32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12

# Device events of a Chrome trace (torch.profiler's categories; host
# runtime calls such as cudaGraphLaunch are 'cuda_runtime' and left out).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_CATS = ("gpu_memcpy", "gpu_memset")
SIDE_ROW = "side-stream copies (overlapped)"

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("ntxent (B1)", ("ntxent",)),
    ("colour (B2)", ("color_kernel",)),
    ("bn_relu (B3)", ("bn_bwd",)),
    # conv64_wgrad_kernel is also B6b's dw2 (csrc/bottleneck.cu): on the
    # fused path this category is B6's.
    ("conv64 (B4; B6b's dw2 on the fused path)", ("conv64_",)),
    ("winograd (B5)", ("winograd_",)),
    ("bottleneck (B6)", ("bottleneck_",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "xmma", "cutlass", "nhwc", "nchw")),
    ("matmul", ("gemm", "matmul")),
    ("optimizer", ("adam", "multi_tensor")),
    ("reduction", ("reduce",)),
    # torch.rand & co. (augmentation draws, MC-dropout masks).
    ("random draws", ("distribution",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "cat", "copy", "fill")),
)

# Kernels that are a generic launcher of the class in their first template
# argument: that argument names the family.
_LAUNCHERS = ("cutlass::Kernel", "cutlass::Kernel2", "cutlass::device_kernel")
# Ops that read only the rows they gather of their first input.
_GATHERS = ("index_select", "gather", "embedding", "aten.index.")
_LABEL = "profile_step::op#"


def category(name: str) -> str:
    """A kernel's category (``CATEGORIES``), 'other' where none matches."""
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)),
                "other")


def by_category(by_name: Dict[str, float]):
    """Device ms by kernel category, largest first: [(category, ms)]."""
    cats: Dict[str, float] = {}
    for name, ms in by_name.items():
        cat = category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    return sorted(cats.items(), key=lambda kv: -kv[1])


def _strip_group(s: str, open_: str, close: str) -> str:
    """``s`` without its (nested) ``open_ ... close`` groups."""
    out, depth = [], 0
    for ch in s:
        if ch == open_:
            depth += 1
        elif ch == close and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def family(name: str) -> str:
    """The kernel family of a device event's name: the kernel name with
    its return type, parameter list and template arguments dropped (a
    generic launcher keeps its first template argument, the kernel class)
    and a numeric launch suffix collapsed; a copy or a set keeps its
    name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    base = _strip_group(s, "<", ">").strip()
    if base in _LAUNCHERS and "<" in s:
        first = s[s.index("<") + 1:]
        first = _strip_group(first, "<", ">").split(",")[0].rstrip(">")
        base = f"{base}<{first.strip()}>"
    return re.sub(r"_\d+$", "", base)


def _trace_path(logdir: str) -> Optional[str]:
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def _load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def parse_trace(logdir: str, n_steps: int, top: int,
                costs: Optional[Dict[str, dict]] = None,
                out: Callable[[str], None] = print) -> dict:
    """Read the newest Chrome trace under ``logdir`` and print its device
    time over ``n_steps`` steps: busy ms a step, by category, and the
    ``top`` kernel families with their roofline columns from ``costs``
    (family -> bytes, flops and floor ms of one step; ``op_costs``; read
    from ``op_costs.json`` beside the trace when not given). Only device
    events count (kernels, copies, sets); copies and sets on a stream other
    than the busiest one overlap it and get their own row, outside the busy
    time. Returns the numbers printed."""
    path = _trace_path(logdir)
    if path is None:
        out(f"no *.pt.trace.json under {logdir}")
        return {"path": None}
    if costs is None:
        cost_path = os.path.join(os.path.dirname(path), "op_costs.json")
        costs = {}
        if os.path.exists(cost_path):
            with open(cost_path) as f:
                costs = json.load(f)
    events = _load_events(path)
    device = [e for e in events
              if e.get("ph") == "X" and str(e.get("cat", "")).lower()
              in DEVICE_CATS]
    report = {"path": path, "n_events": len(events),
              "n_device_events": len(device)}
    if not device:
        out(f"{path}: {len(events)} events, no device events (a trace "
            "without a card)")
        report.update(device_ms=0.0, families=[], categories=[],
                      floor_ms=0.0, covered_ms=0.0, side_ms=0.0)
        return report

    def stream(e):
        return (e.get("args") or {}).get("stream", e.get("tid"))

    per_stream = collections.Counter()
    for e in device:
        per_stream[stream(e)] += float(e.get("dur", 0.0))
    main = per_stream.most_common(1)[0][0]
    totals, calls = collections.Counter(), collections.Counter()
    by_name = collections.Counter()
    side_us = 0.0
    for e in device:
        dur = float(e.get("dur", 0.0))
        if str(e["cat"]).lower() in COPY_CATS and stream(e) != main:
            side_us += dur
            continue
        fam = family(e["name"])
        totals[fam] += dur
        calls[fam] += 1
        by_name[e["name"]] += dur / 1e3
    busy_ms = sum(totals.values()) / 1e3
    span_ms = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in device)
               - min(float(e["ts"]) for e in device)) / 1e3
    step = 1.0 / n_steps
    out(f"=== {path} | device busy {busy_ms:.2f} ms | {busy_ms * step:.3f} "
        f"ms/step over {n_steps} steps (first to last device event "
        f"{span_ms * step:.3f} ms/step) ===")
    cats = by_category(by_name)
    out("--- by category ---")
    for cat, ms in cats:
        out(f"{ms * step:9.3f} ms/step {100 * ms / busy_ms:5.1f}%  {cat}")
    if side_us:
        out(f"{side_us / 1e3 * step:9.3f} ms/step    -   {SIDE_ROW}")

    fams = []
    for fam, us in totals.most_common():
        ms = us / 1e3 * step
        c = costs.get(fam)
        fams.append(dict(
            family=fam, ms=ms, pct=100 * us / 1e3 / busy_ms,
            calls=calls[fam] * step,
            bytes=None if c is None else c["bytes"],
            flops=None if c is None else c["flops"],
            floor_ms=None if c is None else c["floor_ms"]))
    floor = sum(f["floor_ms"] for f in fams if f["floor_ms"] is not None)
    covered = sum(f["ms"] for f in fams if f["floor_ms"] is not None)
    out(f"--- roofline floor of the families an aten op launched: "
        f"{floor:.3f} ms/step, covering {covered:.3f} of "
        f"{busy_ms * step:.3f} device ms/step (headroom "
        f"{covered / floor if floor else float('nan'):.2f}x; HBM "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"bf16 / {PEAK_TF32_FLOPS / 1e12:.0f} tf32 / "
        f"{PEAK_F32_FLOPS / 1e12:.0f} float32 TFLOP/s) ---")
    out(f"{'ms/step':>9} {'%dev':>5} {'calls':>6} {'GB/s':>6} {'TF/s':>6} "
        f"{'xFloor':>6}  family")
    for f in fams[:top]:
        if f["floor_ms"] is None:
            gbs = tfs = xfl = "-"
        else:
            secs = f["ms"] / 1e3
            gbs = f"{f['bytes'] / secs / 1e9:.0f}"
            tfs = f"{f['flops'] / secs / 1e12:.1f}"
            xfl = (f"{f['ms'] / f['floor_ms']:.2f}" if f["floor_ms"]
                   else "-")
        out(f"{f['ms']:9.3f} {f['pct']:5.1f} {f['calls']:6.1f} {gbs:>6} "
            f"{tfs:>6} {xfl:>6}  {f['family']}")
    report.update(device_ms=busy_ms * step, span_ms=span_ms * step,
                  categories=[(c, ms * step) for c, ms in cats],
                  families=fams, floor_ms=floor, covered_ms=covered,
                  side_ms=side_us / 1e3 * step)
    return report


def _op_peak(func, tensors) -> float:
    """The peak rate of an op's arithmetic, by its operands' type."""
    floats = [t.dtype for t in tensors if t.is_floating_point()]
    if not floats or floats[0] in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    name = str(func)
    tf32 = (torch.backends.cudnn.allow_tf32 if "conv" in name
            else torch.backends.cuda.matmul.allow_tf32)
    return PEAK_TF32_FLOPS if tf32 else PEAK_F32_FLOPS


def _op_cost(func, args, kwargs, out) -> dict:
    """Bytes (every input read once, every output written once; a gather
    reads as many bytes of its source as it writes), flops (PyTorch's flop
    formula for the op, 0 where it has none) and the op's floor ms."""
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    in_bytes = [t.numel() * t.element_size() for t in ins]
    if in_bytes and any(g in str(func) for g in _GATHERS):
        in_bytes[0] = min(in_bytes[0], out_bytes)
    n_bytes = sum(in_bytes) + out_bytes
    formula = flop_registry.get(func._overloadpacket)
    flops = float(formula(*args, **(kwargs or {}), out_val=out)
                  if formula else 0)
    floor_ms = max(n_bytes / HBM_BYTES_PER_S,
                   flops / _op_peak(func, ins)) * 1e3
    return dict(bytes=float(n_bytes), flops=flops, floor_ms=floor_ms)


def op_costs(fn: Callable[[], object]) -> Dict[str, dict]:
    """Run ``fn()`` (one eager step) under torch.profiler and a dispatch
    mode that labels every aten op and records its cost (``_op_cost``).
    Each op's cost goes to the family of the longest kernel it launched;
    returns family -> summed bytes, flops, floor ms and ops. Kernels that
    no aten op launched (ctypes launches of the port's kernels) are in no
    family's cost."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    ops: List[Optional[dict]] = []

    class _Costs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            i = len(ops)
            ops.append(None)
            with torch.profiler.record_function(f"{_LABEL}{i}"):
                out = func(*args, **(kwargs or {}))
            ops[i] = _op_cost(func, args, kwargs, out)
            return out

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with _Costs():
            fn()
        if cuda:
            torch.cuda.synchronize()
    launched: Dict[int, List] = collections.defaultdict(list)
    for e in prof.events():
        if not e.kernels:
            continue
        p = e
        while p is not None and not p.name.startswith(_LABEL):
            p = p.cpu_parent
        if p is not None:
            launched[int(p.name[len(_LABEL):])].extend(e.kernels)
    costs: Dict[str, dict] = {}
    for i, kernels in launched.items():
        main = max(kernels, key=lambda k: k.duration)
        c = costs.setdefault(family(main.name), dict(
            bytes=0.0, flops=0.0, floor_ms=0.0, ops=0))
        for key in ("bytes", "flops", "floor_ms"):
            c[key] += ops[i][key]
        c["ops"] += 1
    return costs


def profile_variant(variant: str, images: torch.Tensor, batch: int,
                    steps: int, top: int, logdir: str, seed: int = 0,
                    stage_sizes: Optional[Sequence[int]] = None,
                    width: Optional[int] = None,
                    out: Callable[[str], None] = print) -> dict:
    """Warm the variant up, trace ``steps`` replays into ``logdir``, take
    the costs of one eager step (on a card) and print ``parse_trace``'s
    tables; returns its numbers with the traced epoch's wall ms a step
    and last loss."""
    from simclr_tpu_torch.scripts.bench_variants import (
        release, run_epoch, timed_epochs, variant_config)
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr
    from simclr_tpu_torch.utils.profiling import trace

    device = images.device
    cfg = variant_config(variant, batch, stage_sizes, width)
    model, state, optimizer = init_simclr(cfg, seed=seed, device=device)
    engine = build_engine(cfg, model, optimizer)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    try:
        out(f"warming up {variant} ...")
        state = timed_epochs(engine, state, images, steps, 0,
                             generator).state
        out(f"tracing {steps} steps ...")
        with trace(logdir):
            start = time.perf_counter()
            state, loss = run_epoch(engine, state, images, steps, generator)
            wall_ms = (time.perf_counter() - start) * 1e3 / steps
        out(f"wall: {wall_ms:.2f} ms/step ({1e3 / wall_ms:.2f} steps/s) | "
            f"loss {loss:.4f}")
        costs = {}
        if device.type == "cuda":
            row = torch.arange(batch, device=device) % images.shape[0]
            costs = op_costs(lambda: engine.train_step(state, images, row,
                                                       generator))
        path = _trace_path(logdir)
        if path is not None:
            with open(os.path.join(os.path.dirname(path), "op_costs.json"),
                      "w") as f:
                json.dump(costs, f)
        report = parse_trace(logdir, steps, top, costs, out)
        report.update(wall_ms=wall_ms, loss=loss)
        return report
    finally:
        engine.graphs.clear()
        del engine, model, state, optimizer, generator
        release(device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from simclr_tpu_torch.scripts.bench_variants import VARIANTS

    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--logdir", default="results/profile_step_torch")
    p.add_argument("--parse_only", action="store_true",
                   help="just re-parse an existing trace")
    p.add_argument("--variant", default="unfused", choices=list(VARIANTS),
                   help="a bench_variants variant name")
    p.add_argument("--stage_sizes", type=int, nargs="+", default=None,
                   help="blocks a stage (default ResNet-50's 3 4 6 3)")
    p.add_argument("--width", type=int, default=None,
                   help="the stem's width (default 64)")
    p.add_argument("--n_images", type=int, default=None,
                   help="use the first N training images (default all)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions; the trace has no device events)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.parse_only:
        return parse_trace(args.logdir, args.steps, args.top)

    from simclr_tpu_torch.scripts.bench_variants import load_images
    from simclr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    images = load_images(device, args.n_images)
    return profile_variant(args.variant, images, args.batch, args.steps,
                           args.top, args.logdir,
                           stage_sizes=args.stage_sizes, width=args.width)


if __name__ == "__main__":
    main()
