#!/usr/bin/env python3
"""Drive the PyTorch port (``simclr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each printed as one line with its result and wall time:

1. env: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc.
2. build: compile the kernels from ``simclr_tpu_torch/csrc`` (nvcc,
   one process per source, started together).
3. ntxent: kernel B1 forward and backward against their plain versions
   at 2N in {1024, 2048, 200}, D = 128, float32 (TF32 off on both sides).
4. color: kernel B2 against its plain version at 512 CIFAR-sized images
   and 128 STL-sized ones.
5. slice: full-width ResNet-50 SimCLR pretraining (default ``Config()``,
   batch 512 = 1,024 images a step) through ``init_simclr``,
   ``build_engine`` and ``train_epoch`` over a synthetic CIFAR-10-shaped
   dataset on the card. The launch counts are set to 0 just before and
   read just after; every kernel must have launched and every loss must
   be finite.
6. profile: two more slice steps under torch.profiler; the device's busy
   share of the wall time and its time by kernel category and kernel.
7. parity: a width-16 model takes two steps on the card (kernels) and on
   the CPU (plain versions) from the same weights, batch and augmentation
   draws, in float32; the losses must agree.

Then a JSON line with each kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without that line; so does a run without a GPU or outside
the repository. Writes nothing but the kernel build under
``simclr_tpu_torch/_build/``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

TIME_BUDGET_S = 600.0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
T0 = time.perf_counter()


def phase(name):
    """Decorator: run a phase, print its line, re-raise any failure."""
    def wrap(fn):
        def run(*args, **kwargs):
            start = time.perf_counter()
            try:
                result = fn(*args, **kwargs)
            except BaseException:
                print(f"[{name}] FAILED after "
                      f"{time.perf_counter() - start:.1f} s", flush=True)
                raise
            total = time.perf_counter() - T0
            print(f"[{name}] ok {time.perf_counter() - start:.1f} s "
                  f"(total {total:.1f} s): {result['summary']}", flush=True)
            if total > TIME_BUDGET_S:
                raise RuntimeError(f"over the {TIME_BUDGET_S:.0f} s budget")
            return result
        return run
    return wrap


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("env")
def env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from simclr_tpu_torch.ops.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    nvcc_release = nvcc.stdout.strip().splitlines()[-1]
    return {"smi": smi,
            "summary": f"{smi} | python {sys.version.split()[0]} | torch "
                       f"{torch.__version__} | CUDA {torch.version.cuda} | "
                       f"nvcc {nvcc_release}"}


@phase("build")
def build():
    from simclr_tpu_torch.ops.kernels import _build, color, ntxent
    lib_path = _build.build()
    lib = _build.library()
    if lib.ntxent_max_dim() != ntxent.MAX_DIM:
        raise RuntimeError("ntxent MAX_DIM disagrees with the CUDA source")
    if lib.color_max_hw() != color.MAX_HW:
        raise RuntimeError("color MAX_HW disagrees with the CUDA source")
    log = (lib_path.parent / "build.log").read_text().splitlines()
    usage = [line.split("info    :")[-1].strip() for line in log
             if "registers" in line]
    for line in usage:
        print(f"  ptxas: {line}")
    return {"summary": f"{lib_path.relative_to(lib_path.parents[2])}"}


def _correct_mismatch_ok(torch, z, inv_t, got, want):
    """Correctness bits may differ only where the positive is within
    1e-4 of the row's largest negative (a float tie)."""
    from simclr_tpu_torch.ops.kernels.ntxent import (
        _masked_similarity, _positives)
    s = _masked_similarity(z, inv_t)
    rows = torch.arange(z.shape[0], device=z.device)
    pos = _positives(z.shape[0], z.device)
    s_pos = s[rows, pos]
    s[rows, pos] = -math.inf
    margin = (s_pos - s.max(dim=1).values).abs()
    bad = got != want
    return bool((margin[bad] < 1e-4).all()), int(bad.sum())


@phase("ntxent")
def ntxent_phase(torch):
    from simclr_tpu_torch.ops import losses
    from simclr_tpu_torch.ops.kernels import ntxent as k
    d, inv_t = 128, 2.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    err_f = err_b = 0.0
    notes = []
    for n2 in (1024, 2048, 200):
        # Positives correlated with their anchors, so most rows are right
        # and a few are not: both branches of `correct` are exercised.
        a = torch.randn(n2 // 2, d, device="cuda", generator=gen)
        b = a + 2.5 * torch.randn(n2 // 2, d, device="cuda", generator=gen)
        z = losses.l2_normalize(torch.cat([a, b]), dim=1).contiguous()
        loss_k, corr_k, lse_k = k.ntxent_fwd(z, inv_t)
        loss_p, corr_p, lse_p = k.ntxent_fwd_plain(z, inv_t)
        e = max((loss_k - loss_p).abs().max().item(),
                (lse_k - lse_p).abs().max().item())
        if not e < 2e-5:  # per-row values ~7; f32 sums in another order
            raise AssertionError(f"2N={n2}: forward error {e}")
        ok, n_bad = _correct_mismatch_ok(torch, z, inv_t, corr_k, corr_p)
        if not ok:
            raise AssertionError(f"2N={n2}: correctness bits disagree")
        g = torch.full((1,), 0.7, device="cuda")
        dz_k = k.ntxent_bwd(z, lse_p, inv_t, g)
        dz_p = k.ntxent_bwd_plain(z, lse_p, inv_t, g)
        eb = (dz_k - dz_p).abs().max().item()
        if not eb <= 1e-4 * dz_p.abs().max().item():
            raise AssertionError(f"2N={n2}: backward error {eb}")
        # The autograd wrapper end to end against the plain loss.
        zz = torch.cat([a, b]).requires_grad_()
        lk, ak = k.nt_xent_loss_fused(zz[: n2 // 2], zz[n2 // 2:], 0.5)
        lk.backward()
        gk = zz.grad.clone()
        zz.grad = None
        lp, ap = losses.nt_xent_loss(zz[: n2 // 2], zz[n2 // 2:], 0.5)
        lp.backward()
        if not (abs(lk.item() - lp.item()) < 1e-5
                and abs(ak.item() - ap.item()) <= 100.0 * n_bad / n2 + 1e-4
                and (gk - zz.grad).abs().max() <= 1e-4 * zz.grad.abs().max()):
            raise AssertionError(f"2N={n2}: autograd wrapper disagrees")
        err_f, err_b = max(err_f, e), max(err_b, eb)
        notes.append(f"2N={n2} fwd err {e:.2e} (tol 2e-5) bwd err {eb:.2e} "
                     f"(tol 1e-4 of max) acc {ak.item():.1f}")

    # Times at the main path's shape.
    n2 = 1024
    z = losses.l2_normalize(torch.randn(n2, d, device="cuda",
                                        generator=gen), dim=1).contiguous()
    _, _, lse = k.ntxent_fwd_plain(z, inv_t)
    g = torch.ones(1, device="cuda")
    fwd = dict(ms=time_ms(torch, lambda: k.ntxent_fwd(z, inv_t)),
               plain_ms=time_ms(torch, lambda: k.ntxent_fwd_plain(z, inv_t)))
    bwd = dict(ms=time_ms(torch, lambda: k.ntxent_bwd(z, lse, inv_t, g)),
               plain_ms=time_ms(
                   torch, lambda: k.ntxent_bwd_plain(z, lse, inv_t, g)))
    zb = n2 * d * 4
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        zb + 3 * n2 * 4, 2.0 * n2 * n2 * d, PEAK_F32_FLOPS)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        2 * zb + n2 * 4 + 4, 4.0 * n2 * n2 * d, PEAK_F32_FLOPS)
    fwd["max_abs_err"], bwd["max_abs_err"] = err_f, err_b
    return {"fwd": fwd, "bwd": bwd,
            "summary": "; ".join(notes) + f"; at 2N=1024: fwd "
                       f"{fwd['ms']:.4f} ms, bwd {bwd['ms']:.4f} ms"}


@phase("color")
def color_phase(torch):
    from simclr_tpu_torch.config import CIFAR10, STL10, AugmentConfig
    from simclr_tpu_torch.ops.augment import sample_color_params
    from simclr_tpu_torch.ops.kernels import color as k
    aug = AugmentConfig()
    gen = torch.Generator(device="cuda").manual_seed(1)
    err, notes, timing = 0.0, [], {}
    for n, ds in ((512, CIFAR10), (128, STL10)):
        size = ds.img_size
        imgs = torch.rand(n, size, size, 3, device="cuda", generator=gen)
        factors, sched = sample_color_params(
            gen, n, aug.color_distort_strength, aug.color_jitter_prob,
            aug.color_drop_prob)
        out_k = k.color_distort(imgs, factors, sched, ds.mean, ds.std)
        out_p = k.color_distort_plain(imgs, factors, sched, ds.mean, ds.std)
        e = (out_k - out_p).abs().max().item()
        # Normalised values up to ~2.7; float32 with FMA contraction and
        # another summation order for the contrast mean.
        if not e < 1e-4:
            raise AssertionError(f"{ds.name}: colour error {e}")
        err = max(err, e)
        notes.append(f"{ds.name} n={n} err {e:.2e} (tol 1e-4)")
        if ds is CIFAR10:
            timing = dict(
                ms=time_ms(torch, lambda: k.color_distort(
                    imgs, factors, sched, ds.mean, ds.std)),
                plain_ms=time_ms(torch, lambda: k.color_distort_plain(
                    imgs, factors, sched, ds.mean, ds.std)))
            n_bytes = 2 * imgs.numel() * 4 + factors.numel() * 4 \
                + sched.numel() * 4
            # ~30 float operations a pixel channel-triple per step.
            timing["bound_ms"], timing["bound_by"] = bound_ms(
                n_bytes, 4 * 30 * n * size * size, PEAK_F32_FLOPS)
    timing["max_abs_err"] = err
    return {"timing": timing,
            "summary": "; ".join(notes)
                       + f"; at 512x32x32: {timing['ms']:.4f} ms"}


def reset_counts(k_ntxent, k_color):
    k_ntxent.ntxent_fwd.launches = 0
    k_ntxent.ntxent_bwd.launches = 0
    k_color.color_distort.launches = 0


@phase("slice")
def slice_phase(torch, smi):
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import (
        DeviceDataset, epoch_permutation)
    from simclr_tpu_torch.ops.kernels import color as k_color
    from simclr_tpu_torch.ops.kernels import ntxent as k_ntxent
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    cfg = Config()
    steps, batch = 6, cfg.train.batch_size
    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    ds = DeviceDataset.from_numpy(images, labels, "cuda")
    model, state, opt = init_simclr(cfg, seed=0, device="cuda")
    engine = build_engine(cfg, model, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx_mat = epoch_permutation(gen, ds.n, batch)
    n_params = sum(p.numel() for p in model.f.parameters())
    # One warm-up step (cuDNN plans, allocator), not counted.
    state, _ = engine.train_epoch(state, ds.images, idx_mat[:1], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(k_ntxent, k_color)
    start = time.perf_counter()
    state, (losses, accs) = engine.train_epoch(state, ds.images,
                                               idx_mat[1:steps + 1], gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {"ntxent_fwd": k_ntxent.ntxent_fwd.launches,
                "ntxent_bwd": k_ntxent.ntxent_bwd.launches,
                "color": k_color.color_distort.launches}
    losses, accs = losses.tolist(), accs.tolist()
    if not all(math.isfinite(v) for v in losses + accs):
        raise AssertionError(f"non-finite loss or accuracy: {losses}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if state.step != steps + 1 or n_params != 23_500_352:
        raise AssertionError(f"step {state.step}, trunk params {n_params}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return {"launches": launches, "engine": engine, "state": state,
            "images": ds.images, "idx": idx_mat[1:3], "gen": gen,
            "summary": f"ResNet-50 ({n_params} trunk params), batch {batch},"
                       f" {steps} steps: losses "
                       f"{[round(v, 4) for v in losses]}, acc "
                       f"{[round(v, 2) for v in accs]}; "
                       f"{steps / seconds:.3f} steps/s, peak "
                       f"{peak_gib:.2f} GiB on {smi}; launches {launches}"}


_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("ntxent (B1)", ("ntxent",)),
    ("colour (B2)", ("color_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "xmma", "cutlass", "nhwc", "nchw")),
    ("matmul", ("gemm", "matmul")),
    ("optimizer", ("adam", "multi_tensor")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "cat", "copy", "fill")),
)


@phase("profile")
def profile_phase(torch, run):
    """Two more slice steps under torch.profiler: device busy share of the
    wall time (the profiler's own overhead included) and device time by
    kernel category, by kernel, and by the PyTorch op (and its input
    shapes) that launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    idx = run["idx"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        run["engine"].train_epoch(run["state"], run["images"], idx,
                                  run["gen"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    if not busy:
        raise AssertionError("the profiler saw no device time")
    cats = {}
    for name, ms in by_name.items():
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in low for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    steps = len(idx)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  kernel {ms / steps:8.3f} ms/step  {name[:100]}")
    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    for key, ms in sorted(ops, key=lambda kv: -kv[1])[:12]:
        print(f"  op     {ms / steps:8.3f} ms/step  {key}")
    shaped = [(e.key, str(e.input_shapes)[:90], e.count // steps,
               e.self_device_time_total / 1e3)
              for e in prof.key_averages(group_by_input_shape=True)
              if e.device_type == DeviceType.CPU and e.self_device_time_total]
    for key, shapes, count, ms in sorted(shaped, key=lambda r: -r[3])[:12]:
        print(f"  shape  {ms / steps:8.3f} ms/step  {count:4d}x {key} "
              f"{shapes}")
    cat_text = ", ".join(f"{c} {ms / steps:.2f}" for c, ms in
                         sorted(cats.items(), key=lambda kv: -kv[1]))
    return {"summary": f"{steps} steps, wall {wall_ms / steps:.2f} ms/step,"
                       f" device busy {busy / steps:.2f} ms/step "
                       f"({100 * busy / wall_ms:.1f}%); ms/step by "
                       f"category: {cat_text}"}


@phase("parity")
def parity_phase(torch):
    from simclr_tpu_torch.config import Config, ModelConfig
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.ops.augment import sample_view_params
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    cfg = Config(model=ModelConfig(
        feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16,
        compute_dtype="float32", bn_dtype="float32"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=40))
    images, _ = synthetic_dataset(40, img_size=32, seed=1)
    gen = torch.Generator().manual_seed(2)
    draws = [tuple(sample_view_params(gen, 40, 32, 32, cfg.augment)
                   for _ in range(2)) for _ in range(2)]
    result = {}
    for dev in ("cuda", "cpu"):
        model, state, opt = init_simclr(cfg, seed=0, device=dev)
        engine = build_engine(cfg, model, opt)
        batch = torch.from_numpy(images).to(dev)
        losses = []
        for params in draws:
            pair = tuple(p.to(dev) for p in params)
            state, (loss, _) = engine.train_step_on_params(state, batch,
                                                           pair)
            losses.append(loss.item())
        result[dev] = losses
    diff = max(abs(a - b) / abs(b) for a, b in zip(result["cuda"],
                                                   result["cpu"]))
    # float32 both sides (TF32 off); cuDNN and the CPU sum convolutions in
    # another order, and the second step follows an Adam update.
    if not diff < 1e-3:
        raise AssertionError(f"card {result['cuda']} vs cpu {result['cpu']}")
    return {"summary": f"losses card {result['cuda']} cpu {result['cpu']}, "
                       f"max rel diff {diff:.2e} (tol 1e-3)"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    import simclr_tpu_torch  # noqa: F401  (fails outside the repository)

    info = env(torch)
    build()
    nt = ntxent_phase(torch)
    col = color_phase(torch)
    sl = slice_phase(torch, info["smi"])
    profile_phase(torch, sl)
    parity_phase(torch)

    src = "simclr_tpu_torch/csrc/"
    rows = [
        dict(name="ntxent_fwd", src=src + "ntxent.cu",
             replaces="simclr_tpu/ops/pallas/ntxent.py:114",
             launches=sl["launches"]["ntxent_fwd"], **nt["fwd"]),
        dict(name="ntxent_bwd", src=src + "ntxent.cu",
             replaces="simclr_tpu/ops/pallas/ntxent.py:137",
             launches=sl["launches"]["ntxent_bwd"], **nt["bwd"]),
        dict(name="color", src=src + "color.cu",
             replaces="simclr_tpu/ops/pallas/color.py:195",
             launches=sl["launches"]["color"], **col["timing"]),
    ]
    kernels = [{"name": r["name"], "route": "cuda", "source": r["src"],
                "replaces": r["replaces"], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}
               for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
