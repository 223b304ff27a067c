#!/usr/bin/env python3
"""Drive the PyTorch port (``simclr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each printed as one line with its result and wall time:

1. env: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc.
2. build: compile the kernels from ``simclr_tpu_torch/csrc`` (nvcc,
   one process per source, started together); hold the Python mirrors of
   the kernels' constants and tilings (NT-Xent's row tiles and column
   ranges, Winograd tile blocks, the C = 64 conv's tiles and row items)
   against the C side, and B2's instantiations and bulk spans at every
   image size and offset; print how many NT-Xent clusters the card holds
   at once and each kernel's ptxas registers, shared memory and spills and
   any nvcc warning; fail on a spill of a B1 or B2 kernel.
3. ntxent: kernels B1f and B1b against their plain versions at
   (2N, D) in {(1024, 128), (2048, 128), (200, 128), (200, 40),
   (256, 2048), (64, 3)}, float32 (TF32 off in the plain versions); two
   calls of each must give the same bits. Timed at 2N = 1024 by their
   profiler device time (the wrapper's event time printed beside it),
   with cuBLAS's float32 z @ z.T printed for reference.
4. color: kernel B2 against its plain version at 512 CIFAR-sized images,
   128 STL-sized ones and ragged shapes (hw = 63, also from a buffer one
   float in; a batch of one; one image of 128 x 128); two calls must give
   the same bits. Timed at 512 x 32 x 32 by its profiler device time (the
   wrapper's event time and the device time of ``images.clone()`` beside
   it).
5. bn_relu: kernels B3a-c (the single-pass subset-BN(+add)+ReLU
   backwards) against their plain versions in bf16 and float32 at the
   largest shapes of the bn_relu_fused path and at ragged small ones; the
   autograd functions against autograd of the plain forward; a shape
   ``supports()`` refuses must raise. B3c's one library counterpart,
   aten's eval-mode BN backward, is checked and timed beside it.
6. slice: full-width ResNet-50 SimCLR pretraining (default ``Config()``,
   batch 512 = 1,024 images a step) through ``init_simclr``,
   ``build_engine`` and the graphed ``train_epoch`` over a synthetic
   CIFAR-10-shaped dataset on the card: WARMUP_STEPS eager steps, the
   capture and one replay, then 8 timed replays. The launch counts are
   set to 0 just before and read just after; the wrappers count in the
   eager steps and once in the capture, never in a replay, so every
   count must be its per-step launches times WARMUP_STEPS + 1; every
   loss must be finite.
7. profile: two more replayed steps under torch.profiler; the device's
   busy share of the wall time and its time by kernel category and
   kernel; each wrapper's kernel, by name, must show the path's launches
   a step.
8. bnrelu_slice, bnrelu_profile: phases 6 and 7 again with
   ``ModelConfig(bn_relu_fused=True)``, whose block BNs run their
   backward through B3: 32 B3a, 16 B3b and 4 B3c launches a step.
9. conv: kernels B4f/B4w (layer1's C = 64 conv: forward, input and
   weight gradient) and B5f/B5w (Winograd F(2x2,3x3): forward/input
   gradient and dU) against their plain versions at the training step's
   shapes, at the serving phase's (512 images) and at ragged ones (B4:
   W = 7, W = 17 and W = 300, which takes five column tiles); the
   autograd functions against autograd of
   their plain forwards; refused operands must raise. Each kernel is
   timed beside its plain version and the cuDNN call that computes the
   same function (``F.conv2d`` or ``aten.convolution_backward``), B4f
   and B5f also as the input gradient beside cuDNN's dx, with each factor
   over cuDNN at layer1 (B4) and layer2-4 (B5); B4f's and B5f's times
   are their kernels' device time by torch.profiler (the wrapper's
   CUDA-event time and host ms to enqueue a call printed beside).
10. conv_slice, conv_profile: phases 6 and 7 with
   ``ModelConfig(conv64_pallas=True, winograd_conv2=True)``: layer1's
   three conv2 through B4 (6 B4f, 3 B4w launches a step), the ten other
   stride-1 conv2 through B5 (20 B5f, 10 B5w).
11. bottleneck: kernels B6f/B6b (the fused identity bottleneck, forward
   and recompute-backward) against their plain versions at the four
   stage shapes of ResNet-50 at 1,024 images, at 512 (the serving
   phase's) and at two ragged ones; the
   autograd function against autograd of the plain forward; refused
   operands must raise; no B6 kernel may spill (ptxas). Each kernel is
   timed beside its plain version and the unfused block (cuDNN convs and
   PyTorch elementwise, forward and forward + backward); B6f's time is
   its tile kernel's device time, as B4f's. Then b6_split:
   one call of each at each stage under torch.profiler, device time by
   kernel, and each wrapper's time with its packing done beforehand.
12. fused_slice, fused_profile: phases 6 and 7 with
   ``ModelConfig(fuse_identity_blocks=True)``: the 12 identity blocks
   through B6f and B6b (12 launches of each a step).
13. optin_fold, optin_fold_profile, optin_wgrad_remat_accum,
   optin_wgrad_remat_accum_profile, optin: phases 6 and 7 with
   ``ModelConfig(fold_bn_scales=True)`` (the 12 identity blocks on
   ``ops/foldconv.py``) and with ``conv_wgrad_fraction=0.25``,
   ``bn12_shadow_stages=(0,)``, ``relu_from_output``, ``relu_barrier``,
   ``remat_stages=(0,)`` and ``TrainConfig(accum_steps=2)`` (two
   captures: one step accumulates, the other also steps Adam), B1 and
   B2 as on every path; then replays against eager steps of a twin (the
   draws bit for bit, an accumulating replay leaves the parameters bit
   for bit, the optimizer steps within the graph phase's tolerance);
   then one eager step from the same weights and views with cuDNN
   deterministic: the folded path against the unfolded exact one (loss,
   per-leaf gradient cosine, the stem's gradient norm) and remat against
   none (loss, gradients, running statistics updated once, and what a
   forward keeps for the backward with and without remat).
14. parity: width-16 models, the default and the bn_relu_fused one in
   float32 and ones with ``conv64_pallas`` and ``winograd_conv2`` and with
   ``fuse_identity_blocks`` in bf16, and the two optin configurations in
   float32 (``stage_sizes=(2,1,1,1)``, three steps), take two steps on the card
   (kernels) and on the CPU (plain versions) from the same weights, batch and
   augmentation draws; the losses must agree.
15. graph: on the same four width-16 configurations, 3 replays of the
   captured step against 3 eager steps from the same weights, Adam state,
   generator state and rows: the draws bit for bit (and different from
   one replay to the next), the losses and parameters within stated
   tolerances, the replays under ``torch.cuda.set_sync_debug_mode
   ("error")``; and capturable Adam against the default one. Then the
   fine-tune step (``train/ssl.py``, batch 64) the same way, against
   eager steps from the same weights, SGD state, generator and rows, on
   the default and bn_relu_fused configurations, and one more replay of
   each under the profiler, where B3's launches show by name. Then the
   supervised baseline's half-step (width-16 ``SupervisedResNet``, batch
   64, capturable Adam; B2 once a half-step) and the MINE step (``repr``
   mode, batch 64, over a width-16 SimCLR with MC dropout; B2 three times
   a step) the same way: their view draws and the six dropout masks bit
   for bit, the masks different from one replay to the next.
16. pretrain: ``pretrain()`` at full width on the default config, 4,096
   synthetic images (80/20 split), 2 epochs with a checkpoint after
   each, under torch.profiler (each epoch's seconds, steps/s, device
   busy share and peak memory); a run resumed from the first epoch's
   checkpoint must end where it did; the export must load back.
17. lin_eval: ``linear_evaluation`` of that export at full width on the
   3,277 / 819 split (features at batch 512, 40 float32 L-BFGS
   iterations at most): the loss falls from ln 10, all finite, the
   first 16 images' features within 1e-2 of the CPU's; extraction
   images/s, ms an L-BFGS iteration, top-1.
18. ssl: ``train_ssl`` from the export (batch 64, 10% of the labels by
   weighted draws: 5 steps an epoch), 2 epochs, tested on the 819:
   ``f`` and ``g`` grafted, ``f`` moved and ``g`` not, a finite history;
   seconds an epoch, steps/s, the busy share of two replayed steps under
   the profiler, peak memory. Neither downstream path launches a kernel
   of the port (their counts are read and must be 0).
19. supervised: ``train_supervised`` at full width (batch 64, two
   half-steps a batch: 102 an epoch), 2 epochs, validated and tested on
   the 819: B2 once in each eager half-step and in the capture and no
   other kernel, a finite history, the best epoch's parameters restored
   bit for bit; seconds an epoch, half-steps/s, the busy share of two
   replayed half-steps under the profiler, peak memory.
20. mine: ``train_mine_from_export`` on the export at batch 256 and
   hidden width 512: ``repr`` mode with ``encoder='dropout'`` for 200
   steps (B2 three times a step), then ``orig`` mode without dropout for
   50 (twice a step; MineNet 5,120 wide), counted in the EMA's first
   sample, the eager steps and the capture; finite traces; ms a step,
   the busy share of two replayed steps, peak memory.

21. native: the port's C++ data plane builds (no numpy fallback on the
   card); its CIFAR-10 and STL-10 decoders give numpy's bytes;
   ``NativePipeline``'s batches are the gathers of their rows, each row
   once an epoch; its batches/s at batch 512 over 50,000 CIFAR-shaped
   images, on the host and with the copy to the card.
22. streaming: ``pretrain_streaming`` at full width (batch 512, 4,096
   synthetic images, 3 epochs) with the numpy feed and with the native
   pipeline, every step a graph replay but the first two (B1f/B1b 1 and
   B2 2 a step, counted); a streamed epoch against a resident one from
   the same weights, permutation and generator, bit for bit with cuDNN
   deterministic; steps/s of both feeds and of the resident epoch, the
   busy share of 4 profiled streamed steps and their host-to-device copy
   time.
23. parallel: (a) a one-rank NCCL group in this process, the explicit
   data-parallel engine's graphed epoch at full width against the
   one-device engine (loss within 1e-3; B2 2 a step, no B1), steps/s and
   busy share; (b) two gloo ranks in two processes on this card, width
   16, float32, one explicit SGD step against one process on the global
   batch.
24. analysis: the representation analysis of the pretrain phase's export
   at full width (``scripts/analysis.py`` without the figures): the
   similarity metrics of h at batch 256 over 4 batches (B2 twice a
   batch), then features, the flipped-view analogy and the one-batch
   gradient flow (B1f and B1b once, B2 twice), all counted; the model's
   parameters and buffers bit for bit as before; ``_pairwise_metrics``
   on the card against the CPU on the same features; pos_cos > neg_cos;
   the metric pass's images/s.
25. serving: ``export_forward`` of the export's eval forward on the card
   at batch 512 and ``load_forward``, on the default path and from the
   same weights under ``conv64_pallas`` with ``winograd_conv2`` and under
   ``fuse_identity_blocks``: each artifact against the eager forward
   (relative norm within 1e-2; bit for bit expected), each path's eager
   (h, z) against a float32 forward of the same weights (a kernel path
   at most twice the default bf16 path's error), one forward of each
   counted (no kernel of the port; B4f 3 and B5f 10; B6f 12), the
   artifact's graph checked for one operator node a launch and no
   convolution in a kernel's place, both forwards' images/s, device ms
   and host ms to enqueue, and the artifact's size.
26. stl10: ``Config.for_dataset('stl10')`` at full width (the 7x7
   stride-2 stem, the max-pool, the 9-tap blur), batch 256, 2,048
   synthetic 96x96 images: ``pretrain()`` for 2 epochs of graph replays
   (B1f/B1b 1 and B2 2 in each eager step and the capture, B1f 1 and B2
   2 in each validation step, counted), finite losses, steps/s, busy
   share and peak memory; augmented pairs/s at 96x96; a short linear
   evaluation.
27. measure: the four measurement harnesses (``simclr_tpu_torch/
   scripts/``): ``bench_variants`` on ``unfused``, ``bnrelu``,
   ``conv64``, ``winograd`` and ``fuse64`` (batch 512, 6 steps, 2 timed
   epochs; each wrapper's launches counted; losses finite; ``unfused``
   within 10% of the slice phase's steps/s), ``profile_step`` on
   ``unfused`` (device busy within 5% of the profile phase's; a roofline
   floor from one eager step's op costs), ``bn_relu_microbench`` (B3b at
   its four shapes) and ``bench_winograd`` (B5 against cuDNN at layers
   2-4), each checked before it is timed.

Then a JSON line with each kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py b6_split   # only B6's time split (also on an
                                     # archive of an earlier tree)
    python3 chip_smoke.py b6_trace   # B6 tile kernels' phase clocks
    python3 chip_smoke.py color      # only phase 4 (also on an archive
                                     # of an earlier tree)
    python3 chip_smoke.py b2_trace   # B2 blocks' phase clocks
    python3 chip_smoke.py measure    # phases 6, 7 and 27 only
    python3 chip_smoke.py serving    # phases 2, 16 and three times 25
 Any failure
exits non-zero without that line; so does a run without a GPU or outside
the repository. Writes nothing but the kernel build under
``simclr_tpu_torch/_build/`` and, in a temporary directory that it
removes at the end, the pretrain phase's checkpoints and the export that
the downstream phases read, the serving phase's artifact, the stl10
phase's export and the measure phase's trace.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

TIME_BUDGET_S = 600.0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12     # tf32 on the tensor cores
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


def median_ms(torch, fn, iters=25, warmup=3):
    """Median device time of one fn() call over iters calls, each between
    its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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
    from simclr_tpu_torch.ops.kernels import (
        _build, bn_relu, bottleneck, color, conv64, ntxent, winograd)
    lib_path = _build.build()
    lib = _build.library()
    if lib.ntxent_max_dim() != ntxent.MAX_DIM:
        raise RuntimeError("ntxent MAX_DIM disagrees with the CUDA source")
    if lib.color_max_hw() != color.MAX_HW:
        raise RuntimeError("color MAX_HW disagrees with the CUDA source")
    # B2's instantiation and bulk span (mirrored by color.geometry, held
    # against a brute-force enumeration by
    # tests/test_torch_color_geometry.py) at every image size and offset.
    geom = (ctypes.c_int * 6)()
    for hw in range(1, color.MAX_HW + 1):
        for mis in (0, 4, 8, 12):
            if (lib.color_geometry(hw, mis, geom) != 0
                    or tuple(geom)[:5] != color.geometry(hw, mis)):
                raise RuntimeError(f"color geometry at hw={hw}, mis={mis} "
                                   "disagrees with the CUDA source")
    if (lib.bn_bwd_row_blocks(1, bn_relu.VEC) != 1
            or lib.bn_bwd_row_blocks(1, bn_relu.VEC + 1) != -1):
        raise RuntimeError("bn_relu VEC disagrees with the CUDA source")
    if (lib.winograd_dw_ranges(1, 2, 2, winograd.BLOCK, winograd.BLOCK) != 1
            or lib.winograd_dw_ranges(1, 2, 2, winograd.BLOCK // 2,
                                      winograd.BLOCK) != -1):
        raise RuntimeError("winograd BLOCK disagrees with the CUDA source")
    # The Python mirror of the Winograd kernels' tile blocks (held against
    # a brute-force enumeration by tests/test_torch_winograd.py) is the C
    # side's, at the path's shapes and the ragged one.
    geom = (ctypes.c_int * 6)()
    for n, _, _, h, w in _B5_SHAPES:
        for kernel in (0, 1):
            if (lib.winograd_geometry(n, h, w, kernel, geom) != 0
                    or tuple(geom) != winograd.tile_blocks(n, h, w, kernel)):
                raise RuntimeError("winograd tile blocks disagree with the "
                                   "CUDA source")
    # The same for the C = 64 conv kernels' tiles and row items (held
    # against a brute-force enumeration by tests/test_torch_conv64.py);
    # B4w's pixel ranges fill the SMs once.
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, h, w in _B4_SHAPES:
        for kernel in (0, 1):
            want = conv64.geometry(n, h, w, kernel)
            if (lib.conv64_geometry(n, h, w, kernel, geom) != 0
                    or tuple(geom)[:5] != want
                    or geom[5] != min(want[4], sms)
                    or len(conv64.tile_boxes(n, h, w, kernel)) != want[4]):
                raise RuntimeError("conv64 tiles disagree with the CUDA "
                                   "source")
    # The fused bottleneck's tiles, grid and workspace (mirrored by
    # bottleneck.geometry, grid and workspace_bytes, held against a
    # brute-force enumeration by tests/test_torch_bottleneck_geometry.py).
    geom8 = (ctypes.c_int * 8)()
    for n, c, h, w in _B6_SHAPES:
        if (lib.bottleneck_geometry(n, h, w, c, geom8) != 0
                or tuple(geom8)[:7] != bottleneck.geometry(n, h, w, c)
                or geom8[7] != bottleneck.grid(n, h, w, c, sms)
                or lib.bottleneck_bwd_workspace(n, h, w, c)
                != bottleneck.workspace_bytes(n, h, w, c, sms)):
            raise RuntimeError("bottleneck tiles or workspace disagree with "
                               "the CUDA source")
    # The C side takes exactly the widths and row lengths supports() does.
    work = lib.bottleneck_bwd_workspace
    if work(1, 1, 1, 32) != 0 or not all(
            work(1, 1, bottleneck.TILE_ELEMS // c, c) > 0
            and work(1, 1, bottleneck.TILE_ELEMS // c + 1, c) == 0
            for c in bottleneck.WIDTHS):
        raise RuntimeError("bottleneck WIDTHS/TILE_ELEMS disagree with the "
                           "CUDA source")
    # B1's tiling (mirrored by ntxent.geometry, held against ntxent.tiles
    # by tests/test_torch_ntxent_geometry.py) at every shape of the ntxent
    # phase; how many clusters of CLUSTER blocks the card holds at once
    # (and, beside them, how many clusters of 8 at the same shared memory).
    for n2, d in _B1_SHAPES:
        for kernel in (0, 1):
            if (lib.ntxent_geometry(n2, d, kernel, geom8) != 0
                    or tuple(geom8) != ntxent.geometry(n2, d, kernel)):
                raise RuntimeError("ntxent tiling disagrees with the CUDA "
                                   "source")
    resident = {(kernel, cl): lib.ntxent_max_active_clusters(kernel, cl)
                for kernel in (0, 1) for cl in (ntxent.CLUSTER, 8)}
    if min(resident.values()) < 1:
        raise RuntimeError(f"ntxent clusters do not fit: {resident}")
    clusters = ntxent.geometry(1024, 128, 0)[1]
    waves = [-(-clusters // resident[kernel, ntxent.CLUSTER])
             for kernel in (0, 1)]
    print(f"  ntxent: clusters of {ntxent.CLUSTER} resident at once (fwd, "
          f"bwd): {resident[0, ntxent.CLUSTER]}, "
          f"{resident[1, ntxent.CLUSTER]}; of 8: {resident[0, 8]}, "
          f"{resident[1, 8]}; 2N = 1024 takes {clusters} clusters "
          f"({clusters * ntxent.CLUSTER} blocks) in {waves[0]}, {waves[1]} "
          f"wave(s)")
    log = (lib_path.parent / "build.log").read_text()
    usage = _ptxas_usage(log)
    for name, frame, regs in usage:
        print(f"  ptxas: {name}: {regs}; {frame}")
    for line in log.splitlines():
        # ptxas reports serialised wgmma (C7515, C7520) as information.
        if "warning" in line or "C7515" in line or "C7520" in line:
            print(f"  nvcc: {line.strip()}")
    spills = [(n, f) for n, f, _ in usage
              if (n.startswith("ntxent_") or n == "color_kernel")
              and re.search(r"[1-9]\d* bytes spill", f)]
    if spills:
        raise RuntimeError(f"B1 or B2 kernels spill: {spills}")
    return {"ptxas": usage,
            "summary": f"{lib_path.relative_to(lib_path.parents[2])}"}


def _ptxas_usage(log):
    """(kernel, stack/spill line, register/shared-memory line) for each
    kernel in nvcc's -Xptxas=-v output; the name is the last component of
    the mangled one (``_Z[N]<length><name>...``, the first component
    being the anonymous namespace where there is one)."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        name, rest = mangled, mangled[2 + mangled.startswith("_ZN"):]
        while (m := re.match(r"\d+", rest)):
            end = m.end() + int(m.group())
            name, rest = rest[m.end():end], rest[end:]
        lines = [line.split("info    :")[-1].strip()
                 for line in block.splitlines()]
        frame = next((x for x in lines if "spill" in x), "")
        usage = next((x for x in lines if "registers" in x), "")
        out.append((name, frame, usage))
    return out


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


# B1's shapes: the main path's 2N = 1024 at D = 128, twice its batch, a
# ragged 2N (and D) that leaves ranks of the cluster without columns, the
# gate's widest D, and a D that is not a multiple of 4 (scalar loads).
_B1_SHAPES = ((1024, 128), (2048, 128), (200, 128), (200, 40), (256, 2048),
              (64, 3))


# Profiler sessions _kernel_ms runs at most: one archive run's color
# phase saw none of 20 ``imgs.clone()`` copies in its session.
_PROFILER_SESSIONS = 2


def _kernel_ms(torch, calls, iters=20):
    """Mean device time of one launch of each kernel in ``calls`` (the
    part of its name to match: a call), over ``iters`` rounds of the calls
    under one torch.profiler session: the wrappers' host time (Python,
    allocations, the ctypes call) is left out, which event times around a
    call of a few us cannot do. The profiler may miss a launch at its
    start, so a mean is over the launches it saw (at least half). It has
    also been seen to miss every copy of a session (``imgs.clone()``'s
    Memcpy DtoD, once in six runs of the color phase on the H100), so a
    session that saw fewer than half of a kernel's launches is run again,
    up to ``_PROFILER_SESSIONS`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    for _ in range(_PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for call in calls.values():
                    call()
            torch.cuda.synchronize()
        times = {key: [] for key in calls}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = next((k for k in calls if k in e.name), None)
                if key is not None:
                    times[key].append(e.time_range.elapsed_us() / 1e3)
        short = {key: len(ts) for key, ts in times.items()
                 if 2 * len(ts) < iters}
        if not short:
            return {key: sum(ts) / len(ts) for key, ts in times.items()}
    key, seen = next(iter(short.items()))
    raise AssertionError(f"the profiler saw {seen} launches of {key} in "
                         f"{iters} rounds, in each of {_PROFILER_SESSIONS} "
                         f"sessions")


@phase("ntxent")
def ntxent_phase(torch):
    from simclr_tpu_torch.ops import losses
    from simclr_tpu_torch.ops.kernels import ntxent as k
    inv_t = 2.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    err_f = err_b = 0.0
    notes = []
    for n2, d in _B1_SHAPES:
        # Positives correlated with their anchors, so most rows are right
        # and a few are not: both branches of `correct` are exercised.
        a = torch.randn(n2 // 2, d, device="cuda", generator=gen)
        b = a + 2.5 * torch.randn(n2 // 2, d, device="cuda", generator=gen)
        z = losses.l2_normalize(torch.cat([a, b]), dim=1).contiguous()
        loss_k, corr_k, lse_k = k.ntxent_fwd(z, inv_t)
        if not all(torch.equal(x, y) for x, y in zip(
                (loss_k, corr_k, lse_k), k.ntxent_fwd(z, inv_t))):
            raise AssertionError(f"2N={n2} D={d}: two forward calls differ")
        loss_p, corr_p, lse_p = k.ntxent_fwd_plain(z, inv_t)
        e = max((loss_k - loss_p).abs().max().item(),
                (lse_k - lse_p).abs().max().item())
        if not e < 2e-5:  # per-row values ~7; f32 sums in another order
            raise AssertionError(f"2N={n2} D={d}: forward error {e}")
        ok, n_bad = _correct_mismatch_ok(torch, z, inv_t, corr_k, corr_p)
        if not ok:
            raise AssertionError(f"2N={n2} D={d}: correctness bits disagree")
        g = torch.full((1,), 0.7, device="cuda")
        dz_k = k.ntxent_bwd(z, lse_p, inv_t, g)
        if not torch.equal(dz_k, k.ntxent_bwd(z, lse_p, inv_t, g)):
            raise AssertionError(f"2N={n2} D={d}: two backward calls differ")
        dz_p = k.ntxent_bwd_plain(z, lse_p, inv_t, g)
        eb = (dz_k - dz_p).abs().max().item()
        if not eb <= 1e-4 * dz_p.abs().max().item():
            raise AssertionError(f"2N={n2} D={d}: backward error {eb}")
        # The autograd wrapper end to end against the plain loss.
        zz = torch.cat([a, b]).requires_grad_()
        lk, ak = k.nt_xent_loss_fused(zz[: n2 // 2], zz[n2 // 2:], 0.5)
        lk.backward()
        gk = zz.grad.clone()
        zz.grad = None
        lp, ap = losses.nt_xent_loss(zz[: n2 // 2], zz[n2 // 2:], 0.5)
        lp.backward()
        diffs = (abs(lk.item() - lp.item()), abs(ak.item() - ap.item()),
                 ((gk - zz.grad).abs().max() / zz.grad.abs().max()).item())
        if not (diffs[0] < 1e-5 and diffs[1] <= 100.0 * n_bad / n2 + 1e-4
                and diffs[2] <= 1e-4):
            raise AssertionError(f"2N={n2} D={d}: autograd wrapper disagrees "
                                 f"(loss, accuracy, gradient): {diffs}")
        err_f, err_b = max(err_f, e), max(err_b, eb)
        top = dz_p.abs().max().item()
        notes.append(f"2N={n2} D={d} fwd err {e:.2e} (tol 2e-5) bwd err "
                     f"{eb:.2e} (tol 1e-4 of max {top:.2e}) acc "
                     f"{ak.item():.1f}; two calls bit-identical")

    # Times at the main path's shape: the kernels by their profiler device
    # time, the plain versions by CUDA events.
    n2, d = 1024, 128
    z = losses.l2_normalize(torch.randn(n2, d, device="cuda",
                                        generator=gen), dim=1).contiguous()
    _, _, lse = k.ntxent_fwd_plain(z, inv_t)
    g = torch.ones(1, device="cuda")
    calls = {"fwd": lambda: k.ntxent_fwd(z, inv_t),
             "bwd": lambda: k.ntxent_bwd(z, lse, inv_t, g)}
    plains = {"fwd": lambda: k.ntxent_fwd_plain(z, inv_t),
              "bwd": lambda: k.ntxent_bwd_plain(z, lse, inv_t, g)}
    zb = n2 * d * 4
    # Bytes (z in, per-row outputs or dz out) and the operations as the
    # kernels do them: each product three times in tf32 on the tensor cores.
    work = {"fwd": (zb + 3 * n2 * 4, 3 * 2.0 * n2 * n2 * d),
            "bwd": (2 * zb + n2 * 4 + 4, 3 * 4.0 * n2 * n2 * d)}
    device = _kernel_ms(torch, {f"ntxent_{name}_kernel": call
                                for name, call in calls.items()}
                        | {"gemm": lambda: z @ z.T})
    out = {}
    for name, call in calls.items():
        t = dict(ms=device[f"ntxent_{name}_kernel"],
                 plain_ms=time_ms(torch, plains[name]),
                 max_abs_err=err_f if name == "fwd" else err_b)
        n_bytes, flops = work[name]
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops,
                                                PEAK_TF32_FLOPS)
        wrapper = time_ms(torch, call)
        print(f"  B1{name[0]} at 2N={n2} D={d}: kernel {t['ms']:.4f} ms "
              f"(profiler device time), wrapper {wrapper:.4f} ms (CUDA "
              f"events over back-to-back calls), plain {t['plain_ms']:.4f}"
              f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})",
              flush=True)
        out[name] = t
    print(f"  cuBLAS float32 z @ z.T at 2N={n2} D={d} (reference, not the "
          f"loss): {device['gemm']:.4f} ms device, "
          f"{time_ms(torch, lambda: z @ z.T):.4f} ms by events", flush=True)
    return {"fwd": out["fwd"], "bwd": out["bwd"],
            "summary": "; ".join(notes) + f"; at 2N=1024: fwd "
                       f"{out['fwd']['ms']:.4f} ms, bwd "
                       f"{out['bwd']['ms']:.4f} ms (device)"}


# B2's shapes: (images, height, width, dataset, offset of the images in
# their buffer in floats). The main path's 512 CIFAR images, 128 STL-10
# ones, hw = 63 (not a multiple of 4: the images start at every offset
# modulo 16, so the bulk copies have heads and tails), the same one float
# into a buffer (input and output at different offsets), a batch of one,
# and one image of MAX_HW = 128 x 128 pixels.
_B2_SHAPES = ((512, 32, 32, "cifar10", 0), (128, 96, 96, "stl10", 0),
              (37, 7, 9, "cifar10", 0), (37, 7, 9, "cifar10", 1),
              (1, 32, 32, "cifar10", 0), (1, 128, 128, "cifar10", 0))


def _b2_inputs(torch, gen, n, h, w, offset=0):
    from simclr_tpu_torch.config import AugmentConfig
    from simclr_tpu_torch.ops.augment import sample_color_params
    aug = AugmentConfig()
    buf = torch.rand(offset + n * h * w * 3, device="cuda", generator=gen)
    factors, sched = sample_color_params(
        gen, n, aug.color_distort_strength, aug.color_jitter_prob,
        aug.color_drop_prob)
    return buf[offset:].view(n, h, w, 3), factors, sched


def _b2_floor_ms(torch, imgs):
    """Device time of ``imgs.clone()``, a copy of the same bytes in and
    out (a contiguous clone is one cudaMemcpyAsync, device to device):
    the practical floor for B2."""
    return _kernel_ms(torch, {"Memcpy DtoD": imgs.clone})["Memcpy DtoD"]


@phase("color")
def color_phase(torch):
    from simclr_tpu_torch.config import CIFAR10, STL10
    from simclr_tpu_torch.ops.kernels import color as k
    sets = {"cifar10": CIFAR10, "stl10": STL10}
    gen = torch.Generator(device="cuda").manual_seed(1)
    err, notes, timing = 0.0, [], {}
    for n, h, w, name, offset in _B2_SHAPES:
        ds = sets[name]
        imgs, factors, sched = _b2_inputs(torch, gen, n, h, w, offset)
        out_k = k.color_distort(imgs, factors, sched, ds.mean, ds.std)
        if not torch.equal(out_k, k.color_distort(imgs, factors, sched,
                                                  ds.mean, ds.std)):
            raise AssertionError(f"{n}x{h}x{w}: two calls differ")
        out_p = k.color_distort_plain(imgs, factors, sched, ds.mean, ds.std)
        e = (out_k - out_p).abs().max().item()
        # Normalised values up to ~2.7; float32 with FMA contraction and
        # another summation order for the contrast mean.
        if not e < 1e-4:
            raise AssertionError(f"{n}x{h}x{w} {name}: colour error {e}")
        err = max(err, e)
        notes.append(f"{n}x{h}x{w} {name}{' +1 float' if offset else ''} "
                     f"err {e:.2e}")
        if (n, h, w) == (512, 32, 32):
            call = lambda: k.color_distort(imgs, factors, sched, ds.mean,
                                           ds.std)
            timing = dict(
                ms=_kernel_ms(torch, {"color_kernel": call})["color_kernel"],
                plain_ms=time_ms(torch, lambda: k.color_distort_plain(
                    imgs, factors, sched, ds.mean, ds.std)))
            n_bytes = 2 * imgs.numel() * 4 + factors.numel() * 4 \
                + sched.numel() * 4
            # ~30 float operations a pixel channel-triple per step. The
            # bytes are counted at the HBM rate, as for every kernel; at
            # this size that is no lower bound, since the 12.6 MB stay in
            # the 50 MB L2 and a copy of them beats it. So B2 is read
            # against images.clone() of the same bytes, the copy floor.
            timing["bound_ms"], timing["bound_by"] = bound_ms(
                n_bytes, 4 * 30 * n * h * w, PEAK_F32_FLOPS)
            wrapper, floor = time_ms(torch, call), _b2_floor_ms(torch, imgs)
            print(f"  B2 at {n}x{h}x{w}: kernel {timing['ms']:.4f} ms "
                  f"(profiler device time), wrapper {wrapper:.4f} ms (CUDA "
                  f"events over back-to-back calls), plain "
                  f"{timing['plain_ms']:.4f} ms; images.clone() "
                  f"{floor:.4f} ms device (the copy floor), kernel / copy "
                  f"{timing['ms'] / floor:.2f}; HBM byte bound "
                  f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}; "
                  "beaten by the copy at this size)", flush=True)
    timing["max_abs_err"] = err
    return {"timing": timing,
            "summary": "; ".join(notes) + " (tol 1e-4; two calls "
                       f"bit-identical); at 512x32x32: {timing['ms']:.4f} "
                       f"ms (device), {timing['ms'] / floor:.2f}x the copy"}


def _b2_c_call(torch, lib, imgs, factors, sched, ds):
    """One B2 launch through a library's C entry ``color_distort``."""
    n, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    args = (imgs.data_ptr(), factors.data_ptr(), sched.data_ptr(),
            out.data_ptr(), n, h * w, *map(float, ds.mean),
            *map(float, ds.std))

    def call():
        status = lib.color_distort(*args,
                                   torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"color_distort failed with {status}")
        return out
    return call


def b2_trace(torch):
    """Where a B2 block's time goes: a build with -DSIMCLR_B2_TRACE
    records thread 0's clock64() in every block at its start, with the
    image in registers, after the four steps, before the bulk store and at
    its end (csrc/color.cu, B2_MARK), with the block's SM; for one call at
    512 x 32 x 32, the mean and largest clocks of each phase over the
    blocks, and each SM's span from its first block's start to its last
    block's end."""
    from simclr_tpu_torch.config import CIFAR10
    from simclr_tpu_torch.ops.kernels import _build
    lib = _build.load(_build.build(("-DSIMCLR_B2_TRACE",)))
    lib.color_trace.argtypes = [ctypes.c_void_p]
    lib.color_trace.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs, factors, sched = _b2_inputs(torch, gen, 512, 32, 32)
    call = _b2_c_call(torch, lib, imgs, factors, sched, CIFAR10)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (1024 * 6))()
    if lib.color_trace(buf) != 1024:
        raise RuntimeError("color_trace failed")
    rows = [list(buf)[6 * i: 6 * i + 6] for i in range(512)]
    names = ("in", "chain", "to smem", "store", "block")
    spans = [[r[j + 1] - r[j] for j in range(1, 5)] + [r[5] - r[1]]
             for r in rows]
    text = ", ".join(
        f"{name} {statistics.mean(v):.0f} (max {max(v)})"
        for name, v in zip(names, zip(*spans)))
    by_sm = {}
    for r in rows:
        by_sm.setdefault(r[0], []).append(r)
    sm_span = [max(r[5] for r in v) - min(r[1] for r in v)
               for v in by_sm.values()]
    skew = [max(r[1] for r in v) - min(r[1] for r in v)
            for v in by_sm.values()]
    counts = sorted({len(v) for v in by_sm.values()})
    print(f"  B2 trace 512x32x32 (clocks a block): {text}; {len(by_sm)} "
          f"SMs with {counts} blocks each, an SM's span "
          f"{statistics.mean(sm_span):.0f} (max "
          f"{max(sm_span)}), its blocks' start skew "
          f"{statistics.mean(skew):.0f} (max {max(skew)})", flush=True)


# B3 comparisons: (wrapper, mode, NCHW shape). The first five are the
# largest shapes of the bn_relu_fused path at batch 512 (2N = 1,024); the
# ragged ones exercise partial row blocks, C not a multiple of 256 and the
# 2-D (N, C) view.
_B3_CASES = (
    ("relu", (1024, 64, 32, 32)), ("relu", (1024, 512, 4, 4)),
    ("add_relu", (1024, 256, 32, 32)),
    ("none", (1024, 256, 32, 32)), ("none", (1024, 2048, 4, 4)),
    ("relu", (37, 72, 3, 5)), ("add_relu", (37, 72, 3, 5)),
    ("none", (37, 72, 3, 5)), ("relu", (1000, 24)),
)
# The shape each kernel's times in the kernels line are taken at: its
# largest on the path, in the path's bf16.
_B3_TIMED = {"relu": (1024, 64, 32, 32), "add_relu": (1024, 256, 32, 32),
             "none": (1024, 256, 32, 32)}
# Tensors each pass reads or writes: g, out[, x], dx[, dskip].
_B3_TENSORS = {"relu": 3, "add_relu": 5, "none": 3}


def _b3_inputs(torch, gen, shape, dtype):
    cl = (torch.channels_last if len(shape) == 4
          else torch.contiguous_format)
    c = shape[1]

    def t(scale=1.0, offset=0.0):
        return (torch.randn(shape, device="cuda", generator=gen) * scale
                + offset).to(dtype).contiguous(memory_format=cl)

    def v(scale, offset):
        return torch.randn(c, device="cuda", generator=gen) * scale + offset

    return dict(g=t(), out=torch.relu(t()), x=t(1.5, 1.0),
                a32=v(0.2, 1.0), mean=v(0.5, 1.0), rsig=v(0.1, 0.7).abs())


def _b3_call(k, mode, i, plain=False):
    """(outputs..., S1, S2) of one B3 pass, kernel or plain version."""
    if mode == "relu":
        fn = k.bwd_relu_plain if plain else k.bwd_relu
        return fn(i["g"], i["out"], i["a32"])
    if mode == "add_relu":
        fn = k.bwd_add_relu_plain if plain else k.bwd_add_relu
        return fn(i["g"], i["out"], i["x"], i["a32"], i["mean"], i["rsig"])
    fn = k.bwd_norelu_plain if plain else k.bwd_norelu
    return fn(i["g"], i["x"], i["a32"], i["mean"], i["rsig"])


def _b3_abs_sums(torch, mode, i):
    """Per-channel sums of |terms| of S1 and S2 (S2' in 'relu' mode): the
    scale of their float32 summation error."""
    red = (0,) + tuple(range(2, i["g"].dim()))
    cs = (1, -1) + (1,) * (i["g"].dim() - 2)
    g = i["g"].float()
    gy = g if mode == "none" else g * (i["out"].float() > 0)
    xh = (i["out"].float() if mode == "relu"
          else (i["x"].float() - i["mean"].view(cs)) * i["rsig"].view(cs))
    return gy.abs().sum(red), (gy * xh).abs().sum(red)


def _b3_autograd_check(torch, k, gen):
    """Each autograd function (kernel backward) against autograd of the
    plain forward, float32, loss weighting out, mean and var: dx/dskip
    within 2e-5 and dscale/dbias within 3e-4 (float32 sums in another
    order; in 'relu' mode also the S2 recovery), relative and absolute."""
    from simclr_tpu_torch.ops import subset_bn
    shape, kk, eps = (256, 128, 8, 8), 32, 1e-5
    worst = 0.0
    for mode in ("relu", "add_relu", "none"):
        i = _b3_inputs(torch, gen, shape, torch.float32)
        c = shape[1]
        w = [torch.randn(s, device="cuda", generator=gen)
             for s in (shape, (c,), (c,))]
        shift = torch.randn(c, device="cuda", generator=gen) + 1.0
        grads = []
        for fused in (True, False):
            x, skip = (i["x"].clone().requires_grad_(),
                       i["g"].clone().requires_grad_())
            scale = (i["a32"].clone()).requires_grad_()
            bias = (i["mean"] * 0.2).requires_grad_()
            if fused:
                if mode == "add_relu":
                    o, m, v = k.subset_bn_add_relu(x, skip, scale, bias,
                                                   shift, kk, eps,
                                                   torch.float32)
                else:
                    op = (k.subset_bn_relu if mode == "relu"
                          else k.subset_bn_only)
                    o, m, v = op(x, scale, bias, shift, kk, eps,
                                 torch.float32)
            else:
                m, v = subset_bn.bn_stats(x, shift, kk)
                o = subset_bn.bn_apply(x, scale, bias, m, v, eps,
                                       torch.float32)
                if mode == "add_relu":
                    o = torch.relu(o + skip)
                elif mode == "relu":
                    o = torch.relu(o)
            ((o * w[0]).sum() + (m * w[1]).sum()
             + (v * w[2]).sum()).backward()
            grads.append([torch.zeros_like(t) if t.grad is None else t.grad
                          for t in (x, skip, scale, bias)])
        for a, b, tol in zip(grads[0], grads[1], (2e-5, 2e-5, 3e-4, 3e-4)):
            if not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
                raise AssertionError(f"{mode}: autograd function disagrees "
                                     f"by {(a - b).abs().max().item():.3e}")
            worst = max(worst, (a - b).abs().max().item())
    return worst


def _b3c_library(torch, i, want, eps=1e-5):
    """aten's eval-mode BN backward on B3c's inputs, the one library call
    that computes B3c's function: from a given mean and variance it
    returns dx = g * scale * invstd on every row, dweight = sum(g * xhat)
    and dbias = sum(g), which are B3c's dx, S2 and S1 (the head rows'
    correction stays outside in both). B3a (S2' read from the output) and
    B3b (the mask and dskip) have none. Checked against the plain
    version (dx within 2**-7 relative: three bf16 roundings against one;
    sums within 2e-5 of sum|terms|, since invstd comes from a variance
    made from rsig) and returned as the call to time; the port never
    makes it."""
    scale = i["a32"] / i["rsig"]
    var = i["rsig"].reciprocal().square() - eps
    empty = i["g"].new_empty(0, dtype=torch.float32)

    def call():
        return torch.ops.aten.native_batch_norm_backward(
            i["g"], i["x"], scale, i["mean"], var, empty, empty, False, eps,
            [True, True, True])

    dx, dw, db = call()
    scales = _b3_abs_sums(torch, "none", i)
    ok = bool(((dx.float() - want[0].float()).abs()
               <= 2.0 ** -7 * want[0].float().abs() + 1e-6).all())
    for a, b, sc in zip((db, dw), want[1:], scales):
        ok = ok and bool(((a - b).abs() <= 2e-5 * sc + 1e-6).all())
    if not ok:
        raise AssertionError("native_batch_norm_backward (eval) does not "
                             "compute B3c's function")
    return call


@phase("bn_relu")
def bn_relu_phase(torch):
    from simclr_tpu_torch.ops.kernels import bn_relu as k
    gen = torch.Generator(device="cuda").manual_seed(3)
    err = {m: 0.0 for m in _B3_TENSORS}
    timing, notes = {}, []
    for mode, shape in _B3_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            i = _b3_inputs(torch, gen, shape, dtype)
            got = _b3_call(k, mode, i)
            want = _b3_call(k, mode, i, plain=True)
            n_t = len(got) - 2
            # dx and dskip: the same roundings in the same order -> equal.
            e_t = max((a - b).abs().max().item()
                      for a, b in zip(got[:n_t], want[:n_t]))
            if e_t != 0.0:
                raise AssertionError(f"{mode} {shape} {dtype}: dx/dskip "
                                     f"differ by {e_t}")
            # S1, S2: float32 sums in another order; worst-case bound of
            # either order within 2e-5 of the sum of |terms| (the kernel's
            # longest chain of additions is ~130).
            scales = _b3_abs_sums(torch, mode, i)
            e_s = 0.0
            for a, b, sc in zip(got[n_t:], want[n_t:], scales):
                d = (a - b).abs()
                if not bool((d <= 2e-5 * sc + 1e-6).all()):
                    raise AssertionError(f"{mode} {shape} {dtype}: sums "
                                         f"differ by {d.max().item()}")
                e_s = max(e_s, d.max().item())
            err[mode] = max(err[mode], e_t, e_s)
            ms = median_ms(torch, lambda: _b3_call(k, mode, i))
            plain_ms = median_ms(torch, lambda: _b3_call(k, mode, i, True))
            n_bytes = (_B3_TENSORS[mode] * i["g"].numel()
                       * i["g"].element_size()
                       + (5 if mode != "relu" else 3) * shape[1] * 4)
            bound, by = bound_ms(n_bytes, 8.0 * i["g"].numel(),
                                 PEAK_F32_FLOPS)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            notes.append(f"{mode} {list(shape)} {name}: {ms:.4f} ms "
                         f"(plain {plain_ms:.4f}, bound {bound:.4f} {by}), "
                         f"sum err {e_s:.2e}")
            if dtype == torch.bfloat16 and shape == _B3_TIMED[mode]:
                library_ms = None
                if mode == "none":
                    library_ms = median_ms(torch,
                                           _b3c_library(torch, i, want))
                    notes.append(f"{mode} {list(shape)} {name}: library "
                                 f"(aten eval BN backward) {library_ms:.4f}"
                                 " ms")
                timing[mode] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by=by,
                                    library_ms=library_ms)
            del i, got, want
    for line in notes:
        print(f"  {line}")
    worst = _b3_autograd_check(torch, k, gen)
    # A shape the kernel cannot read raises on the card.
    refused = 0
    for bad in (_b3_inputs(torch, gen, (8, 12, 2, 2), torch.float32),
                _b3_inputs(torch, gen, (8, 16, 2, 2), torch.float16)):
        try:
            k.bwd_relu(bad["g"], bad["out"], bad["a32"])
        except ValueError:
            refused += 1
    if refused != 2:
        raise AssertionError("a shape supports() refuses did not raise")
    for mode in timing:
        timing[mode]["max_abs_err"] = err[mode]
    return {"timing": timing,
            "summary": "dx/dskip equal to the plain versions; S1/S2 within "
                       "2e-5 of sum|terms|; autograd functions within "
                       f"tolerance (worst {worst:.2e}); refused shapes "
                       "raise; " + "; ".join(
                           f"{m} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f})"
                           for m, t in timing.items())}


# B4 comparisons: (N, H, W) at C = 64. The first is layer1 at batch 512
# (2N = 1,024 images); the ragged ones have partial tiles and H != W, W
# below 8, W above 8 and not a multiple of 8, and W above 256 (five
# column tiles, each with its own halo); the last is layer1 of the
# serving phase's eval forward (512 images).
_B4_SHAPES = ((1024, 32, 32), (3, 5, 7), (2, 3, 300), (5, 9, 17),
              (512, 32, 32))
# B5 comparisons: (N, C, K, H, W). The first three are the path's
# stride-1 conv2 of layer2, layer3 and layer4; the ragged one has an odd
# batch, C != K, H != W and a partial last block of tiles; the last three
# are the first three in the serving phase's eval forward (512 images).
_B5_SHAPES = ((1024, 128, 128, 16, 16), (1024, 256, 256, 8, 8),
              (1024, 512, 512, 4, 4), (3, 96, 160, 6, 10),
              (512, 128, 128, 16, 16), (512, 256, 256, 8, 8),
              (512, 512, 512, 4, 4))
# Tolerance of a bf16 output made by one rounding of float32 sums taken in
# another order: one bf16 ulp of the element (2**-7 relative), plus
# 1e-5 of the largest output for elements near 0.
_ULP = 2.0 ** -7


def _within_ulp(torch, got, want, what):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= _ULP * want.abs()
                 + 1e-5 * want.abs().max()).all()):
        raise AssertionError(f"{what}: differs by {err.max().item()}")
    return err.max().item()


def _within_sums(torch, got, want, scale, what):
    """float32 sums in another order: within 2e-5 of the sum of |terms|,
    as the B3 sums."""
    err = (got - want).abs()
    if not bool((err <= 2e-5 * scale + 1e-6).all()):
        raise AssertionError(f"{what}: sums differ by {err.max().item()}")
    return err.max().item()


def _rel_norm(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _conv_inputs(torch, gen, n, c, k, h, w):
    """bf16 x (N, C, H, W) and cotangent g (N, K, H, W) in channels_last,
    and a float32 (K, C, 3, 3) filter at the model's init scale."""
    cl = torch.channels_last
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=cl)
    wt = torch.randn(k, c, 3, 3, device="cuda", generator=gen) \
        * (2.0 / (9 * k)) ** 0.5
    g = torch.randn(n, k, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=cl)
    return x, wt, g


def _conv_bwd_library(torch, g, x, w16, mask):
    """aten's convolution backward (cuDNN) for dx or dW alone."""
    return lambda: torch.ops.aten.convolution_backward(
        g, x, w16, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)


def _enqueue_ms(torch, fn, iters=20):
    """Host ms that one fn() call takes to return, over ``iters`` calls
    from an idle device (their launches enqueued, not finished)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - start) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def _op_device_timing(torch, t, kernel, call):
    """For an operator's wrapper (B4f, B5f, B6f): ``t["ms"]`` becomes the
    device time of its kernel (``kernel``: part of the kernel's name) by
    torch.profiler, as B1's and B2's are; the CUDA-event time around the
    wrapper, which holds the dispatcher's host time where the call is
    host-bound, moves to ``wrapper_ms``, and ``host_ms`` is the host time
    to enqueue one call (taken first: a profiler session just ended may
    still slow the host's launches)."""
    t["wrapper_ms"], t["host_ms"] = t["ms"], _enqueue_ms(torch, call)
    t["ms"] = _kernel_ms(torch, {kernel: call})[kernel]
    return t


def _conv_timing(torch, kernel, plain, library, n_bytes, flops):
    t = dict(ms=median_ms(torch, kernel), plain_ms=median_ms(torch, plain),
             library_ms=median_ms(torch, library))
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    return t


def _autograd_grads(torch, fn, x, w, r):
    """(y, dx, dw) of sum(fn(x, w) * r) by autograd."""
    xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xx, ww)
    (y.float() * r).sum().backward()
    return y.detach(), xx.grad, ww.grad


def _b4(torch, F, k, gen, notes):
    err, timing = {"fwd": 0.0, "wgrad": 0.0}, {}
    for n, h, w in _B4_SHAPES:
        x, wt, g = _conv_inputs(torch, gen, n, 64, 64, h, w)
        where = f"{n}x64x{h}x{w}"
        for what, a, b in (("y", x, wt), ("dx", g, k.rot180_swap(wt))):
            err["fwd"] = max(err["fwd"], _within_ulp(
                torch, k.conv_c64(a, b), k.conv3x3_c64_plain(a, b),
                f"B4f {what} {where}"))
        scale = k.wgrad_c64_plain(x.abs(), g.abs())   # sum of |terms|
        err["wgrad"] = max(err["wgrad"], _within_sums(
            torch, k.wgrad_c64(x, g), k.wgrad_c64_plain(x, g), scale,
            f"B4w {where}"))
        if (n, h, w) != _B4_SHAPES[0]:
            continue
        w16, rot = wt.to(torch.bfloat16), k.rot180_swap(wt)
        px = n * h * w
        io_bytes, flops = 2 * px * 64 * 2, 2.0 * px * 64 * 576
        timing["fwd"] = _conv_timing(
            torch, lambda: k.conv_c64(x, wt),
            lambda: k.conv3x3_c64_plain(x, wt),
            lambda: F.conv2d(x, w16, padding=1), io_bytes + 9 * 64 * 64 * 2,
            flops)
        _op_device_timing(torch, timing["fwd"], "conv64_fwd_kernel",
                          lambda: k.conv_c64(x, wt))
        timing["wgrad"] = _conv_timing(
            torch, lambda: k.wgrad_c64(x, g),
            lambda: k.wgrad_c64_plain(x, g),
            _conv_bwd_library(torch, g, x, w16, [False, True, False]),
            io_bytes + 64 * 576 * 4, flops)
        dx_ms = _kernel_ms(torch, {"conv64_fwd_kernel": lambda: k.conv_c64(
            g, rot)})["conv64_fwd_kernel"]
        dx_lib = median_ms(torch, _conv_bwd_library(
            torch, g, x, w16, [True, False, False]))
        t_fwd, t_wg = timing["fwd"], timing["wgrad"]
        notes.append(
            f"B4 at {where}: fwd {t_fwd['ms']:.4f} ms device (wrapper "
            f"{t_fwd['wrapper_ms']:.4f} by events, {t_fwd['host_ms']:.4f} "
            f"host ms to enqueue a call; plain "
            f"{t_fwd['plain_ms']:.4f}, library {t_fwd['library_ms']:.4f}, "
            f"{t_fwd['ms'] / t_fwd['library_ms']:.2f}x; bound "
            f"{t_fwd['bound_ms']:.4f} {t_fwd['bound_by']}); dx {dx_ms:.4f} "
            f"(library {dx_lib:.4f}, {dx_ms / dx_lib:.2f}x); wgrad "
            f"{t_wg['ms']:.4f} (plain {t_wg['plain_ms']:.4f}, library "
            f"{t_wg['library_ms']:.4f}, "
            f"{t_wg['ms'] / t_wg['library_ms']:.2f}x; bound "
            f"{t_wg['bound_ms']:.4f} {t_wg['bound_by']})")
        del x, g
    # The autograd function against autograd of the plain forward: y, dx
    # within one bf16 ulp; dW within one ulp too (the plain path rounds
    # dW to bf16 at the weight's cast, the kernel path keeps it float32).
    x, wt, g = _conv_inputs(torch, gen, 64, 64, 64, 16, 16)
    got = _autograd_grads(torch, k.conv3x3_c64, x, wt, g.float())
    want = _autograd_grads(torch, k.conv3x3_c64_plain, x, wt, g.float())
    worst = max(_within_ulp(torch, a, b, f"B4 autograd {name}")
                / b.float().abs().max().item()
                for a, b, name in zip(got, want, ("y", "dx", "dw")))
    notes.append(f"B4 autograd function within one bf16 ulp (largest "
                 f"difference {worst:.2e} of the largest entry)")
    return err, timing


def _b5w_abs_sums(torch, k, x, g):
    """Per-element sums of |terms| of dU = V^T dM (bf16 V and dM)."""
    c, kk = x.shape[1], g.shape[1]
    v = k._bf16_rounded(k._input_transform(k._nhwc32(x))).reshape(16, -1, c)
    dm = k._bf16_rounded(k._dm_transform(k._nhwc32(g))).reshape(16, -1, kk)
    return torch.matmul(v.abs().transpose(1, 2), dm.abs())


def _b5(torch, F, k, rot180_swap, gen, notes):
    err, timing = {"fwd": 0.0, "dw": 0.0}, {}
    for n, c, kk, h, w in _B5_SHAPES:
        x, wt, g = _conv_inputs(torch, gen, n, c, kk, h, w)
        w16 = wt.to(torch.bfloat16)
        u = k.transform_filter(w16).to(torch.bfloat16)
        u_rot = k.transform_filter(rot180_swap(w16)).to(torch.bfloat16)
        where = f"{n}x{c}x{h}x{w}->{kk}"
        for what, a, uu in (("y", x, u), ("dx", g, u_rot)):
            err["fwd"] = max(err["fwd"], _within_ulp(
                torch, k.winograd_fwd(a, uu), k.winograd_fwd_plain(a, uu),
                f"B5f {what} {where}"))
        err["dw"] = max(err["dw"], _within_sums(
            torch, k.winograd_dw(x, g), k.winograd_dw_plain(x, g),
            _b5w_abs_sums(torch, k, x, g), f"B5w {where}"))
        if n != 1024:
            continue
        px, tiles = n * h * w, n * h * w // 4
        io_bytes, flops = px * (c + kk) * 2, 2.0 * 16 * c * kk * tiles
        t_fwd = _conv_timing(
            torch, lambda: k.winograd_fwd(x, u),
            lambda: k.winograd_fwd_plain(x, u),
            lambda: F.conv2d(x, w16, padding=1), io_bytes + 16 * c * kk * 2,
            flops)
        _op_device_timing(torch, t_fwd, "winograd_fwd_kernel",
                          lambda: k.winograd_fwd(x, u))
        t_dw = _conv_timing(
            torch, lambda: k.winograd_dw(x, g),
            lambda: k.winograd_dw_plain(x, g),
            _conv_bwd_library(torch, g, x, w16, [False, True, False]),
            io_bytes + 16 * c * kk * 4, flops)
        # B5f as the input gradient (the rotated, swapped filter) beside
        # cuDNN's dx.
        dx_ms = _kernel_ms(torch, {"winograd_fwd_kernel": lambda: (
            k.winograd_fwd(g, u_rot))})["winograd_fwd_kernel"]
        dx_lib = median_ms(torch, _conv_bwd_library(
            torch, g, x, w16, [True, False, False]))
        notes.append(
            f"B5 at {where}: fwd {t_fwd['ms']:.4f} ms device (wrapper "
            f"{t_fwd['wrapper_ms']:.4f} by events, {t_fwd['host_ms']:.4f} "
            f"host ms to enqueue a call; plain "
            f"{t_fwd['plain_ms']:.4f}, library {t_fwd['library_ms']:.4f}, "
            f"{t_fwd['ms'] / t_fwd['library_ms']:.2f}x; bound "
            f"{t_fwd['bound_ms']:.4f} {t_fwd['bound_by']}); dx {dx_ms:.4f} "
            f"(library {dx_lib:.4f}, {dx_ms / dx_lib:.2f}x); dw "
            f"{t_dw['ms']:.4f} (plain {t_dw['plain_ms']:.4f}, library "
            f"{t_dw['library_ms']:.4f}, "
            f"{t_dw['ms'] / t_dw['library_ms']:.2f}x; bound "
            f"{t_dw['bound_ms']:.4f} {t_dw['bound_by']})")
        if not timing:   # the row: layer2, the path's largest tensors
            timing = {"fwd": t_fwd, "dw": t_dw}
        del x, g
    # The autograd function against autograd of the plain forward (which
    # rounds at other points: dM and dV in float32, dU to bf16): within
    # 1e-2 in relative norm.
    x, wt, g = _conv_inputs(torch, gen, 64, 128, 128, 8, 8)
    w16 = wt.to(torch.bfloat16)

    def plain(xx, ww):
        return k.winograd_fwd_plain(
            xx, k.transform_filter(ww).to(torch.bfloat16))

    got = _autograd_grads(torch, k.winograd_conv3x3, x, w16, g.float())
    want = _autograd_grads(torch, plain, x, w16, g.float())
    rel = [_rel_norm(a, b) for a, b in zip(got, want)]
    if not max(rel) < 1e-2:
        raise AssertionError(f"B5 autograd function: relative errors {rel}")
    notes.append(f"B5 autograd function within 1e-2 in norm (y, dx, dw: "
                 + ", ".join(f"{r:.2e}" for r in rel) + ")")
    return err, timing


def _conv_refusals(torch, c64, wino, gen):
    """Operands the kernels cannot take raise on the card; a shape outside
    winograd.supported() takes the direct convolution (no launch)."""
    x32, w32, _ = _conv_inputs(torch, gen, 2, 32, 32, 6, 6)
    x64, w64, _ = _conv_inputs(torch, gen, 2, 64, 64, 6, 6)
    x7, w7, _ = _conv_inputs(torch, gen, 2, 128, 128, 7, 7)
    u = wino.transform_filter(w64).to(torch.bfloat16)
    calls = (lambda: c64.conv_c64(x32, w32),              # C != 64
             lambda: c64.conv_c64(x64.float(), w64),      # float32
             lambda: wino.winograd_fwd(x64.float(), u),   # float32
             lambda: wino.winograd_fwd(
                 x7, wino.transform_filter(w7).to(torch.bfloat16)))  # odd
    refused = 0
    for call in calls:
        try:
            call()
        except ValueError:
            refused += 1
    if refused != len(calls):
        raise AssertionError("an operand the conv kernels refuse did not "
                             "raise")
    before = wino.winograd_fwd.launches
    wino.winograd_conv3x3(x7, w7)
    if wino.winograd_fwd.launches != before:
        raise AssertionError("an unsupported shape reached the kernel")


@phase("conv")
def conv_phase(torch):
    import torch.nn.functional as F
    from simclr_tpu_torch.ops.kernels import conv64, winograd
    gen = torch.Generator(device="cuda").manual_seed(4)
    notes = []
    b4_err, b4 = _b4(torch, F, conv64, gen, notes)
    b5_err, b5 = _b5(torch, F, winograd, conv64.rot180_swap, gen, notes)
    _conv_refusals(torch, conv64, winograd, gen)
    from simclr_tpu_torch.ops.kernels import _build
    log = (_build.library_path().parent / "build.log").read_text()
    for name, frame, usage in _ptxas_usage(log):
        if name.startswith(("conv64", "winograd")):
            notes.append(f"ptxas {name}: {usage}; {frame}")
    for line in notes:
        print(f"  {line}")
    b4["fwd"]["max_abs_err"], b4["wgrad"]["max_abs_err"] = (
        b4_err["fwd"], b4_err["wgrad"])
    b5["fwd"]["max_abs_err"], b5["dw"]["max_abs_err"] = (
        b5_err["fwd"], b5_err["dw"])
    rows = {"conv64_fwd": b4["fwd"], "conv64_wgrad": b4["wgrad"],
            "winograd_fwd": b5["fwd"], "winograd_dw": b5["dw"]}
    times = "; ".join(f"{name} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}"
                      f", library {t['library_ms']:.4f})"
                      for name, t in rows.items())
    return {"timing": rows,
            "summary": "B4f/B5f within one bf16 ulp of the plain versions, "
                       "B4w/B5w sums within 2e-5 of sum|terms|, at the "
                       "training step's, the serving forward's and ragged "
                       "shapes; refused operands raise; "
                       + times}


# B6 comparisons: (N, C, H, W) with x of 4C channels. The first four are
# the identity blocks of layer1-4 at batch 512 (2N = 1,024 images); the
# ragged ones have an odd batch, H = W = 7, and tiles that span images and
# end past the batch; the last four are the first four in the serving
# phase's eval forward (512 images).
_B6_SHAPES = ((1024, 64, 32, 32), (1024, 128, 16, 16), (1024, 256, 8, 8),
              (1024, 512, 4, 4), (5, 128, 7, 7), (3, 512, 7, 7),
              (512, 64, 32, 32), (512, 128, 16, 16), (512, 256, 8, 8),
              (512, 512, 4, 4))
_B6_NAMES = ("dx", "dw1", "dw2", "dw3", "dA1", "dB1", "dA2", "dB2", "dA3",
             "dB3")


def _b6_inputs(torch, gen, n, c, h, w):
    """bf16 x and cotangent (N, 4C, H, W) in channels_last, float32 weights
    at the model's init scale and affines that give unit-scale
    pre-activations (var(y1) = 8, var(y2) = 1, var(y3) = 1/4 at these
    weights), so that about half of each ReLU is open."""
    cl, f = torch.channels_last, 4 * c

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = rnd(n, f, h, w).to(torch.bfloat16).contiguous(memory_format=cl)
    g = rnd(n, f, h, w).to(torch.bfloat16).contiguous(memory_format=cl)
    w1 = rnd(c, f, 1, 1) * (2.0 / c) ** 0.5
    w2 = rnd(c, c, 3, 3) * (2.0 / (9 * c)) ** 0.5
    w3 = rnd(f, c, 1, 1) * (2.0 / f) ** 0.5
    aff = []
    for dim, scale in ((c, 8 ** -0.5), (c, 1.0), (f, 2.0)):
        aff += [(1.0 + 0.1 * rnd(dim)) * scale, 0.2 * rnd(dim)]
    return x, g, (w1, w2, w3), tuple(aff)


def _unfused_block(torch, F, x, ws16, aff):
    """The block as the model's plain-ops branch computes it in bf16:
    cuDNN convolutions with bf16 outputs, the affines and ReLUs as
    PyTorch elementwise passes. The yardstick for B6 (library_ms)."""
    cs = (1, -1, 1, 1)

    def act(y, a, b):
        return torch.relu(y.float() * a.view(cs) + b.view(cs)).to(y.dtype)

    a1 = act(F.conv2d(x, ws16[0]), aff[0], aff[1])
    a2 = act(F.conv2d(a1, ws16[1], padding=1), aff[2], aff[3])
    return torch.relu(F.conv2d(a2, ws16[2]).float() * aff[4].view(cs)
                      + aff[5].view(cs) + x.float()).to(x.dtype)


def _b6_check(torch, got, want, what, fails):
    """Each output against the plain version; a miss is appended to
    ``fails``. The two sum in other orders, so an intermediate (a1, a2,
    dy1-3) rounds apart by one bf16 step here and there, and where a
    pre-activation lies within that error of 0 a ReLU mask flips: the
    element then differs by its whole size, and the backward spreads it
    through 3x3 neighbourhoods in every channel. Measured against a
    float64 evaluation of the same roundings, the plain version's own dx
    is 1.5e-3 (C = 64) to 5.3e-3 (C = 512) off in relative norm, the
    kernel's (longer sequential float32 sums) at most 2.3x that. So out
    must be within one bf16 ulp plus 1e-3 of its largest entry at all but
    1e-3 of its elements and within 2e-3 in relative norm (its masks move
    it continuously); dx within 2e-2 and every float32 sum within 3e-2 in
    relative norm (measured up to 1.24e-2 and 1.43e-2). Returns the
    largest absolute difference."""
    worst = 0.0
    for name, a, b in zip(what, got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        tol = 2e-3 if name.endswith("out") else (
            2e-2 if name.endswith("dx") else 3e-2)
        if name.endswith("out"):
            frac = (err > _ULP * b.abs() + 1e-3 * b.abs().max()).float() \
                .mean().item()
            if not frac <= 1e-3:
                fails.append(f"{name}: {frac:.2e} of the elements beyond "
                             "one ulp")
        rel = _rel_norm(a, b)
        if not rel <= tol:
            fails.append(f"{name}: relative error {rel:.3e} (tolerance "
                         f"{tol})")
        worst = max(worst, err.max().item())
    return worst


def _b6_autograd(torch, k, gen):
    """fused_bottleneck (B6f, B6b) against autograd of the plain forward:
    the same function, rounded at other points (autograd's dy are the
    gradients of the bf16 activations, not bf16(u A)), so within 1e-2 in
    relative norm."""
    x, g, ws, aff = _b6_inputs(torch, gen, 16, 128, 8, 8)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *aff)]
        out = fn(leaves[0], *leaves[1:4], tuple(leaves[4:]))
        (out.float() * g.float()).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    got = grads(k.fused_bottleneck)
    want = grads(k.fused_bottleneck_plain)
    rel = [_rel_norm(a, b) for a, b in zip(got, want)]
    if not max(rel) < 1e-2:
        raise AssertionError(f"B6 autograd function: relative errors {rel}")
    return max(rel)


def _b6_refusals(torch, k, gen):
    """float32 x, C % 16 != 0, and W beyond a tile row raise on the card."""
    x, _, ws, aff = _b6_inputs(torch, gen, 2, 64, 4, 4)
    x40, _, ws40, aff40 = _b6_inputs(torch, gen, 2, 40, 4, 4)
    xw, _, wsw, affw = _b6_inputs(torch, gen, 1, 512, 2, 32)
    calls = (lambda: k.bottleneck_fwd(x.float(), *ws, aff),
             lambda: k.bottleneck_fwd(x40, *ws40, aff40),
             lambda: k.bottleneck_bwd(x40, *ws40, aff40, x40),
             lambda: k.bottleneck_fwd(xw, *wsw, affw))
    refused = 0
    for call in calls:
        try:
            call()
        except ValueError:
            refused += 1
    if refused != len(calls):
        raise AssertionError("an operand the bottleneck kernels refuse did "
                             "not raise")


def _b6_split(torch, k, gen):
    """Where B6's time goes, at the four stage shapes: one bottleneck_fwd
    and one bottleneck_bwd call under torch.profiler, device time by
    kernel name; and each wrapper's median time beside the same wrapper
    with its weight and affine packing done beforehand (``pack_weights``
    and ``pack_affines`` answered from a cache), which is the C entry
    point's time plus the wrapper's checks and allocations: the
    difference is what the packing costs a call. Works on any revision
    of ``ops/kernels/bottleneck.py`` whose wrappers pack through those two
    functions (the mma.sync kernels before the Hopper redesign included:
    ``python3 chip_smoke.py b6_split`` from an archive of such a tree)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for n, c, h, w in _B6_SHAPES[:4]:
        x, g, ws, aff = _b6_inputs(torch, gen, n, c, h, w)
        where = f"{n}x{4 * c}x{h}x{w}"
        calls = {"fwd": lambda: k.bottleneck_fwd(x, *ws, aff),
                 "bwd": lambda: k.bottleneck_bwd(x, *ws, aff, g)}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    key = e.name[:60]
                    by_name[key] = (by_name.get(key, 0.0)
                                    + e.time_range.elapsed_us() / 1e3)
            wrapper = median_ms(torch, call)
            pack, pack_aff = k.pack_weights, k.pack_affines
            cache = {}

            def cached(fn, tag):
                def run(*args, **kwargs):
                    key = (tag, *(a if isinstance(a, (bool, int)) else id(a)
                                  for a in args),
                           *sorted(kwargs.items()))
                    if key not in cache:
                        cache[key] = fn(*args, **kwargs)
                    return cache[key]
                return run
            k.pack_weights = cached(pack, "w")
            k.pack_affines = cached(pack_aff, "a")
            try:
                raw = median_ms(torch, call)
            finally:
                k.pack_weights, k.pack_affines = pack, pack_aff
            split = "; ".join(f"{ms:.4f} {kname}" for kname, ms in sorted(
                by_name.items(), key=lambda kv: -kv[1]))
            print(f"  B6 split {where} {name}: wrapper {wrapper:.4f} ms, "
                  f"packed beforehand {raw:.4f} ms, kernels "
                  f"{sum(by_name.values()):.4f} ms = {split}", flush=True)
            out[(c, name)] = dict(wrapper=wrapper, raw=raw, kernels=by_name)
        del x, g
    return out


# Phase marks of the tile kernel (csrc/bottleneck.cu B6_MARK ids) by mode.
_B6_MARKS = {
    0: "tile start, conv1 done, conv1 epilogue done, conv2 pass done, "
       "conv2 epilogue done, conv3 pass done, conv3 epilogue done",
    1: "as mode 0 (BWD1)",
    2: "tile start, da2 pass done, its epilogue done",
    3: "tile start, dy2 halo in, conv3x3^T pass done, dy1 epilogue done, "
       "dx pass done, dx epilogue done",
}


@phase("b6_trace")
def b6_trace_phase(torch):
    """Where a B6 tile's time goes: a build with -DSIMCLR_B6_TRACE records
    clock64() at the tile kernel's phase boundaries (B6_MARK) for the first
    12 tiles of block 0; for one bottleneck_fwd and one bottleneck_bwd call
    at each stage shape, the mean clocks between consecutive marks (mode,
    from-id -> to-id; the ids are in _B6_MARKS), past the first two
    tiles."""
    from simclr_tpu_torch.ops.kernels import _build
    from simclr_tpu_torch.ops.kernels import bottleneck as k
    lib = _build.load(_build.build(("-DSIMCLR_B6_TRACE",)))
    lib.bottleneck_trace.argtypes = [ctypes.c_void_p]
    lib.bottleneck_trace.restype = ctypes.c_int
    plain_library = _build.library
    _build.library = lambda: lib
    buf = (ctypes.c_longlong * 1024)()
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    try:
        for n, c, h, w in _B6_SHAPES[:4]:
            x, g, ws, aff = _b6_inputs(torch, gen, n, c, h, w)
            for name, call in (("fwd", lambda: k.bottleneck_fwd(x, *ws, aff)),
                               ("bwd", lambda: k.bottleneck_bwd(
                                   x, *ws, aff, g))):
                call()
                lib.bottleneck_trace(buf)
                call()
                marks = list(buf)[:lib.bottleneck_trace(buf)]
                spans = {}
                for a, b in zip(marks, marks[1:]):
                    if (a >> 4) & 15 == (b >> 4) & 15:
                        key = ((b >> 4) & 15, a & 15, b & 15)
                        spans.setdefault(key, []).append((b >> 8) - (a >> 8))
                text = ", ".join(
                    f"m{m} {i}->{j} {statistics.mean(v[2:] or v):.0f}"
                    for (m, i, j), v in sorted(spans.items()))
                print(f"  B6 trace C={c} {name} (clocks): {text}", flush=True)
                out[(c, name)] = spans
            del x, g
    finally:
        _build.library = plain_library
    for mode, marks in _B6_MARKS.items():
        print(f"  B6 trace mode {mode} marks 0..: {marks}")
    return {"summary": f"{len(out)} calls traced"}


@phase("b6_split")
def b6_split_phase(torch):
    from simclr_tpu_torch.ops.kernels import bottleneck as k
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = _b6_split(torch, k, gen)
    return {"split": out, "summary": "; ".join(
        f"C={c} {name} {t['wrapper']:.4f} ms (packed beforehand "
        f"{t['raw']:.4f})" for (c, name), t in out.items())}


def _b6_spills(ptxas):
    """The B6 kernels' ptxas lines (csrc/bottleneck.cu's, and conv64.cu's
    weight-gradient kernel, which computes dw2); raises if one spills."""
    lines = [(n, f, u) for n, f, u in ptxas
             if n.startswith("bottleneck_") or n == "conv64_wgrad_kernel"]
    spills = [(n, f) for n, f, _ in lines
              if re.search(r"[1-9]\d* bytes spill", f)]
    if spills:
        raise AssertionError(f"B6 kernels spill: {spills}")
    return lines


@phase("bottleneck")
def bottleneck_phase(torch, ptxas):
    import torch.nn.functional as F
    from simclr_tpu_torch.ops.kernels import bottleneck as k
    gen = torch.Generator(device="cuda").manual_seed(6)
    err = {"fwd": 0.0, "bwd": 0.0}
    notes, stages, fails = [], {}, []
    for n, c, h, w in _B6_SHAPES:
        x, g, ws, aff = _b6_inputs(torch, gen, n, c, h, w)
        where = f"{n}x{4 * c}x{h}x{w}"
        out = k.bottleneck_fwd(x, *ws, aff)
        plain = k.fused_bottleneck_plain(x, *ws, aff)
        e_f = _b6_check(torch, [out], [plain], [f"B6f {where} out"], fails)
        got = k.bottleneck_bwd(x, *ws, aff, g)
        want = k.fused_bottleneck_bwd_plain(x, *ws, aff, g)
        e_b = _b6_check(torch, got, want,
                        [f"B6b {where} {m}" for m in _B6_NAMES], fails)
        err["fwd"], err["bwd"] = max(err["fwd"], e_f), max(err["bwd"], e_b)
        print(f"  B6 {where}, relative errors: out "
              f"{_rel_norm(out, plain):.2e}; " + ", ".join(
                  f"{m} {_rel_norm(a, b):.2e}" for m, a, b
                  in zip(_B6_NAMES, got, want)), flush=True)
        del got, want
        if fails or n != 1024:
            continue
        px, f = n * h * w, 4 * c
        w_elems = 2 * f * c + 9 * c * c
        flops = 2.0 * px * w_elems
        ws16 = [t.to(torch.bfloat16) for t in ws]

        def unfused_fwd_bwd():
            leaves = [t.detach().requires_grad_() for t in (x, *ws16)]
            _unfused_block(torch, F, leaves[0], leaves[1:], aff).backward(g)

        t = {"fwd": dict(
                ms=median_ms(torch, lambda: k.bottleneck_fwd(x, *ws, aff)),
                plain_ms=median_ms(torch, lambda: k.fused_bottleneck_plain(
                    x, *ws, aff)),
                library_ms=median_ms(torch, lambda: _unfused_block(
                    torch, F, x, ws16, aff))),
             "bwd": dict(
                ms=median_ms(torch, lambda: k.bottleneck_bwd(
                    x, *ws, aff, g)),
                plain_ms=median_ms(
                    torch, lambda: k.fused_bottleneck_bwd_plain(
                        x, *ws, aff, g)),
                library_ms=median_ms(torch, unfused_fwd_bwd))}
        # Bytes: x (and g) read once, out (dx) written once, bf16 weights
        # read, float32 weight gradients and affines written; operations:
        # the three products (B6b: the recomputed forward, dgrad, wgrad).
        t["fwd"]["bound_ms"], t["fwd"]["bound_by"] = bound_ms(
            2 * px * f * 2 + w_elems * 2 + 6 * c * 4 * 2, flops,
            PEAK_BF16_FLOPS)
        t["bwd"]["bound_ms"], t["bwd"]["bound_by"] = bound_ms(
            3 * px * f * 2 + w_elems * (2 + 4) + 12 * c * 4 * 2, 3 * flops,
            PEAK_BF16_FLOPS)
        _op_device_timing(torch, t["fwd"], f"bottleneck_tile_kernel<{c}, 0>",
                          lambda: k.bottleneck_fwd(x, *ws, aff))
        stages[c] = t
        notes.append(
            f"B6 at {where}: fwd {t['fwd']['ms']:.4f} ms device (wrapper "
            f"{t['fwd']['wrapper_ms']:.4f} by events, "
            f"{t['fwd']['host_ms']:.4f} host ms to enqueue a call; plain "
            f"{t['fwd']['plain_ms']:.4f}, unfused "
            f"{t['fwd']['library_ms']:.4f}, bound "
            f"{t['fwd']['bound_ms']:.4f} {t['fwd']['bound_by']}); "
            f"bwd {t['bwd']['ms']:.4f} (plain {t['bwd']['plain_ms']:.4f}, "
            f"unfused fwd+bwd {t['bwd']['library_ms']:.4f}, bound "
            f"{t['bwd']['bound_ms']:.4f} {t['bwd']['bound_by']})")
        del x, g
    if fails:
        raise AssertionError("; ".join(fails))
    worst = _b6_autograd(torch, k, gen)
    _b6_refusals(torch, k, gen)
    for line in notes:
        print(f"  {line}")
    regs = sorted({u for _, _, u in _b6_spills(ptxas)})
    # The row: layer1, the path's largest tensors; every stage in notes.
    rows = {"bottleneck_fwd": dict(stages[64]["fwd"],
                                   max_abs_err=err["fwd"]),
            "bottleneck_bwd": dict(stages[64]["bwd"],
                                   max_abs_err=err["bwd"])}
    return {"timing": rows,
            "summary": "B6f within one bf16 ulp at all but 1e-3 of the "
                       "elements and 2e-3 in relative norm, B6b within 2e-2 "
                       "(dx) and 3e-2 (sums) in relative norm of the plain "
                       "versions at the four "
                       "stage shapes of the training step and of the "
                       "serving forward, and two ragged ones; autograd "
                       "function"
                       f" within 1e-2 ({worst:.2e}); refused operands "
                       f"raise; no B6 kernel spills ({len(regs)} ptxas "
                       "usages); " + "; ".join(
                           f"C={c}: fwd {t['fwd']['ms']:.4f} ms, bwd "
                           f"{t['bwd']['ms']:.4f} ms" for c, t in
                           stages.items())}


def _counters():
    from simclr_tpu_torch.ops.kernels import (
        bn_relu, bottleneck, color, conv64, ntxent, winograd)
    return {"ntxent_fwd": ntxent.ntxent_fwd, "ntxent_bwd": ntxent.ntxent_bwd,
            "color": color.color_distort, "bn_bwd_relu": bn_relu.bwd_relu,
            "bn_bwd_add_relu": bn_relu.bwd_add_relu,
            "bn_bwd_norelu": bn_relu.bwd_norelu,
            "conv64_fwd": conv64.conv_c64, "conv64_wgrad": conv64.wgrad_c64,
            "winograd_fwd": winograd.winograd_fwd,
            "winograd_dw": winograd.winograd_dw,
            "bottleneck_fwd": bottleneck.bottleneck_fwd,
            "bottleneck_bwd": bottleneck.bottleneck_bwd}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


# Each kernel wrapper's launches a step on every path, and on the paths
# that run them (the slice phases add theirs).
_PER_STEP = {"ntxent_fwd": 1, "ntxent_bwd": 1, "color": 2}
# A device kernel that each wrapper launches exactly once a call, by its
# name in the profiler (B3's MODE is 0 relu, 1 add_relu, 2 no ReLU; B6's
# tile kernel MODE 0 is B6f and 1 B6b's first pass; B4w's own reduce,
# since B6b runs B4w's partial kernel for its dw2).
_KERNEL_NAME = {
    "ntxent_fwd": r"ntxent_fwd_kernel", "ntxent_bwd": r"ntxent_bwd_kernel",
    "color": r"color_kernel",
    "bn_bwd_relu": r"bn_bwd_kernel<[^<>]*, 0>",
    "bn_bwd_add_relu": r"bn_bwd_kernel<[^<>]*, 1>",
    "bn_bwd_norelu": r"bn_bwd_kernel<[^<>]*, 2>",
    "conv64_fwd": r"conv64_fwd_kernel", "conv64_wgrad": r"conv64_wgrad_reduce",
    "winograd_fwd": r"winograd_fwd_kernel",
    "winograd_dw": r"winograd_dw_kernel",
    "bottleneck_fwd": r"bottleneck_tile_kernel<\d+, 0>",
    "bottleneck_bwd": r"bottleneck_tile_kernel<\d+, 1>",
}


def _run_slice(torch, smi, cfg, expected):
    """Full-width ResNet-50 steps at batch 512 through the graphed
    ``train_epoch``: its first call runs WARMUP_STEPS eager steps, captures
    the step and replays it once; the timed call replays it. ``expected``
    maps a counter to the launches it must show a step besides
    ``_PER_STEP``. The wrappers count only where they launch: in the eager
    steps and once in each capture (two with gradient accumulation, one
    that accumulates and one that also steps Adam), never in a replay."""
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import (
        DeviceDataset, epoch_permutation)
    from simclr_tpu_torch.ops.augment import augment_train_apply
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.pretrain import (
        _forward_pair, build_engine, init_simclr)

    steps, batch, warm = 8, cfg.train.batch_size, WARMUP_STEPS
    expected = {**_PER_STEP, **expected}
    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    ds = DeviceDataset.from_numpy(images, labels, "cuda")
    model, state, opt = init_simclr(cfg, seed=0, device="cuda")
    engine = build_engine(cfg, model, opt)
    captures = len(getattr(opt, "kinds", (None,)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx_mat = torch.cat([epoch_permutation(gen, ds.n, batch)
                         for _ in range(2)])
    n_params = sum(p.numel() for p in model.f.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    state, _ = engine.train_epoch(state, ds.images, idx_mat[:warm + 1], gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    at_capture = read_counts()
    start = time.perf_counter()
    state, (losses, accs) = engine.train_epoch(
        state, ds.images, idx_mat[warm + 1:warm + 1 + steps], gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counts()
    losses, accs = losses.tolist(), accs.tolist()
    if not all(math.isfinite(v) for v in losses + accs):
        raise AssertionError(f"non-finite loss or accuracy: {losses}")
    if launches != at_capture or len(engine.graphs) != captures:
        raise AssertionError(f"a replay counted launches or captured again:"
                             f" {at_capture} then {launches}")
    if not all(launches[n] for n in expected):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    # WARMUP_STEPS eager steps and the captures, one step's launches each.
    for name, count in launches.items():
        if count != expected.get(name, 0) * (warm + captures):
            raise AssertionError(f"{name}: {count} launches in {warm} eager "
                                 f"steps and {captures} capture(s), "
                                 f"expected {expected.get(name, 0)} a step")
    if state.step != warm + 1 + steps or n_params != 23_500_352:
        raise AssertionError(f"step {state.step}, trunk params {n_params}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.max_memory_reserved() / 2 ** 30
    # What one more forward leaves allocated for the backward (the tensors
    # autograd saved, and the two views), on an unused row of indices.
    row = warm + 1 + steps
    base = torch.cuda.memory_allocated()
    pair = tuple(augment_train_apply(ds.images.index_select(
        0, idx_mat[row]), p, cfg.dataset)
        for p in engine.sample_pair_params(gen, batch,
                                           *ds.images.shape[1:3]))
    z = _forward_pair(model, *pair)
    torch.cuda.synchronize()
    kept_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    del pair, z
    return {"launches": launches, "engine": engine, "state": state,
            "images": ds.images, "idx": idx_mat[row + 1:row + 3], "gen": gen,
            "expected": expected, "ds": ds, "kept_gib": kept_gib,
            "steps_per_s": steps / seconds,
            "summary": f"ResNet-50 ({n_params} trunk params), batch {batch},"
                       f" {warm} eager steps, {captures} capture(s) and 1 "
                       f"replay in "
                       f"{first_s:.2f} s, then {steps} replayed steps: "
                       f"losses {[round(v, 4) for v in losses]}, acc "
                       f"{[round(v, 2) for v in accs]}; "
                       f"{steps / seconds:.3f} steps/s, peak "
                       f"{peak_gib:.2f} GiB allocated, {reserved_gib:.2f} GiB "
                       f"reserved ({kept_gib:.2f} GiB kept by an "
                       f"eager forward for the backward) on {smi}; launches"
                       f" (eager steps + capture) {launches}"}


@phase("slice")
def slice_phase(torch, smi):
    from simclr_tpu_torch.config import Config
    return _run_slice(torch, smi, Config(), {})


@phase("bnrelu_slice")
def bnrelu_slice_phase(torch, smi):
    from simclr_tpu_torch.config import Config, ModelConfig
    cfg = Config(model=ModelConfig(bn_relu_fused=True, bn_relu_impl="pallas"))
    # bn1 and bn2 of 16 blocks, bn3 of 16, the 4 downsample BNs.
    return _run_slice(torch, smi, cfg, {"bn_bwd_relu": 32,
                                        "bn_bwd_add_relu": 16,
                                        "bn_bwd_norelu": 4})


@phase("conv_slice")
def conv_slice_phase(torch, smi):
    from simclr_tpu_torch.config import Config, ModelConfig
    cfg = Config(model=ModelConfig(conv64_pallas=True, winograd_conv2=True))
    # layer1_0-2 conv2 through B4: forward and dx on B4f, dW on B4w;
    # layer2_1-3, layer3_1-5 and layer4_1-2 conv2 through B5.
    return _run_slice(torch, smi, cfg, {"conv64_fwd": 6, "conv64_wgrad": 3,
                                        "winograd_fwd": 20,
                                        "winograd_dw": 10})


@phase("fused_slice")
def fused_slice_phase(torch, smi):
    from simclr_tpu_torch.config import Config, ModelConfig
    cfg = Config(model=ModelConfig(fuse_identity_blocks=True))
    # The 12 identity blocks (layer1_1-2, layer2_1-3, layer3_1-5,
    # layer4_1-2): every one passes bottleneck.supports at batch 512.
    return _run_slice(torch, smi, cfg, {"bottleneck_fwd": 12,
                                        "bottleneck_bwd": 12})


def _profiled(torch, fn):
    """fn() under torch.profiler: (profile, wall ms, device ms by kernel
    name). Fails where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not sum(by_name.values()):
        raise AssertionError("the profiler saw no device time")
    return prof, wall_ms, by_name


def _named_launches(prof):
    """Each wrapper's kernel (``_KERNEL_NAME``) counted by name in a
    profile."""
    from torch.autograd import DeviceType
    return {c: sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and re.search(pattern, e.name))
            for c, pattern in _KERNEL_NAME.items()}


def _profile(torch, run):
    """Two more slice steps, replays of the captured step, under
    torch.profiler: device busy share of the wall time (the profiler's own
    overhead included) and device time by kernel category and by kernel
    (a replay has no PyTorch op to charge it to). Each
    wrapper's kernel (``_KERNEL_NAME``) must show the path's launches a
    step by name, 0 where the path does not run it."""
    idx = run["idx"]
    prof, wall_ms, by_name = _profiled(
        torch, lambda: run["engine"].train_epoch(run["state"], run["images"],
                                                 idx, run["gen"]))
    busy = sum(by_name.values())
    steps = len(idx)
    named = _named_launches(prof)
    for c, count in named.items():
        if count != run["expected"].get(c, 0) * steps:
            raise AssertionError(f"{c}: {count} kernels named "
                                 f"{_KERNEL_NAME[c]} in {steps} replayed "
                                 f"steps; launches by name {named}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  kernel {ms / steps:8.3f} ms/step  {name[:100]}")
    cat_text = ", ".join(f"{c} {ms / steps:.2f}" for c, ms in
                         _by_category(by_name))
    return {"busy_ms": busy / steps,
            "summary": f"{steps} replayed steps, kernels by name a step "
                       f"{ {c: n // steps for c, n in named.items() if n} }, "
                       f"wall {wall_ms / steps:.2f} ms/step,"
                       f" device busy {busy / steps:.2f} ms/step "
                       f"({100 * busy / wall_ms:.1f}%); ms/step by "
                       f"category: {cat_text}"}


@phase("profile")
def profile_phase(torch, run):
    return _profile(torch, run)


@phase("bnrelu_profile")
def bnrelu_profile_phase(torch, run):
    return _profile(torch, run)


@phase("conv_profile")
def conv_profile_phase(torch, run):
    return _profile(torch, run)


@phase("fused_profile")
def fused_profile_phase(torch, run):
    return _profile(torch, run)


def _release(torch, run):
    """Drop a slice's model, optimizer and data before the next one, so
    that its peak memory is its own."""
    run.clear()
    gc.collect()
    torch.cuda.empty_cache()


# The opt-in configurations of the pretrain step at full width (the optin
# phases): (name, ModelConfig overrides, TrainConfig overrides).
_OPTIN = (
    ("fold", dict(fold_bn_scales=True), {}),
    ("wgrad_remat_accum", dict(conv_wgrad_fraction=0.25,
                               bn12_shadow_stages=(0,),
                               relu_from_output=True, relu_barrier=True,
                               remat_stages=(0,)), dict(accum_steps=2)),
)
# Fold against the unfolded exact path on the card, one step of NT-Xent at
# full width from the same weights and views, in float32 and in bf16
# compute. In float32 the two are one function computed two ways:
# per-leaf gradient cosine at least 0.999, as the JAX package checks its
# folded path (foldconv.py:150-155). In bf16 no two roundings of this
# network agree leaf by leaf at init: on an H100 this phase found the
# unfolded bf16 gradient's cosine to its own float32 twin at 0.15 over
# the whole gradient, the folded one's at 0.03, and fold against
# unfolded in bf16 at 0.025 for one leaf (all printed below). So bf16 is
# held to its loss and to the stem's gradient norm
# (within 10% of the unfolded one's: the JAX package's open TPU fault was
# a stem gradient of 1e-19 against 2.3, foldconv.py:150-163), and its
# cosines are printed. The head's first bias is left out: a BN follows
# it, so its gradient is zero in exact arithmetic and only noise. The
# losses: float32 sums in another order; in bf16 the unfolded BN applies
# in bf16 and the folded one in float32 before one cast, which moves an
# activation by a bf16 step here and there, and the loss averages 1,024
# rows.
_FOLD_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
_FOLD_COS, _FOLD_STEM = 0.999, 0.1
# Remat against no remat on the card with cuDNN deterministic: the
# recompute runs the same kernels on the same inputs, so the two agree
# bit for bit (printed); held to float32 noise all the same.
_REMAT_LOSS_RTOL, _REMAT_GRAD_REL, _REMAT_STATS_ATOL = 1e-6, 1e-5, 1e-6


def _optin_config(name):
    from simclr_tpu_torch.config import Config, ModelConfig
    _, model_over, train_over = next(o for o in _OPTIN if o[0] == name)
    cfg = Config(model=ModelConfig(**model_over))
    return cfg.replace(train=dataclasses.replace(cfg.train, **train_over))


@phase("optin_fold")
def optin_fold_phase(torch, smi):
    # The 12 identity blocks fold (no kernel of theirs); B1 and B2 as on
    # every path.
    return _run_slice(torch, smi, _optin_config("fold"), {})


@phase("optin_fold_profile")
def optin_fold_profile_phase(torch, run):
    """Two profiled replays, then 2 replays against eager steps."""
    result = _profile(torch, run)
    note = _optin_replays(torch, "fold", run, 2)
    return {"summary": f"{result['summary']}; {note}"}


@phase("optin_wgrad_remat_accum")
def optin_accum_phase(torch, smi):
    return _run_slice(torch, smi, _optin_config("wgrad_remat_accum"), {})


@phase("optin_wgrad_remat_accum_profile")
def optin_accum_profile_phase(torch, run):
    """Two profiled replays, then 4 replays (two accumulation cycles)
    against eager micro-steps."""
    result = _profile(torch, run)
    note = _optin_replays(torch, "wgrad_remat_accum", run, 4)
    return {"summary": f"{result['summary']}; {note}"}


def _optin_replays(torch, name, run, n_steps):
    """The slice's captured step(s), replayed once a row for ``n_steps``
    rows (each its own one-row epoch, under ``set_sync_debug_mode
    ("error")``), against eager steps of a twin loaded with the model's
    weights, optimizer state (with accumulation, the accumulator and its
    count) and generator state, on the same rows: the draws bit for bit,
    the losses within the graph phase's tolerance; with accumulation the
    parameters after an accumulating replay bit for bit those before it,
    and after each optimizer step within ``_GRAPH_PARAM_REL`` of the
    twin's change."""
    import copy
    from simclr_tpu_torch.data.pipeline import epoch_permutation
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    engine, state, gen = run["engine"], run["state"], run["gen"]
    images, cfg = run["images"], engine.cfg
    batch = cfg.train.batch_size
    model, opt = engine.model, engine.optimizer
    idx = epoch_permutation(gen, images.shape[0], batch)[:n_steps]
    twin, twin_state, twin_opt = init_simclr(cfg, seed=0, device="cuda")
    twin.load_state_dict(model.state_dict())
    twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    twin_gen = torch.Generator(device="cuda")
    twin_gen.set_state(gen.get_state())
    twin_engine = build_engine(cfg, twin, twin_opt)
    accum = getattr(opt, "k", 1)
    kinds, frozen, rels, losses = [], 0, [], []
    start = [p.detach().clone() for p in model.parameters()]
    for i in range(n_steps):
        draws = twin_engine.sample_pair_params(twin_gen, batch, 32, 32)
        p0 = [p.detach().clone() for p in model.parameters()]
        kinds.append(getattr(opt, "next_kind", lambda: "step")())
        twin_state, (le, _) = twin_engine.train_step_on_params(
            twin_state, images.index_select(0, idx[i]), draws)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, (lr_, _) = engine.train_epoch(state, images,
                                                 idx[i:i + 1], gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rec = engine.graphs[next(k for k in engine.graphs
                                 if k[1] in (kinds[-1], None))]
        if not all(_draws_equal(torch, a, b)
                   for a, b in zip(draws, rec.draws)):
            raise AssertionError(f"{name}: replay {i} drew other view "
                                 "parameters than the eager step")
        losses.append((lr_.item(), le.item()))
        if kinds[-1] == "accumulate":
            if not all(torch.equal(p, q) for p, q in
                       zip(model.parameters(), p0)):
                raise AssertionError(f"{name}: an accumulating replay "
                                     "moved the parameters")
            frozen += 1
        else:
            rels.append(_rel_change(torch, model, twin, start))
    loss_diff = max(abs(a - b) / abs(b) for a, b in losses)
    rtol = _GRAPH_LOSS_RTOL[cfg.model.compute_dtype]
    if not (loss_diff <= rtol and rels and max(rels) <= _GRAPH_PARAM_REL):
        raise AssertionError(f"{name}: replayed/eager losses {losses}, "
                             f"parameters {rels} of the change")
    return (f"{name}: {n_steps} replays ({kinds}) against eager steps: "
            f"draws identical, losses max rel {loss_diff:.1e} (tol {rtol})"
            f", parameters unchanged bit for bit after {frozen} "
            f"accumulating replays, {[f'{r:.1e}' for r in rels]} of the "
            f"change after the optimizer steps (tol {_GRAPH_PARAM_REL}; "
            f"accum_steps {accum})")


def _cosine(torch, a, b):
    return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                 dim=0).item()


def _fold_check(torch, cfg, views):
    """``cfg``'s model with and without ``fold_bn_scales``, both with the
    exact BN gradient, one step from the same weights and views in float32
    and in bf16 compute (the tolerances' note above)."""
    grads, losses, weights = {}, {}, None
    dts = ("float32", "bfloat16")
    for dt in dts:
        for fold in (False, True):
            c = cfg.replace(model=dataclasses.replace(
                cfg.model, fold_bn_scales=fold, bn_grad_mode="exact",
                compute_dtype=dt, bn_dtype=dt))
            loss, g, _, _, w = _one_step_grads(torch, c, views, weights)
            weights = weights or w
            grads[dt, fold], losses[dt, fold] = g, loss
    names = [n for n in grads["float32", False] if n != "g.linear0.bias"]
    leaf = {dt: {n: _cosine(torch, grads[dt, True][n], grads[dt, False][n])
                 for n in names} for dt in dts}
    worst = {dt: sorted(v, key=v.get)[:3] for dt, v in leaf.items()}
    loss_rel = {dt: abs(losses[dt, True] - losses[dt, False])
                / abs(losses[dt, False]) for dt in dts}
    stem = {k: g["f.stem_conv.weight"].norm().item()
            for k, g in grads.items()}
    stem_rel = {dt: abs(stem[dt, True] / stem[dt, False] - 1) for dt in dts}
    ref = torch.cat([grads["float32", False][n].flatten() for n in names])
    to_f32 = {fold: _cosine(torch, torch.cat(
        [grads["bfloat16", fold][n].flatten() for n in names]), ref)
        for fold in (False, True)}
    text = "fold vs unfolded exact (same weights and views): " + "; ".join(
        f"{dt}: loss {losses[dt, True]:.6f} vs {losses[dt, False]:.6f} "
        f"(rel {loss_rel[dt]:.1e}, tol {_FOLD_LOSS_RTOL[dt]}), per-leaf "
        f"gradient cosine min "
        f"{[(n, round(leaf[dt][n], 6)) for n in worst[dt]]}"
        f"{f' (tol {_FOLD_COS})' if dt == 'float32' else ''}, median "
        f"{statistics.median(leaf[dt].values()):.6f}, stem gradient norm "
        f"{stem[dt, True]:.4f} vs {stem[dt, False]:.4f} (rel "
        f"{stem_rel[dt]:.1e}, tol {_FOLD_STEM})" for dt in dts) + (
        f"; the bf16 gradient's cosine to the float32 exact one "
        f"{to_f32[False]:.4f} unfolded, {to_f32[True]:.4f} folded")
    if not (all(loss_rel[dt] <= _FOLD_LOSS_RTOL[dt]
                and stem_rel[dt] <= _FOLD_STEM for dt in dts)
            and leaf["float32"][worst["float32"][0]] >= _FOLD_COS):
        raise AssertionError(text)
    return text


def _one_step_grads(torch, cfg, views, state_dict=None):
    """One eager forward and backward of ``cfg``'s model (seed 0, or
    ``state_dict``) on the NHWC views at full width, no optimizer step:
    (loss, {name: gradient}, {name: buffer after}, GiB the forward kept
    for the backward, the state_dict before)."""
    from simclr_tpu_torch.train.pretrain import (
        _forward_pair, build_engine, init_simclr)
    model, _, opt = init_simclr(cfg, seed=0, device="cuda")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    engine = build_engine(cfg, model, opt)
    model.train()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    z1, z2 = _forward_pair(model, *views)
    torch.cuda.synchronize()
    kept = (torch.cuda.memory_allocated() - base) / 2 ** 30
    loss, _ = engine.loss_fn(z1, z2)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    bufs = {n: b.detach().clone() for n, b in model.named_buffers()}
    return loss.item(), grads, bufs, kept, before


@phase("optin")
def optin_phase(torch):
    """The optin configurations' gradient checks at full width (ResNet-50,
    batch 512 = 1,024 images, one eager step from the same weights and
    views, cuDNN deterministic): the folded path against the unfolded
    exact path in float32 and in bf16 (``_fold_check``), and remat
    against no remat in bf16."""
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.ops.augment import (
        augment_train_apply, sample_view_params)
    notes = []
    cfg = _optin_config("fold")
    batch = cfg.train.batch_size
    images = torch.from_numpy(synthetic_dataset(batch, 32, seed=5)[0]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.no_grad():
        views = tuple(
            augment_train_apply(images, sample_view_params(
                gen, batch, 32, 32, cfg.augment), cfg.dataset)
            for _ in range(2))
    torch.backends.cudnn.deterministic = True
    try:
        notes.append(_fold_check(torch, cfg, views))
        gc.collect()
        acfg = _optin_config("wgrad_remat_accum")
        plain = acfg.replace(model=dataclasses.replace(acfg.model,
                                                       remat_stages=()))
        lp, gp, bp, kept_plain, weights = _one_step_grads(torch, plain,
                                                          views)
        lr_, gr, br, kept_remat, _ = _one_step_grads(torch, acfg, views,
                                                     weights)
        bits = (lr_ == lp and all(torch.equal(gr[n], gp[n]) for n in gp)
                and all(torch.equal(br[n], bp[n]) for n in bp))
        moved = all(not torch.equal(br[n], weights[n]) for n in br
                    if n.endswith("running_mean"))
        grad_rel = max(((gr[n] - gp[n]).norm() / gp[n].norm().clamp_min(
            1e-30)).item() for n in gp)
        stats_err = max((br[n].float() - bp[n].float()).abs().max().item()
                        for n in bp)
        if not (abs(lr_ - lp) <= _REMAT_LOSS_RTOL * abs(lp)
                and grad_rel <= _REMAT_GRAD_REL
                and stats_err <= _REMAT_STATS_ATOL and moved):
            raise AssertionError(f"remat vs none: loss {lr_} vs {lp}, "
                                 f"gradients {grad_rel:.2e}, running "
                                 f"statistics {stats_err:.2e}, every "
                                 f"running mean moved: {moved}")
        del weights
        notes.append(f"remat_stages=(0,) vs none (wgrad_remat_accum's "
                     f"model, same weights and views): bit-identical "
                     f"{bits}; loss {lr_:.6f} vs {lp:.6f}, gradients "
                     f"{grad_rel:.1e} in relative norm at worst, running "
                     f"statistics {stats_err:.1e} (updated once: equal to "
                     f"the no-remat step's); kept by the forward "
                     f"{kept_remat:.2f} GiB with remat vs {kept_plain:.2f} "
                     f"GiB without")
    finally:
        torch.backends.cudnn.deterministic = False
    return {"summary": "; ".join(notes)}



# Parity configurations: (name, ModelConfig overrides, tolerance on the
# losses' relative difference, kernels that must have run on the card).
_PARITY = (
    # float32 both sides (TF32 off); cuDNN and the CPU sum convolutions in
    # another order, and the second step follows an Adam update.
    ("default", dict(compute_dtype="float32", bn_dtype="float32"), 1e-3,
     ()),
    ("bn_relu_fused", dict(compute_dtype="float32", bn_dtype="float32",
                           bn_relu_fused=True), 1e-3,
     ("bn_bwd_relu", "bn_bwd_add_relu", "bn_bwd_norelu")),
    # bf16, which both conv gates need: layer3_1 (64 features) takes B4,
    # layer4_1 (128) takes B5. The other convolutions and the BN passes
    # round to bf16 in cuDNN's and the CPU's own orders: an output moves by
    # a bf16 step (0.4%) here and there, and the loss by far less.
    ("conv64+winograd", dict(stage_sizes=(1, 1, 2, 2), conv64_pallas=True,
                             winograd_conv2=True), 1e-2,
     ("conv64_fwd", "conv64_wgrad", "winograd_fwd", "winograd_dw")),
    # bf16, which the B6 gate needs; stage_sizes give identity blocks
    # layer1_1 (16 features: the plain-ops branch), layer3_1 (64) and
    # layer4_1 (128), which take B6. Rounding as for conv64+winograd.
    ("fuse_identity_blocks", dict(stage_sizes=(2, 1, 2, 2),
                                  fuse_identity_blocks=True), 1e-2,
     ("bottleneck_fwd", "bottleneck_bwd")),
)


# The optin configurations at width 16 in float32 (stage_sizes (2,1,1,1):
# layer1_1 is an identity block, so it folds), with their TrainConfig
# overrides; three steps, so that with accumulation over two the third
# follows an Adam step. The tolerance as for "default".
_OPTIN_PARITY = (
    ("fold", dict(compute_dtype="float32", bn_dtype="float32",
                  stage_sizes=(2, 1, 1, 1), fold_bn_scales=True), 1e-3, (),
     {}),
    ("wgrad_remat_accum", dict(compute_dtype="float32", bn_dtype="float32",
                               stage_sizes=(2, 1, 1, 1), **_OPTIN[1][1]),
     1e-3, (), _OPTIN[1][2]),
)


@phase("parity")
def parity_phase(torch):
    from simclr_tpu_torch.config import Config, ModelConfig
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.ops.augment import sample_view_params
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    images, _ = synthetic_dataset(40, img_size=32, seed=1)
    notes = []
    for name, over, tol, kernels, *train in _PARITY + _OPTIN_PARITY:
        small = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16)
        cfg = Config(model=ModelConfig(**{**small, **over}))
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=40, **(train[0] if train else {})))
        gen = torch.Generator().manual_seed(2)
        draws = [tuple(sample_view_params(gen, 40, 32, 32, cfg.augment)
                       for _ in range(2)) for _ in range(3 if train else 2)]
        result = {}
        for dev in ("cuda", "cpu"):
            model, state, opt = init_simclr(cfg, seed=0, device=dev)
            engine = build_engine(cfg, model, opt)
            batch = torch.from_numpy(images).to(dev)
            losses = []
            reset_counts()
            for params in draws:
                pair = tuple(p.to(dev) for p in params)
                state, (loss, _) = engine.train_step_on_params(state, batch,
                                                               pair)
                losses.append(loss.item())
            result[dev] = losses
            counts = read_counts()
            if dev == "cuda" and not all(counts[k] for k in kernels):
                raise AssertionError(f"{name}: a kernel did not run on the "
                                     f"card: {counts}")
        diff = max(abs(a - b) / abs(b) for a, b in zip(result["cuda"],
                                                       result["cpu"]))
        if not diff < tol:
            raise AssertionError(f"{name}: card {result['cuda']} vs cpu "
                                 f"{result['cpu']}")
        notes.append(f"{name}: losses card {result['cuda']} cpu "
                     f"{result['cpu']}, max rel diff {diff:.2e} (tol {tol})")
    return {"summary": "; ".join(notes)}


# Tolerances of the graph phase (replayed steps against eager ones on the
# card, the same kernels and the same draws): the losses' relative
# difference, and the parameters' change over the compared steps, as the
# norm of (replayed - eager) over the norm of the eager change. cuDNN may
# pick backward algorithms that sum with atomics, so two runs of one step
# can differ in the last bits; Adam's first steps move an entry by about
# lr * sign(gradient), so a gradient entry within that noise can move the
# other way (as tests/test_torch_pretrain.py measures against JAX on the
# CPU, 17% at worst there).
_GRAPH_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
_GRAPH_PARAM_REL = 0.25
# Capturable Adam against the default one, eagerly, three steps on the
# same gradients at lr 1e-3. The capturable one computes 1 - beta2 ** t in
# float32 on the device, where beta2 = 0.999 is 0.99900001: at t = 1 that
# is 1.3e-5 off the host's double value, which moves an update by half as
# much, 6.4e-9 at lr 1e-3, so three steps may move a parameter by about
# 2e-8 (1.9e-8 seen on the card near 0, where 1e-8 failed). atol 1e-7
# leaves a factor 5; rtol 1e-6 covers the float32 rounding of the larger
# parameters.
_ADAM_RTOL, _ADAM_ATOL = 1e-6, 1e-7
# The MINE step's loss and EMA, replayed against eager: the frozen bf16
# model's features are those of the same kernels on the same views and
# masks, and MineNet runs in float32 (TF32 off); its loss is a difference
# of two terms of order 1 that can nearly cancel, so it is held relative
# to max(|loss|, 1e-3).
_MINE_LOSS_RTOL = 1e-3


def _adam_check(torch):
    from simclr_tpu_torch.train.common import adam_torch
    gen = torch.Generator().manual_seed(5)
    shapes = ((64, 3, 3, 3), (512,), (128, 256))
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 10.0 ** -k for s in shapes]
             for k in range(3)]
    runs = []
    for capturable in (True, False):
        ps = [torch.nn.Parameter(p.cuda()) for p in p0]
        opt = adam_torch(ps, 1e-3, 1e-6, capturable=capturable)
        for g in grads:
            for p, gi in zip(ps, g):
                p.grad = gi.cuda()
            opt.step()
        runs.append([p.detach().cpu() for p in ps])
    worst = 0.0
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=_ADAM_RTOL, atol=_ADAM_ATOL)
        bound = _ADAM_ATOL + _ADAM_RTOL * b.abs()
        worst = max(worst, ((a - b).abs() / bound).max().item())
    return worst


def _draw_tensors(d):
    """A view's draws (``ViewParams``, ``CropParams``, ``SupervisedParams``)
    as a flat list of tensors, boxes unpacked."""
    out = []
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        out.extend(v if isinstance(v, tuple) else [v])
    return out


def _draws_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(_draw_tensors(a),
                                                 _draw_tensors(b)))


def _clone_draws(torch, d):
    return dataclasses.replace(d, **{
        f.name: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                 else v.clone())
        for f in dataclasses.fields(d) for v in [getattr(d, f.name)]})


def _rel_change(torch, model, twin, p0):
    """The distance between two models' parameters over the twin's change
    from ``p0``, in norm."""
    change = torch.cat([(p - q).flatten() for p, q in
                        zip(twin.parameters(), p0)]).norm()
    diff = torch.cat([(p - q).flatten() for p, q in
                      zip(model.parameters(), twin.parameters())]).norm()
    return (diff / change).item()


def _classifier_graph_check(torch, name, over, kernels, init=None,
                            augment="fine_tune"):
    """A ``train/ssl.py:SupervisedEngine`` step of a width-16 classifier
    at batch 64: the fine-tune step (``init_finetune``, SGD) on one parity
    configuration, or the supervised baseline's half-step
    (``train/supervised.py:init_supervised``, capturable Adam,
    ``augment='supervised'``). WARMUP_STEPS eager steps and the capture,
    then N replays (each its own one-row epoch, under
    ``set_sync_debug_mode("error")``) against N eager steps of a twin
    loaded with the first's weights, optimizer state and generator state
    after the capture, on the same rows: the view draws bit for bit and
    different from one replay to the next; then one more replay under the
    profiler, where each wrapper's kernel must show its launches a step
    by name."""
    import copy
    from simclr_tpu_torch.config import Config, ModelConfig
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import epoch_permutation
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.ssl import SupervisedEngine, init_finetune

    init = init or init_finetune
    n_steps, batch, warm = 3, 64, WARMUP_STEPS
    images, labels = synthetic_dataset(batch * (warm + n_steps + 1), 32,
                                       seed=6)
    images = torch.from_numpy(images).cuda()
    labels = torch.from_numpy(labels.astype("int32")).cuda()
    small = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16)
    cfg = Config(model=ModelConfig(**{**small, **over}))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                micro_batch_size=batch))
    gen = torch.Generator(device="cuda").manual_seed(7)
    idx = epoch_permutation(gen, images.shape[0], batch)
    model, state, opt = init(cfg, seed=0, device="cuda")
    engine = SupervisedEngine(model, opt, cfg, augment)
    reset_counts()
    state, _ = engine.train_epoch(state, images, labels, idx[:warm], gen)
    counts = read_counts()
    if not all(counts[k] for k in kernels) or any(
            counts[k] for k in counts if k not in kernels):
        raise AssertionError(f"{name}: launches {counts}")
    (rec,) = engine.graphs.values()
    twin, twin_state, twin_opt = init(cfg, seed=0, device="cuda")
    twin.load_state_dict(model.state_dict())
    twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    twin_gen = torch.Generator(device="cuda")
    twin_gen.set_state(gen.get_state())
    twin_engine = SupervisedEngine(twin, twin_opt, cfg, augment)
    p0 = [p.detach().clone() for p in model.parameters()]
    eager, replayed = [], []
    for i in range(n_steps):
        rows = idx[warm + i]
        draws = twin_engine.sample_params(twin_gen, batch, 32, 32)
        twin_state, (loss, _) = twin_engine.train_step_on_params(
            twin_state, images.index_select(0, rows),
            labels.index_select(0, rows), draws, twin_gen)
        eager.append((draws, loss))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(n_steps):
            state, (loss, _) = engine.train_epoch(
                state, images, labels, idx[warm + i:warm + i + 1], gen)
            replayed.append((_clone_draws(torch, rec.draws), loss))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if len(engine.graphs) != 1 or state.step != warm + n_steps:
        raise AssertionError(f"{name}: captured "
                             f"{len(engine.graphs)} times, step {state.step}")
    for i, ((de, _), (dr, _)) in enumerate(zip(eager, replayed)):
        if not _draws_equal(torch, de, dr):
            raise AssertionError(f"{name}: replay {i} drew other views "
                                 "than the eager step")
    for i in range(n_steps - 1):
        if _draws_equal(torch, replayed[i][0], replayed[i + 1][0]):
            raise AssertionError(f"{name}: replays {i} and {i + 1} drew the "
                                 "same views")
    le = [l.item() for _, l in eager]
    lr_ = [l.item() for _, l in replayed]
    rtol = _GRAPH_LOSS_RTOL[cfg.model.compute_dtype]
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(lr_, le))
    rel = _rel_change(torch, model, twin, p0)
    if not (loss_diff <= rtol and rel <= _GRAPH_PARAM_REL):
        raise AssertionError(f"{name}: replayed losses {lr_}, "
                             f"eager {le}; parameter difference {rel:.2e} "
                             "of the change")
    per_step = {k: counts[k] // (warm + 1) for k in kernels}
    prof, _, _ = _profiled(torch, lambda: engine.train_epoch(
        state, images, labels, idx[warm + n_steps:], gen))
    named = _named_launches(prof)
    if any(named[k] != per_step.get(k, 0) for k in named):
        raise AssertionError(f"{name}: one replay launched "
                             f"{named} by name, expected {per_step}")
    del engine, twin_engine, rec
    gc.collect()
    return (f"{name} (batch {batch}): views identical, varying; "
            f"losses replayed {[round(v, 6) for v in lr_]} eager "
            f"{[round(v, 6) for v in le]} (max rel {loss_diff:.1e}, tol "
            f"{rtol}); parameters {rel:.1e} of the change (tol "
            f"{_GRAPH_PARAM_REL}); a replay's kernels by name "
            f"{ {k: n for k, n in named.items() if n} }")


def _dropout_masks(torch, model):
    from simclr_tpu_torch.models.resnet import MCDropout
    return [m.mask.clone() for m in model.modules()
            if isinstance(m, MCDropout)]


def _mine_graph_check(torch):
    """The MINE step (``train/mine.py``) at batch 64 in ``repr`` mode over
    a width-16 frozen SimCLR with MC dropout (``encoder='dropout'``, six
    sites): WARMUP_STEPS eager steps and the capture (B2 three times in
    each, no other kernel), then N replays (each its own one-row chunk,
    under ``set_sync_debug_mode("error")``) against N eager steps of a twin
    loaded with the first's MineNet weights, Adam state, EMA and generator
    state after the capture, on the same rows: the view draws and the six
    dropout masks bit for bit, the masks different from one replay to the
    next, the losses, the EMA and the MineNet parameters within the graph
    tolerances."""
    import copy
    from simclr_tpu_torch.config import Config, ModelConfig
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.models.resnet import MCDropout
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.mine import build_mine, draw_rows

    n_steps, batch, warm = 3, 64, WARMUP_STEPS
    images = torch.from_numpy(synthetic_dataset(512, 32, seed=10)[0]).cuda()
    cfg = Config(model=ModelConfig(feature_dim=512, stage_sizes=(1, 1, 1, 1),
                                   width=16, encoder="dropout"))
    sd = SimCLR(cfg.model, generator=torch.Generator().manual_seed(1)
                ).state_dict()
    engine, state = build_mine(cfg, sd, hidden_size=256, device="cuda")
    twin, twin_state = build_mine(cfg, sd, hidden_size=256, device="cuda")
    for e in (engine, twin):
        for m in e.simclr.modules():
            if isinstance(m, MCDropout):
                m.record = True
    gen = torch.Generator(device="cuda").manual_seed(11)
    engine.init_log_ma(images, draw_rows(gen, 512, 1, batch)[0], gen)
    rows = draw_rows(gen, 512, warm + n_steps, batch)
    reset_counts()
    state, _ = engine.train_chunk(state, images, rows[:warm], gen)
    counts = read_counts()
    if counts["color"] != 3 * (warm + 1) or any(
            v for k, v in counts.items() if k != "color"):
        raise AssertionError(f"MINE step: launches {counts}, expected "
                             f"color {3 * (warm + 1)} and no other")
    (rec,) = engine.graphs.values()
    twin.mine.load_state_dict(engine.mine.state_dict())
    twin.optimizer.load_state_dict(copy.deepcopy(
        engine.optimizer.state_dict()))
    twin.log_ma = engine.log_ma.clone()
    twin_gen = torch.Generator(device="cuda")
    twin_gen.set_state(gen.get_state())
    p0 = [p.detach().clone() for p in engine.mine.parameters()]
    eager, replayed = [], []
    for i in range(n_steps):
        (loss, _), draws = twin._update(images, rows[warm + i], twin_gen)
        eager.append((draws, _dropout_masks(torch, twin.simclr), loss))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(n_steps):
            state, (losses, _) = engine.train_chunk(
                state, images, rows[warm + i:warm + i + 1], gen)
            replayed.append((tuple(_clone_draws(torch, d)
                                   for d in rec.draws),
                             _dropout_masks(torch, engine.simclr),
                             losses[0]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if len(engine.graphs) != 1 or state.step != warm + n_steps:
        raise AssertionError(f"MINE step: captured {len(engine.graphs)} "
                             f"times, step {state.step}")
    sites = len(replayed[0][1])
    for i, ((de, me, _), (dr, mr, _)) in enumerate(zip(eager, replayed)):
        if not all(_draws_equal(torch, a, b) for a, b in zip(de, dr)):
            raise AssertionError(f"MINE step: replay {i} drew other view "
                                 "parameters than the eager step")
        if len(me) != sites or not all(torch.equal(a, b)
                                       for a, b in zip(me, mr)):
            raise AssertionError(f"MINE step: replay {i} drew other "
                                 "dropout masks than the eager step")
    for i in range(n_steps - 1):
        if any(torch.equal(a, b) for a, b in
               zip(replayed[i][1], replayed[i + 1][1])):
            raise AssertionError(f"MINE step: replays {i} and {i + 1} drew "
                                 "the same dropout mask")
    le = [l.item() for *_, l in eager]
    lr_ = [l.item() for *_, l in replayed]
    loss_diff = max(abs(a - b) / max(abs(b), 1e-3) for a, b in zip(lr_, le))
    rel = _rel_change(torch, engine.mine, twin.mine, p0)
    ema = abs(engine.log_ma.item() - twin.log_ma.item())
    if not (loss_diff <= _MINE_LOSS_RTOL and rel <= _GRAPH_PARAM_REL
            and ema <= _MINE_LOSS_RTOL * max(abs(twin.log_ma.item()), 1)):
        raise AssertionError(f"MINE step: replayed losses {lr_}, eager {le};"
                             f" MineNet {rel:.2e} of the change apart; EMA "
                             f"{engine.log_ma.item()} vs {twin.log_ma.item()}")
    del engine, twin, rec
    gc.collect()
    return (f"MINE step (repr, batch {batch}, MC dropout at {sites} sites, "
            f"B2 {3 * (warm + 1)} launches in {warm} eager steps and the "
            f"capture): views and masks identical, masks varying; losses "
            f"replayed {[round(v, 6) for v in lr_]} eager "
            f"{[round(v, 6) for v in le]} (max rel {loss_diff:.1e}, tol "
            f"{_MINE_LOSS_RTOL}); MineNet {rel:.1e} of the change (tol "
            f"{_GRAPH_PARAM_REL}); EMA {ema:.1e} apart")


@phase("graph")
def graph_phase(torch):
    """Width-16 models on the four paths: WARMUP_STEPS eager steps and the
    capture, then N replays of the captured step (each its own one-row
    epoch, under ``set_sync_debug_mode("error")``), against N eager steps
    of a second model loaded with the first's weights, Adam state and
    generator state after the capture, on the same rows."""
    import copy
    from simclr_tpu_torch.config import Config, ModelConfig
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import epoch_permutation
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    n_steps, batch, warm = 3, 40, WARMUP_STEPS
    images = torch.from_numpy(
        synthetic_dataset(batch * (warm + n_steps), 32, seed=4)[0]).cuda()
    notes = [f"capturable Adam vs default, 3 steps: worst |diff| "
             f"{_adam_check(torch):.2f} of atol {_ADAM_ATOL} + rtol "
             f"{_ADAM_RTOL} |p|"]
    for name, over, _, kernels in _PARITY:
        small = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16)
        cfg = Config(model=ModelConfig(**{**small, **over}))
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    batch_size=batch))
        gen = torch.Generator(device="cuda").manual_seed(3)
        idx = epoch_permutation(gen, images.shape[0], batch)
        model, state, opt = init_simclr(cfg, seed=0, device="cuda")
        engine = build_engine(cfg, model, opt)
        reset_counts()
        state, _ = engine.train_epoch(state, images, idx[:warm], gen)
        counts = read_counts()
        if not all(counts[k] for k in ("ntxent_fwd", "ntxent_bwd", "color",
                                       *kernels)):
            raise AssertionError(f"{name}: a kernel did not run: {counts}")
        (rec,) = engine.graphs.values()
        # The eager twin, from the state the replays start from.
        twin, twin_state, twin_opt = init_simclr(cfg, seed=0, device="cuda")
        twin.load_state_dict(model.state_dict())
        twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        twin_gen = torch.Generator(device="cuda")
        twin_gen.set_state(gen.get_state())
        twin_engine = build_engine(cfg, twin, twin_opt)
        p0 = [p.detach().clone() for p in model.parameters()]
        eager, replayed = [], []
        for i in range(n_steps):
            draws = twin_engine.sample_pair_params(twin_gen, batch, 32, 32)
            twin_state, (loss, _) = twin_engine.train_step_on_params(
                twin_state, images.index_select(0, idx[warm + i]), draws)
            eager.append((draws, loss))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(n_steps):
                state, (loss, _) = engine.train_epoch(
                    state, images, idx[warm + i:warm + i + 1], gen)
                replayed.append(((_clone_draws(torch, rec.draws[0]),
                                  _clone_draws(torch, rec.draws[1])), loss))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if len(engine.graphs) != 1 or state.step != warm + n_steps:
            raise AssertionError(f"{name}: captured {len(engine.graphs)} "
                                 f"times, step {state.step}")
        for i, ((de, le), (dr, lr_)) in enumerate(zip(eager, replayed)):
            if not all(_draws_equal(torch, a, b) for a, b in zip(de, dr)):
                raise AssertionError(f"{name}: replay {i} drew other view "
                                     "parameters than the eager step")
        for i in range(n_steps - 1):
            if _draws_equal(torch, replayed[i][0][0], replayed[i + 1][0][0]):
                raise AssertionError(f"{name}: replays {i} and {i + 1} drew "
                                     "the same view parameters")
        le = [l.item() for _, l in eager]
        lr_ = [l.item() for _, l in replayed]
        rtol = _GRAPH_LOSS_RTOL[cfg.model.compute_dtype]
        loss_diff = max(abs(a - b) / abs(b) for a, b in zip(lr_, le))
        rel = _rel_change(torch, model, twin, p0)
        same = all(torch.equal(p, q) for p, q in
                   zip(model.parameters(), twin.parameters()))
        if not (loss_diff <= rtol and rel <= _GRAPH_PARAM_REL):
            raise AssertionError(f"{name}: replayed losses {lr_}, eager "
                                 f"{le}; parameter difference {rel:.2e} of "
                                 "the change")
        notes.append(f"{name}: draws identical, varying; losses replayed "
                     f"{[round(v, 6) for v in lr_]} eager "
                     f"{[round(v, 6) for v in le]} (max rel {loss_diff:.1e},"
                     f" tol {rtol}); parameters {rel:.1e} of the change "
                     f"(tol {_GRAPH_PARAM_REL}), bit-identical: {same}")
        del engine, twin_engine, rec
        gc.collect()
    from simclr_tpu_torch.train.supervised import init_supervised
    for name, over, _, kernels in _PARITY[:2]:
        notes.append(_classifier_graph_check(torch, f"fine-tune {name}",
                                             over, kernels))
    notes.append(_classifier_graph_check(
        torch, "supervised half-step", {}, ("color",), init_supervised,
        augment="supervised"))
    notes.append(_mine_graph_check(torch))
    return {"summary": "no sync in the replays; " + "; ".join(notes)}


def _busy_by_epoch(torch, prof):
    """Each ``train_epoch n`` annotation's wall time and the device time
    of the kernels and copies that started inside it (not the device-side
    spans of pretrain()'s own annotations)."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU
             and e.name.startswith("train_epoch ")}
    kernels = [(e.time_range.start, e.time_range.elapsed_us())
               for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("train_epoch ", "eval_epoch "))]
    out = {}
    for name, (t0, t1) in sorted(spans.items()):
        busy = sum(us for start, us in kernels if t0 <= start <= t1)
        out[name] = (t1 - t0, busy)
    return out


@phase("pretrain")
def pretrain_phase(torch, smi, tmp):
    """``pretrain()`` at full width on the default config over 4,096
    synthetic CIFAR-shaped images (80/20 split: 6 steps an epoch and a
    one-batch validation epoch), 2 epochs with a checkpoint after each,
    under torch.profiler; then a second run resumed from the first
    epoch's checkpoint must end where the first did, and the export must
    load back. Writes under ``tmp``, which the caller removes; returns the
    split and the export for the downstream phases."""
    from torch.profiler import ProfilerActivity, profile
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import (
        DeviceDataset, Split, split_indices)
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.pretrain import pretrain, resolve_model_config
    from simclr_tpu_torch.utils.checkpoint import load_exported_model
    from simclr_tpu_torch.utils.profiling import read_metrics

    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    tr, va = split_indices(4096, 0.2)
    split = Split(DeviceDataset.from_numpy(images[tr], labels[tr], "cuda"),
                  DeviceDataset.from_numpy(images[va], labels[va], "cuda"))
    base = Config()
    cfg = base.replace(
        train=dataclasses.replace(base.train, n_epoch=2,
                                  save_ckpt_every=1),
        out_dir=f"{tmp}/out", ckpt_dir=f"{tmp}/ckpt")
    peaks, lines = [], []

    def log(line):
        # Replays allocate nothing: the graph's private pool counts as
        # reserved, not allocated, so both peaks are printed.
        lines.append(line)
        if line.startswith("checkpoint saved"):
            peaks.append((torch.cuda.max_memory_allocated() / 2 ** 30,
                          torch.cuda.max_memory_reserved() / 2 ** 30))
            torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = pretrain(cfg, split, log=log, save_plots=False,
                       metrics_path=f"{tmp}/metrics.jsonl")
    busy = _busy_by_epoch(torch, prof)
    records = [r for r in read_metrics(f"{tmp}/metrics.jsonl")
               if "train_loss" in r]
    hist = run.history.to_dict()
    values = [v for k in ("loss", "accuracy") for s in hist[k].values()
              for v in s]
    if (len(records) != 2 or len(hist["loss"]["valid"]) != 2
            or not all(math.isfinite(v) for v in values)):
        raise AssertionError(f"history {hist}, metrics {records}")
    final = {k: v.detach().clone() for k, v in
             run.state.model.state_dict().items()}
    start = torch.load(f"{tmp}/ckpt/epoch_00000/state.pt",
                       map_location="cuda", weights_only=True)["model"]
    steps = run.state.step
    del run
    _release(torch, {})
    resumed = pretrain(cfg, split, log=lines.append, save_plots=False,
                       resume_from=f"{tmp}/ckpt/epoch_00000")
    rhist = resumed.history.to_dict()
    if (rhist["loss"]["train"][0] != hist["loss"]["train"][0]
            or resumed.state.step != steps):
        raise AssertionError(f"resumed history {rhist}, steps "
                             f"{resumed.state.step} vs {steps}")
    got = resumed.state.model.state_dict()
    same = all(torch.equal(got[k], final[k]) for k in final)
    # The graph phase's tolerances: the second epoch's mean loss, and
    # the parameters' distance over their change in that epoch.
    params = [k for k, _ in resumed.state.model.named_parameters()]
    apart = torch.cat([(final[k] - got[k]).float().flatten()
                       for k in params]).norm().item()
    change = torch.cat([(final[k] - start[k]).float().flatten()
                        for k in params]).norm().item()
    loss_diff = abs(rhist["loss"]["train"][1] - hist["loss"]["train"][1])
    rtol = _GRAPH_LOSS_RTOL[cfg.model.compute_dtype]
    if not (loss_diff <= rtol * abs(hist["loss"]["train"][1])
            and apart <= _GRAPH_PARAM_REL * change):
        raise AssertionError(f"resumed run ended elsewhere: epoch-2 loss"
                             f" {rhist['loss']['train'][1]} vs "
                             f"{hist['loss']['train'][1]}, parameters "
                             f"{apart:.3e} apart (changed {change:.3e})")
    sd, cfg_json = load_exported_model(resumed.export_path)
    model = SimCLR(resolve_model_config(cfg).model)
    model.load_state_dict(sd)
    if cfg_json["train"]["n_epoch"] != 2 or not all(
            torch.equal(sd[k], got[k].cpu()) for k in got):
        raise AssertionError("the export did not load back")
    export = resumed.export_path
    del resumed
    for (name, (wall_us, busy_us)), rec, (alloc, reserved) in zip(
            busy.items(), records, peaks):
        print(f"  {name}: {rec['epoch_seconds']:.3f} s, "
              f"{rec['steps_per_sec']:.3f} steps/s, device busy "
              f"{100 * busy_us / wall_us:.1f}% of {wall_us / 1e3:.1f} ms "
              f"(profiled), peak {alloc:.2f} GiB allocated, {reserved:.2f} "
              f"GiB reserved, on {smi}")
    return {"split": split, "export": export,
            "summary": f"2 epochs of 6 steps (train losses "
                       f"{[round(v, 4) for v in hist['loss']['train']]}, "
                       f"valid {[round(v, 4) for v in hist['loss']['valid']]}"
                       f"); resumed from epoch 1: parameters bit-identical "
                       f"{same} ({apart:.2e} apart, changed {change:.2e} in "
                       f"epoch 2), "
                       f"epoch-2 loss {rhist['loss']['train'][1]:.6f} vs "
                       f"{hist['loss']['train'][1]:.6f}; export loads back"}


# The parity phase's bf16 tolerance, on the first images' features of the
# export on the card (cuDNN) and on the CPU, in relative norm: bf16
# convolutions and BN passes round at other points on the two.
_FEATURE_REL = 1e-2


@phase("lin_eval")
def lin_eval_phase(torch, smi, pre):
    """``linear_evaluation`` of the pretrain phase's export at full width
    on its 3,277 / 819 split: features at batch 512, the float32 L-BFGS
    head (``n_epoch_lin_eval = 2``: 40 iterations at most), test top-1.
    The launch counts are set to 0 before and read after: the default
    path runs no kernel. The L-BFGS trace must fall from ln 10, all
    finite; the first 16 images' features on the card must equal the
    CPU's from the same export. Then extraction and the fit again, timed
    apart (images/s, ms an L-BFGS iteration)."""
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.pipeline import DeviceDataset
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.lin_eval import (
        extract_features, linear_evaluation, train_linear_classifier)
    from simclr_tpu_torch.train.pretrain import resolve_model_config
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    base = Config()
    cfg = base.replace(train=dataclasses.replace(base.train,
                                                 n_epoch_lin_eval=2))
    train, test = pre["split"].train, pre["split"].val
    sd, _ = load_pretrained(pre["export"])
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = SimCLR(resolve_model_config(cfg).model)
        models[dev].load_state_dict(sd)
        models[dev] = models[dev].to(dev, memory_format=torch.channels_last)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_counts()
    start = time.perf_counter()
    loss, acc = linear_evaluation(models["cuda"], train, test, cfg,
                                  log=lines.append)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()):
        raise AssertionError(f"the default downstream path launched "
                             f"{launches}")
    first, final, iters = (float(v) for v in re.match(
        r"lin-eval L-BFGS: loss (\S+) -> (\S+) \((\d+) iterations\)",
        lines[0]).groups())
    if not (abs(first - math.log(10)) < 1e-3 and final < first
            and 0 < iters <= 40 and math.isfinite(loss)
            and math.isfinite(acc)):
        raise AssertionError(f"linear evaluation: {lines}")
    head = {}
    for dev, model in models.items():
        images = train.images[:16].to(dev)
        head[dev] = extract_features(
            model, DeviceDataset(images, train.labels[:16].to(dev)),
            cfg)[0].cpu()
    rel = _rel_norm(head["cuda"], head["cpu"])
    if not rel <= _FEATURE_REL:
        raise AssertionError(f"features on the card {rel:.2e} off the CPU's")
    torch.cuda.synchronize()
    start = time.perf_counter()
    feats, targets = extract_features(models["cuda"], train, cfg)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - start
    fit_lines = []
    start = time.perf_counter()
    _, trace = train_linear_classifier(
        feats, targets, cfg.optim.reg_wt_lin_eval,
        cfg.train.n_epoch_lin_eval, cfg.optim.lbfgs_max_iter,
        cfg.dataset.num_classes, log=fit_lines.append)
    fit_s = time.perf_counter() - start
    fit_iters = int(re.search(r"\((\d+) iterations", fit_lines[0]).group(1))
    print(f"  lin_eval: extraction {train.n / extract_s:.1f} images/s "
          f"({train.n} images at batch 512, {extract_s:.3f} s); L-BFGS "
          f"{1e3 * fit_s / fit_iters:.3f} ms an iteration ({fit_iters} "
          f"iterations on {tuple(feats.shape)} float32 features, "
          f"{fit_s:.3f} s); linear_evaluation {total_s:.3f} s; top-1 "
          f"{acc:.2f}%; peak {peak:.2f} GiB allocated; on {smi}")
    del models, feats
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": f"export of the pretrain phase, {train.n} / {test.n}"
                       f" images: L-BFGS loss {first:.4f} -> {final:.4f} in "
                       f"{int(iters)} iterations (trace "
                       f"{[round(float(v), 4) for v in trace]}), test"
                       f" loss {loss:.4f}, top-1 {acc:.2f}%; no kernel "
                       f"launched; first 16 images' features {rel:.2e} off "
                       f"the CPU's in relative norm (tol {_FEATURE_REL})"}


@phase("ssl")
def ssl_phase(torch, smi, pre):
    """``train_ssl`` from the pretrain phase's export at full width,
    ``micro_batch_size`` 64 and ``ssl_label_size`` 0.1 (327 weighted draws
    of the 3,277 images: 5 replayed steps an epoch after the first
    epoch's warm-up steps and capture), 2 epochs, tested on the 819. The
    launch counts are set to 0 before and read after: the default path
    runs no kernel. ``init_finetune`` must graft the export's ``f`` and
    ``g``; after training ``f`` must have moved and ``g`` not; the history
    must be finite. Then two more steps replayed under the profiler on
    the fine-tuned model: the device's busy share."""
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.pipeline import (
        class_weights, weighted_sample_indices)
    from simclr_tpu_torch.train.ssl import (
        SupervisedEngine, init_finetune, train_ssl)
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    cfg = Config()
    tcfg = cfg.train
    train, test = pre["split"].train, pre["split"].val
    sd, _ = load_pretrained(pre["export"])
    grafted, _, _ = init_finetune(cfg, tcfg.seed, pre["export"],
                                  device="cuda")
    got = grafted.state_dict()
    if not all(torch.equal(got[k].cpu(), v) for k, v in sd.items()):
        raise AssertionError("init_finetune did not graft the export")
    del grafted, got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_counts()
    result = train_ssl(cfg, train, test_ds=test,
                       pretrained_path=pre["export"], n_epochs=2,
                       log=lines.append)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    if any(launches.values()):
        raise AssertionError(f"the default downstream path launched "
                             f"{launches}")
    hist = result.history.to_dict()
    values = [v for d in hist.values() for v in d["train"]]
    steps = max(int(tcfg.ssl_label_size * train.n),
                tcfg.micro_batch_size) // tcfg.micro_batch_size
    if (len(hist["loss"]["train"]) != 2 or result.state.step != 2 * steps
            or not all(math.isfinite(v) for v in values)
            or not math.isfinite(result.test_acc)):
        raise AssertionError(f"fine-tune history {hist}, step "
                             f"{result.state.step}, test {result.test_acc}")
    model = result.state.model
    now = {k: v.cpu() for k, v in model.state_dict().items()}
    g_same = all(torch.equal(now[k], v) for k, v in sd.items()
                 if k.startswith("g."))
    f_moved = _rel_norm(
        torch.cat([now[k].flatten() for k in sd if k.startswith("f.")]),
        torch.cat([v.flatten() for k, v in sd.items()
                   if k.startswith("f.")]))
    if not g_same or not f_moved > 0:
        raise AssertionError(f"g unchanged {g_same}, f moved {f_moved}")
    # Two replayed steps on a new engine (its warm-up and capture first).
    engine = SupervisedEngine(model, result.state.optimizer, cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    weights = torch.from_numpy(class_weights(train.labels.cpu().numpy()))
    idx = weighted_sample_indices(gen, weights, 4 * tcfg.micro_batch_size,
                                  tcfg.micro_batch_size)
    state, _ = engine.train_epoch(result.state, train.images, train.labels,
                                  idx[:2], gen)
    _, wall_ms, by_name = _profiled(torch, lambda: engine.train_epoch(
        state, train.images, train.labels, idx[2:], gen))
    busy = sum(by_name.values())
    secs, test_acc = result.epoch_seconds, result.test_acc
    print(f"  ssl: epoch 1 (2 eager steps, the capture, {steps - 2} "
          f"replays) {secs[0]:.3f} s, epoch 2 ({steps} replays) "
          f"{secs[1]:.3f} s, {steps / secs[1]:.3f} steps/s; a replayed "
          f"step {wall_ms / 2:.2f} ms wall (profiled), device busy "
          f"{busy / 2:.2f} ms ({100 * busy / wall_ms:.1f}%); peak "
          f"{peak[0]:.2f} GiB allocated, {peak[1]:.2f} GiB reserved; test "
          f"top-1 {test_acc:.2f}%; on {smi}")
    print("  ssl: train_ssl's log: " + " / ".join(lines))
    del engine, result, model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": f"2 epochs of {steps} steps at batch "
                       f"{tcfg.micro_batch_size} from the export (f and g "
                       f"grafted): train losses "
                       f"{[round(v, 4) for v in hist['loss']['train']]}, "
                       f"accuracies "
                       f"{[round(v, 2) for v in hist['accuracy']['train']]}"
                       f", test top-1 {test_acc:.2f}%; no kernel launched; g "
                       f"unchanged, f moved {f_moved:.2e} in relative norm"}


def _by_category(by_name):
    """Device ms by kernel category, largest first (one table for this
    script and the profile_step harness:
    ``simclr_tpu_torch/scripts/profile_step.py:CATEGORIES``)."""
    from simclr_tpu_torch.scripts.profile_step import by_category
    return by_category(by_name)


def _replays_busy(torch, run):
    """Two replayed steps of ``run`` under the profiler: (wall ms, device
    busy ms, "category ms, ..." text) a step."""
    _, wall_ms, by_name = _profiled(torch, run)
    text = ", ".join(f"{c} {ms / 2:.2f}" for c, ms in _by_category(by_name))
    return wall_ms / 2, sum(by_name.values()) / 2, text


@phase("supervised")
def supervised_phase(torch, smi, pre):
    """``train_supervised`` at full width (CIFAR-stem ResNet-50, bf16) on
    the pretrain phase's 3,277 images, ``micro_batch_size`` 64 (51 batches,
    102 half-steps an epoch), 2 epochs, validated and tested on the 819.
    The launch counts are set to 0 before and read after: B2 once in each
    of the WARMUP_STEPS eager half-steps and once in the capture (replays
    do not count), no other kernel. The history must be finite; the
    parameters at the end must be those of the best epoch (kept by the
    log callback when it is announced), bit for bit. Then two more
    half-steps replayed under the profiler on a new engine: the device's
    busy share."""
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.pipeline import epoch_permutation
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.ssl import SupervisedEngine
    from simclr_tpu_torch.train.supervised import train_supervised

    cfg = Config()
    batch = cfg.train.micro_batch_size
    train, test = pre["split"].train, pre["split"].val
    lines, best = [], {}

    def log(line):
        lines.append(line)
        if line.startswith("Found a better model"):
            best["params"] = [p.detach().clone() for p in
                              best["model"].parameters()]

    # The model is built inside train_supervised: keep a handle on it,
    # so that the log callback can copy the best epoch's parameters.
    import simclr_tpu_torch.train.supervised as sup
    init = sup.init_supervised

    def init_and_keep(*args, **kwargs):
        out = init(*args, **kwargs)
        best["model"] = out[0]
        return out

    sup.init_supervised = init_and_keep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = train_supervised(cfg, train, val_ds=test, test_ds=test,
                                  n_epochs=2, log=log)
    finally:
        sup.init_supervised = init
    torch.cuda.synchronize()
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    want = {k: 0 for k in launches}
    want["color"] = WARMUP_STEPS + 1
    if launches != want:
        raise AssertionError(f"supervised: launches {launches}, expected "
                             f"{want}")
    hist = result.history.to_dict()
    values = [v for d in hist.values() for s in d.values() for v in s]
    half_steps = 2 * (train.n // batch)
    if (len(hist["loss"]["train"]) != 2 or len(hist["loss"]["valid"]) != 2
            or result.state.step != 2 * half_steps
            or not all(math.isfinite(v) for v in values)
            or not math.isfinite(result.test_acc)):
        raise AssertionError(f"supervised history {hist}, step "
                             f"{result.state.step}, test {result.test_acc}")
    model = result.state.model
    if "params" not in best or not all(
            torch.equal(p, q) for p, q in zip(model.parameters(),
                                              best["params"])):
        raise AssertionError("the best epoch's parameters were not "
                             "restored")
    engine = SupervisedEngine(model, result.state.optimizer, cfg,
                              augment="supervised")
    gen = torch.Generator(device="cuda").manual_seed(12)
    idx = epoch_permutation(gen, train.n, batch)[:2].repeat_interleave(
        2, dim=0)
    state, _ = engine.train_epoch(result.state, train.images, train.labels,
                                  idx[:2], gen)
    wall, busy, cats = _replays_busy(torch, lambda: engine.train_epoch(
        state, train.images, train.labels, idx[2:], gen))
    secs = result.epoch_seconds
    print(f"  supervised: epoch 1 ({WARMUP_STEPS} eager half-steps, the "
          f"capture, {half_steps - WARMUP_STEPS} replays, validation) "
          f"{secs[0]:.3f} s, epoch 2 ({half_steps} replays) {secs[1]:.3f} "
          f"s, {half_steps / secs[1]:.3f} half-steps/s; a replayed "
          f"half-step {wall:.2f} ms wall (profiled), device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%); peak {peak[0]:.2f} "
          f"GiB allocated, {peak[1]:.2f} GiB reserved; best val top-1 "
          f"{result.best_acc:.2f}%, test top-1 {result.test_acc:.2f}%; on "
          f"{smi}")
    print(f"  supervised: device ms a replayed half-step by category: "
          f"{cats}")
    print("  supervised: train_supervised's log: " + " / ".join(lines))
    del engine, result, model, state, best
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": f"2 epochs of {half_steps} half-steps at batch "
                       f"{batch}: train losses "
                       f"{[round(v, 4) for v in hist['loss']['train']]}, "
                       f"valid top-1 "
                       f"{[round(v, 2) for v in hist['accuracy']['valid']]}"
                       f"; B2 {want['color']} launches (eager and capture),"
                       f" no other kernel; best epoch's parameters "
                       f"restored"}


def _mine_run(torch, smi, cfg, pre, n_iter, mode, per_step):
    """One ``train_mine_from_export`` run at batch 256 and hidden width
    512 (chunks of 50 steps); its B2 launches must be ``per_step`` in the
    EMA's first sample, each WARMUP_STEPS eager step and the capture, and
    no other kernel may run. Then two more steps replayed under the
    profiler on a new engine. Returns its numbers."""
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.mine import (
        build_mine, draw_rows, train_mine_from_export)
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    train = pre["split"].train
    repr_mode = mode == "repr"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lines = []
    result = train_mine_from_export(
        cfg, train, pre["export"], n_iter=n_iter, mi_between_repr=repr_mode,
        batch_size=256, hidden_size=512, log=lines.append, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    want = {k: 0 for k in launches}
    want["color"] = per_step * (1 + WARMUP_STEPS + 1)
    if launches != want:
        raise AssertionError(f"MINE {mode}: launches {launches}, expected "
                             f"{want}")
    traces = [float(v) for v in (*result.loss_trace, *result.mi_trace)]
    if (result.state.step != n_iter or len(result.loss_trace) != n_iter // 50
            or not all(math.isfinite(v) for v in traces)):
        raise AssertionError(f"MINE {mode}: step {result.state.step}, "
                             f"traces {traces}")
    sd, _ = load_pretrained(pre["export"])
    engine, state = build_mine(cfg, sd, mi_between_repr=repr_mode,
                               hidden_size=512, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    engine.init_log_ma(train.images, draw_rows(gen, train.n, 1, 256)[0], gen)
    rows = draw_rows(gen, train.n, 4, 256)
    state, _ = engine.train_chunk(state, train.images, rows[:2], gen)
    wall, busy, cats = _replays_busy(torch, lambda: engine.train_chunk(
        state, train.images, rows[2:], gen))
    steady = result.chunk_seconds[1:]
    step_ms = (1e3 * statistics.median(steady) / 50 if steady else None)
    del engine, state, result
    gc.collect()
    torch.cuda.empty_cache()
    return dict(traces=traces, lines=lines, wall=wall, busy=busy, peak=peak,
                step_ms=step_ms, b2=want["color"], cats=cats)


@phase("mine")
def mine_phase(torch, smi, pre):
    """``train_mine_from_export`` on the pretrain phase's export at full
    width over its 3,277 images, batch 256 and hidden width 512: ``repr``
    mode with ``ModelConfig(encoder='dropout')`` for 200 steps (4 chunks;
    B2 three times a step), then ``orig`` mode without dropout for 50
    steps (1 chunk; B2 twice a step, MineNet 5,120 wide). Each run's
    launch counts are checked (``_mine_run``) and its traces must be
    finite; ms a step from the replayed chunks, the busy share of two
    replayed steps under the profiler, peak memory."""
    from simclr_tpu_torch.config import Config

    base = Config()
    dropout = base.replace(model=dataclasses.replace(base.model,
                                                     encoder="dropout"))
    runs = {"repr": _mine_run(torch, smi, dropout, pre, 200, "repr", 3),
            "orig": _mine_run(torch, smi, base, pre, 50, "orig", 2)}
    for mode, r in runs.items():
        step = (f"{r['step_ms']:.2f} ms a step (median replayed chunk of 50,"
                f" with its host fetch), " if r["step_ms"] else "")
        print(f"  mine {mode}: {step}a replayed step {r['wall']:.2f} ms wall "
              f"(profiled), device busy {r['busy']:.2f} ms "
              f"({100 * r['busy'] / r['wall']:.1f}%); peak {r['peak'][0]:.2f}"
              f" GiB allocated, {r['peak'][1]:.2f} GiB reserved; on {smi}")
        print(f"  mine {mode}: device ms a replayed step by category: "
              f"{r['cats']}")
        print(f"  mine {mode}: train_mine's log: " + " / ".join(r["lines"]))
    rt, ot = runs["repr"]["traces"], runs["orig"]["traces"]
    return {"summary": f"repr with MC dropout, 200 steps: loss trace "
                       f"{[round(v, 4) for v in rt[:4]]}, MI trace "
                       f"{[round(v, 4) for v in rt[4:]]}; orig, 50 steps: "
                       f"loss {ot[0]:.4f}, MI {ot[1]:.4f}; B2 "
                       f"{runs['repr']['b2']} / {runs['orig']['b2']} launches"
                       f" (3 / 2 a step in the EMA's first sample, "
                       f"the eager steps and the capture), no other kernel"}


# ---------------------------------------------------------------------------
# Representation analysis, the serving artifact and STL-10 at 96x96.
# ---------------------------------------------------------------------------

# _pairwise_metrics of the same features on the card and on the CPU:
# float32 on both, reductions in other orders. NMI buckets each value by
# a float32 division and a truncation: a value within an ulp of a bucket
# edge may land on the other side, which moves one of 2,048 counts.
_METRIC_ATOL = {"nmi": 2e-3}
_METRIC_TOL = 1e-4
# The loaded artifact against the eager forward, in relative norm: both
# run the same bf16 cuDNN convolutions, kernels and BN passes, but the
# exported graph may pick other algorithms.
_SERVE_REL = 1e-2


def _load_export(torch, path, cfg=None):
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.pretrain import resolve_model_config
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    sd, _ = load_pretrained(path)
    model = SimCLR(resolve_model_config(cfg or Config()).model)
    model.load_state_dict(sd)
    return model.to("cuda", memory_format=torch.channels_last)


def _expect_counts(counts, want, what):
    for name, count in counts.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {count} times, "
                                 f"expected {want.get(name, 0)}: {counts}")


@phase("analysis")
def analysis_phase(torch, smi, pre):
    """The representation analysis of the pretrain phase's export at full
    width on its CIFAR-shaped images (``scripts/analysis.py``'s work
    without the figures): ``get_similarity_metrics`` of h at batch 256
    over 4 batches of the 3,277 training images (B2 twice a batch, no
    other kernel); then ``extract_features`` of h over the 819, the
    flipped-view analogy and the one-batch gradient flow of 256 training
    images (B1f and B1b once, B2 twice). The model's parameters and
    buffers must be bit for bit what they were; ``_pairwise_metrics`` of
    one batch's features on the card must match the CPU's; positives must
    be closer than negatives."""
    import numpy as np
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.ops.augment import augment_train_pair
    from simclr_tpu_torch.scripts.analysis import grad_flow
    from simclr_tpu_torch.train.lin_eval import extract_features
    from simclr_tpu_torch.utils.metrics import (
        _METRIC_KEYS, _pairwise_metrics, contrastive_feature_fn,
        get_representation_analogy, get_similarity_metrics)

    cfg = Config()
    train, test = pre["split"].train, pre["split"].val
    model = _load_export(torch, pre["export"])
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fn = contrastive_feature_fn(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    start = time.perf_counter()
    metrics = get_similarity_metrics(fn, train, cfg, batch_size=256,
                                     n_batches=4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    _expect_counts(read_counts(), {"color": 8}, "similarity metrics")
    # The same pass again, warm (the first call picks cuDNN's algorithms
    # for the new shapes).
    start = time.perf_counter()
    get_similarity_metrics(fn, train, cfg, batch_size=256, n_batches=4)
    torch.cuda.synchronize()
    metric_s = time.perf_counter() - start
    if not all(v.shape == (1024,) and np.isfinite(v).all()
               for v in metrics.values()):
        raise AssertionError("similarity metrics: shapes or values")
    pos, neg = metrics["pos_cos"].mean(), metrics["neg_cos"].mean()
    if not pos > neg:
        raise AssertionError(f"pos_cos {pos:.4f} <= neg_cos {neg:.4f}")

    reset_counts()
    start = time.perf_counter()
    feats, _ = extract_features(model, test, cfg)
    analogy = get_representation_analogy(fn, fn, test, cfg)
    grads, grad_loss = grad_flow(cfg, model, train.images[:256])
    torch.cuda.synchronize()
    rest_s = time.perf_counter() - start
    _expect_counts(read_counts(), {"ntxent_fwd": 1, "ntxent_bwd": 1,
                                   "color": 2},
                   "features, analogy and gradient flow")
    after = model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if changed or not model.training:
        raise AssertionError(f"the analysis changed {changed[:5]}")
    if not (all(np.isfinite(g).all() for g in grads.values())
            and math.isfinite(grad_loss) and feats.shape == (test.n, 2048)
            and all(math.isfinite(v) for v in analogy.values())):
        raise AssertionError("features, analogy or gradients not finite")

    # One batch's metrics on the card against the CPU, same features.
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        v1, v2 = augment_train_pair(gen, train.images[:256], cfg.augment,
                                    cfg.dataset)
        f1, f2 = fn(v1, gen), fn(v2, gen)
    perm = torch.randperm(256, generator=gen, device="cuda")
    on_card = _pairwise_metrics(f1, f2, perm)
    on_cpu = _pairwise_metrics(f1.cpu(), f2.cpu(), perm.cpu())
    worst = {}
    for k in _METRIC_KEYS:
        a, b = on_card[k].cpu(), on_cpu[k]
        atol = _METRIC_ATOL.get(k.split("_")[1], _METRIC_TOL)
        worst[k] = (a - b).abs().max().item()
        if not torch.allclose(a, b, rtol=_METRIC_TOL, atol=atol):
            raise AssertionError(f"{k} on the card {worst[k]:.2e} off the "
                                 f"CPU's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  analysis: similarity metrics {1024 / metric_s:.1f} images/s "
          f"(4 batches of 256, two views each, {metric_s:.3f} s warm; "
          f"{1024 / first_s:.1f} in the first pass); "
          f"features, analogy and gradient flow {rest_s:.3f} s; peak "
          f"{peak:.2f} GiB allocated; on {smi}")
    print(f"  analysis: pos/neg cos {pos:.4f} / {neg:.4f}, analogy "
          f"{ {k: round(v, 5) for k, v in analogy.items()} }, gradient-flow"
          f" loss {grad_loss:.4f} over {len(grads)} leaves; card vs CPU "
          f"max |diff| {max(worst.values()):.2e}")
    del model, fn, f1, f2
    _release(torch, {})
    return {"summary": f"h metrics over 1,024 images (B2 8), pos_cos "
                       f"{pos:.4f} > neg_cos {neg:.4f}; features, analogy "
                       f"and gradient flow (B1f 1, B1b 1, B2 2); model "
                       f"state bit for bit; _pairwise_metrics card vs CPU "
                       f"within {_METRIC_TOL} (nmi "
                       f"{_METRIC_ATOL['nmi']}): max "
                       f"{max(worst.values()):.2e}"}


# The serving phase's paths: (name, ModelConfig flags, launches of one
# forward, convolutions the kernels replace). ResNet-50 has 53
# convolutions: the stem, 16 blocks of three, 4 downsamples.
_SERVE_PATHS = (
    ("default", {}, {}, 0),
    # layer1's three conv2 through B4f, the ten other stride-1 conv2
    # through B5f.
    ("conv64 + winograd", dict(conv64_pallas=True, winograd_conv2=True),
     {"conv64_fwd": 3, "winograd_fwd": 10}, 13),
    # The 12 identity blocks through B6f.
    ("fuse_identity_blocks", dict(fuse_identity_blocks=True),
     {"bottleneck_fwd": 12}, 36),
)
_SERVE_CONVS = 53
# A counter's name -> its operator in the artifact's graph.
_SERVE_OPS = {"conv64_fwd": "conv_c64", "winograd_fwd": "winograd_fwd",
              "bottleneck_fwd": "bottleneck_fwd"}


def _graph_ops(module):
    """Nodes of the port's operators by name, and aten convolutions, in a
    loaded artifact's graph."""
    ops, convs = {}, 0
    for node in module.graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("simclr_tpu_torch."):
            key = name.split(".")[1]
            ops[key] = ops.get(key, 0) + 1
        convs += name.startswith("aten.conv")
    return ops, convs


# Each path's eager (h, z) against a float32 forward of the same weights
# (the default path, cuDNN without TF32), in relative norm: a kernel
# path's error at most _SERVE_F32_RATIO times the default bf16 path's.
# B4f and B5f are within one bf16 ulp of their plain versions, B6f at all
# but 1e-3 of its elements, so a kernel path rounds about as much as
# cuDNN's bf16 path does. Its distance to the default path's (h, z) is
# printed beside it.
_SERVE_F32_RATIO = 2.0


def _forward_device_ms(torch, fn, calls=3):
    """Device ms of one fn() call: the device time torch.profiler saw over
    ``calls`` calls, over their number."""
    _, _, by_name = _profiled(torch, lambda: [fn() for _ in range(calls)])
    return sum(by_name.values()) / calls


@phase("serving")
def serving_phase(torch, smi, pre, tmp):
    """``export_forward`` of the export's full-width eval forward on the
    card for NHWC batches of 512 and ``load_forward``, on the default path
    and, from the same weights, under ``conv64_pallas`` with
    ``winograd_conv2`` and under ``fuse_identity_blocks``
    (``_SERVE_PATHS``). Each loaded artifact against the eager forward
    under the same flags on 512 test views (relative norm within
    ``_SERVE_REL``; bit for bit is expected, the max |diff| is printed),
    and each path's eager forward against a float32 forward of the same
    weights: a kernel path's error at most ``_SERVE_F32_RATIO`` times the
    default path's, so the kernels at this forward's own shapes against
    cuDNN's convolutions. Counted from 0 for one forward of each:
    the artifact and the eager forward launch B4f 3 and B5f 10, or B6f
    12, or none of the port's kernels, and nothing else; the artifact's
    graph holds one operator node a launch and no convolution in the
    kernels' place. Export s, load s, artifact MB, and both forwards'
    images/s, device ms and host ms to enqueue."""
    import os
    from simclr_tpu_torch.config import CIFAR10, Config, ModelConfig
    from simclr_tpu_torch.ops.augment import augment_test
    from simclr_tpu_torch.utils.serving import export_forward, load_forward

    x = augment_test(pre["split"].train.images[:512], CIFAR10)
    f32 = _load_export(torch, pre["export"], Config(model=ModelConfig(
        compute_dtype="float32", bn_dtype="float32"))).eval()
    with torch.no_grad():
        exact = f32(x.permute(0, 3, 1, 2), None)
    del f32
    done, default = [], None
    for name, flags, launches, replaced in _SERVE_PATHS:
        model = _load_export(torch, pre["export"],
                             Config(model=ModelConfig(**flags)))
        path = f"{tmp}/forward.pt2"
        # export_forward runs one real forward before its trace.
        start = time.perf_counter()
        export_forward(path, model, tuple(x.shape))
        export_s = time.perf_counter() - start
        start = time.perf_counter()
        served = load_forward(path)
        load_s = time.perf_counter() - start
        model.eval()
        ops, convs = _graph_ops(served)
        want_ops = {_SERVE_OPS[c]: n for c, n in launches.items()}
        if ops != want_ops or convs != _SERVE_CONVS - replaced:
            raise AssertionError(f"{name}: the artifact's graph holds "
                                 f"{ops} and {convs} convolutions, "
                                 f"expected {want_ops} and "
                                 f"{_SERVE_CONVS - replaced}")

        def eager():
            with torch.no_grad():
                return model(x.permute(0, 3, 1, 2), None)

        def loaded():
            with torch.no_grad():
                return served(x)

        outs = []
        for what, fn in (("artifact", loaded), ("eager", eager)):
            reset_counts()
            outs.append(fn())
            torch.cuda.synchronize()
            _expect_counts(read_counts(), launches,
                           f"{name}: one {what} forward")
        (sh, sz), (h, z) = outs
        rel = max(_rel_norm(sh, h), _rel_norm(sz, z))
        err = max((sh - h).abs().max().item(), (sz - z).abs().max().item())
        if not (rel <= _SERVE_REL and sh.shape == h.shape
                and sz.shape == z.shape):
            raise AssertionError(f"{name}: the artifact is {rel:.2e} off "
                                 f"the eager forward")
        f32_err = {k: _rel_norm(a, b) for k, a, b in zip("hz", (h, z), exact)}
        if default is None:
            default = (h, z), f32_err
            vs_default = (f"; eager against float32 h {f32_err['h']:.2e}, "
                          f"z {f32_err['z']:.2e}")
        else:
            off = {k: _rel_norm(a, b) for k, a, b in zip("hz", (h, z),
                                                        default[0])}
            vs_default = (
                f"; eager against float32 h {f32_err['h']:.2e}, z "
                f"{f32_err['z']:.2e} (at most {_SERVE_F32_RATIO} x the "
                f"default path's), against the default path's h "
                f"{off['h']:.2e}, z {off['z']:.2e}")
            if not all(f32_err[k] <= _SERVE_F32_RATIO * default[1][k]
                       for k in "hz"):
                raise AssertionError(f"{name}{vs_default}: default "
                                     f"{default[1]}")
        fns = {"eager": eager, "artifact": loaded}
        # The host's times first: a profiler session just ended may still
        # slow its launches.
        host = {what: _enqueue_ms(torch, fn, iters=1)
                for what, fn in fns.items()}
        times = {}
        for what, fn in fns.items():
            ms = median_ms(torch, fn, iters=10)
            times[what] = (f"{512e3 / ms:.1f} images/s ({ms:.3f} ms a batch "
                           f"of 512 by events, "
                           f"{_forward_device_ms(torch, fn):.3f} device, "
                           f"{host[what]:.3f} host ms to enqueue)")
        size_mb = os.path.getsize(path) / 1e6
        print(f"  serving {name}: export {export_s:.1f} s, load "
              f"{load_s:.1f} s, artifact {size_mb:.1f} MB; eager "
              f"{times['eager']}, artifact {times['artifact']}; {rel:.2e} "
              f"off in relative norm, max |diff| {err:.2e}{vs_default}; on "
              f"{smi}", flush=True)
        done.append(f"{name} {rel:.2e} (max |diff| {err:.2e}), "
                    f"launches {launches or 'none'}{vs_default}")
        del model, served, outs, h, z, sh, sz
        os.remove(path)
        _release(torch, {})
    return {"summary": f"batch 512, h and z of each loaded artifact against "
                       f"the eager forward in relative norm (tol "
                       f"{_SERVE_REL}) and the port's kernels it launched: "
                       + "; ".join(done)}


def _epoch_categories(torch, prof, span, steps):
    """Device ms a step by kernel category (``_by_category``) of the
    kernels that started inside the annotation ``span``, over ``steps``
    steps."""
    from torch.autograd import DeviceType
    events = prof.events()
    t0, t1 = next((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU and e.name == span)
    by_name = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and t0 <= e.time_range.start
                <= t1 and not e.name.startswith(("train_epoch ",
                                                 "eval_epoch "))):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    return ", ".join(f"{c} {ms / steps:.2f}"
                     for c, ms in _by_category(by_name))


@phase("stl10")
def stl10_phase(torch, smi, tmp):
    """STL-10 at 96x96 (``Config.for_dataset('stl10')``: the 7x7 stride-2
    stem, the 3x3 max-pool, the 9-tap blur) at full width and batch 256 on
    2,048 synthetic 96x96 images on the card (80/20 split: 6 steps an
    epoch and a one-batch validation epoch): ``pretrain()`` for 2 epochs
    under torch.profiler, every step a graph replay but the warm-up ones.
    The counts: B1f and B1b once and B2 twice in each eager step and the
    capture, B1f once and B2 twice in each validation step; every loss
    finite. Then augmented pairs/s at 96x96 (``scripts/stl10_artifact.
    py``: 20 calls, one synchronisation, median of 3; B2 160 launches in
    all) and a short ``linear_evaluation`` (top-1 a floor on synthetic
    data)."""
    from torch.profiler import ProfilerActivity, profile
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import (
        DeviceDataset, Split, split_indices)
    from simclr_tpu_torch.ops.augment import gaussian_kernel_size
    from simclr_tpu_torch.scripts.stl10_artifact import aug_pairs_per_sec
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    from simclr_tpu_torch.train.lin_eval import linear_evaluation
    from simclr_tpu_torch.train.pretrain import pretrain

    base = Config.for_dataset("stl10")
    cfg = base.replace(
        train=dataclasses.replace(base.train, n_epoch=2, batch_size=256,
                                  save_ckpt=False, n_epoch_lin_eval=2),
        out_dir=f"{tmp}/stl10")
    if (cfg.model.low_quality_img or cfg.dataset.img_size != 96
            or gaussian_kernel_size(96) != 9):
        raise AssertionError("not the STL-10 configuration")
    images, labels = synthetic_dataset(2048, img_size=96, seed=0)
    tr, va = split_indices(2048, 0.2)
    split = Split(DeviceDataset.from_numpy(images[tr], labels[tr], "cuda"),
                  DeviceDataset.from_numpy(images[va], labels[va], "cuda"))
    del images
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = pretrain(cfg, split, log=lines.append, save_plots=False,
                       device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    eager = WARMUP_STEPS + 1
    val_steps = cfg.train.n_epoch * (split.val.n // 256)
    _expect_counts(counts, {"ntxent_fwd": eager + val_steps,
                            "ntxent_bwd": eager,
                            "color": 2 * (eager + val_steps)},
                   "STL-10 pretrain")
    hist = run.history.to_dict()
    values = [v for k in ("loss", "accuracy") for s in hist[k].values()
              for v in s]
    if len(hist["loss"]["train"]) != 2 or not all(
            math.isfinite(v) for v in values):
        raise AssertionError(f"STL-10 history {hist}")
    busy = _busy_by_epoch(torch, prof)
    wall_us, busy_us = busy["train_epoch 2"]
    cats = _epoch_categories(torch, prof, "train_epoch 2", 6)

    reset_counts()
    pairs = aug_pairs_per_sec(cfg, split.train.images[:256])
    _expect_counts(read_counts(), {"color": 160}, "augmentation rate")
    lin_lines = []
    loss, acc = linear_evaluation(run.state.model, split.train, split.val,
                                  cfg, log=lin_lines.append)
    if not (math.isfinite(loss) and math.isfinite(acc)):
        raise AssertionError(f"linear evaluation: {lin_lines}")
    print(f"  stl10: {run.steady_steps_per_sec:.3f} steps/s in epoch 2 "
          f"(batch 256, 512 images of 96x96 a step; "
          f"{run.steps_per_sec:.3f} with epoch 1's warm-up and capture), "
          f"device busy {100 * busy_us / wall_us:.1f}% of epoch 2's "
          f"{wall_us / 1e3:.1f} ms (profiled); peak {peak[0]:.2f} GiB "
          f"allocated, {peak[1]:.2f} GiB reserved; augmentation "
          f"{pairs:.1f} pairs/s at 96x96; on {smi}")
    print(f"  stl10: device ms a replayed step by category (epoch 2): "
          f"{cats}")
    print(f"  stl10: linear evaluation top-1 {acc:.2f}% (a floor on "
          f"synthetic data, not an accuracy), loss {loss:.4f}; "
          f"{lin_lines[0]}")
    del run, split
    _release(torch, {})
    return {"summary": f"2 epochs of 6 steps (train losses "
                       f"{[round(v, 4) for v in hist['loss']['train']]}, "
                       f"valid {[round(v, 4) for v in hist['loss']['valid']]}"
                       f"); B1f {counts['ntxent_fwd']}, B1b "
                       f"{counts['ntxent_bwd']}, B2 {counts['color']} "
                       f"launches (eager steps, capture, validation); "
                       f"{pairs:.1f} aug pairs/s; top-1 {acc:.2f}%"}


# ---------------------------------------------------------------------------
# Host streaming, the C++ data plane and data parallelism.
# ---------------------------------------------------------------------------

def _cifar_files(root, np, n=64):
    """CIFAR-10 binary batches and an STL-10 file with labels, random."""
    import os
    rng = np.random.RandomState(0)
    d = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(d)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        np.concatenate([rng.randint(0, 10, (n, 1)),
                        rng.randint(0, 256, (n, 3072))], 1).astype(
            np.uint8).tofile(os.path.join(d, name))
    s = os.path.join(root, "stl10_binary")
    os.makedirs(s)
    rng.randint(0, 256, (16, 3, 96, 96)).astype(np.uint8).tofile(
        os.path.join(s, "train_X.bin"))
    rng.randint(1, 11, 16).astype(np.uint8).tofile(
        os.path.join(s, "train_y.bin"))
    return d, s


@phase("native")
def native_phase(torch, smi):
    """The port's C++ data plane on the card's host: it must build (no
    numpy fallback here); its decoders must give the numpy decoders'
    bytes and ``NativePipeline``'s batches the rows of a numpy gather by
    their labels, every row once an epoch; then its batches/s at batch 512
    over 50,000 CIFAR-shaped images (host only, ``next(copy=False)``) and
    with the copy to the card (``next_device()``, synchronised at the
    end)."""
    import os
    import numpy as np
    from simclr_tpu_torch.data import datasets, native

    t0 = time.perf_counter()
    if native.load_library() is None:
        raise AssertionError("the native data plane did not build")
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    try:
        cifar, stl = _cifar_files(tmp, np)
        for train in (True, False):
            got = native.decode_cifar10_binary(cifar, train)
            want = datasets._cifar10_binary_numpy(cifar, train)
            if got is None or not all(np.array_equal(a, b)
                                      for a, b in zip(got, want)):
                raise AssertionError("CIFAR-10 decode differs from numpy")
        x, y = os.path.join(stl, "train_X.bin"), os.path.join(stl,
                                                               "train_y.bin")
        got, want = native.decode_stl10(x, y, 16), datasets._stl10_numpy(x, y)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("STL-10 decode differs from numpy")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n, batch = 50_000, 512
    images = np.random.default_rng(0).integers(0, 256, (n, 32, 32, 3),
                                               dtype=np.uint8)
    labels = np.arange(n, dtype=np.int32)
    with native.NativePipeline(images, labels, batch, seed=0,
                               device="cuda") as pipe:
        seen = []
        for _ in range(pipe.steps_per_epoch):
            imgs, labs = pipe.next(copy=False)
            if not np.array_equal(imgs, images[labs]):
                raise AssertionError("a batch is not the gather of its rows")
            seen.append(labs.copy())
        seen = np.concatenate(seen)
        if len(np.unique(seen)) != len(seen) or len(seen) != (
                n // batch) * batch:
            raise AssertionError("an epoch did not take each row once")
        steps = 2 * pipe.steps_per_epoch
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.next(copy=False)
        host_rate = steps / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            d_imgs, _ = pipe.next_device()
        torch.cuda.synchronize()
        device_rate = steps / (time.perf_counter() - t0)
        if not torch.equal(d_imgs.cpu(), torch.from_numpy(
                pipe._out[(pipe._slot ^ 1)][0].numpy())):
            raise AssertionError("the card's batch differs from the host's")
    return {"host_rate": host_rate, "device_rate": device_rate,
            "summary": f"built in {build_s:.2f} s; decoders equal numpy; "
                       f"NativePipeline at batch {batch} over {n} images: "
                       f"{host_rate:.1f} batches/s on the host, "
                       f"{device_rate:.1f} batches/s with the copy to the "
                       f"card (pinned buffers, side stream), on {smi}"}


def _counted_run(torch, per_step, captures, fn):
    """fn() with the launch counts set to 0 just before and read just
    after; each counter must show its launches a step times the eager
    steps and captures (WARMUP_STEPS + ``captures``), every other 0."""
    from simclr_tpu_torch.train.common import WARMUP_STEPS
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    for name, count in counts.items():
        want = per_step.get(name, 0) * (WARMUP_STEPS + captures)
        if count != want:
            raise AssertionError(f"{name}: {count} launches, expected "
                                 f"{per_step.get(name, 0)} a step: {counts}")
    return out, counts


def _state_bits(model, opt):
    out = {f"m.{k}": v for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        out.update({f"o.{i}.{k}": v for k, v in st.items()})
    return out


@phase("streaming")
def streaming_phase(torch, smi):
    """``pretrain_streaming`` at full width (``Config()``, batch 512) on
    4,096 synthetic CIFAR-shaped images, 3 epochs of 8 steps, with the
    numpy feed and with the native pipeline: every step a replay of one
    captured step but the first epoch's 2 eager ones, B1f/B1b 1 and B2 2
    a step (counted in the eager steps and the capture), finite losses;
    steps/s of the last two epochs. Then, with cuDNN deterministic, one
    streamed epoch (``train_stream`` over ``host_stream``) against one
    resident ``train_epoch`` from the same weights, permutation and
    generator: parameters, buffers and Adam state bit for bit; a second
    resident epoch gives the resident steps/s; and 4 streamed steps under
    the profiler give the device's busy share (kernels and the
    device-to-device copy into the graph's batch, not the host-to-device
    copies, which run on the side stream beside them) and the
    host-to-device copy time a step."""
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import epoch_permutation, host_stream
    from simclr_tpu_torch.train.pretrain import (
        build_engine, epoch_seed, init_simclr)
    from simclr_tpu_torch.train.streaming import pretrain_streaming

    cfg = Config()
    batch = cfg.train.batch_size
    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    rates, notes = {}, []
    for feed in ("numpy", "native"):
        res, _ = _counted_run(torch, _PER_STEP, 1, lambda: pretrain_streaming(
            cfg, images, labels, n_epochs=3,
            use_native_pipeline=feed == "native", log=lambda _: None))
        losses = res.history.loss["train"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{feed}: losses {losses}")
        rates[feed] = res.steady_steps_per_sec
        notes.append(f"{feed} feed: epoch losses "
                     f"{[round(v, 4) for v in losses]}, "
                     f"{res.steady_steps_per_sec:.3f} steps/s")
        del res
        _release(torch, {})

    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        runs = {}
        d_images = torch.from_numpy(images).cuda()
        like = torch.empty((batch, 32, 32, 3), dtype=torch.uint8,
                           device="cuda")
        for kind in ("resident", "streamed"):
            model, state, opt = init_simclr(cfg, 0, "cuda")
            engine = build_engine(cfg, model, opt)
            gen = torch.Generator(device="cuda").manual_seed(
                epoch_seed(0, 0))
            if kind == "resident":
                idx = epoch_permutation(gen, 4096, batch)
                state, (losses, _) = engine.train_epoch(state, d_images, idx,
                                                        gen)
            else:
                batches = (b for b, _ in host_stream(images, labels, batch,
                                                     gen))
                state, (losses, _) = engine.train_stream(state, batches, 8,
                                                         like, gen)
            torch.cuda.synchronize()
            runs[kind] = (losses.cpu(), _state_bits(model, opt), engine,
                          state, gen)
        (l0, s0, eng_r, st_r, gen_r), (l1, s1, eng_s, st_s, gen_s) = (
            runs["resident"], runs["streamed"])
        same = torch.equal(l0, l1) and s0.keys() == s1.keys() and all(
            torch.equal(s0[k], s1[k]) for k in s0)
        if not same:
            bad = [k for k in s0 if not torch.equal(s0[k], s1[k])][:5]
            raise AssertionError(f"streamed epoch differs from resident: "
                                 f"losses {l0.tolist()} vs {l1.tolist()}, "
                                 f"first differing {bad}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    # The resident rate: a second epoch of replays.
    gen_r.manual_seed(epoch_seed(0, 1))
    idx = epoch_permutation(gen_r, 4096, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng_r.train_epoch(st_r, d_images, idx, gen_r)[1][0].cpu()
    rates["resident"] = 8 / (time.perf_counter() - t0)
    # A profiled streamed run of 4 replays.
    gen_s.manual_seed(epoch_seed(0, 1))
    stream = host_stream(images[:4 * batch], labels[:4 * batch], batch,
                         gen_s)
    prof, wall_ms, by_name = _profiled(
        torch, lambda: eng_s.train_stream(st_s, (b for b, _ in stream), 4,
                                          like, gen_s))
    h2d = sum(ms for name, ms in by_name.items() if "HtoD" in name)
    busy = sum(ms for name, ms in by_name.items() if "HtoD" not in name)
    named = _named_launches(prof)
    if named["ntxent_fwd"] != 4 or named["color"] != 8:
        raise AssertionError(f"replays ran kernels by name {named}")
    del runs, eng_r, eng_s, st_r, st_s, d_images
    _release(torch, {})
    return {"rates": rates, "busy": 100 * busy / wall_ms,
            "h2d_ms": h2d / 4,
            "summary": "; ".join(notes) + f"; streamed epoch == resident "
                       f"epoch bit for bit (losses, parameters, buffers, "
                       f"Adam state); resident {rates['resident']:.3f} "
                       f"steps/s; profiled streamed steps: wall "
                       f"{wall_ms / 4:.2f} ms/step, device busy "
                       f"{busy / 4:.2f} ms/step ({100 * busy / wall_ms:.1f}%"
                       f"), host-to-device copies {h2d / 4:.3f} ms/step "
                       f"(side stream); on {smi}"}


# The two-rank gloo check on the card (width 16, float32, batch 32, one
# SGD step): the ranks score their rows with the plain float32 local loss,
# one process the global batch through kernel B1 (3xTF32, within 1.9e-6
# of plain), and every BN's statistics are summed in another order. The
# loss within 1e-5 relative. The parameters' distance from the one
# process's, over the whole tree, within 1e-2 of the step's change: on the
# CPU this configuration gives 1.4e-3 (the pieces alone, the gathered
# loss and an axis BN at (64, 16, 32, 32), agree to 1e-7; one process
# against itself on the batch in reverse order, 8.8e-5): a pre-activation
# within rounding of 0 flips its ReLU mask, and the step's gradient at
# init is a small difference of large terms. The head's hidden bias, zero
# in exact arithmetic (a BN follows), within 1e-6 absolute.
_GLOO_LOSS_RTOL, _GLOO_STEP_REL, _GLOO_NOISE_ATOL = 1e-5, 1e-2, 1e-6
_GLOO_NOISE = ("g.linear0.bias",)


def _gloo_config():
    from simclr_tpu_torch.config import Config, ModelConfig
    cfg = Config(model=ModelConfig(
        feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16,
        compute_dtype="float32", bn_dtype="float32", bn_stats_fraction=1.0))
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=32))


def _gloo_step(mesh, images):
    """One SGD step of the width-16 float32 model on the global batch,
    through the explicit engine on ``mesh`` (a rank of the gloo group) or
    the one-device engine (``mesh`` None); (loss, parameters, launches)."""
    import torch
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _gloo_config()
    model, state, _ = init_simclr(cfg, 0, "cuda:0", mesh=mesh)
    start = {k: v.detach().cpu().numpy().copy() for k, v in
             model.named_parameters()}
    sgd = torch.optim.SGD(model.parameters(), lr=0.05)
    engine = build_engine(cfg, model, sgd, mesh=mesh)
    reset_counts()
    state, (loss, _) = engine.train_step_on_batch(
        state, torch.from_numpy(images).to("cuda:0"),
        torch.Generator(device="cuda:0").manual_seed(3))
    torch.cuda.synchronize()
    return (loss.item(), {k: v.detach().cpu().numpy() for k, v in
                          model.named_parameters()}, read_counts(), start)


def _copy_state(torch, dst, src):
    """Copy one engine's model and Adam state into another's, in place
    (the addresses a captured step reads stay the same)."""
    with torch.no_grad():
        dst_sd, src_sd = dst.model.state_dict(), src.model.state_dict()
        for k, v in src_sd.items():
            dst_sd[k].copy_(v)
        for pd, ps in zip(dst.model.parameters(), src.model.parameters()):
            for k, v in src.optimizer.state[ps].items():
                dst.optimizer.state[pd][k].copy_(v)


def _gloo_check(torch):
    """Two gloo ranks in two processes on this card against one process
    on the global batch (``_gloo_step``); a summary line. Restores the
    cuDNN determinism setting it changes."""
    import numpy as np
    from simclr_tpu_torch.parallel.launch import spawn_ranks
    small = np.random.RandomState(0).randint(0, 256, (32, 32, 32, 3)).astype(
        np.uint8)
    two = spawn_ranks(_gloo_step, 2, small, timeout=300, device="cuda:0",
                      backend="gloo", threads=0)
    deterministic = torch.backends.cudnn.deterministic
    try:
        one_loss, one_params, _, one_start = _gloo_step(None, small)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bad, rels = [], []
    keys = [k for k in one_params if k not in _GLOO_NOISE]
    step = math.sqrt(sum(float(np.sum((one_params[k] - one_start[k]) ** 2))
                         for k in keys))
    for loss, params, counts, _ in two:
        if abs(loss - one_loss) > _GLOO_LOSS_RTOL * abs(one_loss):
            bad.append(f"loss {loss} vs {one_loss}")
        if counts["color"] != 2 or counts["ntxent_fwd"]:
            bad.append(f"launches {counts}")
        apart = math.sqrt(sum(float(np.sum((params[k] - one_params[k]) ** 2))
                              for k in keys))
        rels.append(apart / step)
        if rels[-1] > _GLOO_STEP_REL:
            bad.append(f"parameters {rels[-1]:.3e} of the step apart")
        for k in _GLOO_NOISE:
            if np.abs(params[k] - one_params[k]).max() > _GLOO_NOISE_ATOL:
                bad.append(f"{k} apart")
    if bad:
        raise AssertionError(f"gloo ranks against one process: {bad}; "
                             f"losses {[t[0] for t in two]} vs {one_loss}")
    return (f"two gloo ranks on this card, width 16 float32: losses "
            f"{[round(t[0], 7) for t in two]} vs one process "
            f"{one_loss:.7f}; after one SGD step the parameters "
            f"{max(rels):.2e} of the step's change apart")


@phase("parallel")
def parallel_phase(torch, smi):
    """(a) A one-rank NCCL group in this process: the explicit engine at
    full width (``Config()``, batch 512; the NCCL all-reduces of the BN
    moments, the projections' gather and the gradients inside the
    captured step) against the one-device engine, one row at a time, each
    step from the same state (the one-device engine's model and Adam state
    copied into the explicit one's tensors before it): the first step
    eager, the others replays of each engine's captured step; each loss
    within 1e-3 relative (B1 against the plain local loss; from one state
    to the next the two part, as Adam's first steps amplify float32 noise,
    so the states are re-aligned). B2 2 a step and no B1 on the explicit
    engine (counted in its eager step and its capture); steps/s of 8
    replays and the busy share of 2 profiled replays. (b) Two gloo ranks
    in two processes on this card (NCCL refuses two ranks on one GPU),
    width 16, float32, one eager SGD step of the explicit engine against
    one process on the global batch (``_GLOO_*`` tolerances)."""
    import torch.distributed as dist
    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import DeviceDataset, epoch_permutation
    from simclr_tpu_torch.parallel.mesh import make_mesh
    from simclr_tpu_torch.train.pretrain import build_engine, init_simclr

    cfg = Config()
    batch = cfg.train.batch_size
    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    ds = DeviceDataset.from_numpy(images, labels, "cuda")
    mesh = make_mesh(1, device="cuda")
    try:
        run = {}
        for kind in ("one_device", "explicit"):
            on = mesh if kind == "explicit" else None
            model, state, opt = init_simclr(cfg, 0, "cuda", mesh=on)
            run[kind] = (build_engine(cfg, model, opt, mesh=on), state,
                         torch.Generator(device="cuda").manual_seed(1))
        idx = torch.cat([epoch_permutation(run["explicit"][2], 4096, batch)
                         for _ in range(2)])
        run["one_device"][2].manual_seed(1)
        run["explicit"][2].manual_seed(1)
        losses = {k: [] for k in run}
        counts = {}
        for i in range(5):
            _copy_state(torch, run["explicit"][0], run["one_device"][0])
            for kind, (engine, state, gen) in run.items():
                if kind == "explicit":
                    reset_counts()
                _, (loss, _) = engine.train_epoch(state, ds.images,
                                                  idx[i:i + 1], gen)
                losses[kind].append(loss.item())
                if kind == "explicit":
                    counts = {k: counts.get(k, 0) + v
                              for k, v in read_counts().items()}
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses["explicit"],
                                                       losses["one_device"]))
        if not diff <= 1e-3:
            raise AssertionError(f"explicit {losses['explicit']} vs "
                                 f"one-device {losses['one_device']}")
        # One eager step and the capture, each 2 B2 and no B1.
        if counts != {k: (4 if k == "color" else 0) for k in counts}:
            raise AssertionError(f"explicit engine launches {counts}")
        engine, state, gen = run.pop("explicit")
        run.clear()
        _release(torch, {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_epoch(state, ds.images, idx[5:13], gen)[1][0].cpu()
        rate = 8 / (time.perf_counter() - t0)
        _, wall_ms, by_name = _profiled(
            torch, lambda: engine.train_epoch(state, ds.images, idx[13:15],
                                              gen))
        busy = sum(by_name.values())
        nccl = sum(ms for n, ms in by_name.items() if "nccl" in n.lower())
        del engine, state, ds
    finally:
        dist.destroy_process_group()
    _release(torch, {})
    gloo = _gloo_check(torch)
    return {"rate": rate, "busy": 100 * busy / wall_ms,
            "summary": f"(a) one-rank NCCL explicit engine, ResNet-50 "
                       f"batch 512, each step from the one-device "
                       f"engine's state: losses "
                       f"{[round(v, 6) for v in losses['explicit']]} vs "
                       f"{[round(v, 6) for v in losses['one_device']]} "
                       f"(max rel diff {diff:.2e}); {rate:.3f} steps/s; 2 "
                       f"profiled replays: wall {wall_ms / 2:.2f} ms/step, "
                       f"device busy {busy / 2:.2f} ms/step "
                       f"({100 * busy / wall_ms:.1f}%), NCCL kernels "
                       f"{nccl / 2:.3f} ms/step; launches {counts}. (b) "
                       f"{gloo}; on {smi}"}


# The measure phase: a bench_variants variant on each kernel path, with the
# launches a step each wrapper must show besides _PER_STEP.
_MEASURE_VARIANTS = {
    "unfused": {},
    "bnrelu": {"bn_bwd_relu": 32, "bn_bwd_add_relu": 16,
               "bn_bwd_norelu": 4},
    "conv64": {"conv64_fwd": 6, "conv64_wgrad": 3},
    "winograd": {"winograd_fwd": 20, "winograd_dw": 10},
    "fuse64": {"bottleneck_fwd": 12, "bottleneck_bwd": 12},
}
_MEASURE_RATE_REL = 0.10   # unfused against the slice phase's steps/s
_MEASURE_BUSY_REL = 0.05   # profile_step against the profile phase's busy
# What a freed variant may leave allocated: B6's packing indices (its
# wrapper's lru_cache, 45.8 MiB over the four widths and both halves).
_MEASURE_LEFT_MIB = 64.0


@phase("measure")
def measure_phase(torch, smi, slice_rate, profile_busy):
    """The four measurement harnesses' functions on the card
    (``simclr_tpu_torch/scripts/``): ``bench_variants`` on a variant of
    each kernel path at batch 512 (6 steps, 2 timed epochs) over 4,096
    synthetic images, each wrapper's launches counted in the eager steps
    and the capture, each loss finite, each freed engine's memory given
    back, ``unfused`` within 10% of the slice phase's steps/s;
    ``profile_step`` on ``unfused`` (6 traced replays, the costs of one
    eager step), its device-busy ms a step within 5% of the profile
    phase's and a roofline floor over some of it;
    ``bn_relu_microbench`` at its four shapes and ``bench_winograd`` at
    layers 2-4, each checked against its plain version or cuDNN before it
    is timed, with its launch counts."""
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.scripts import (
        bench_variants, bench_winograd, bn_relu_microbench, profile_step)
    from simclr_tpu_torch.train.common import WARMUP_STEPS

    images = torch.from_numpy(synthetic_dataset(4096, img_size=32,
                                                seed=0)[0]).to("cuda")
    rows = {}
    for name, extra in _MEASURE_VARIANTS.items():
        reset_counts()
        row = bench_variants.bench_variant(name, images, 512, 6, 2)
        counts = read_counts()
        want = {**_PER_STEP, **extra}
        for c, n in counts.items():
            if n != want.get(c, 0) * (WARMUP_STEPS + 1):
                raise AssertionError(f"{name}: {c} launched {n} times, "
                                     f"expected {want.get(c, 0)} a step; "
                                     f"{counts}")
        if not math.isfinite(row["loss"]):
            raise AssertionError(f"{name}: loss {row['loss']}")
        if row["left_mib"] > _MEASURE_LEFT_MIB:
            raise AssertionError(f"{name}: {row['left_mib']:.1f} MiB left "
                                 "allocated after its engine was freed")
        rows[name] = row
        print(f"  {bench_variants.format_row(row)}", flush=True)
    rate = rows["unfused"]["steps_per_s"]
    if abs(rate - slice_rate) > _MEASURE_RATE_REL * slice_rate:
        raise AssertionError(f"bench_variants unfused {rate:.3f} steps/s, "
                             f"the slice phase {slice_rate:.3f}")
    logdir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        report = profile_step.profile_variant(
            "unfused", images, 512, 6, 20, logdir,
            out=lambda line: print(f"  {line}", flush=True))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    busy = report["device_ms"]
    if abs(busy - profile_busy) > _MEASURE_BUSY_REL * profile_busy:
        raise AssertionError(f"profile_step busy {busy:.2f} ms/step, the "
                             f"profile phase {profile_busy:.2f}")
    if not report["floor_ms"] > 0.0:
        raise AssertionError("profile_step found no op's cost")
    del images
    gc.collect()
    torch.cuda.empty_cache()
    out = lambda line: print(f"  {line}", flush=True)  # noqa: E731
    b3 = bn_relu_microbench.run(20, "cuda", compiled=False, out=out)
    b5 = bench_winograd.run(10, "cuda", out=out)
    b3_first = next(r for r in b3 if r["call"] == "kernel")
    b5_l2 = {r["conv"]: r for r in b5 if r["shape"] == "layer2"}
    return {"rows": rows, "profile": report, "b3": b3, "b5": b5,
            "summary": "bench_variants " + ", ".join(
                f"{n} {r['steps_per_s']:.3f}" for n, r in rows.items())
                + f" steps/s (slice {slice_rate:.3f}); profile_step busy "
                f"{busy:.2f} ms/step (profile phase {profile_busy:.2f}), "
                f"floor {report['floor_ms']:.2f} over "
                f"{report['covered_ms']:.2f}; B3b at "
                f"{b3_first['shape']} {b3_first['ms']:.4f} ms (bound "
                f"{b3_first['bound_ms']:.4f}); layer2 fwd+bwd winograd "
                f"{b5_l2['winograd']['fwd_bwd_ms']:.4f} ms, cuDNN "
                f"{b5_l2['direct']['fwd_bwd_ms']:.4f} ms; on {smi}"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    import simclr_tpu_torch  # noqa: F401  (fails outside the repository)

    info = env(torch)
    if sys.argv[1:] == ["b6_trace"]:
        b6_trace_phase(torch)
        return 0
    if sys.argv[1:] == ["color"]:
        # Only B2's checks and times, e.g. on an archive of an earlier
        # tree, for a before/after comparison in one call.
        color_phase(torch)
        return 0
    if sys.argv[1:] == ["b2_trace"]:
        b2_trace(torch)
        return 0
    if sys.argv[1:] == ["measure"]:
        # The measure phase and the default slice it is compared with.
        build()
        sl = slice_phase(torch, info["smi"])
        prof = profile_phase(torch, sl)
        rate = sl["steps_per_s"]
        _release(torch, sl)
        measure_phase(torch, info["smi"], rate, prof["busy_ms"])
        return 0
    if sys.argv[1:] == ["serving"]:
        # The serving phase straight after the pretrain phase whose export
        # it serves, three times over in one process.
        build()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
        try:
            pre = pretrain_phase(torch, info["smi"], tmp)
            for _ in range(3):
                serving_phase(torch, info["smi"], pre, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["b6_split"]:
        # Only B6's time split (see _b6_split), e.g. on an archive of an
        # earlier tree, for a before/after comparison in one call.
        from simclr_tpu_torch.ops.kernels import _build
        log = (_build.build().parent / "build.log").read_text()
        for name, frame, usage in _ptxas_usage(log):
            if "bottleneck" in name:
                print(f"  ptxas: {name}: {usage}; {frame}")
        b6_split_phase(torch)
        return 0
    built = build()
    nt = ntxent_phase(torch)
    col = color_phase(torch)
    b3 = bn_relu_phase(torch)
    sl = slice_phase(torch, info["smi"])
    default_busy = profile_phase(torch, sl)["busy_ms"]
    default_launches, default_rate = sl["launches"], sl["steps_per_s"]
    _release(torch, sl)
    bsl = bnrelu_slice_phase(torch, info["smi"])
    bnrelu_profile_phase(torch, bsl)
    b3_launches = bsl["launches"]
    _release(torch, bsl)
    conv = conv_phase(torch)
    csl = conv_slice_phase(torch, info["smi"])
    conv_profile_phase(torch, csl)
    conv_launches = csl["launches"]
    _release(torch, csl)
    b6 = bottleneck_phase(torch, built["ptxas"])
    b6_split_phase(torch)
    fsl = fused_slice_phase(torch, info["smi"])
    fused_profile_phase(torch, fsl)
    fused_launches = fsl["launches"]
    _release(torch, fsl)
    osl = optin_fold_phase(torch, info["smi"])
    optin_fold_profile_phase(torch, osl)
    _release(torch, osl)
    osl = optin_accum_phase(torch, info["smi"])
    optin_accum_profile_phase(torch, osl)
    _release(torch, osl)
    optin_phase(torch)
    parity_phase(torch)
    graph_phase(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        pre = pretrain_phase(torch, info["smi"], tmp)
        lin_eval_phase(torch, info["smi"], pre)
        ssl_phase(torch, info["smi"], pre)
        supervised_phase(torch, info["smi"], pre)
        mine_phase(torch, info["smi"], pre)
        analysis_phase(torch, info["smi"], pre)
        serving_phase(torch, info["smi"], pre, tmp)
        stl10_phase(torch, info["smi"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    native_phase(torch, info["smi"])
    streaming_phase(torch, info["smi"])
    parallel_phase(torch, info["smi"])
    measure_phase(torch, info["smi"], default_rate, default_busy)

    src = "simclr_tpu_torch/csrc/"
    b3_src = "simclr_tpu/ops/pallas/bn_relu.py:"
    rows = [
        dict(name="ntxent_fwd", src=src + "ntxent.cu",
             replaces="simclr_tpu/ops/pallas/ntxent.py:114",
             launches=default_launches["ntxent_fwd"], **nt["fwd"]),
        dict(name="ntxent_bwd", src=src + "ntxent.cu",
             replaces="simclr_tpu/ops/pallas/ntxent.py:137",
             launches=default_launches["ntxent_bwd"], **nt["bwd"]),
        dict(name="color", src=src + "color.cu",
             replaces="simclr_tpu/ops/pallas/color.py:195",
             launches=default_launches["color"], **col["timing"]),
        dict(name="bn_bwd_relu", src=src + "bn_relu.cu",
             replaces=b3_src + "113", launches=b3_launches["bn_bwd_relu"],
             **b3["timing"]["relu"]),
        dict(name="bn_bwd_add_relu", src=src + "bn_relu.cu",
             replaces=b3_src + "129",
             launches=b3_launches["bn_bwd_add_relu"],
             **b3["timing"]["add_relu"]),
        dict(name="bn_bwd_norelu", src=src + "bn_relu.cu",
             replaces=b3_src + "98", launches=b3_launches["bn_bwd_norelu"],
             **b3["timing"]["none"]),
    ]
    for name, src_file, replaces in (
            ("conv64_fwd", "conv64.cu", "conv64.py:160"),
            ("conv64_wgrad", "conv64.cu", "conv64.py:250"),
            ("winograd_fwd", "winograd.cu", "winograd.py:218"),
            ("winograd_dw", "winograd.cu", "winograd.py:238")):
        rows.append(dict(name=name, src=src + src_file,
                         replaces="simclr_tpu/ops/pallas/" + replaces,
                         launches=conv_launches[name],
                         **conv["timing"][name]))
    for name, replaces in (("bottleneck_fwd", "213"),
                           ("bottleneck_bwd", "237")):
        rows.append(dict(name=name, src=src + "bottleneck.cu",
                         replaces="simclr_tpu/ops/pallas/bottleneck.py:"
                                  + replaces,
                         launches=fused_launches[name],
                         **b6["timing"][name]))
    kernels = [{"name": r["name"], "route": "cuda", "source": r["src"],
                "replaces": r["replaces"], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms")}
               for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
