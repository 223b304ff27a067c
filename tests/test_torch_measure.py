"""The port's measurement harnesses (``simclr_tpu_torch/scripts/
{bench_variants,profile_step,bn_relu_microbench,bench_winograd}.py``) and
its public names, on the CPU, held against the JAX package.

* ``VARIANTS`` equals ``scripts/bench_variants.py``'s, key for key and in
  order; every variant builds through ``init_simclr`` at stage sizes
  (1, 1, 1, 1) and width 4 and one forward of two views gives a finite
  loss.
* ``parse_trace`` on a synthetic Chrome trace with known events: device
  busy, families, categories, the side-stream row and the roofline floor,
  exactly; ``family`` and ``_op_cost`` on known names and a known
  convolution; a real CPU trace through ``--parse_only``.
* The microbenchmark's B3b inputs at (2048, 256): the port's plain
  ``bwd_add_relu_plain`` against JAX's ``_xla_bwd_add_relu`` and against
  ``_run_bwd(_bwd_kernel_add_relu, ..., interpret=True)``: dx and dskip
  equal (the same bf16 products), S1 and S2 within 2e-5 of the sum of
  their |terms| plus 1e-6 (float32 sums in another order), as the card's
  check.
* ``winograd_conv3x3`` at layer2's width and a batch of 2, bf16, forward
  and VJP, against JAX's ``winograd_conv3x3(..., interpret=True)``
  (``tests/test_torch_conv.py``'s bounds: y and dx within 2e-3 in relative
  norm and 2e-2 of the largest entry, dw within 1e-2 in norm) and against
  ``F.conv2d`` (``bench_winograd.check_forward``).
* Each port ``__init__``'s ``__all__`` equals the JAX one's, read with
  ``ast`` (no JAX module imported for it), and every name resolves.
* Each harness's ``main()`` with ``--device cpu`` at the smallest sizes
  prints its line with its fields; the default device raises here.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import importlib.util
import io
import json
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.ops.pallas import bn_relu as jbn
from simclr_tpu.ops.pallas import winograd as jwg
from simclr_tpu_torch.ops.kernels import bn_relu as tbn
from simclr_tpu_torch.ops.kernels import winograd as twg
from simclr_tpu_torch.parallel import mesh as tmesh
from simclr_tpu_torch.scripts import (
    bench_variants, bench_winograd, bn_relu_microbench, profile_step)
from simclr_tpu_torch.train.pretrain import (
    _forward_pair, build_engine, init_simclr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("", "data", "models", "ops", "parallel", "train", "utils")
TINY = dict(batch=8, stage_sizes=(1, 1, 1, 1), width=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's thread pool costs more than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue().splitlines()


# ---------------------------------------------------------------------------
# VARIANTS and every variant's forward.
# ---------------------------------------------------------------------------

def test_variants_equal_the_jax_table():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_variants", os.path.join(ROOT, "scripts",
                                           "bench_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert bench_variants.VARIANTS == mod.VARIANTS
    assert list(bench_variants.VARIANTS) == list(mod.VARIANTS)
    assert len(bench_variants.VARIANTS) == 35


@pytest.fixture(scope="module")
def views():
    images = bench_variants.load_images(torch.device("cpu"), n_images=8)
    return images


@pytest.mark.parametrize("name", list(bench_variants.VARIANTS))
def test_every_variant_builds_and_gives_a_finite_loss(name, views):
    cfg = bench_variants.variant_config(name, **TINY)
    for key, value in bench_variants.VARIANTS[name].items():
        assert getattr(cfg.model, key) == value
    model, _, optimizer = init_simclr(cfg, seed=0, device="cpu")
    engine = build_engine(cfg, model, optimizer)
    gen = torch.Generator().manual_seed(0)
    pair = engine._views(views, engine.sample_pair_params(gen, 8, 32, 32))
    z1, z2 = _forward_pair(model, *pair)
    loss, _ = engine.loss_fn(z1, z2)
    assert z1.shape == (8, cfg.model.compressed_dim)
    assert math.isfinite(float(loss.detach()))


# ---------------------------------------------------------------------------
# profile_step: families, op costs, the trace parser.
# ---------------------------------------------------------------------------

_ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, "
                "c10::BFloat16, at::native::binary_internal::MulFunctor<float>"
                " >, std::array<char*, 3ul> >(int, at::native::BinaryFunctor"
                "<c10::BFloat16, c10::BFloat16, c10::BFloat16, at::native::"
                "binary_internal::MulFunctor<float> >, std::array<char*, 3ul>)")
_CONV = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
         "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel"
         "__5x_cudnn")
_B3 = "void (anonymous namespace)::bn_bwd_kernel<__nv_bfloat16, 1>(Args)"


def test_family_collapses_templates_parameters_and_suffixes():
    fam = profile_step.family
    assert fam(_ELEMENTWISE) == "at::native::vectorized_elementwise_kernel"
    assert fam(_CONV) == _CONV
    assert fam(_B3) == "bn_bwd_kernel"
    assert fam("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_"
               "bf16_64x64_32x6_tn_align8>(Params)") == (
        "cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_"
        "32x6_tn_align8>")
    assert fam("triton_poi_fused_add_12") == "triton_poi_fused_add"
    assert fam("Memcpy DtoD (Device -> Device)") == (
        "Memcpy DtoD (Device -> Device)")
    assert profile_step.category(_B3) == "bn_relu (B3)"
    assert profile_step.category(_CONV) == "convolution"
    assert profile_step.category("mystery") == "other"


def test_op_cost_of_a_convolution_and_a_gather():
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    conv = torch.ops.aten.convolution.default
    args = (x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1)
    out = conv(*args)
    c = profile_step._op_cost(conv, args, {}, out)
    assert c["bytes"] == 4 * (x.numel() + w.numel() + out.numel())
    assert c["flops"] == 2 * 2 * 4 * 3 * 9 * 8 * 8
    peak = (profile_step.PEAK_TF32_FLOPS if torch.backends.cudnn.allow_tf32
            else profile_step.PEAK_F32_FLOPS)
    assert c["floor_ms"] == pytest.approx(1e3 * max(
        c["bytes"] / profile_step.HBM_BYTES_PER_S, c["flops"] / peak))
    # A gather reads as many bytes of its source as it writes.
    src, idx = torch.randn(100, 4), torch.tensor([3, 7])
    gather = torch.ops.aten.index_select.default
    c = profile_step._op_cost(gather, (src, 0, idx), {},
                              gather(src, 0, idx))
    assert c["bytes"] == 2 * 4 * 4 + 2 * 8 + 2 * 4 * 4
    assert c["flops"] == 0.0


def _event(cat, name, ts, dur, stream=7, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0,
                tid=stream, args={"stream": stream}, **kw)


def test_parse_trace_on_known_events(tmp_path):
    events = [
        _event("kernel", _ELEMENTWISE, 0.0, 100.0),
        _event("kernel", _ELEMENTWISE.replace("MulFunctor", "AddFunctor"),
               100.0, 60.0),
        _event("kernel", _CONV, 200.0, 300.0),
        _event("kernel", _B3, 500.0, 40.0),
        _event("gpu_memset", "Memset (Device)", 540.0, 4.0),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 550.0, 6.0),
        # A copy on a side stream overlaps the step: its own row only.
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10.0, 50.0,
               stream=13),
        # Host events are not device time.
        _event("cuda_runtime", "cudaGraphLaunch", 0.0, 900.0, stream=1),
        _event("cpu_op", "aten::add", 0.0, 500.0, stream=1),
        dict(ph="i", cat="cpu_instant_event", name="marker", ts=5.0),
    ]
    (tmp_path / "host_1.123.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    fam_ew = "at::native::vectorized_elementwise_kernel"
    costs = {fam_ew: dict(bytes=3.2e8, flops=0.0, floor_ms=0.05, ops=2),
             _CONV: dict(bytes=1e6, flops=9.89e10, floor_ms=0.1, ops=1)}
    (tmp_path / "op_costs.json").write_text(json.dumps(costs))
    lines = []
    report = profile_step.parse_trace(str(tmp_path), 2, 10, out=lines.append)
    assert report["n_device_events"] == 7
    assert report["device_ms"] == pytest.approx(510.0 / 1e3 / 2)
    assert report["side_ms"] == pytest.approx(50.0 / 1e3 / 2)
    assert report["span_ms"] == pytest.approx(556.0 / 1e3 / 2)
    fams = {f["family"]: f for f in report["families"]}
    assert list(fams) == [_CONV, fam_ew, "bn_bwd_kernel",
                          "Memcpy DtoD (Device -> Device)",
                          "Memset (Device)"]
    assert fams[fam_ew]["ms"] == pytest.approx(0.08)
    assert fams[fam_ew]["calls"] == 1.0
    assert fams[_CONV]["pct"] == pytest.approx(100 * 300 / 510)
    assert fams["bn_bwd_kernel"]["floor_ms"] is None
    assert report["floor_ms"] == pytest.approx(0.15)
    assert report["covered_ms"] == pytest.approx(0.23)
    assert dict(report["categories"]) == pytest.approx({
        "convolution": 0.15, "elementwise": 0.08, "bn_relu (B3)": 0.02,
        "other": 0.005})
    table = {line.split()[-1]: line.split() for line in lines
             if line.split()[-1] in (fam_ew, "bn_bwd_kernel")}
    # ms/step, %dev, calls, GB/s, TF/s, xFloor.
    assert table[fam_ew][3:6] == ["4000", "0.0", "1.60"]
    assert table["bn_bwd_kernel"][3:6] == ["-", "-", "-"]
    assert any("side-stream copies (overlapped)" in line for line in lines)
    assert any("covering 0.230 of 0.255 device ms/step" in line
               for line in lines)


# ---------------------------------------------------------------------------
# The microbenchmarks' numerics against the JAX package.
# ---------------------------------------------------------------------------

def test_microbench_inputs_plain_version_matches_jax_and_its_kernel():
    i = bn_relu_microbench.make_inputs(2048, 256, "cpu")
    args = (i["g"], i["out"], i["x"], i["a32"], i["mean"], i["rsig"])
    got = tbn.bwd_add_relu_plain(*args)

    def jax_array(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jargs = [jax_array(t) for t in args]
    plain = jbn._xla_bwd_add_relu(*jargs)
    kernel = jbn._run_bwd(jbn._bwd_kernel_add_relu, jargs[:3], jargs[3:], 2,
                          True)
    scales = bn_relu_microbench.abs_sums(i)
    for want in (plain, kernel):
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
        for a, b, scale in zip(got[2:], want[2:], scales):
            err = np.abs(a.numpy() - np.asarray(b).reshape(-1))
            assert (err <= 2e-5 * scale.numpy() + 1e-6).all()
    # The harness's own check holds the wrapper (the plain version on the
    # CPU) against the plain version.
    assert bn_relu_microbench.check(i) == 0.0


def test_winograd_at_layer2_width_matches_jax_and_the_direct_conv():
    rng = np.random.RandomState(0)
    x, w, gy = bench_winograd.make_inputs(rng, 2, 16, 128, "cpu")
    assert twg.supported(tuple(x.shape), tuple(w.shape), (1, 1))
    errs = bench_winograd.check_forward(x, w)
    assert errs["err_winograd"] <= 4 * errs["err_direct"] + 1e-3

    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = twg.winograd_conv3x3(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), gy)

    def nhwc(t):
        return jnp.asarray(t.detach().float().permute(0, 2, 3, 1).numpy()
                           ).astype(jnp.bfloat16)

    jw = jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()).astype(
        jnp.bfloat16)
    assert jwg._pick_s(2, 16, 128, 128) is not None   # JAX's kernel runs
    import jax
    jy, vjp = jax.vjp(lambda a, b: jwg.winograd_conv3x3(a, b, True),
                      nhwc(x), jw)
    jdx, jdw = vjp(nhwc(gy))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    pairs = ((y.detach().float().permute(0, 2, 3, 1).numpy(), jy),
             (dx.float().permute(0, 2, 3, 1).numpy(), jdx))
    for a, b in pairs:
        b = np.asarray(b.astype(jnp.float32))
        assert rel(a, b) < 2e-3
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()
    assert rel(dw.float().permute(2, 3, 1, 0).numpy(),
               np.asarray(jdw.astype(jnp.float32))) < 1e-2


# ---------------------------------------------------------------------------
# The public names.
# ---------------------------------------------------------------------------

def _jax_all(sub):
    path = os.path.join(ROOT, "simclr_tpu", sub, "__init__.py")
    tree = ast.parse(open(path).read())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and node.targets[0].id == "__all__")


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "root")
def test_package_exports_the_jax_names(sub):
    pkg = importlib.import_module(
        "simclr_tpu_torch" + (f".{sub}" if sub else ""))
    assert pkg.__all__ == _jax_all(sub)
    for name in pkg.__all__:
        value = getattr(pkg, name)
        if sub == "train" and name == "pretrain":
            # The submodule (ROADMAP Queue C): the function is one level
            # down.
            assert value is importlib.import_module(
                "simclr_tpu_torch.train.pretrain")
            assert callable(value.pretrain)
        else:
            assert value is not None, name
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")


def test_batch_sharding_and_replicated():
    mesh = tmesh.Mesh(group=None, rank=1, size=4,
                      device=torch.device("cpu"), backend="gloo")
    x = torch.arange(24).reshape(8, 3)
    assert torch.equal(tmesh.batch_sharding(mesh)(x), x[2:4])
    assert torch.equal(tmesh.shard_batch(x, mesh), x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_sharding(mesh)(x[:7])
    assert tmesh.replicated(mesh).kind == "replicated"
    one = tmesh.Mesh(None, 0, 1, torch.device("cpu"), "gloo")
    assert tmesh.shard_batch(x, one) is x


# ---------------------------------------------------------------------------
# Each harness's command line.
# ---------------------------------------------------------------------------

_TINY_ARGS = ["--device", "cpu", "--batch", "8", "--steps", "2",
              "--stage_sizes", "1", "1", "1", "1", "--width", "4",
              "--n_images", "32"]


def test_bench_variants_main_prints_the_jax_fields(tmp_path):
    out = tmp_path / "rows.json"
    rows, lines = _printed(bench_variants.main, [
        "unfused", "conv64", *_TINY_ARGS, "--reps", "2", "--json",
        str(out)])
    assert [r["name"] for r in json.loads(out.read_text())] == [
        "unfused", "conv64"]
    pattern = re.compile(r"^(\S+) +([\d.]+) steps/s \( *([\d.]+) ms/step\) "
                         r"reps=\[([\d., ]+)\] loss=([\d.]+)$")
    for line, row in zip(lines, rows):
        m = pattern.match(line)
        assert m, line
        name, rate, ms, reps, loss = m.groups()
        assert name == row["name"]
        assert float(ms) == pytest.approx(1e3 / float(rate), rel=1e-3)
        assert len(reps.split(",")) == 2
        assert 0.0 < float(loss) < 10.0
        assert row["captures"] == 0   # the CPU runs the eager loop


def test_profile_step_traces_on_the_cpu_and_parses_again(tmp_path):
    logdir = str(tmp_path / "trace")
    report, lines = _printed(profile_step.main, [
        *_TINY_ARGS, "--variant", "bnrelu", "--logdir", logdir])
    assert lines[0] == "warming up bnrelu ..."
    assert re.match(r"wall: [\d.]+ ms/step \([\d.]+ steps/s\) \| loss "
                    r"[\d.]+$", lines[2])
    assert report["n_events"] > 100 and report["n_device_events"] == 0
    again, lines = _printed(profile_step.main, [
        "--parse_only", "--logdir", logdir, "--steps", "2"])
    assert again["path"] == report["path"]
    assert again["n_events"] == report["n_events"]
    assert lines == [f"{report['path']}: {report['n_events']} events, no "
                     "device events (a trace without a card)"]


def test_microbenchmarks_main_print_their_rows():
    rows, lines = _printed(bn_relu_microbench.main, [
        "--device", "cpu", "--reps", "1", "--rows_scale", "4096"])
    assert [(r["shape"], r["call"]) for r in rows] == [
        (s, c) for s in ((256, 256), (64, 512), (16, 1024), (4, 2048))
        for c in ("kernel", "plain")]
    assert re.match(r"^\( +256, +256\) kernel +[\d.]+ ms +[\d.]+ GB/s "
                    r"effective \(bound [\d.]+ ms at 3\.35 TB/s\)$",
                    lines[1]), lines[1]
    rows, lines = _printed(bench_winograd.main, [
        "--device", "cpu", "--iters", "1", "--batch", "1"])
    assert [(r["shape"], r["conv"]) for r in rows] == [
        (s, c) for s in ("layer2", "layer3", "layer4")
        for c in ("direct", "winograd")]
    assert re.match(r"^layer2 winograd +fwd +[\d.]+ us \( *[\d.]+ "
                    r"TF/s-equiv\) \| fwd\+bwd +[\d.]+ us \( *[\d.]+ "
                    r"TF/s-equiv\)$", lines[2]), lines[2]


@pytest.mark.parametrize("harness,argv", [
    (bench_variants, ["unfused"]), (profile_step, []),
    (bn_relu_microbench, []), (bench_winograd, [])],
    ids=["bench_variants", "profile_step", "bn_relu_microbench",
         "bench_winograd"])
def test_default_device_raises_without_a_card(harness, argv):
    assert harness.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(argv)
