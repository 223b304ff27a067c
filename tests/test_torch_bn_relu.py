"""Kernel B3's path in the port against the JAX package: the three
subset-BN(+add)+ReLU ops with the single-pass backward, ``SubsetBNAct``,
the ``bn_relu_fused`` model, and ``subset_bn_apply`` (``bn_fused_vjp``).

JAX runs on the CPU with its Pallas kernel in interpret mode, as
``tests/test_bn_relu.py`` runs it; the port runs its plain versions (the
kernel wrappers take them for CPU tensors). Inputs come from numpy with a
seed; the JAX side is NHWC, the port NCHW in channels_last memory.

Tolerances, float32 unless stated:

* op level, against the Pallas kernel: out, mean, var rtol/atol 1e-5
  (XLA may contract the apply's multiply-add into one rounding where
  PyTorch rounds the product: one float32 step of intermediates up to ~16
  in size, 1.2e-6 seen); dx and dskip rtol/atol 2e-5;
  dscale and dbias rtol/atol 3e-4 (float32 sums over 4,096 rows in
  another order, and in 'relu' mode the (S2' - bias*S1)/scale recovery),
  as ``tests/test_bn_relu.py`` holds the kernel against autodiff.
* op level at C=64, against JAX's autodiff (its ``SubsetBNAct`` sends
  C % 128 != 0 there; the port's kernel takes C % 8 == 0): the same.
* bf16 application: JAX's CPU compiler may keep bf16 intermediates in
  float32 where PyTorch rounds each op, which moves an output by one bf16
  step (0.4% relative) and, where out is within that of 0, flips a ReLU
  mask entry. out within 1e-2 relative in norm, mean/var rtol 1e-6 (float32
  statistics of the same float32 x), gradients within 1e-2 in norm.
* model level: every parameter gradient within 1e-3 in norm of JAX's
  (the bound ``tests/test_bn_relu.py`` holds its fused model to; measured
  6e-5). With the straight-through head of the default 'subset_st' the
  trunk gradients of this tiny model differ from JAX's by up to 1.1e-3 in
  norm, and by 1.0e-3 with ``bn_relu_fused=False`` too, which runs no B3
  code: the head's large straight-through gradient loses float32 digits
  in the trunk BNs' backward (the head alone agrees to 6e-7). That
  case, and the same model without ``bn_relu_fused``, are held to 2e-3;
  the same model with an exact head to 1e-3.
* three pretrain steps: the first loss (same weights) rtol 1e-5, measured
  2e-7; the later ones rtol 1e-3, since Adam's sign-like first steps
  amplify float32 gradient noise: measured 1.2e-4 at step 3, and 5.9e-4
  for the port's default model with ``bn_grad_mode='exact'``, which runs
  no B3 code. Running statistics after the first step rtol 1e-4 / atol
  1e-5, as ``tests/test_torch_pretrain.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.config import ModelConfig as JModelConfig
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops import subset_bn as jsubset_bn
from simclr_tpu.ops.pallas import bn_relu as jk
from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models.norm import SubsetBatchNorm, SubsetBNAct
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops import subset_bn
from simclr_tpu_torch.ops.kernels import bn_relu as tk
from simclr_tpu_torch.utils.weights import simclr_to_jax
from test_torch_pretrain import _run_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


EPS = 1e-5
SHAPE = (256, 4, 4, 128)   # rows 4096 -> a 4-step Pallas grid in f32
K = 32
MODES = ("relu", "add_relu", "none")
GRAD_NAMES = ("dx", "dskip", "dscale", "dbias")


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f = lambda *a, **kw: rng.normal(*a, **kw).astype(np.float32)
    return dict(x=f(1.0, 1.5, shape), skip=f(0.0, 1.0, shape),
                scale=f(1.0, 0.2, (c,)), bias=f(0.0, 0.2, (c,)),
                shift=f(1.0, 0.5, (c,)), wy=f(size=shape), wm=f(size=(c,)),
                wv=f(size=(c,)))


def _nchw(a):
    """NHWC numpy -> NCHW torch tensor in channels_last memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t):
    a = t.detach().to(torch.float32)
    return (a.permute(0, 2, 3, 1) if a.dim() == 4 else a).numpy()


def _jax_op(mode, i, k, dt, impl):
    """JAX (out, mean, var) and the gradients of loss3 in x, skip, scale,
    bias; impl 'autodiff' differentiates the plain forward."""
    def ops(x, skip, scale, bias):
        if impl == "autodiff":
            m, v = jk._bn_stats(x, i["shift"], k, EPS)
            y = jk._bn_apply(x, scale, bias, m, v, EPS, dt)
            if mode == "add_relu":
                y = jnp.maximum(y + skip.astype(y.dtype), 0)
            elif mode == "relu":
                y = jnp.maximum(y, 0)
            return y, m, v
        if mode == "add_relu":
            return jk.subset_bn_add_relu(x, skip, scale, bias, i["shift"], k,
                                         EPS, dt, True, impl)
        op = jk.subset_bn_relu if mode == "relu" else jk.subset_bn_only
        return op(x, scale, bias, i["shift"], k, EPS, dt, True, impl)

    def loss3(x, skip, scale, bias):
        o, m, v = ops(x, skip, scale, bias)
        return (jnp.sum(o.astype(jnp.float32) * i["wy"])
                + jnp.sum(m * i["wm"]) + jnp.sum(v * i["wv"])), (o, m, v)

    args = [jnp.asarray(i[n]) for n in ("x", "skip", "scale", "bias")]
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss3, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return [np.asarray(o, np.float32) for o in outs], \
        [np.asarray(g, np.float32) for g in grads]


def _port_op(mode, i, k, dt, impl="pallas"):
    x = _nchw(i["x"]).clone(memory_format=torch.channels_last)
    skip = _nchw(i["skip"]).clone(memory_format=torch.channels_last)
    scale, bias = (torch.from_numpy(i[n]) for n in ("scale", "bias"))
    leaves = [t.requires_grad_() for t in (x, skip, scale, bias)]
    shift = torch.from_numpy(i["shift"])
    if mode == "add_relu":
        o, m, v = tk.subset_bn_add_relu(x, skip, scale, bias, shift, k, EPS,
                                        dt, impl)
    else:
        op = tk.subset_bn_relu if mode == "relu" else tk.subset_bn_only
        o, m, v = op(x, scale, bias, shift, k, EPS, dt, impl)
    loss = ((o.to(torch.float32) * _nchw(i["wy"])).sum()
            + (m * torch.from_numpy(i["wm"])).sum()
            + (v * torch.from_numpy(i["wv"])).sum())
    loss.backward()
    grads = [np.zeros_like(i["skip"]) if t.grad is None else _nhwc(t.grad)
             for t in leaves]
    return [_nhwc(o), m.detach().numpy(), v.detach().numpy()], grads


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _model_grads(cfg, x):
    """Every parameter gradient of sum(z^2) + 0.1 sum|h| in training mode,
    port and JAX, from the port's seed-0 weights: two dicts keyed by the
    JAX parameter path."""
    tmodel = SimCLR(ModelConfig(**cfg),
                    generator=torch.Generator().manual_seed(0))
    params, stats = simclr_to_jax(tmodel.state_dict())
    jmodel = JSimCLR(cfg=JModelConfig(**cfg))

    @jax.jit
    def jgrad(p):
        def loss(p):
            (h, z), _ = jmodel.apply({"params": p, "batch_stats": stats},
                                     jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
            return jnp.sum(jnp.square(z)) + 0.1 * jnp.sum(jnp.abs(h))
        return jax.grad(loss)(p)

    jg = dict(_flat(jax.device_get(jgrad(params))))
    tmodel.train()
    h, z = tmodel(_nchw(x))
    (z.square().sum() + 0.1 * h.abs().sum()).backward()
    tg = dict(_flat(simclr_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()})[0]))
    assert tg.keys() == jg.keys()
    return tg, jg, tmodel


def _assert_model_grads_close(tg, jg, bound):
    """Each gradient within ``bound`` of JAX's in norm, relative to its
    own norm or 1e-3 of all gradients' (as tests/test_bn_relu.py)."""
    gscale = float(np.sqrt(sum(float(np.vdot(v, v)) for v in jg.values())))
    for name, b in jg.items():
        denom = max(float(np.linalg.norm(b)), 1e-3 * gscale)
        rel = np.linalg.norm(tg[name] - b) / denom
        assert rel < bound, (name, rel)


def _assert_grads_close(got, want, elem_tol, sum_tol):
    for a, b, name in zip(got, want, GRAD_NAMES):
        tol = sum_tol if name in ("dscale", "dbias") else elem_tol
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_op_matches_jax_pallas_kernel_f32(mode):
    i = _inputs(0, SHAPE)
    (jo, jm, jv), jg = _jax_op(mode, i, K, jnp.float32, "pallas")
    (to, tm, tv), tg = _port_op(mode, i, K, torch.float32)
    for a, b in ((to, jo), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    _assert_grads_close(tg, jg, 2e-5, 3e-4)


@pytest.mark.parametrize("mode", MODES)
def test_op_at_c64_matches_jax_autodiff(mode):
    i = _inputs(1, (128, 4, 4, 64))
    (jo, jm, jv), jg = _jax_op(mode, i, K, jnp.float32, "autodiff")
    (to, tm, tv), tg = _port_op(mode, i, K, torch.float32)
    for a, b in ((to, jo), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    _assert_grads_close(tg, jg, 2e-5, 3e-4)


@pytest.mark.parametrize("impl", ["xla", "xla_mask"])
def test_plain_impls_match_the_kernel_path(impl):
    """'xla' and 'xla_mask' select the plain backward; on CPU tensors the
    kernel wrapper runs the same plain version, so all agree exactly."""
    i = _inputs(2, (96, 2, 2, 16))
    for mode in MODES:
        want = _port_op(mode, i, K, torch.float32)
        got = _port_op(mode, i, K, torch.float32, impl)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(a, b)


def test_op_bf16_apply_matches_jax():
    shape = (512, 2, 2, 128)   # rows 2048: one bf16 Pallas row block
    i = _inputs(5, shape)
    k = 64                     # stats_fraction 0.0625 of 512, min 64
    (jo, jm, jv), jg = _jax_op("relu", i, k, jnp.bfloat16, "pallas")
    (to, tm, tv), tg = _port_op("relu", i, k, torch.bfloat16)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(to, jo) < 1e-2
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    for a, b, name in zip(tg, jg, GRAD_NAMES):
        if name != "dskip":
            assert rel(a, b) < 1e-2, (name, rel(a, b))


@pytest.mark.parametrize("mode", MODES)
def test_module_forward_and_stats_bitwise_like_subset_batchnorm(mode):
    """SubsetBNAct's training forward and running statistics equal
    SubsetBatchNorm(grad_mode='exact') followed by the add/ReLU, bit for
    bit; so does eval mode."""
    i = _inputs(3, SHAPE)
    x, skip = _nchw(i["x"]), _nchw(i["skip"])
    c = SHAPE[-1]
    kw = dict(dtype=torch.float32, stats_fraction=K / SHAPE[0],
              min_stats_samples=K)
    bn = SubsetBatchNorm(c, grad_mode="exact", **kw)
    act = SubsetBNAct(c, mode=mode, **kw)
    state = {"weight": torch.from_numpy(i["scale"]),
             "bias": torch.from_numpy(i["bias"]),
             "running_mean": torch.from_numpy(i["shift"]),
             "running_var": torch.from_numpy(i["wv"] ** 2 + 0.5)}
    bn.load_state_dict(state)
    act.load_state_dict(state)
    for train in (True, False):
        bn.train(train)
        act.train(train)
        y = bn(x)
        if mode == "add_relu":
            y = torch.relu(y + skip)
        elif mode == "relu":
            y = torch.relu(y)
        y2 = act(x, skip) if mode == "add_relu" else act(x)
        torch.testing.assert_close(y2, y, rtol=0, atol=0)
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(act, name),
                                       getattr(bn, name), rtol=0, atol=0)


def test_module_refuses_bad_arguments():
    with pytest.raises(ValueError):
        SubsetBNAct(16, mode="gelu")
    with pytest.raises(ValueError):
        SubsetBNAct(16, impl="triton")
    act = SubsetBNAct(16, mode="relu")
    with pytest.raises(ValueError):
        act(torch.zeros(4, 16), torch.zeros(4, 16))


def test_supports_states_what_the_kernel_reads():
    cl = torch.channels_last
    assert tk.supports(torch.zeros(4, 64, 3, 5).to(memory_format=cl))
    assert tk.supports(torch.zeros(7, 2048))
    assert tk.supports(torch.zeros(3, 8, 1, 1, dtype=torch.bfloat16))
    assert not tk.supports(torch.zeros(4, 64, 3, 5))          # NCHW memory
    assert not tk.supports(torch.zeros(4, 12, 2, 2).to(memory_format=cl))
    assert not tk.supports(torch.zeros(4, 64, dtype=torch.float16))
    assert not tk.supports(torch.zeros(4, 64, 3))             # 3-D
    assert not tk.supports(torch.zeros(0, 64))                # empty
    assert not tk.supports(torch.zeros(4, 64, 1, 1)
                           .expand(4, 64, 2, 2))              # stride 0
    assert not tk.supports(torch.zeros(65)[1:].view(1, 64))   # misaligned


def test_wrapper_on_a_cpu_tensor_runs_the_plain_version_uncounted():
    i = _inputs(4, (16, 2, 2, 64))
    g, out = _nchw(i["wy"]), _nchw(i["x"])
    a32 = torch.from_numpy(i["scale"])
    before = tk.bwd_relu.launches
    for a, b in zip(tk.bwd_relu(g, out, a32),
                    tk.bwd_relu_plain(g, out, a32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tk.bwd_relu.launches == before
    with pytest.raises(ValueError, match="no bn_relu kernel"):
        tk.bwd_relu(g.to("meta"), out.to("meta"), a32.to("meta"))


TINY = dict(compute_dtype="float32", bn_dtype="float32",
            bn_stats_fraction=0.25, stage_sizes=(1, 1), width=32,
            feature_dim=128, compressed_dim=16, bn_relu_fused=True,
            fuse_interpret=True)


@pytest.mark.parametrize("grad_mode,head_mode,fused,bound", [
    ("exact", None, True, 1e-3), ("subset_st", "exact", True, 1e-3),
    ("subset_st", None, True, 2e-3), ("subset_st", None, False, 2e-3)])
def test_tiny_model_gradients_match_jax(grad_mode, head_mode, fused, bound):
    """Every parameter gradient of a tiny SimCLR with bn_relu_fused. bn3
    and the downsample BN have C=128/256 (JAX's Pallas kernel), bn1/bn2
    C=32/64 (JAX's autodiff); all of them the port's kernel path. With
    'subset_st' the stem BN (and the head's, unless overridden) keep the
    straight-through backward while the block BNs run the exact one. The
    last case runs the same model without bn_relu_fused (no B3 code): it
    pins that the straight-through head alone needs the 2e-3 bound."""
    cfg = dict(TINY, bn_grad_mode=grad_mode, head_bn_grad_mode=head_mode,
               bn_relu_fused=fused)
    x = np.random.default_rng(4).normal(0.0, 1.0, (96, 8, 8, 3)).astype(
        np.float32)   # 96 images: k = 64 < 96
    tg, jg, _ = _model_grads(cfg, x)
    assert any("layer1_0/bn3" in n for n in tg)
    _assert_model_grads_close(tg, jg, bound)


@pytest.fixture(scope="module")
def pretrain_run():
    """Three width-16 steps with bn_relu_fused on both sides. The port runs
    its shipped path (impl 'pallas': the kernel wrappers); the JAX oracle
    runs impl 'xla', its plain-op variant of the same backward (held to
    its Pallas kernel at 2e-5 by tests/test_bn_relu.py), which compiles in
    a third of the time of the interpreted kernel."""
    return _run_both(3, jax_over=dict(bn_relu_impl="xla"),
                     compute_dtype="float32", bn_dtype="float32",
                     bn_relu_fused=True)


def test_pretrain_losses_track_jax(pretrain_run):
    for step, ((tl, _), (jl, _)) in enumerate(pretrain_run["metrics"]):
        np.testing.assert_allclose(tl, jl, rtol=1e-5 if step == 0 else 1e-3)
    assert pretrain_run["step"] == 3


def test_pretrain_running_statistics_track_jax(pretrain_run):
    ts, js = pretrain_run["stats"][0]
    assert ts.keys() == js.keys()
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("shape", [(16, 4, 4, 8), (16, 8)])
def test_subset_bn_apply_matches_jax(k, shape):
    """bn_fused_vjp's op: outputs rtol/atol 1e-5 (as the ops above),
    gradients rtol/atol 2e-5, as tests/test_subset_bn_vjp.py holds the JAX
    op to autodiff."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    f = lambda *a, **kw: rng.normal(*a, **kw).astype(np.float32)
    x, scale, bias, shift = (f(2.0, 1.5, shape), f(1.0, 0.2, (c,)),
                             f(0.0, 0.2, (c,)), f(2.0, 0.5, (c,)))
    wy, wm, wv = f(size=shape), f(size=(c,)), f(size=(c,))

    def jloss(x, scale, bias):
        y, m, v = jsubset_bn.subset_bn_apply(x, scale, bias, shift, k, EPS,
                                             jnp.float32)
        return (jnp.sum(y * wy) + jnp.sum(m * wm) + jnp.sum(v * wv),
                (y, m, v))

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(x, scale, bias)
    leaves = [_nchw(x).clone(memory_format=torch.channels_last)
              if x.ndim == 4 else torch.from_numpy(x),
              torch.from_numpy(scale), torch.from_numpy(bias)]
    leaves = [t.requires_grad_() for t in leaves]
    y, m, v = subset_bn.subset_bn_apply(*leaves, torch.from_numpy(shift), k,
                                        EPS, torch.float32)
    tv = ((y * _nchw(wy)).sum() + (m * torch.from_numpy(wm)).sum()
          + (v * torch.from_numpy(wv)).sum())
    tv.backward()
    for a, b in zip((y, m, v), jout):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for t, b, name in zip(leaves, jg, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_fused_vjp_model_gradients_match_jax():
    """bn_fused_vjp=True in a width-16 model: stem, block and head BNs run
    subset_bn_apply, and shadow statistics are off, as in JAX."""
    cfg = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16,
               compute_dtype="float32", bn_dtype="float32",
               bn_fused_vjp=True)
    x = np.random.default_rng(6).normal(0.0, 1.0, (80, 8, 8, 3)).astype(
        np.float32)
    tg, jg, tmodel = _model_grads(cfg, x)
    assert not any(getattr(m, "shadow_bn3", False) for m in tmodel.modules())
    _assert_model_grads_close(tg, jg, 1e-3)


def test_bn_relu_fused_with_fused_blocks_is_still_refused():
    """JAX's rule (models/resnet.py:572-575): bn_relu_fused is off under
    fuse_identity_blocks and under fold_bn_scales, both of which the port
    runs."""
    cfg = ModelConfig(stage_sizes=(1, 1), width=16, feature_dim=128,
                      bn_relu_fused=True)
    assert any(isinstance(m, SubsetBNAct) for m in SimCLR(cfg).modules())
    fused = SimCLR(dataclasses.replace(cfg, fuse_identity_blocks=True))
    assert not any(isinstance(m, SubsetBNAct) for m in fused.modules())
    folded = SimCLR(dataclasses.replace(cfg, fold_bn_scales=True))
    assert not any(isinstance(m, SubsetBNAct) for m in folded.modules())
