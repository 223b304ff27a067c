"""The opt-in paths of the pretrain step in the port against the JAX
package, on the CPU: subset weight gradients, conv + subset BN with the
weight-space scale gradient, the weight-folded identity blocks, the
bn1/bn2 shadow statistics, the ``bn_grad_mode`` probes, ``SubsetBNAct``
without its kernel, remat, and the two XLA scheduling flags.

Inputs come from numpy with a seed; the JAX side is NHWC/HWIO, the port
NCHW/OIHW. Weights are made by the port and carried over with
``simclr_to_jax``, with running statistics moved off their init, so the
one-pass statistics' shift and the eval path matter. Encoders: stage
sizes (2, 2), width 8, 8 x 8 images, 2N = 96 rows, statistics from
k = 64 (``bn_stats_fraction=0.25``, at least 64), float32.

Tolerances, each measured here first:

* ops at float32: ``conv_subset_wgrad``'s dw rtol 1e-5, atol 1e-5 of
  its largest entry (sums of 1,008 products in another order; measured
  2.5e-7 of it); ``conv_subset_bn``'s out, mean and var rtol 1e-5 /
  atol 1e-5 (measured 1.9e-6 at most), its gradients within 1e-5 of
  each one's norm (float32 sums in another order; measured 1.6e-6 at
  most). At bfloat16 x: out within 1e-3 of its norm (PyTorch's CPU bf16
  convolution is not exactly rounded, a few outputs a bf16 step off
  XLA's; measured 7.6e-5), mean and var rtol 1e-4 / atol 1e-5 (5.7e-6),
  gradients within 1e-3 of each one's norm (7.5e-5).
* encoders: outputs, eval outputs and running statistics rtol 1e-4 /
  atol 1e-5 (measured 4.1e-6 at most), every parameter gradient within
  1e-4 of its norm (measured 4.0e-6 at most).
* within the port, bit for bit: the scheduling flags and remat.
* one whole training step with the flags combined (width 16, 32 x 32
  views, batch 40): the loss rtol 1e-5, the running statistics rtol
  1e-4 / atol 1e-5, the gradients within 3e-2 of the whole gradient's
  norm and 5e-2 of each tensor's: the two frameworks' float32 gradients
  differ at this size with no opt-in flag at all by 1.6e-2 of the whole
  norm and 2.5e-2 of a tensor's at worst (measured on this step; the
  encoder cases above hold the flags to 1e-3), and with the flags by
  1.0e-2 and 2.1e-2.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data import datasets as jds
from simclr_tpu.models import norm as jnorm
from simclr_tpu.models.resnet import ResNetEncoder as JResNetEncoder
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops import foldconv as jfold
from simclr_tpu.ops import subset_wgrad as jswg
from simclr_tpu.train import common as jcommon
from simclr_tpu.train.pretrain import build_engine as jax_build_engine
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models import norm as tnorm
from simclr_tpu_torch.models.resnet import Conv, ResNetEncoder
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.foldconv import conv_subset_bn
from simclr_tpu_torch.ops.kernels import bn_relu as tk
from simclr_tpu_torch.ops.subset_wgrad import conv_subset_wgrad, subset_rows
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.utils.weights import simclr_to_jax
from test_torch_augment import jax_view_params

N2, HW = 96, 8
ENC = dict(stage_sizes=(2, 2), width=8, low_quality_img=True,
           bn_stats_fraction=0.25)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


# ---------------------------------------------------------------------------
# conv_subset_wgrad.
# ---------------------------------------------------------------------------

def _wgrad_oracle(stride):
    """n = 96, fraction 0.3: k = int(28.8) = 28, a floor (a ceiling would
    be 29), which does not divide 2N; min_rows 4. JAX's y, dx and dw,
    lowered: (lowered oracle, its arguments, the port's side)."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((N2, 6, 6, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    k = subset_rows(N2, 0.3, 4)
    pad = ((1, 1), (1, 1))

    def conv(x_, w_):
        return jswg.conv_subset_wgrad(x_, w_, (stride, stride), pad, k)

    def oracle(x_, w_, g_):
        y_, vjp = jax.vjp(conv, x_, w_)
        return (y_,) + vjp(g_)

    g = rng.standard_normal(jax.eval_shape(conv, x, w).shape).astype(
        np.float32)
    return jax.jit(oracle).lower(x, w, g), (x, w, g), dict(k=k)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_subset_wgrad_matches_jax(stride, oracles):
    """``_wgrad_oracle``'s case."""
    compiled, (x, w, g), side = oracles[f"wgrad{stride}"]
    k = side["k"]
    assert k == 28
    y, jdx, jdw = compiled.result()(x, w, g)

    tx = _nchw(x).requires_grad_()
    tw = _oihw(w).requires_grad_()
    ty = conv_subset_wgrad(tx, tw, (stride, stride), (1, 1), k)
    ty.backward(_nchw(g))
    # Forward and dx: the plain convolution's, bit for bit.
    px = _nchw(x).requires_grad_()
    pw = _oihw(w).requires_grad_()
    py = torch.nn.functional.conv2d(px, pw, None, stride, 1)
    py.backward(_nchw(g))
    assert torch.equal(ty, py) and torch.equal(tx.grad, px.grad)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jdw), rtol=1e-5,
                               atol=1e-5 * np.abs(jdw).max())
    assert not torch.allclose(tw.grad, pw.grad)


def test_conv_takes_the_plain_path_at_k_ge_n():
    """Conv: training with a fraction whose k reaches n, eval mode, or
    fraction 1 is the plain convolution, with no custom Function."""
    x = torch.randn(16, 4, 5, 5)
    conv = Conv(4, 6, 3, 1, 1, dtype=torch.float32, wgrad_fraction=0.25)
    assert type(conv(x).grad_fn).__name__ == "ConvolutionBackward0"
    conv.min_rows = 4
    assert type(conv(x).grad_fn).__name__ == "_ConvSubsetWgradBackward"
    conv.eval()
    assert type(conv(x).grad_fn).__name__ == "ConvolutionBackward0"


# ---------------------------------------------------------------------------
# conv_subset_bn.
# ---------------------------------------------------------------------------

def _subset_bn_oracle(dtype, ksize):
    """JAX's conv_subset_bn outputs and gradients on a numpy case,
    lowered: (lowered oracle, its arguments, the case)."""
    rng = np.random.default_rng(ksize)
    c, f, k, pad = 8, 12, 40, ksize // 2
    x = rng.standard_normal((N2, HW, HW, c)).astype(np.float32)
    w = (rng.standard_normal((ksize, ksize, c, f)) * 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, f).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, f).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, f).astype(np.float32)
    g = rng.standard_normal((N2, HW, HW, f)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def fn(x_, w_, ga, be, sh):
        return jfold.conv_subset_bn(((pad, pad), (pad, pad)), k, 1e-5, x_,
                                    w_, ga, be, sh)

    def oracle(*args):
        outs, vjp = jax.vjp(fn, *args[:-1])
        return outs, vjp((args[-1], jnp.zeros(f), jnp.zeros(f)))

    # Without excess precision XLA rounds every bf16 op as eager JAX does.
    args = (jnp.asarray(x).astype(jdt), w, gamma, beta, shift,
            jnp.asarray(g).astype(jdt))
    lowered = jax.jit(
        oracle, compiler_options={"xla_allow_excess_precision": False}
    ).lower(*args)
    return lowered, args, dict(x=x, w=w, gamma=gamma, beta=beta,
                               shift=shift, g=g, c=c, f=f, k=k, pad=pad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ksize", [1, 3])
def test_conv_subset_bn_matches_jax(dtype, ksize, oracles):
    """``_subset_bn_oracle``'s case."""
    compiled, args, case = oracles[f"subset_bn_{dtype}_{ksize}"]
    x, w, gamma, beta = case["x"], case["w"], case["gamma"], case["beta"]
    shift, g, f, k, pad = (case[n] for n in ("shift", "g", "f", "k", "pad"))
    tdt = getattr(torch, dtype)
    (jout, jmean, jvar), jgrads = compiled.result()(*args)

    tx = _nchw(x).to(tdt).requires_grad_()
    tw = _oihw(w).requires_grad_()
    tga, tbe = (torch.from_numpy(v).requires_grad_() for v in (gamma, beta))
    out, mean, var = conv_subset_bn(pad, k, 1e-5, tx, tw, tga, tbe,
                                    torch.from_numpy(shift))
    assert out.dtype == tdt and not mean.requires_grad
    out.backward(_nchw(g).to(tdt))
    tgrads = (tx.grad.float().permute(0, 2, 3, 1), tw.grad.permute(2, 3, 1, 0),
              tga.grad, tbe.grad)
    tout = out.detach().float().permute(0, 2, 3, 1).numpy()
    jout = np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-5, atol=1e-5)
        grad_tol = 1e-5
    else:
        assert _rel(tout, jout) < 1e-3
        np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-4, atol=1e-5)
        grad_tol = 1e-3
    for name, t, j in zip(("dx", "dw", "dgamma", "dbeta"), tgrads, jgrads):
        assert _rel(t.detach().numpy(),
                    np.asarray(j.astype(jnp.float32))) < grad_tol, name
    # The shift takes no gradient: JAX returns zeros for it.
    assert not np.asarray(jgrads[4]).any()


# ---------------------------------------------------------------------------
# Within the port.
# ---------------------------------------------------------------------------

def _step(enc, x, r):
    """One training forward and backward: (output, running statistics,
    gradients), cloned."""
    enc.train()
    for p in enc.parameters():
        p.grad = None
    y = enc(x)
    (y.float() * r).sum().backward()
    return (y.detach().clone(),
            {n: b.clone() for n, b in enc.named_buffers()},
            {n: p.grad.clone() for n, p in enc.named_parameters()})


def _bits(a, b):
    (ya, sa, ga), (yb, sb, gb) = a, b
    return (torch.equal(ya, yb) and sa.keys() == sb.keys()
            and all(torch.equal(sa[n], sb[n]) for n in sa)
            and ga.keys() == gb.keys()
            and all(torch.equal(ga[n], gb[n]) for n in ga))


@pytest.mark.parametrize("over", [
    dict(bn_grad_mode="subset_st", bn3_shadow_stats=True,
         bn12_shadow_stats=True),
    dict(fold_bn_scales=True),
    dict(bn_relu_fused=True),
    dict(fuse_identity_blocks=True),
    dict(conv_wgrad_fraction=0.5, conv_wgrad_min_rows=4,
         bn_grad_mode="subset_st_w"),
], ids=["shadow", "fold", "bn_relu_fused", "fused_blocks", "wgrad"])
def test_remat_is_bit_identical_and_updates_statistics_once(over):
    """remat_stages=(0, 1) against no remat from the same weights and
    running statistics: outputs, running statistics and gradients bit for
    bit. The blocks did run twice (forward and recompute), and the
    statistics moved once: a second update, or a recompute shifted by the
    updated mean, would change them."""
    rng = np.random.default_rng(4)
    x = _nchw(rng.standard_normal((N2, HW, HW, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((N2, 64)).astype(np.float32))
    runs, calls = [], []
    for remat in ((), (0, 1)):
        enc = _torch_encoder(remat_stages=remat, **over)
        before = {n: b.clone() for n, b in enc.named_buffers()}
        calls.append(0)
        enc.layer1_0.bn1.register_forward_hook(
            lambda *_: calls.__setitem__(-1, calls[-1] + 1))
        runs.append(_step(enc, x, r))
        assert all(not torch.equal(before[n], runs[-1][1][n])
                   for n in before if n.endswith("running_mean"))
    assert calls == [1, 2]
    assert _bits(*runs)


def test_scheduling_flags_are_bit_identical():
    rng = np.random.default_rng(5)
    x = _nchw(rng.standard_normal((N2, HW, HW, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((N2, 32)).astype(np.float32))
    runs = [_step(_torch_encoder(stage_sizes=(2,), **over), x, r)
            for over in (dict(), dict(relu_from_output=True,
                                      relu_barrier=True))]
    assert _bits(*runs)


@pytest.mark.parametrize("over", [
    dict(fold_bn_scales=True), dict(bn12_shadow_stats=True),
    dict(bn12_shadow_stages=(0,)), dict(conv_wgrad_fraction=0.5),
    dict(remat_stages=(0, 1)), dict(relu_from_output=True),
    dict(relu_barrier=True), dict(bn_grad_mode="subset_st_nomean"),
    dict(bn_grad_mode="subset_st_w")], ids=lambda o: "-".join(o))
def test_names_and_shapes_are_the_same_on_every_flag(over):
    base = dict(stage_sizes=(2, 2), width=8, feature_dim=32)
    want = {n: t.shape for n, t in SimCLR(ModelConfig(**base))
            .state_dict().items()}
    have = {n: t.shape for n, t in SimCLR(ModelConfig(**base, **over))
            .state_dict().items()}
    assert have == want


# ---------------------------------------------------------------------------
# Encoders against JAX's ResNetEncoder.
# ---------------------------------------------------------------------------

def _torch_encoder(**over):
    enc = ResNetEncoder(**{**ENC, **over}, dtype=torch.float32,
                        bn_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, buf in enc.named_buffers():
            shape = tuple(buf.shape)
            if name.endswith("running_mean"):
                buf.add_(torch.from_numpy(rng.uniform(-0.2, 0.2, shape)
                                          .astype(np.float32)))
            else:
                buf.mul_(torch.from_numpy(rng.uniform(0.5, 1.5, shape)
                                          .astype(np.float32)))
    return enc.to(memory_format=torch.channels_last)


def _encoder_oracle(over):
    """The port's encoder with ``over``, its input, cotangent and weights,
    and JAX's oracle on them, lowered (train outputs, running statistics
    and parameter gradients, then eval outputs with the updated
    statistics): (lowered oracle, its arguments, the port's side)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N2, HW, HW, 3)).astype(np.float32)
    enc = _torch_encoder(**over)
    r = rng.standard_normal((N2, enc.out_features)).astype(np.float32)
    params, stats = simclr_to_jax(enc.state_dict())

    jenc = JResNetEncoder(**ENC, dtype=jnp.float32, bn_dtype=jnp.float32,
                          **over)

    def oracle(p, s):
        def loss(p_):
            y, up = jenc.apply({"params": p_, "batch_stats": s},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
            return jnp.sum(y * r), (y, up["batch_stats"])
        (_, (y, st)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        ye = jenc.apply({"params": p, "batch_stats": st}, jnp.asarray(x),
                        train=False)
        return y, st, grads, ye

    return (jax.jit(oracle).lower(params, stats), (params, stats),
            dict(x=x, r=r, enc=enc))


def _encoder_case(compiled, args, side):
    """The port's and JAX's encoder on the same weights, input and
    cotangent (``_encoder_oracle``)."""
    x, r, enc = side["x"], side["r"], side["enc"]
    jy, jst, jgrads, jye = jax.device_get(compiled(*args))
    enc.train()
    ty = enc(_nchw(x))
    (ty * torch.from_numpy(r)).sum().backward()
    tgrads = simclr_to_jax({n: p.grad for n, p in enc.named_parameters()})[0]
    tst = simclr_to_jax(enc.state_dict())[1]
    enc.eval()
    with torch.no_grad():
        tye = enc(_nchw(x))
    return dict(y=(ty.detach().numpy(), jy), eval=(tye.numpy(), jye),
                stats=(dict(_flat(tst)), dict(_flat(jst))),
                grads=(dict(_flat(tgrads)), dict(_flat(jgrads))), enc=enc)


_ENCODER_CASES = {
    "fold": dict(fold_bn_scales=True),
    "bn12_shadow": dict(bn12_shadow_stats=True, bn_grad_mode="subset_st"),
    "bn12_shadow_stage0": dict(bn12_shadow_stages=(0,),
                               bn_grad_mode="subset_st"),
    "wgrad": dict(conv_wgrad_fraction=0.5, conv_wgrad_min_rows=4),
    "subset_st_nomean": dict(bn_grad_mode="subset_st_nomean"),
    "subset_st_w": dict(bn_grad_mode="subset_st_w"),
}


@pytest.fixture(scope="module", autouse=True)
def oracles():
    """The module's JAX oracles (conv_subset_wgrad's, conv_subset_bn's,
    the whole step's and the six encoder cases'), traced here, before the
    first test, and compiled on a thread pool: XLA releases the GIL while it compiles, which is most of
    an oracle's time, so the compiles overlap one another and the tests
    that run meanwhile. name -> (future of the compiled oracle, its
    arguments, the port's side)."""
    pool = ThreadPoolExecutor(max_workers=4)
    futures = {}

    def submit(name, built):
        lowered, args, side = built
        futures[name] = (pool.submit(lowered.compile), args, side)

    # The small ones first: their tests come first.
    for stride in (1, 2):
        submit(f"wgrad{stride}", _wgrad_oracle(stride))
    for dtype in ("float32", "bfloat16"):
        for ksize in (1, 3):
            submit(f"subset_bn_{dtype}_{ksize}",
                   _subset_bn_oracle(dtype, ksize))
    submit("whole_step", _whole_step_oracle())
    for name, over in _ENCODER_CASES.items():
        submit(name, _encoder_oracle(over))
    yield futures
    for future, _, _ in futures.values():
        future.result()
    pool.shutdown()


@pytest.fixture(scope="module", params=list(_ENCODER_CASES))
def encoder_case(request, oracles):
    compiled, args, side = oracles[request.param]
    return request.param, _encoder_case(compiled.result(), args, side)


def test_encoder_matches_jax(encoder_case):
    name, case = encoder_case
    for what in ("y", "eval"):
        t, j = case[what]
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}: {what}")
    ts, js = case["stats"]
    assert ts.keys() == js.keys()
    for leaf in js:
        np.testing.assert_allclose(ts[leaf], js[leaf], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}: {leaf}")
    tg, jg = case["grads"]
    assert tg.keys() == jg.keys()
    for leaf in jg:
        assert np.abs(jg[leaf]).max() > 0, leaf
        assert _rel(tg[leaf], jg[leaf]) < 1e-4, f"{name}: {leaf}"


def test_encoder_paths_run_what_they_claim(encoder_case):
    name, case = encoder_case
    enc = case["enc"]
    blocks = [getattr(enc, b) for b in enc.block_names]
    if name == "fold":
        # layer1_1 and layer2_1 are the identity blocks.
        assert [b.folded for b in blocks] == [False, True, False, True]
        assert isinstance(enc.layer1_1.bn1, tnorm.BNScaleBias)
        assert not any(b.shadow_bn3 or b.shadow_bn12 for b in blocks)
    elif name == "bn12_shadow":
        assert enc.shadow_stem and all(b.shadow_bn12 for b in blocks)
    elif name == "bn12_shadow_stage0":
        assert not enc.shadow_stem
        assert [b.shadow_bn12 for b in blocks] == [True, True, False, False]
    elif name == "wgrad":
        convs = [m for m in enc.modules() if hasattr(m, "wgrad_fraction")]
        assert len(convs) == 1 + 4 * 3 + 2
        assert all(m.wgrad_fraction == 0.5 for m in convs)


def test_fold_and_fuse_precedence():
    """JAX's rules (models/resnet.py:224-229, 573-575): fold_bn_scales
    switches bn_relu_fused off for the whole encoder; fuse_identity_blocks
    takes an identity block before fold, and fold takes the identity
    blocks fusion leaves (below fuse_min_width)."""
    enc = ResNetEncoder(**ENC, fold_bn_scales=True, bn_relu_fused=True)
    assert not any(isinstance(m, tnorm.SubsetBNAct) for m in enc.modules())
    enc = ResNetEncoder(**ENC, fold_bn_scales=True, fuse_identity_blocks=True,
                        fuse_min_width=16)
    assert (enc.layer1_1.folded, enc.layer1_1.fused) == (True, False)
    assert (enc.layer2_1.folded, enc.layer2_1.fused) == (False, True)
    assert not enc.layer1_0.folded and not enc.layer2_0.fused


@pytest.mark.parametrize("mode", ["relu", "add_relu", "none"])
def test_subset_bn_act_unfused_matches_jax(mode, monkeypatch):
    """SubsetBNAct(fused=False) is autograd of the plain math on both
    sides, never kernel B3."""
    for op in ("subset_bn_relu", "subset_bn_add_relu", "subset_bn_only"):
        monkeypatch.setattr(tk, op, None)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N2, 4, 4, 8)).astype(np.float32) + 0.5
    skip = rng.standard_normal(x.shape).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = jnorm.SubsetBNAct(mode=mode, fused=False, dtype=jnp.float32,
                           stats_fraction=0.25)
    args = (jnp.asarray(x),) + ((jnp.asarray(skip),)
                                if mode == "add_relu" else ())
    variables = jax.jit(jm.init)(jax.random.key(0), *args)
    stats = jax.tree.map(lambda v: v + 0.1, variables["batch_stats"])

    def f(p, *a):
        y, up = jm.apply({"params": p, "batch_stats": stats}, *a,
                         mutable=["batch_stats"])
        return y, up["batch_stats"]

    @jax.jit
    def oracle(p, g_, *a):
        (y, st), vjp = jax.vjp(f, p, *a)
        return (y, st), vjp((g_, jax.tree.map(jnp.zeros_like, st)))

    (jy, jst), jgrads = oracle(variables["params"], jnp.asarray(g), *args)

    tm = tnorm.SubsetBNAct(8, mode=mode, dtype=torch.float32,
                           stats_fraction=0.25, fused=False)
    with torch.no_grad():
        tm.running_mean.add_(0.1)
        tm.running_var.add_(0.1)
    tx = _nchw(x).requires_grad_()
    ts = _nchw(skip).requires_grad_()
    ty = tm(tx, ts) if mode == "add_relu" else tm(tx)
    ty.backward(_nchw(g))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), jy,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), jst["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), jst["var"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               jgrads[0]["scale"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), jgrads[0]["bias"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               jgrads[1], rtol=1e-4, atol=1e-5)
    if mode == "add_relu":
        np.testing.assert_allclose(ts.grad.permute(0, 2, 3, 1).numpy(),
                                   jgrads[2], rtol=1e-4, atol=1e-5)


def test_unknown_grad_mode_is_refused():
    with pytest.raises(ValueError, match="unknown grad_mode"):
        tnorm.SubsetBatchNorm(8, grad_mode="other")
    with pytest.raises(ValueError, match="unknown bn_grad_mode"):
        SimCLR(ModelConfig(stage_sizes=(1,), width=8, feature_dim=32,
                           bn_grad_mode="other"))


# ---------------------------------------------------------------------------
# One whole training step with the flags combined.
# ---------------------------------------------------------------------------

COMBINED = dict(feature_dim=512, width=16, stage_sizes=(2, 1, 1, 1),
                compute_dtype="float32", bn_dtype="float32",
                conv_wgrad_fraction=0.5, conv_wgrad_min_rows=4,
                bn12_shadow_stages=(0,), relu_from_output=True,
                relu_barrier=True, remat_stages=(0,))
BATCH = 40


def _whole_step_oracle():
    """One pretrain step of the port's and JAX's engines from the same
    weights, batch and draws, JAX's lowered: (lowered step, its arguments,
    the port's side). JAX's runs ``optax.sgd(-1e6)``, so that its update
    is 1e6 times the gradient, which comes back to float32 precision."""
    train = dict(batch_size=BATCH, temperature=0.5)
    tc = tcfg.Config(model=ModelConfig(**COMBINED),
                     train=tcfg.TrainConfig(**train))
    jc = jcfg.Config(model=jcfg.ModelConfig(**COMBINED),
                     train=jcfg.TrainConfig(**train))
    model, state, opt = tpre.init_simclr(tc, seed=0, device="cpu")
    engine = tpre.build_engine(tc, model, opt)
    params, stats = simclr_to_jax(model.state_dict())
    tx = optax.sgd(-1e6)
    jstate = jcommon.TrainState.create(params, stats, tx)
    jengine = jax_build_engine(jc, JSimCLR(cfg=jc.model), tx,
                               use_pallas_ntxent=False)
    images, _ = jds.synthetic_dataset(BATCH, img_size=32, seed=3)
    args = (jstate, jnp.asarray(images), jax.random.key(10))
    return (jengine.train_step_direct.lower(*args), args,
            dict(tc=tc, model=model, state=state, engine=engine,
                 params=params, images=images))


def test_whole_step_with_the_flags_combined_matches_jax(oracles):
    """One pretrain step on both engines from the same weights, batch and
    draws (``_whole_step_oracle``); the port's gradients are in ``.grad``
    after its Adam step (Adam adds the L2 term to a copy)."""
    compiled, args, side = oracles["whole_step"]
    tc, model, state = side["tc"], side["model"], side["state"]
    engine, params, images = side["engine"], side["params"], side["images"]
    key = args[2]
    jstate, (jloss, _) = compiled.result()(*args)
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    pair = (jax_view_params(k1, BATCH, 32, 32, tc.augment),
            jax_view_params(k2, BATCH, 32, 32, tc.augment))
    state, (tloss, _) = engine.train_step_on_params(
        state, torch.from_numpy(images), pair)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ts = dict(_flat(simclr_to_jax(model.state_dict())[1]))
    js = dict(_flat(jax.device_get(jstate.batch_stats)))
    assert ts.keys() == js.keys()
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    p0 = dict(_flat(params))
    jg = {n: (v.astype(np.float64) - p0[n]) / 1e6
          for n, v in _flat(jax.device_get(jstate.params))}
    tg = dict(_flat(simclr_to_jax(
        {n: p.grad for n, p in model.named_parameters()})[0]))
    assert tg.keys() == jg.keys()
    whole = np.linalg.norm(np.concatenate([v.ravel() for v in jg.values()]))
    diff = np.concatenate([(tg[n] - jg[n]).ravel() for n in jg])
    assert np.linalg.norm(diff) <= 3e-2 * whole
    for name in jg:
        scale = whole if name == "g/linear0/bias" else np.linalg.norm(
            jg[name])
        assert np.linalg.norm(tg[name] - jg[name]) <= 5e-2 * scale, name
