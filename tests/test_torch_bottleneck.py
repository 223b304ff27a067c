"""Kernels B6f/B6b (the fused identity bottleneck) in the port against the
JAX package: ``FoldedBatchNorm``, the fused op, the fused ``Bottleneck``
and models with ``fuse_identity_blocks``.

JAX runs on the CPU with its Pallas kernel in interpret mode, as
``tests/test_pallas_bottleneck.py`` runs it, but never a whole fused model
in interpret mode (that costs a minute): the op and the block are held to
the interpreted kernel, the models to JAX in float32, where both sides
take the plain-ops branch. The port runs its plain versions (the kernel
wrappers take them for CPU tensors). Inputs come from numpy with a seed;
JAX is NHWC/HWIO, the port NCHW (channels_last memory)/OIHW.

Tolerances:

* ``FoldedBatchNorm``, float32: affines, running statistics and
  gradients rtol 1e-5 / atol 1e-6 (the same one-pass float32 statistics
  summed in another order).
* The op, bf16 against the interpreted Pallas kernel: the same roundings
  (a1, a2, dy1-3 and the output to bf16) of float32 sums taken in
  another order, so an intermediate may round apart by one bf16 step
  (2**-8) here and there. out and dx within one bf16 step of the element
  plus 1e-3 of the largest entry, and 3e-3 in relative norm; the
  float32 weight and affine gradients within 2e-3 in relative norm.
* The plain backward against autograd of the plain forward: the same
  function rounded at other points (autograd rounds the gradients of the
  bf16 activations, the kernel dy = u A), within 1e-2 in relative norm.
* The block, bf16 against JAX's fused ``Bottleneck`` (pass A through
  bf16 convolutions, then the kernel). PyTorch's CPU bf16 convolution is
  not exactly rounded (3e-4 of its outputs are one bf16 step off the
  exactly rounded value; XLA's are not), and under jit XLA keeps those
  outputs in float32 by default (excess precision, which moved the BN
  gradients by up to 4.5%). So the port's pass-A convolutions are made
  exactly rounded here (float64, then bf16) and JAX's step is compiled
  without excess precision. What is left: pass A's a1 and a2 round apart
  by a bf16 step where XLA contracts y A + B into one rounding (running
  statistics rtol 1e-3 / atol 3e-5, measured 1.4e-5), and the kernel's
  summation order (out within 1e-3 in relative norm, measured 6e-4;
  gradients within 1e-2, measured 3.7e-3; in eval, with no pass A, 6e-10
  and 2.3e-7).
* The float32 model against JAX (both on the plain-ops branch): the
  objective rtol 1e-5, every gradient within 1e-4 of its norm (or of 1e-3
  of all gradients'), running statistics rtol 1e-4 / atol 1e-5.
* The bf16 model, fused against unfused, port only: the NT-Xent loss
  within JAX's own 2e-2 (``tests/test_pallas_bottleneck.py``), the
  gradient direction within cos 0.9 (its noise floor there).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.config import ModelConfig as JModelConfig
from simclr_tpu.models.norm import FoldedBatchNorm as JFoldedBatchNorm
from simclr_tpu.models.norm import SubsetBatchNorm as JSubsetBatchNorm
from simclr_tpu.models.resnet import Bottleneck as JBottleneck
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops.pallas import bottleneck as jk
from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models.norm import FoldedBatchNorm, SubsetBatchNorm
from simclr_tpu_torch.models.resnet import Bottleneck, Conv
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.kernels import bottleneck as tk
from simclr_tpu_torch.ops.losses import nt_xent_loss
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

ULP = 2.0 ** -8
NAMES = ("dx", "dw1", "dw2", "dw3", "dA1", "dB1", "dA2", "dB2", "dA3", "dB3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _nchw(a):
    """NHWC numpy -> NCHW torch tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


# ---------------------------------------------------------------------------
# (a) FoldedBatchNorm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folded_case():
    """k = 6 statistics rows of (6, 5, 5, 24) pre-activations, a running
    mean far from the batch mean (the shift), and a loss weighting A, B."""
    rng = np.random.default_rng(0)
    c = 24
    y = rng.normal(3.0, 2.0, (6, 5, 5, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, c).astype(np.float32)
    bias = rng.normal(0.0, 0.2, c).astype(np.float32)
    mean = rng.normal(2.0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    wa, wb = rng.normal(size=(2, c)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def jloss(yy, params):
        (a, b), upd = JFoldedBatchNorm(feats=c).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, yy,
            mutable=["batch_stats"])
        return jnp.sum(a * wa) + jnp.sum(b * wb), (a, b, upd)

    (_, (ja, jb, jupd)), (jdy, jdp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(y),
                                             variables["params"])
    # Eval folds the running statistics the training call left.
    je = JFoldedBatchNorm(feats=c, use_running_average=True).apply(
        {"params": variables["params"],
         "batch_stats": jupd["batch_stats"]}, None)

    bn = FoldedBatchNorm(c)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    yt = _nchw(y).requires_grad_()
    a, b = bn(yt)
    ((a * torch.from_numpy(wa)).sum()
     + (b * torch.from_numpy(wb)).sum()).backward()
    port = dict(a=a, b=b, dy=_nhwc(yt.grad), dscale=bn.weight.grad,
                dbias=bn.bias.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())
    bn.eval()
    port["eval"] = bn()
    want = dict(a=ja, b=jb, dy=jdy, dscale=jdp["scale"], dbias=jdp["bias"],
                mean=jupd["batch_stats"]["mean"],
                var=jupd["batch_stats"]["var"], eval=je)
    return port, want


@pytest.mark.parametrize("what", ["a", "b", "mean", "var", "eval"])
def test_folded_bn_affines_and_running_stats_match_jax(folded_case, what):
    port, want = folded_case
    got, ref = port[what], want[what]
    if what == "eval":
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-5,
                                       atol=1e-6)
        return
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["dy", "dscale", "dbias"])
def test_folded_bn_gradient_matches_jax(folded_case, what):
    port, want = folded_case
    got = port[what]
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want[what]), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (b) the op against the interpreted Pallas kernel, (c) the plain backward
# ---------------------------------------------------------------------------

def _op_inputs(seed, n, h, w, c):
    """NHWC/HWIO numpy: bf16-valued x and cotangent, float32 weights at
    the model's init scale and affines that open about half of each ReLU
    (as chip_smoke.py's B6 inputs)."""
    rng = np.random.default_rng(seed)
    f = 4 * c
    x = _bf16(rng.standard_normal((n, h, w, f)))
    g = _bf16(rng.standard_normal((n, h, w, f)))
    w1 = (rng.standard_normal((f, c)) * (2.0 / c) ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c, c))
          * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    w3 = (rng.standard_normal((c, f)) * (2.0 / f) ** 0.5).astype(np.float32)
    aff = []
    for dim, scale in ((c, 8 ** -0.5), (c, 1.0), (f, 2.0)):
        aff += [((1.0 + 0.1 * rng.standard_normal(dim)) * scale).astype(
            np.float32), (0.2 * rng.standard_normal(dim)).astype(np.float32)]
    return x, g, (w1, w2, w3), aff


def _port_weights(w1, w2, w3):
    c, f = w1.shape[1], w1.shape[0]
    return (torch.from_numpy(np.ascontiguousarray(w1.T)).view(c, f, 1, 1),
            torch.from_numpy(np.ascontiguousarray(w2.transpose(3, 2, 0, 1))),
            torch.from_numpy(np.ascontiguousarray(w3.T)).view(f, c, 1, 1))


def _port_to_jax_grads(grads):
    """The port's (dx, dw1, dw2, dw3, affines...) in JAX's layouts."""
    dx, dw1, dw2, dw3, *daff = grads
    c, f = dw1.shape[0], dw1.shape[1]
    return [_nhwc(dx), dw1.reshape(c, f).T.numpy(),
            dw2.permute(2, 3, 1, 0).numpy(), dw3.reshape(f, c).T.numpy(),
            *[v.numpy() for v in daff]]


@pytest.fixture(scope="module")
def op_case():
    """(4, 6, 6, 16): x of 64 channels, two grid steps of 2 images in the
    Pallas kernel (so its revisited-block sums run)."""
    x, g, (w1, w2, w3), aff = _op_inputs(0, 4, 6, 6, 16)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout, vjp = jax.vjp(
        lambda xx, a, b, cc, *af: jk.fused_bottleneck(
            xx, a, b, cc, af, tile=2, interpret=True),
        jx, *map(jnp.asarray, (w1, w2, w3)), *map(jnp.asarray, aff))
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    want = [np.asarray(t, np.float32) for t in (jout, *jgrads)]

    tx = _nchw(x).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    tw = [t.requires_grad_() for t in _port_weights(w1, w2, w3)]
    taff = [torch.from_numpy(a).requires_grad_() for a in aff]
    out = tk.fused_bottleneck(tx, *tw, taff)
    out.backward(_nchw(g).to(torch.bfloat16))
    got = [_nhwc(out)] + _port_to_jax_grads(
        [tx.grad] + [t.grad for t in tw + taff])
    return got, want, (x, g, (w1, w2, w3), aff)


def test_fused_op_forward_matches_jax_pallas(op_case):
    got, want, _ = op_case
    err = np.abs(got[0] - want[0])
    assert (err <= ULP * np.abs(want[0]) + 1e-3 * np.abs(want[0]).max()).all()
    assert _rel(got[0], want[0]) < 3e-3


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_fused_op_gradients_match_jax_pallas(op_case, i):
    got, want, _ = op_case
    a, b = got[1 + i], want[1 + i]
    assert a.shape == b.shape
    if NAMES[i] == "dx":
        err = np.abs(a - b)
        assert (err <= ULP * np.abs(b) + 1e-3 * np.abs(b).max()).all()
        assert _rel(a, b) < 3e-3
    else:
        assert _rel(a, b) < 2e-3, (NAMES[i], _rel(a, b))


def test_plain_backward_matches_autograd_of_the_plain_forward(op_case):
    x, g, (w1, w2, w3), aff = op_case[2]
    tx = _nchw(x).to(torch.bfloat16)
    tw = _port_weights(w1, w2, w3)
    taff = [torch.from_numpy(a) for a in aff]
    tg = _nchw(g).to(torch.bfloat16)
    got = tk.fused_bottleneck_bwd_plain(tx, *tw, taff, tg)
    leaves = [t.clone().requires_grad_() for t in (tx.float(), *tw, *taff)]
    out = tk.fused_bottleneck_plain(leaves[0], *leaves[1:4], leaves[4:])
    # The plain forward rounds x to bf16 first (its cast is the identity
    # on these bf16 values), so autograd reaches the float32 leaf.
    (out.float() * tg.float()).sum().backward()
    for name, a, leaf in zip(NAMES, got, leaves):
        assert a.shape == leaf.shape, name
        assert _rel(a.float().numpy(), leaf.grad.numpy()) < 1e-2, name


def test_layer4_kernel_path_vs_jax_plain_ops_branch():
    """A deliberate difference: at layer4 (C = 512, 4x4) JAX's pick_tile
    refuses the kernel at batch 1024 and its block takes the plain-ops
    branch, which rounds y1, y2, y3 to bf16 before the affines; the port's
    kernel keeps them float32. At this shape the two differ by 3.5e-3 in
    relative norm, and by at most one bf16 ulp of the largest output (the
    same as JAX's own kernel against its plain-ops branch): held within
    1e-2 and 2**-7 of the largest output."""
    x, _, (w1, w2, w3), aff = _op_inputs(7, 4, 4, 4, 512)
    bf, dn = jnp.bfloat16, ("NHWC", "HWIO", "NHWC")
    a = [jnp.asarray(v) for v in aff]

    def conv(inp, wt, pad):
        return jax.lax.conv_general_dilated(
            inp, jnp.asarray(wt).astype(bf), (1, 1), pad,
            dimension_numbers=dn)

    def act(y, i):
        return jnp.maximum(y.astype(jnp.float32) * a[i] + a[i + 1],
                           0.0).astype(bf)

    def plain_ops(jx):   # models/resnet.py:349-360
        a1 = act(conv(jx, w1.reshape(1, 1, 2048, 512), "VALID"), 0)
        a2 = act(conv(a1, w2, [(1, 1), (1, 1)]), 2)
        y3 = conv(a2, w3.reshape(1, 1, 512, 2048), "VALID")
        return jnp.maximum(y3.astype(jnp.float32) * a[4] + a[5]
                           + jx.astype(jnp.float32), 0.0).astype(bf)

    jx = jnp.asarray(x, bf)
    want = np.asarray(jax.jit(plain_ops).lower(jx).compile(
        {"xla_allow_excess_precision": False})(jx), np.float32)
    got = _nhwc(tk.fused_bottleneck_plain(
        _nchw(x).to(torch.bfloat16), *_port_weights(w1, w2, w3),
        [torch.from_numpy(v) for v in aff]))
    assert jk.pick_tile(1024, 4, 4, 512) is None
    assert _rel(got, want) < 1e-2
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


# ---------------------------------------------------------------------------
# (d) the fused Bottleneck against JAX's, bf16
# ---------------------------------------------------------------------------

BLOCK = dict(n=4, h=5, w=5, c=64)   # k = 2 of 4 rows: stats_fraction 0.5


def _jax_block(fused_train):
    norm = lambda **kw: JSubsetBatchNorm(
        use_running_average=not fused_train, momentum=0.9, epsilon=1e-5,
        dtype=jnp.bfloat16, stats_fraction=0.5, min_stats_samples=2, **kw)
    fold = lambda **kw: JFoldedBatchNorm(
        use_running_average=not fused_train, momentum=0.9, epsilon=1e-5,
        **kw)
    return JBottleneck(features=BLOCK["c"], stride=1, norm=norm,
                       dtype=jnp.bfloat16, fused=True, fold_norm=fold,
                       fused_interpret=True, stats_fraction=0.5,
                       min_stats_samples=2)


def _exact_bf16_conv(self, x):
    """Conv.forward with its bf16 output exactly rounded, as XLA's CPU
    convolution rounds it."""
    return torch.nn.functional.conv2d(
        x.double(), self.weight.to(self.dtype).double(), None, self.stride,
        self.padding).to(self.dtype)


@pytest.fixture(scope="module")
def block_case():
    n, h, w, c = BLOCK["n"], BLOCK["h"], BLOCK["w"], BLOCK["c"]
    assert jk.pick_tile(n, h, w, c) is not None    # JAX runs its kernel
    rng = np.random.default_rng(1)
    block = Bottleneck(4 * c, c, 1, lambda f: SubsetBatchNorm(f),
                       torch.bfloat16, 0.5, min_stats_samples=2, fused=True,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # running statistics away from their init
        for name, bn in block.named_children():
            if name.startswith("bn"):
                bn.running_mean.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.5, bn.running_mean.shape).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(rng.uniform(
                    0.5, 2.0, bn.running_var.shape).astype(np.float32)))
    params, stats = simclr_to_jax(block.state_dict())
    x = _bf16(rng.standard_normal((n, h, w, 4 * c)))
    cot = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    out = {}
    for train in (False, True):   # eval first: training moves the stats
        jblock = _jax_block(train)

        def jstep(p, xx):
            def jloss(p):
                y, upd = jblock.apply({"params": p, "batch_stats": stats},
                                      xx, mutable=["batch_stats"])
                return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)
            return jax.value_and_grad(jloss, has_aux=True)(p)

        # By default XLA may keep pass A's bf16 conv outputs in float32
        # under jit (excess precision); the block rounds them, as JAX's
        # own tests run it op by op.
        jx = jnp.asarray(x, jnp.bfloat16)
        (_, (jy, jupd)), jg = jax.jit(jstep).lower(params, jx).compile(
            {"xla_allow_excess_precision": False})(params, jx)
        block.train(train)
        for p in block.parameters():
            p.grad = None
        tx = _nchw(x).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with mock.patch.object(Conv, "forward", _exact_bf16_conv):
            ty = block(tx)
        (ty.float() * _nchw(cot)).sum().backward()
        tg = dict(_flat(simclr_to_jax(
            {k: p.grad for k, p in block.named_parameters()})[0]))
        out[train] = dict(
            y=(_nhwc(ty), np.asarray(jy, np.float32)),
            grads=(tg, dict(_flat(jax.device_get(jg)))),
            stats=(dict(_flat(simclr_to_jax(block.state_dict())[1])),
                   dict(_flat(jax.device_get(jupd["batch_stats"])))))
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_block_output_matches_jax(block_case, train):
    got, want = block_case[train]["y"]
    assert _rel(got, want) < 1e-3


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_block_gradients_match_jax(block_case, train):
    tg, jg = block_case[train]["grads"]
    assert tg.keys() == jg.keys()
    for name, b in jg.items():
        assert _rel(tg[name], b) < 1e-2, (name, _rel(tg[name], b))


def test_fused_block_running_stats_match_jax(block_case):
    ts, js = block_case[True]["stats"]
    assert ts.keys() == js.keys()
    for name, b in js.items():
        np.testing.assert_allclose(ts[name], b, rtol=1e-3, atol=3e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (e) the float32 model against JAX, (f) names, (g) bf16 fused vs unfused
# ---------------------------------------------------------------------------

TINY = dict(stage_sizes=(2, 2), width=16, feature_dim=128,
            compressed_dim=16, bn_stats_fraction=0.25,
            fuse_identity_blocks=True)


@pytest.fixture(scope="module")
def f32_model_case():
    """Objective sum(z^2) + 0.1 sum|h|, its gradients and the running
    statistics after the training forward, port and JAX, from the port's
    seed-0 weights; 96 images of 8x8, so k = 64 < 96."""
    cfg = dict(TINY, compute_dtype="float32", bn_dtype="float32")
    tmodel = SimCLR(ModelConfig(**cfg),
                    generator=torch.Generator().manual_seed(0))
    params, stats = simclr_to_jax(tmodel.state_dict())
    jmodel = JSimCLR(cfg=JModelConfig(**cfg))
    x = np.random.default_rng(2).normal(0.0, 1.0, (96, 8, 8, 3)).astype(
        np.float32)

    @jax.jit
    def jstep(p):
        def loss(p):
            (h, z), upd = jmodel.apply({"params": p, "batch_stats": stats},
                                       jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
            return (jnp.sum(jnp.square(z)) + 0.1 * jnp.sum(jnp.abs(h)),
                    upd["batch_stats"])
        return jax.value_and_grad(loss, has_aux=True)(p)

    (jl, jstats), jg = jstep(params)
    tmodel.train()
    h, z = tmodel(_nchw(x))
    tl = z.square().sum() + 0.1 * h.abs().sum()
    tl.backward()
    return dict(
        loss=(tl.item(), float(jl)),
        grads=(dict(_flat(simclr_to_jax(
            {n: p.grad for n, p in tmodel.named_parameters()})[0])),
            dict(_flat(jax.device_get(jg)))),
        stats=(dict(_flat(simclr_to_jax(tmodel.state_dict())[1])),
               dict(_flat(jax.device_get(jstats)))),
        fused=[n for n, m in tmodel.f.named_modules()
               if getattr(m, "fused", False)])


def test_f32_model_loss_matches_jax(f32_model_case):
    assert f32_model_case["fused"] == ["layer1_1", "layer2_1"]
    tl, jl = f32_model_case["loss"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_f32_model_gradients_match_jax(f32_model_case):
    tg, jg = f32_model_case["grads"]
    assert tg.keys() == jg.keys()
    gscale = float(np.sqrt(sum(float(np.vdot(v, v)) for v in jg.values())))
    for name, b in jg.items():
        denom = max(float(np.linalg.norm(b)), 1e-3 * gscale)
        assert np.linalg.norm(tg[name] - b) / denom < 1e-4, name


def test_f32_model_running_stats_match_jax(f32_model_case):
    ts, js = f32_model_case["stats"]
    assert ts.keys() == js.keys()
    for name, b in js.items():
        np.testing.assert_allclose(ts[name], b, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_state_dict_names_do_not_depend_on_the_flag():
    on = SimCLR(ModelConfig(**TINY),
                generator=torch.Generator().manual_seed(0)).state_dict()
    off = SimCLR(ModelConfig(**dict(TINY, fuse_identity_blocks=False)),
                 generator=torch.Generator().manual_seed(0)).state_dict()
    assert on.keys() == off.keys()
    for name, t in off.items():   # same init draws, in the same order
        torch.testing.assert_close(on[name], t, rtol=0, atol=0)


def test_jax_fused_weights_load_into_the_port_and_back():
    cfg = dict(TINY, stage_sizes=(2,), compute_dtype="float32",
               bn_dtype="float32")
    variables = jax.jit(lambda key: JSimCLR(cfg=JModelConfig(**cfg)).init(
        key, jnp.zeros((2, 8, 8, 3)), train=False))(jax.random.key(0))
    model = SimCLR(ModelConfig(**cfg))
    model.load_state_dict(simclr_from_jax(variables["params"],
                                          variables["batch_stats"]))
    params, stats = simclr_to_jax(model.state_dict())
    for tree, back in ((variables["params"], params),
                       (variables["batch_stats"], stats)):
        want, got = dict(_flat(jax.device_get(tree))), dict(_flat(back))
        assert want.keys() == got.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_bf16_fused_model_tracks_the_unfused_one():
    """layer1_1 (C = 64) takes the fused path (on the CPU the kernels'
    plain versions); the same weights unfused are the reference."""
    cfg = dict(stage_sizes=(2, 1), width=64, feature_dim=256,
               compressed_dim=32, bn_stats_fraction=0.5)
    x = _nchw(np.random.default_rng(3).normal(
        0.0, 1.0, (32, 8, 8, 3)).astype(np.float32))
    runs = []
    for fused in (True, False):
        model = SimCLR(ModelConfig(**cfg, fuse_identity_blocks=fused),
                       generator=torch.Generator().manual_seed(0))
        model.train()
        _, z = model(x)
        loss, _ = nt_xent_loss(z[:16], z[16:], 0.5)
        loss.backward()
        runs.append((loss.item(), torch.cat(
            [p.grad.flatten() for p in model.parameters()])))
    assert model.f.layer1_1.fused is False
    (lf, gf), (lu, gu) = runs
    np.testing.assert_allclose(lf, lu, rtol=2e-2)
    assert float(torch.nn.functional.cosine_similarity(gf, gu, dim=0)) > 0.9


# ---------------------------------------------------------------------------
# (h) block selection, the gate, the CPU wrappers
# ---------------------------------------------------------------------------

def test_fuse_min_width_and_the_bn_relu_rule_pick_the_blocks():
    cfg = ModelConfig(stage_sizes=(2, 2), width=64, feature_dim=128,
                      fuse_identity_blocks=True, fuse_min_width=128,
                      bn_relu_fused=True, winograd_conv2=True)
    f = SimCLR(cfg).f
    assert [n for n in f.block_names if f.get_submodule(n).fused] == [
        "layer2_1"]
    assert isinstance(f.layer2_1.bn1, FoldedBatchNorm)
    # The fused block's conv2 is the plain Conv, whatever winograd says;
    # bn_relu_fused is off under fuse_identity_blocks, as in JAX.
    assert type(f.layer2_1.conv2) is type(f.layer2_1.conv1)
    assert isinstance(f.layer1_1.bn1, SubsetBatchNorm)
    assert not f.layer1_1.fused_bn


def test_gate():
    bf, cl = torch.bfloat16, torch.channels_last
    ok = tk.supports
    assert ok(torch.zeros(3, 256, 7, 7, dtype=bf), 64)
    assert ok(torch.zeros(1, 2048, 1, 16, dtype=bf).to(memory_format=cl),
              512)
    assert ok(torch.zeros(2, 256, 3, 128, dtype=bf), 64)
    assert not ok(torch.zeros(1, 2048, 1, 17, dtype=bf), 512)   # W > M
    assert not ok(torch.zeros(3, 256, 7, 7), 64)                # float32
    assert not ok(torch.zeros(3, 160, 7, 7, dtype=bf), 40)      # C
    assert not ok(torch.zeros(3, 128, 7, 7, dtype=bf), 32)      # C
    assert not ok(torch.zeros(3, 256, 7, 7, dtype=bf), 128)     # 4C
    assert not ok(torch.zeros(0, 256, 7, 7, dtype=bf), 64)
    # JAX's pick_tile is a VMEM rule: it refuses layer4 at batch 1024.
    assert jk.pick_tile(1024, 4, 4, 512) is None
    assert ok(torch.zeros(1024, 2048, 4, 4, dtype=bf), 512)


def test_wrappers_run_the_plain_version_on_cpu_uncounted():
    x, g, ws, aff = _op_inputs(4, 2, 3, 4, 64)
    tx, tg = _nchw(x).to(torch.bfloat16), _nchw(g).to(torch.bfloat16)
    tw = _port_weights(*ws)
    taff = [torch.from_numpy(a) for a in aff]
    before = (tk.bottleneck_fwd.launches, tk.bottleneck_bwd.launches)
    torch.testing.assert_close(tk.bottleneck_fwd(tx, *tw, taff),
                               tk.fused_bottleneck_plain(tx, *tw, taff),
                               rtol=0, atol=0)
    for a, b in zip(tk.bottleneck_bwd(tx, *tw, taff, tg),
                    tk.fused_bottleneck_bwd_plain(tx, *tw, taff, tg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tk.bottleneck_fwd.launches, tk.bottleneck_bwd.launches) == before
    with pytest.raises(ValueError, match="no bottleneck kernel"):
        tk.bottleneck_fwd(tx.to("meta"), *(t.to("meta") for t in tw),
                          [a.to("meta") for a in taff])


def test_pack_weights_layout():
    c = 64
    w1, w2, w3 = (torch.randn(s) for s in ((c, 4 * c, 1, 1), (c, c, 3, 3),
                                            (4 * c, c, 1, 1)))
    fwd = tk.pack_weights(w1, w2, w3, backward=False).float()
    bwd = tk.pack_weights(w1, w2, w3, backward=True).float()
    bf = lambda t: t.to(torch.bfloat16).float()
    m1, t2, m3 = fwd.split([4 * c * c, 9 * c * c, 4 * c * c])
    m3t, t2r, m1t = bwd.split([4 * c * c, 9 * c * c, 4 * c * c])
    # Each matrix [N][K] as ring chunks: [pass of np_ rows][64-deep step]
    # [row][64], the 16-byte chunk j of row r at j ^ (r % 8); np_ = 64 for
    # w1, w2, w3^T and w2 rotated, 128 for w3 and w1^T at C = 64.
    n1, n2, n3 = nt3, nt2, nt1 = tk.pass_widths(c)
    assert (n1, n2, n3) == (64, 64, 128)

    def at(chunks, n, k, row, col, np_):
        p, r = divmod(row, np_)
        s, kk = divmod(col, 64)
        return chunks[((p * (k // 64) + s) * np_ + r) * 64
                      + ((kk // 8) ^ (r % 8)) * 8 + kk % 8]
    for row, col in ((0, 0), (5, 77), (63, 255), (9, 130)):
        assert at(m1, c, 4 * c, row, col, n1) == bf(w1)[row, col, 0, 0]
        assert at(m1t, 4 * c, c, col, row, nt1) == bf(w1)[row, col, 0, 0]
        assert at(m3, 4 * c, c, col, row, n3) == bf(w3)[col, row, 0, 0]
        assert at(m3t, c, 4 * c, row, col, nt3) == bf(w3)[col, row, 0, 0]
    # w2: [co][tap = 3 ky + kx][ci]; the backward's rotated and swapped.
    assert at(t2, c, 9 * c, 5, (3 * 1 + 2) * c + 7, n2) == bf(w2)[5, 7, 1, 2]
    assert at(t2r, c, 9 * c, 5, (3 * 1 + 2) * c + 7, nt2) \
        == bf(w2)[7, 5, 1, 0]
    torch.testing.assert_close(tk.unpack_matrix(m1, c, 4 * c, n1),
                               bf(w1).view(c, 4 * c), rtol=0, atol=0)
    torch.testing.assert_close(tk.unpack_matrix(m3, 4 * c, c, n3),
                               bf(w3).view(4 * c, c), rtol=0, atol=0)
    torch.testing.assert_close(tk.unpack_matrix(m1t, 4 * c, c, nt1),
                               bf(w1).view(c, 4 * c).t(), rtol=0, atol=0)
    torch.testing.assert_close(tk.unpack_matrix(m3t, c, 4 * c, nt3),
                               bf(w3).view(4 * c, c).t(), rtol=0, atol=0)
    torch.testing.assert_close(
        tk.unpack_matrix(t2, c, 9 * c, n2).view(c, 3, 3, c)[5, 1, 2, 7],
        bf(w2)[5, 7, 1, 2])
    torch.testing.assert_close(
        tk.unpack_matrix(t2r, c, 9 * c, nt2).view(c, 3, 3, c)[5, 1, 2, 7],
        bf(w2)[7, 5, 1, 0])
