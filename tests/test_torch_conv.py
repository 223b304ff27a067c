"""Kernels B4 (layer1's C = 64 conv) and B5 (Winograd F(2x2,3x3) conv2)
in the port against the JAX package, and the model with
``conv64_pallas`` and ``winograd_conv2``.

JAX runs on the CPU with its Pallas kernels in interpret mode, as
``tests/test_conv64.py`` and ``tests/test_winograd.py`` run them; the
port runs its plain versions (the kernel wrappers take them for CPU
tensors). Inputs come from numpy with a seed; JAX is NHWC/HWIO, the port
NCHW (channels_last memory)/OIHW.

Tolerances:

* conv64, bf16 (both: float32 sums of the bf16 operands, one rounding
  to bf16): y and dx within one bf16 ulp of JAX's (2**-7 relative) plus
  1e-5 of the largest entry for elements near 0; dW (float32, not
  rounded, on both sides) within 2e-5 of the per-entry sum of |terms|
  (float32 sums over 12,288 pixels in another order).
* Winograd where JAX runs its kernel: the same V (bf16 of the same
  float32 sums) and the same output transform; U may differ by one bf16
  ulp where the two einsums round the float32 filter transform apart, and
  M is summed in another order. y and dx within 2e-3 in relative norm and
  2e-2 of the largest entry; dw within 2e-3 in norm (float32 inputs) and,
  in bf16, where both round y, dx and dw to bf16, 1e-2.
* Winograd where JAX's ``_pick_s`` sends the shape to its direct
  convolution (layer4's 4x4 and the C != K case at these batches), the
  port's Winograd against JAX's direct convolution, with
  ``tests/test_winograd.py``'s own bound: 2e-2 of the largest entry.
* Direct convolution outside ``supported()``: equal to ``F.conv2d`` in
  the port, and within 1e-5 of JAX's (float32, another summation order).
* Model: a tiny bf16 SimCLR against JAX. In bf16 each side rounds every
  convolution and BN pass in its own order, so the same model without the
  flags already differs from JAX by up to 23% in a trunk gradient; with
  the flags each error (h, z, every gradient) is held to at most 1.25x
  its error without them, plus 0.01 (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simclr_tpu.config import ModelConfig as JModelConfig
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops.pallas import conv64 as jc64
from simclr_tpu.ops.pallas import winograd as jwg
from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models.resnet import PallasConv3x3C64, WinogradConv3x3
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.kernels import conv64 as tc64
from simclr_tpu_torch.ops.kernels import winograd as twg
from simclr_tpu_torch.utils.weights import simclr_to_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


ULP = 2.0 ** -7


def _nchw(a):
    """NHWC numpy -> NCHW torch tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


def _oihw(w):
    """HWIO numpy -> OIHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _hwio(t):
    return t.detach().to(torch.float32).permute(2, 3, 1, 0).numpy()


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _assert_within_ulp(got, want, what):
    err = np.abs(got - want)
    bound = ULP * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (err <= bound).all(), (what, err.max())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_grads(fn, x, w, g):
    """JAX (y, dx, dw) of sum(fn(x, w) * g), as float32 numpy."""
    def loss(xv, wv):
        y = fn(xv, wv)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, y), (dx, dw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, w)
    return [np.asarray(a, np.float32) for a in (y, dx, dw)]


def _port_grads(fn, x, w, g):
    """Port (y, dx, dw) of sum(fn(x, w) * g) for NHWC/HWIO numpy inputs
    in the given torch dtypes, as NHWC/HWIO float32 numpy."""
    xt, wt = x.requires_grad_(), w.requires_grad_()
    y = fn(xt, wt)
    (y.to(torch.float32) * _nchw(g)).sum().backward()
    return _nhwc(y), _nhwc(xt.grad), _hwio(wt.grad)


# ---------------------------------------------------------------------------
# conv64 (B4)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conv64_case():
    """N = 256 (one JAX lane tile), 6x8, bf16 x and g, float32 w."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((jc64.LANES, 6, 8, 64)))
    w = (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32)
    g = _bf16(rng.standard_normal((jc64.LANES, 6, 8, 64)))
    jout = _jax_grads(lambda a, b: jc64.conv3x3_c64(a, b, True),
                      jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), g)
    xt = _nchw(x).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    tout = _port_grads(tc64.conv3x3_c64, xt, _oihw(w), g)
    return dict(x=x, w=w, g=g, jax=jout, port=tout)


def test_conv64_value_and_dx_match_jax_pallas(conv64_case):
    for got, want, name in zip(conv64_case["port"][:2],
                               conv64_case["jax"][:2], ("y", "dx")):
        _assert_within_ulp(got, want, name)


def test_conv64_dw_stays_float32_and_matches_jax_pallas(conv64_case):
    x, g = conv64_case["x"], conv64_case["g"]
    dw, jdw = conv64_case["port"][2], conv64_case["jax"][2]
    # Sum of |terms| of each dW entry: the scale of float32 order error.
    scale = _hwio(tc64.wgrad_c64_plain(_nchw(np.abs(x)), _nchw(np.abs(g))))
    assert (np.abs(dw - jdw) <= 2e-5 * scale + 1e-6).all()
    # float32, not rounded to bf16 (JAX's custom VJP returns it so too).
    assert not np.array_equal(dw, _bf16(dw))


def test_rot180_swap_matches_jax_and_gives_the_input_gradient():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        _hwio(tc64.rot180_swap(_oihw(w))),
        np.asarray(jc64._rot180_swap(jnp.asarray(w))))
    x = torch.randn(2, 64, 5, 6, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 64, 5, 6, dtype=torch.float64)
    wt = _oihw(w).to(torch.float64)
    F.conv2d(x, wt, padding=1).backward(g)
    torch.testing.assert_close(
        F.conv2d(g, tc64.rot180_swap(wt), padding=1), x.grad)


def test_conv64_gate():
    bf, cl = torch.bfloat16, torch.channels_last
    assert tc64.supports(torch.zeros(3, 64, 5, 7, dtype=bf))
    assert tc64.supports(torch.zeros(1, 64, 1, 1, dtype=bf)
                         .to(memory_format=cl))
    assert not tc64.supports(torch.zeros(3, 128, 5, 7, dtype=bf))
    assert not tc64.supports(torch.zeros(3, 64, 5, 7))          # float32
    assert not tc64.supports(torch.zeros(0, 64, 5, 7, dtype=bf))
    assert not tc64.supports(torch.zeros(64, 5, 7, dtype=bf))   # 3-D
    # JAX's gate is a TPU lane rule (batch % 256): the CUDA gate is not.
    assert not jc64.supports((255, 32, 32, 64), jnp.bfloat16)
    assert tc64.supports(torch.zeros(255, 64, 2, 2, dtype=bf))


def test_conv64_wrappers_run_the_plain_version_on_cpu_uncounted():
    x = torch.randn(2, 64, 3, 4).to(torch.bfloat16)
    w = torch.randn(64, 64, 3, 3)
    before = (tc64.conv_c64.launches, tc64.wgrad_c64.launches)
    torch.testing.assert_close(tc64.conv_c64(x, w),
                               tc64.conv3x3_c64_plain(x, w), rtol=0, atol=0)
    torch.testing.assert_close(tc64.wgrad_c64(x, x),
                               tc64.wgrad_c64_plain(x, x), rtol=0, atol=0)
    assert (tc64.conv_c64.launches, tc64.wgrad_c64.launches) == before
    with pytest.raises(ValueError, match="no conv64 kernel"):
        tc64.conv_c64(x.to("meta"), w.to("meta"))


# ---------------------------------------------------------------------------
# Winograd (B5)
# ---------------------------------------------------------------------------

# tests/test_winograd.py's shapes (N, H, C, K); JAX's _pick_s takes its
# kernel at the first two and its direct convolution at the last two.
WINO_SHAPES = [(8, 16, 128, 128), (8, 8, 256, 256), (4, 4, 512, 512),
               (2, 8, 128, 256)]


def _jax_takes_kernel(n, h, c, k):
    return jwg._pick_s(n, h, c, k) is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,c,k", WINO_SHAPES)
def test_winograd_matches_jax(n, h, c, k, dtype):
    rng = np.random.default_rng(n * h + c + k)
    x = rng.standard_normal((n, h, h, c)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, c, k))).astype(np.float32)
    g = rng.standard_normal((n, h, h, k)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        x, w, g = _bf16(x), _bf16(w), _bf16(g)
    assert twg.supported((n, c, h, h), (k, c, 3, 3), (1, 1))
    xt = _nchw(x).to(tdt).contiguous(memory_format=torch.channels_last)
    got = _port_grads(twg.winograd_conv3x3, xt, _oihw(w).to(tdt), g)
    if _jax_takes_kernel(n, h, c, k):
        want = _jax_grads(lambda a, b: jwg.winograd_conv3x3(a, b, True),
                          jnp.asarray(x, jdt), jnp.asarray(w, jdt), g)
        for a, b, name in zip(got[:2], want[:2], ("y", "dx")):
            assert _rel(a, b) < 2e-3, (name, _rel(a, b))
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name
        assert _rel(got[2], want[2]) < (2e-3 if dtype == "float32"
                                        else 1e-2)
    else:
        want = _jax_grads(jwg._direct_conv, jnp.asarray(x, jdt),
                          jnp.asarray(w, jdt), g)
        for a, b, name in zip(got, want, ("y", "dx", "dw")):
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


def test_transform_filter_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 128, 96)).astype(np.float32)
    u = twg.transform_filter(_oihw(w))
    assert u.shape == (16, 128, 96)
    np.testing.assert_allclose(u.numpy(), np.asarray(
        jwg.transform_filter(jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    # From bf16 weights (the model's) every sum is exact: equal bits.
    wb = _bf16(w)
    np.testing.assert_array_equal(
        twg.transform_filter(_oihw(wb)).numpy(),
        np.asarray(jwg.transform_filter(jnp.asarray(wb))))


def test_filter_grad_is_the_adjoint_of_transform_filter():
    w = torch.randn(32, 64, 3, 3, dtype=torch.float64)
    du = torch.randn(16, 64, 32, dtype=torch.float64)
    lhs = (twg.transform_filter(w.float()).double() * du).sum()
    rhs = (w * twg.filter_grad(du.float()).double()).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,wshape,stride", [
    ((4, 7, 7, 128), (3, 3, 128, 128), (1, 1)),    # odd spatial
    ((4, 8, 8, 80), (3, 3, 80, 80), (1, 1)),       # C % 32 != 0
    ((4, 8, 8, 128), (3, 3, 128, 128), (2, 2)),    # strided
])
def test_winograd_outside_the_gate_is_the_direct_conv(shape, wshape,
                                                      stride):
    n, h, w_, c = shape
    k = wshape[3]
    assert not twg.supported((n, c, h, w_), (k, c, 3, 3), stride)
    assert not jwg.supported(shape, wshape, stride)
    if stride != (1, 1):
        return   # the wrapper is only ever called with stride 1
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal(wshape)).astype(np.float32)
    got = twg.winograd_conv3x3(_nchw(x), _oihw(w))
    torch.testing.assert_close(got, F.conv2d(_nchw(x), _oihw(w), padding=1),
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(jwg.winograd_conv3x3(
            jnp.asarray(x), jnp.asarray(w), True)), rtol=1e-5, atol=1e-5)


def test_winograd_gate():
    ok = twg.supported
    assert ok((1, 512, 4, 4), (512, 512, 3, 3), (1, 1))      # layer4
    assert ok((3, 96, 6, 10), (160, 96, 3, 3), (1, 1))       # H != W
    assert ok((1, 32, 2, 2), (32, 32, 3, 3), (1, 1))
    assert not ok((2, 128, 5, 6), (128, 128, 3, 3), (1, 1))  # odd H
    assert not ok((2, 128, 6, 6), (128, 64, 3, 3), (1, 1))   # wc != C
    assert not ok((2, 128, 6, 6), (100, 128, 3, 3), (1, 1))  # K % 32
    assert not ok((2, 128, 6, 6), (128, 128, 1, 1), (1, 1))  # 1x1
    # JAX's TPU rules that the CUDA gate drops: C % 128, N % 2, H >= 4,
    # H == W.
    assert not jwg.supported((3, 4, 4, 128), (3, 3, 128, 128), (1, 1))
    assert not jwg.supported((2, 2, 2, 128), (3, 3, 128, 128), (1, 1))
    assert not jwg.supported((2, 4, 4, 96), (3, 3, 96, 96), (1, 1))
    assert ok((3, 96, 2, 4), (96, 96, 3, 3), (1, 1))


def test_winograd_wrappers_run_the_plain_version_on_cpu_uncounted():
    x = torch.randn(2, 32, 4, 6).to(torch.bfloat16)
    g = torch.randn(2, 64, 4, 6).to(torch.bfloat16)
    u = twg.transform_filter(torch.randn(64, 32, 3, 3)).to(torch.bfloat16)
    before = (twg.winograd_fwd.launches, twg.winograd_dw.launches)
    torch.testing.assert_close(twg.winograd_fwd(x, u),
                               twg.winograd_fwd_plain(x, u), rtol=0, atol=0)
    torch.testing.assert_close(twg.winograd_dw(x, g),
                               twg.winograd_dw_plain(x, g), rtol=0, atol=0)
    assert (twg.winograd_fwd.launches, twg.winograd_dw.launches) == before
    with pytest.raises(ValueError, match="no Winograd kernel"):
        twg.winograd_fwd(x.to("meta"), u.to("meta"))


# ---------------------------------------------------------------------------
# The model with both flags
# ---------------------------------------------------------------------------

TINY = dict(stage_sizes=(1, 2), width=64, feature_dim=256,
            compressed_dim=32, conv64_pallas=True, winograd_conv2=True)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_flags_pick_conv2_as_jax_does_and_keep_the_parameter_names():
    on = SimCLR(ModelConfig(**TINY))
    conv2 = {n: type(m) for n, m in on.f.named_modules()
             if n.endswith("conv2")}
    assert conv2 == {"layer1_0.conv2": PallasConv3x3C64,
                     "layer2_0.conv2": type(on.f.layer2_0.conv1),
                     "layer2_1.conv2": WinogradConv3x3}
    off = SimCLR(ModelConfig(**dict(TINY, conv64_pallas=False,
                                    winograd_conv2=False)))
    assert on.state_dict().keys() == off.state_dict().keys()
    for name, t in off.state_dict().items():
        assert on.state_dict()[name].shape == t.shape, name
    # float32 compute: both gates need bf16, so the plain conv, no error.
    f32 = SimCLR(ModelConfig(**dict(TINY, compute_dtype="float32")))
    assert not any(isinstance(m, (PallasConv3x3C64, WinogradConv3x3))
                   for m in f32.modules())


def _tiny_model_errors(flags):
    """Relative errors of the port's bf16 tiny SimCLR against JAX's, from
    the port's seed-0 weights: h, z, and every parameter gradient of
    sum(z^2) + 0.1 sum|h| in training mode (relative to its own norm or
    1e-3 of all gradients', as tests/test_torch_bn_relu.py)."""
    cfg = dict(TINY, conv64_pallas=flags, winograd_conv2=flags)
    tmodel = SimCLR(ModelConfig(**cfg),
                    generator=torch.Generator().manual_seed(0))
    params, stats = simclr_to_jax(tmodel.state_dict())
    jmodel = JSimCLR(cfg=JModelConfig(**cfg, conv64_interpret=True,
                                      winograd_interpret=True))
    x = np.random.default_rng(5).normal(0.0, 1.0, (256, 8, 8, 3)).astype(
        np.float32)

    @jax.jit
    def jstep(p):
        def loss(p):
            (h, z), _ = jmodel.apply({"params": p, "batch_stats": stats},
                                     jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
            return jnp.sum(jnp.square(z)) + 0.1 * jnp.sum(jnp.abs(h)), (h, z)
        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, (jh, jz)), jg = jstep(params)
    jg = dict(_flat(jax.device_get(jg)))
    tmodel.train()
    h, z = tmodel(_nchw(x))
    (z.square().sum() + 0.1 * h.abs().sum()).backward()
    tg = dict(_flat(simclr_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()})[0]))
    assert tg.keys() == jg.keys()
    gscale = float(np.sqrt(sum(float(np.vdot(v, v)) for v in jg.values())))
    errs = {name: float(np.linalg.norm(tg[name] - b)
                        / max(float(np.linalg.norm(b)), 1e-3 * gscale))
            for name, b in jg.items()}
    errs["h"] = _rel(h.detach().numpy(), np.asarray(jh))
    errs["z"] = _rel(z.detach().numpy(), np.asarray(jz))
    return errs


def test_tiny_model_matches_jax_pallas_interpret():
    """A bf16 SimCLR, stage_sizes (1, 2) at width 64, on 256 images of
    8x8: layer1_0's conv2 takes JAX's conv64 kernel (batch 256) and
    layer2_1's (128 features at 4x4) its Winograd kernel, both in
    interpret mode; the port runs its plain versions.

    In bf16 the two frameworks round every convolution and BN pass in
    their own order, and the same model without the flags already differs
    from JAX by 0.45% in h, 2.2% in z and up to 23% in a trunk gradient
    (66% in the head's first bias, zero in exact arithmetic). So the
    flags are held to that baseline: each error with them at most 1.25x
    its error without them, plus 0.01 (measured: at most 1.10x), and
    h, z and the trunk gradients within 1e-2, 4e-2 and 0.3."""
    assert jc64.supports((256, 8, 8, 64), jnp.bfloat16)
    assert jwg.supported((256, 4, 4, 128), (3, 3, 128, 128), (1, 1))
    assert _jax_takes_kernel(256, 4, 128, 128)
    on, off = _tiny_model_errors(True), _tiny_model_errors(False)
    for name, err in on.items():
        assert err <= 1.25 * off[name] + 0.01, (name, err, off[name])
    assert on["h"] < 1e-2 and on["z"] < 4e-2
    assert max(e for n, e in on.items() if n.startswith("f/")) < 0.3
