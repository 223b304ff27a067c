"""The port's SimCLR model against the JAX package's, weight for weight.

A width-16 ResNet (``stage_sizes=(1,1,1,1)``, ``feature_dim=512``) with
float32 compute and float32 BN, weights made by the port and carried to
JAX with ``simclr_to_jax``. The training forward runs 2N = 80 images, so
the statistics subset k = 64 < 80 and both the subset and the
``shadow_bn3`` branches run. Images are 16x16 to keep the CPU cost low
(the CIFAR stem has no fixed input size).

Tolerances, float32 on both sides, set from a float64 evaluation of the
port on the same weights and input (which the port itself matches to
1e-6 of each gradient's largest entry):

* values (h, z, loss, running statistics): rtol 1e-4, atol 1e-4. The JAX
  CPU run's training-mode z is off the float64 values by 3.9e-5, the
  port's by 8.7e-6.
* gradients: atol 2.5e-3 of each gradient's largest entry (and of the
  largest entry over all gradients for the head's first bias, which is
  zero in exact arithmetic because a BN follows it). The JAX CPU run's
  gradients upstream of the stride-2 convolutions are off the float64
  values by up to 1.6e-3 of their largest entry; the port's by 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.config import ModelConfig as JModelConfig
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu_torch.config import ModelConfig
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SMALL = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16,
             compute_dtype="float32", bn_dtype="float32")
N2, SIZE = 80, 16
RTOL, ATOL = 1e-4, 1e-4
GRAD_ATOL = 2.5e-3


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _pair(**over):
    torch_model = SimCLR(ModelConfig(**SMALL, **over),
                         generator=torch.Generator().manual_seed(0))
    params, stats = simclr_to_jax(torch_model.state_dict())
    # Non-trivial running statistics, so the eval path and the shift of
    # the one-pass variance are exercised.
    rng = np.random.default_rng(1)
    for name, v in list(_flat(stats)):
        *path, leaf = name.split("/")
        node = stats
        for p in path:
            node = node[p]
        node[leaf] = (v + rng.uniform(-0.2, 0.2, v.shape) if leaf == "mean"
                      else v * rng.uniform(0.5, 1.5, v.shape)).astype(
                          np.float32)
    torch_model.load_state_dict(simclr_from_jax(params, stats))
    return torch_model, JSimCLR(cfg=JModelConfig(**SMALL, **over)), \
        params, stats


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_weight_round_trip_is_exact():
    torch_model, _, params, stats = _pair()
    p2, s2 = simclr_to_jax(simclr_from_jax(params, stats))
    a, b = dict(_flat(params)), dict(_flat(p2))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    a, b = dict(_flat(stats)), dict(_flat(s2))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    sd = torch_model.state_dict()
    assert set(sd) == set(simclr_from_jax(params, stats))


def test_parameter_tree_matches_jax_init():
    """The port's modules mirror the JAX tree leaf for leaf and shape for
    shape (the init tree of the JAX model, traced without running it)."""
    _, jmodel, params, stats = _pair()
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)},
                            jnp.zeros((2, SIZE, SIZE, 3)), train=False))
    want = {k: v.shape for k, v in _flat(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))}
    have = {k: v.shape for k, v in _flat(params)}
    assert want == have
    assert {k for k, _ in _flat(jax.tree.map(
        lambda s: np.zeros(()), shapes["batch_stats"]))} == {
            k for k, _ in _flat(stats)}


def test_eval_forward_matches_jax():
    torch_model, jmodel, params, stats = _pair()
    x = _images(6, 0)
    jh, jz = jmodel.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
    torch_model.eval()
    with torch.no_grad():
        th, tz = torch_model(_nchw(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("over", [
    {},                                             # shipped: subset_st,
    {"bn_st_surrogate": "pad"},                     # affine, shadow_bn3
    {"bn_grad_mode": "exact", "bn3_shadow_stats": False},
], ids=["subset_st-affine-shadow", "subset_st-pad-shadow", "exact"])
def test_training_forward_and_gradients_match_jax(over):
    torch_model, jmodel, params, stats = _pair(**over)
    x = _images(N2, 2)
    r = np.random.default_rng(3).standard_normal((N2, 128)).astype(
        np.float32)

    @jax.jit
    def jax_step(p):
        def objective(p):
            (h, z), upd = jmodel.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
            return jnp.sum(z * r) + jnp.sum(h), (z, upd["batch_stats"])
        return jax.value_and_grad(objective, has_aux=True)(p)

    (jloss, (jz, jstats)), jgrads = jax_step(params)

    torch_model.train()
    th, tz = torch_model(_nchw(x))
    tloss = (tz * torch.from_numpy(r)).sum() + th.sum()
    tloss.backward()

    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL)
    tgrads = dict(_flat(simclr_to_jax(
        {n: p.grad for n, p in torch_model.named_parameters()})[0]))
    jgrads = dict(_flat(jax.device_get(jgrads)))
    assert tgrads.keys() == jgrads.keys()
    top = max(np.abs(g).max() for g in jgrads.values())
    for name, jg in jgrads.items():
        scale = top if name == "g/linear0/bias" else np.abs(jg).max()
        np.testing.assert_allclose(tgrads[name], jg, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)
    _, tstats = simclr_to_jax(torch_model.state_dict())
    for name, js in _flat(jax.device_get(jstats)):
        np.testing.assert_allclose(dict(_flat(tstats))[name], js,
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_unported_flags_raise():
    """The flags this test once saw refused are ported: each builds a
    model whose parameter and statistics tree is the JAX model's, leaf
    for leaf and shape for shape (the JAX tree is the same on and off
    each of them)."""
    _, jmodel, params, stats = _pair()
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)},
                            jnp.zeros((2, SIZE, SIZE, 3)), train=False))
    want = {k: v.shape for k, v in _flat(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))}
    want_stats = {k for k, _ in _flat(jax.tree.map(
        lambda s: np.zeros(()), shapes["batch_stats"]))}
    for field, value in [("fold_bn_scales", True), ("bn12_shadow_stats", True),
                         ("relu_from_output", True),
                         ("conv_wgrad_fraction", 0.5),
                         ("remat_stages", (0,))]:
        cfg = dataclasses.replace(ModelConfig(**SMALL), **{field: value})
        p, s = simclr_to_jax(SimCLR(cfg).state_dict())
        assert {k: v.shape for k, v in _flat(p)} == want, field
        assert {k for k, _ in _flat(s)} == want_stats, field
    # The MC-dropout encoder is ported; an unknown encoder is refused.
    SimCLR(dataclasses.replace(ModelConfig(**SMALL), encoder="dropout"))
    with pytest.raises(ValueError, match="unknown encoder"):
        SimCLR(dataclasses.replace(ModelConfig(**SMALL), encoder="other"))
