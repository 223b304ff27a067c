"""The STL-10 configuration of the port against the JAX package's, on the
CPU: the 7x7 stride-2 stem with its ``[(3, 3), (3, 3)]`` padding and the
3x3 stride-2 max-pool with its ``[(1, 1), (1, 1)]`` -inf padding
(``low_quality_img=False``), and the STL-10 config (96x96, the 9-tap
blur).

A tiny ``low_quality_img=False`` SimCLR (``stage_sizes=(1,1,1,1)``, width
4, feature_dim 64, compressed_dim 16) in float32, its weights made by the
port and carried to JAX with ``simclr_to_jax``, with perturbed running
statistics. Inputs from a numpy seed.

Tolerances and why:

* the eval forward (h, z), float32 on both sides: rtol 1e-4, atol 1e-4,
  as ``tests/test_torch_model.py`` sets them.
* one pretrain step (a 2N = 80 forward, so the 64-row statistics subset
  and the shadow bn3 branch run; NT-Xent at T = 0.5), the port in float32
  against JAX's SimCLR evaluated in float64 (``jax.enable_x64``, float64
  compute and BN, the same weights and views): the loss within rtol
  1e-5, each gradient within 1e-4 of its largest entry (of the largest
  entry over all gradients for the head's first bias, zero in exact
  arithmetic). Measured: the port's float32 gradients are within 2e-5 of
  its own float64 ones, which equal JAX's float64 ones. JAX's float32 CPU
  gradients are off JAX's own float64 ones by up to 4.4e-2 of the largest
  entry here (the stem BN's bias, upstream of the stride-2 7x7 conv and
  the max-pool; 1.6e-3 behind the CIFAR stem), too far to hold the port
  to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops import augment as ja
from simclr_tpu.ops.losses import nt_xent_loss as jnt_xent
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.train.pretrain import _forward_pair, contrastive_fn
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

TINY = dict(feature_dim=64, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=4, compute_dtype="float32", bn_dtype="float32",
            low_quality_img=False)
RTOL, ATOL, GRAD_ATOL = 1e-4, 1e-4, 1e-4
N = 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: PyTorch's thread pool costs more than it gives."""
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


@pytest.fixture(scope="module")
def pair():
    model = SimCLR(tcfg.ModelConfig(**TINY),
                   generator=torch.Generator().manual_seed(0))
    params, stats = simclr_to_jax(model.state_dict())
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + rng.uniform(-0.2, 0.2, v.shape)
                         if path[-1].key == "mean"
                         else v * rng.uniform(0.5, 1.5, v.shape)
                         ).astype(np.float32), stats)
    model.load_state_dict(simclr_from_jax(params, stats))
    return model, JSimCLR(cfg=jcfg.ModelConfig(**TINY)), params, stats


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def test_stl10_config_matches_jax_and_builds_the_stem():
    t, j = tcfg.Config.for_dataset("stl10"), jcfg.Config.for_dataset("stl10")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.low_quality_img is False
    assert t.dataset.img_size == 96 and t.train.batch_size == 512
    assert ta.gaussian_kernel_size(96) == ja.gaussian_kernel_size(96) == 9
    model = SimCLR(dataclasses.replace(t.model, stage_sizes=(1, 1, 1, 1),
                                       width=4))
    stem = model.f.stem_conv
    assert stem.kernel_size == (7, 7) and stem.stride == (2, 2)
    assert stem.padding == (3, 3)
    # The CIFAR config keeps the 3x3 stride-1 stem and the 3-tap blur.
    c = tcfg.Config.for_dataset("cifar10")
    assert c.model.low_quality_img is True
    assert ta.gaussian_kernel_size(c.dataset.img_size) == 3


@pytest.mark.parametrize("size", [64, 65, 96])
def test_eval_forward_matches_jax(pair, size):
    """64 and 96 give even maps at every stride, 65 odd ones: each
    padding shows in the border rows."""
    model, jmodel, params, stats = pair
    x = _images(3, size, size)
    jh, jz = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
            params, stats, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        h, z = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)


def test_pretrain_step_gradients_match_jax_in_float64(pair):
    model, _, params, stats = pair
    v1, v2 = _images(N, 64, 2), _images(N, 64, 3)

    with jax.enable_x64(True):
        jmodel = JSimCLR(cfg=jcfg.ModelConfig(**{
            **TINY, "compute_dtype": "float64", "bn_dtype": "float64"}))
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params, stats))

        @jax.jit
        def jax_step(p):
            def objective(p):
                (_, z), _ = jmodel.apply(
                    {"params": p, "batch_stats": s64},
                    jnp.concatenate([v1, v2]).astype(jnp.float64),
                    train=True, mutable=["batch_stats"])
                z1, z2 = jnp.split(z, 2)
                return jnt_xent(z1, z2, 0.5, normalize=True)[0]
            return jax.value_and_grad(objective)(p)

        jloss, jgrads = jax.device_get(jax_step(p64))

    cfg = tcfg.Config.for_dataset("stl10")
    model.train()
    z1, z2 = _forward_pair(model, torch.from_numpy(v1), torch.from_numpy(v2))
    loss, _ = contrastive_fn(cfg, "cpu")(z1, z2)
    model.zero_grad(set_to_none=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = dict(_flat(simclr_to_jax(
        {n: p.grad for n, p in model.named_parameters()})[0]))
    jgrads = dict(_flat(jgrads))
    assert tgrads.keys() == jgrads.keys()
    assert tgrads["f/stem_conv/kernel"].shape == (7, 7, 3, 4)
    top = max(np.abs(g).max() for g in jgrads.values())
    for name, jg in jgrads.items():
        scale = top if name == "g/linear0/bias" else np.abs(jg).max()
        np.testing.assert_allclose(tgrads[name], jg, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)
    # Leave the module fixture's model as the eval tests expect it.
    model.load_state_dict(simclr_from_jax(params, stats))
