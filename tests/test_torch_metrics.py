"""The port's representation metrics (``simclr_tpu_torch/utils/metrics.py``)
and ``augment_anchor_pair`` against the JAX package's, on the CPU.

Inputs are made from a numpy seed and fed to both sides. Tolerances and
why:

* the five formulas, ``calc_nmi`` and ``_pairwise_metrics``: rtol 1e-5
  (atol 1e-6 where a value can be near 0): float32 on both sides, the
  reductions summed in other orders.
* ``bucketize_feature_values``: equal indices. Both sides build the
  boundaries by JAX's ``linspace`` formula and search on the left.
* the analogy: rtol 1e-5 on the same linear feature function.
* ``augment_anchor_pair``: the original bit for bit against JAX's eager
  ``augment_test`` (the same float32 subtract and divide) and within 1e-6
  of the jitted pair's (XLA fuses the division); the view within atol
  2e-5, as in ``tests/test_torch_augment.py`` (the port normalises before
  the blur).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data.pipeline import DeviceDataset as JDataset
from simclr_tpu.ops import augment as ja
from simclr_tpu.utils import metrics as jm
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import DeviceDataset
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.train.lin_eval import extract_features
from simclr_tpu_torch.utils import metrics as tm

from test_torch_augment import jax_view_params

RTOL = 1e-5

# The JAX oracles that several tests call at one shape, compiled once
# (eager, each JAX op compiles on its first call).
_jax_nmi = jax.jit(jm.calc_nmi)
_jax_pairwise = jax.jit(jm._pairwise_metrics)
_jax_anchor_pair = jax.jit(ja.augment_anchor_pair, static_argnums=(2, 3))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's thread pool costs more than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(n=24, d=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (a + rng.normal(scale=0.7, size=(n, d))).astype(np.float32)
    return a, b


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.from_numpy(x) for x in arrays))
    want = fn_j(*(jnp.asarray(x) for x in arrays))
    return got.numpy(), np.asarray(want)


# ---------------------------------------------------------------------------
# The formulas.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["calc_ned", "calc_nsed", "calc_corrcoeff",
                                  "cosine_similarity"])
def test_formula_matches_jax(name):
    a, b = _pair()
    got, want = _both(getattr(tm, name), getattr(jm, name), a, b)
    assert got.shape == (24,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_cosine_of_a_zero_row_is_zero_as_in_jax():
    """Each norm is clamped on its own: a zero row gives 0, not NaN."""
    a, b = _pair(4, 8)
    a[1] = 0.0
    b[2] = 0.0
    got, want = _both(tm.cosine_similarity, jm.cosine_similarity, a, b)
    assert got[1] == 0.0 and got[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # The same rows through F.cosine_similarity (one clamp of the
    # product) would agree here; the formula is written out so that the
    # clamp is JAX's.
    assert np.isfinite(got).all()


@pytest.mark.parametrize("shape", [(6, 64), (3, 5, 32)])
def test_bucketize_matches_jax(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got, want = _both(tm.bucketize_feature_values,
                      jm.bucketize_feature_values, x)
    assert got.shape == (1,) + shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # The extremes: the minimum in bucket 0, the maximum at D // 2.
    assert got.min() == 0 and got.max() == shape[-1] // 2


@pytest.mark.parametrize("case", ["independent", "identical", "affine"])
def test_nmi_matches_jax(case):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(8, 256)).astype(np.float32)
    b = {"independent": rng.normal(size=(8, 256)).astype(np.float32),
         "identical": a.copy(),
         "affine": (2.0 * a + 1.0).astype(np.float32)}[case]
    got, want = _both(tm.calc_nmi, _jax_nmi, a, b)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    if case == "identical":
        np.testing.assert_allclose(got, 1.0, rtol=1e-5)
    if case == "independent":
        assert (got < 0.2).all()


def test_nmi_of_a_constant_row_is_finite_as_in_jax():
    a, b = _pair(8, 256)
    a[0] = 0.5
    got, want = _both(tm.calc_nmi, _jax_nmi, a, b)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_pairwise_metrics_match_jax_with_one_permutation():
    a, b = _pair(16, 48, seed=7)
    perm = np.random.default_rng(7).permutation(16)
    got = tm._pairwise_metrics(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(perm))
    want = _jax_pairwise(jnp.asarray(a), jnp.asarray(b), jnp.asarray(perm))
    assert sorted(got) == sorted(want) == sorted(tm._METRIC_KEYS)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    # 4-D features are flattened per row, as on the JAX side.
    got4 = tm._pairwise_metrics(torch.from_numpy(a).reshape(16, 3, 4, 4),
                                torch.from_numpy(b).reshape(16, 3, 4, 4),
                                torch.from_numpy(perm))
    for k in want:
        np.testing.assert_array_equal(got4[k].numpy(), got[k].numpy())


# ---------------------------------------------------------------------------
# The loops over a dataset.
# ---------------------------------------------------------------------------

def _linear_fn(weight):
    """A feature function of a fixed projection of 4x4-pooled views, in
    both packages' signatures."""
    w_t = torch.from_numpy(weight)

    def port(x, generator=None):
        n, h, w, c = x.shape
        pooled = x.reshape(n, h // 4, 4, w // 4, 4, c).mean(dim=(2, 4))
        return pooled.reshape(n, -1) @ w_t

    def jax_fn(variables, x, key):
        n, h, w, c = x.shape
        pooled = x.reshape(n, h // 4, 4, w // 4, 4, c).mean(axis=(2, 4))
        return pooled.reshape(n, -1) @ variables

    return port, (jax_fn, jnp.asarray(weight))


@pytest.fixture(scope="module")
def data():
    images, labels = synthetic_dataset(70, 16, seed=11)
    weight = np.random.default_rng(11).normal(
        size=(48, 32)).astype(np.float32)
    return images, labels, weight


def _cfg16():
    ds = tcfg.DatasetConfig(name="cifar10", img_size=16)
    return tcfg.Config(dataset=ds)


def test_similarity_metrics_stop_at_the_ragged_batch_and_separate(data):
    images, labels, weight = data
    ds = DeviceDataset.from_numpy(images, labels, "cpu")
    fn, _ = _linear_fn(weight)
    cfg = _cfg16()
    m = tm.get_similarity_metrics(fn, ds, cfg, batch_size=16)
    # 70 images: four whole batches of 16, the ragged fifth is skipped.
    assert sorted(m) == sorted(tm._METRIC_KEYS)
    for k, v in m.items():
        assert v.shape == (64,) and np.isfinite(v).all(), k
    # Two views of one image are closer than two images.
    assert m["pos_cos"].mean() > m["neg_cos"].mean()
    assert m["pos_cc"].mean() > m["neg_cc"].mean()
    assert m["pos_ned"].mean() < m["neg_ned"].mean()
    two = tm.get_similarity_metrics(fn, ds, cfg, batch_size=16, n_batches=2)
    assert two["pos_cos"].shape == (32,)
    # The same seed draws the same views: the first two batches repeat.
    np.testing.assert_array_equal(two["pos_cos"], m["pos_cos"][:32])
    pair = tm.get_similarity_metrics_pairs(fn, fn, ds, cfg, batch_size=16,
                                           n_batches=1)
    np.testing.assert_array_equal(pair[0]["neg_nmi"], pair[1]["neg_nmi"])


def test_representation_analogy_matches_jax_and_flips_the_width(data):
    images, labels, weight = data
    fn, jfn = _linear_fn(weight)
    fn2, jfn2 = _linear_fn(weight[::-1].copy())
    cfg = _cfg16()
    ds = DeviceDataset.from_numpy(images, labels, "cpu")
    got = tm.get_representation_analogy(fn, fn2, ds, cfg, batch_size=20)
    jds = JDataset.from_numpy(images, labels)
    jc = jcfg.Config(dataset=jcfg.DatasetConfig(name="cifar10",
                                                 img_size=16))
    want = jm.get_representation_analogy(jfn, jfn2, jds, jc, batch_size=20)
    assert sorted(got) == sorted(want) == ["model1_l1", "model1_l2",
                                           "model2_l1", "model2_l2"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k

    # The axis: with the identity as feature function, the distances are
    # those of a flip of NHWC axis 2 (width), not of axis 1 (height).
    def ident(x, generator=None):
        return x

    got = tm.get_representation_analogy(ident, ident, ds, cfg,
                                        batch_size=20)
    orig = ta.augment_test(torch.from_numpy(images[:20]), cfg.dataset)
    o = orig.numpy()
    width = np.abs(o - o[:, :, ::-1, :]).mean()
    height = np.abs(o - o[:, ::-1, :, :]).mean()
    assert got["model1_l1"] == pytest.approx(float(width), rel=1e-6)
    assert abs(width - height) > 1e-3


def test_feature_fns_run_eval_mode_and_restore_the_flag():
    mcfg = tcfg.ModelConfig(feature_dim=32, compressed_dim=8,
                            stage_sizes=(1, 1, 1, 1), width=2,
                            compute_dtype="float32", bn_dtype="float32")
    model = SimCLR(mcfg, generator=torch.Generator().manual_seed(0))
    model.train()
    images, labels = synthetic_dataset(8, 16, seed=2)
    ds = DeviceDataset.from_numpy(images, labels, "cpu")
    cfg = _cfg16()
    x = ta.augment_test(ds.images, cfg.dataset)
    h = tm.contrastive_feature_fn(model)(x, None)
    z = tm.contrastive_feature_fn(model, use_hidden_feat=False)(x, None)
    assert model.training and not h.requires_grad
    want_h, _ = extract_features(model, ds, cfg)
    want_z, _ = extract_features(model, ds, cfg, use_hidden_feat=False)
    np.testing.assert_array_equal(h.numpy(), want_h.numpy())
    np.testing.assert_array_equal(z.numpy(), want_z.numpy())

    class Logits(torch.nn.Module):
        def forward(self, x, generator=None):
            return x.mean(dim=(2, 3))

    logits = Logits().train()
    out = tm.supervised_feature_fn(logits)(x, None)
    assert logits.training
    np.testing.assert_array_equal(out.numpy(), x.mean(dim=(1, 2)).numpy())


# ---------------------------------------------------------------------------
# The anchor pair.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_augment_anchor_pair_matches_jax(seed):
    n = 6
    imgs = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)
    key = jax.random.key(seed)
    want_orig, want_view = _jax_anchor_pair(
        key, jnp.asarray(imgs), jcfg.AugmentConfig(), jcfg.CIFAR10)
    orig, view = ta.augment_anchor_pair_apply(
        torch.from_numpy(imgs), jax_view_params(key, n, 32, 32),
        tcfg.CIFAR10)
    np.testing.assert_array_equal(
        orig.numpy(), np.asarray(ja.augment_test(jnp.asarray(imgs),
                                                 jcfg.CIFAR10)))
    np.testing.assert_allclose(orig.numpy(), np.asarray(want_orig),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(view.numpy(), np.asarray(want_view),
                               atol=2e-5, rtol=0)
    # The sampling entry point: the test view first, then one training
    # view drawn from the generator.
    gen = torch.Generator().manual_seed(seed)
    o2, v2 = ta.augment_anchor_pair(gen, torch.from_numpy(imgs),
                                    tcfg.AugmentConfig(), tcfg.CIFAR10)
    np.testing.assert_array_equal(o2.numpy(), orig.numpy())
    gen.manual_seed(seed)
    np.testing.assert_array_equal(
        v2.numpy(), ta.augment_train(gen, torch.from_numpy(imgs),
                                     tcfg.AugmentConfig(),
                                     tcfg.CIFAR10).numpy())
