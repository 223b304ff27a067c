"""The port's linear evaluation and JAX-export reader against the JAX
package's, on the CPU. With tests/test_torch_ssl.py in one process: 29-31
s on the CPU box, about 12 s of it importing torch, JAX, flax and orbax.

Models: a tiny SimCLR (``stage_sizes=(1,1,1,1)``, width 2, feature_dim
64, compressed_dim 16) in float32, with JAX-layout weights made by the
port from a seed and perturbed running statistics, carried across with
``simclr_from_jax``; 16x16 images from a numpy seed. One JAX oracle per
module-scoped fixture, jitted.

Tolerances and why:

* ``center_crop`` / ``augment_test``: equal bit for bit (a slice, then
  the same float32 subtract and divide).
* features (float32 on both sides): rtol 1e-4, atol 1e-5; XLA and PyTorch
  sum the convolutions in other orders.
* the L-BFGS fit: the final objective within 1e-4 relative, the
  predictions equal, the row-centred logits (of size 1-3) within 1e-2
  absolute. The line searches differ (strong Wolfe against optax's zoom),
  so only the optimum is shared; the objective is so flat there that
  float32 no longer sees it change while the logits still differ by 3e-3
  (the port stops where the loss stops changing); ``b`` is fixed only up
  to a shift.
* ``linear_evaluation``: the test loss within 1e-3 relative and the
  top-1 equal, from features that agree to 1e-4.
* the msgpack reader: every leaf equal to flax's bit for bit; a port
  SimCLR built from the bf16 export against JAX's eval forward within
  2e-2 in relative norm (bf16 convolutions, rounded at other points).
"""

import dataclasses
import json
import math

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data.pipeline import DeviceDataset as JDataset
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops import augment as ja
from simclr_tpu.train import lin_eval as jl
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import DeviceDataset
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.scripts import lin_eval as cli
from simclr_tpu_torch.train import lin_eval as tl
from simclr_tpu_torch.utils import checkpoint as ck
from simclr_tpu_torch.utils import msgpack
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

TINY = dict(feature_dim=64, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=2, compute_dtype="float32", bn_dtype="float32",
            fuse_identity_blocks=False, fold_bn_scales=False,
            bn_relu_fused=False)
EXPORT = "results/simclr_bs16_nepoch8_cifar10_temp05.msgpack"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: PyTorch's thread pool costs more
    than it gives (the L-BFGS fit ran 8x slower on 8 threads)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _quiet(msg):
    pass


def _configs(n_steps=30):
    t = tcfg.Config(model=tcfg.ModelConfig(**TINY),
                    train=tcfg.TrainConfig(n_epoch_lin_eval=n_steps))
    j = jcfg.Config(model=jcfg.ModelConfig(**TINY),
                    train=jcfg.TrainConfig(n_epoch_lin_eval=n_steps))
    return t, j


def _repo_file(path):
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), path)


# ---------------------------------------------------------------------------
# The test view.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crop_dim", [None, (12, 10), (16, 16)])
def test_augment_test_and_center_crop_match_jax(crop_dim):
    images, _ = synthetic_dataset(6, 16, seed=2)
    ds = jcfg.CIFAR10
    got = ta.augment_test(torch.from_numpy(images), ds, crop_dim)
    want = ja.augment_test(jnp.asarray(images), ds, crop_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if crop_dim is not None:
        np.testing.assert_array_equal(
            ta.center_crop(torch.from_numpy(images), crop_dim).numpy(),
            np.asarray(ja.center_crop(jnp.asarray(images), crop_dim)))


# ---------------------------------------------------------------------------
# Features and the whole linear evaluation against JAX.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """JAX-layout weights with perturbed running statistics, a 200 / 40
    image split of 16x16 synthetic images, and JAX's features and linear
    evaluation on them: ``linear_evaluation``'s steps, with the features
    of both splits from one ``extract_features`` call (each call compiles
    its program anew)."""
    tc, jc = _configs()
    model = SimCLR(tc.model, generator=torch.Generator().manual_seed(3))
    params, stats = simclr_to_jax(model.state_dict())
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 1.5, leaf.shape)
                            if path[-1].key == "var"
                            else rng.normal(0.0, 0.2, leaf.shape)
                            ).astype(np.float32), stats)
    images, labels = synthetic_dataset(240, 16, seed=1)
    jmodel = JSimCLR(cfg=jc.model)
    every, targs = jl.extract_features(
        jmodel, params, stats, JDataset.from_numpy(images, labels), jc,
        batch_size=40)
    feats, targs = every[:200], targs[:200]
    clf, _ = jl.train_linear_classifier(
        feats, targs, reg_weight=jc.optim.reg_wt_lin_eval,
        n_steps=jc.train.n_epoch_lin_eval, max_iter=jc.optim.lbfgs_max_iter,
        n_class=jc.dataset.num_classes, log=_quiet)
    loss, acc = jl.evaluate_linear(clf, every[200:],
                                   jnp.asarray(labels[200:]))
    return dict(params=params, stats=stats, images=images, labels=labels,
                feats=np.asarray(feats), targs=np.asarray(targs),
                loss=loss, acc=acc, cfg=tc)


def _port_model(tiny):
    model = SimCLR(tiny["cfg"].model)
    model.load_state_dict(simclr_from_jax(tiny["params"], tiny["stats"]))
    return model


def test_extract_features_matches_jax_with_a_ragged_tail(tiny):
    """Batch 64 over 200 images: a tail of 8."""
    model = _port_model(tiny)
    model.train()
    ds = DeviceDataset.from_numpy(tiny["images"][:200],
                                  tiny["labels"][:200], "cpu")
    feats, targs = tl.extract_features(model, ds, tiny["cfg"],
                                       batch_size=64)
    assert feats.shape == (200, 64) and feats.dtype == torch.float32
    assert model.training
    np.testing.assert_allclose(feats.numpy(), tiny["feats"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(targs.numpy(), tiny["targs"])
    # One batch of all 200 gives the same rows: eval-mode BN is per sample.
    whole, _ = tl.extract_features(model, ds, tiny["cfg"], batch_size=512)
    np.testing.assert_allclose(whole.numpy(), feats.numpy(), rtol=1e-5,
                               atol=1e-6)
    z, _ = tl.extract_features(model, ds, tiny["cfg"], batch_size=64,
                               use_hidden_feat=False)
    assert z.shape == (200, 16)


def test_linear_evaluation_matches_jax(tiny):
    model = _port_model(tiny)
    train = DeviceDataset.from_numpy(tiny["images"][:200],
                                     tiny["labels"][:200], "cpu")
    test = DeviceDataset.from_numpy(tiny["images"][200:],
                                    tiny["labels"][200:], "cpu")
    lines = []
    loss, acc = tl.linear_evaluation(model, train, test, tiny["cfg"],
                                     log=lines.append)
    assert lines[0].startswith("lin-eval L-BFGS: loss 2.3026 -> ")
    np.testing.assert_allclose(loss, tiny["loss"], rtol=1e-3)
    assert acc == pytest.approx(tiny["acc"], abs=1e-9)


# ---------------------------------------------------------------------------
# The L-BFGS head on a toy problem.
# ---------------------------------------------------------------------------

def _toy(n=200, d=32, c=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(c, d) * 4
    labels = rng.randint(0, c, size=n)
    feats = (centers[labels] + rng.randn(n, d) * 0.3).astype(np.float32)
    return feats, labels


def _objective(feats, labels, w, b, reg):
    logits = feats.astype(np.float64) @ w + b
    m = logits.max(1, keepdims=True)
    lp = logits - m - np.log(np.exp(logits - m).sum(1, keepdims=True))
    return -lp[np.arange(len(labels)), labels].mean() + reg * (w ** 2).sum()


@pytest.fixture(scope="module")
def toy_fit():
    feats, labels = _toy()
    clf, trace = jl.train_linear_classifier(
        jnp.asarray(feats), jnp.asarray(labels), reg_weight=1e-3,
        n_steps=3, max_iter=20, n_class=4, log=_quiet)
    test, test_labels = _toy(n=50, seed=1)
    return dict(feats=feats, labels=labels, w=np.asarray(clf.w, np.float64),
                b=np.asarray(clf.b, np.float64), trace=np.asarray(trace),
                test=test, test_labels=test_labels,
                eval=jl.evaluate_linear(clf, jnp.asarray(test),
                                        jnp.asarray(test_labels)))


def test_train_linear_classifier_reaches_jaxs_optimum(toy_fit):
    feats, labels = toy_fit["feats"], toy_fit["labels"]
    lines = []
    clf, trace = tl.train_linear_classifier(
        torch.from_numpy(feats), torch.from_numpy(labels), reg_weight=1e-3,
        n_steps=3, max_iter=20, n_class=4, log=lines.append)
    assert clf.w.shape == (32, 4) and clf.b.shape == (4,)
    assert clf.w.dtype == torch.float32
    assert trace.shape == (4,)
    assert trace[0] == pytest.approx(math.log(4), rel=1e-6)
    assert toy_fit["trace"][0] == pytest.approx(math.log(4), rel=1e-6)
    assert np.all(np.diff(trace) <= 0)
    iters = int(lines[0].split("(")[1].split()[0])
    assert 0 < iters <= 60
    w, b = clf.w.double().numpy(), clf.b.double().numpy()
    got = _objective(feats, labels, w, b, 1e-3)
    want = _objective(feats, labels, toy_fit["w"], toy_fit["b"], 1e-3)
    assert got == pytest.approx(want, rel=1e-4)
    assert trace[-1] == pytest.approx(got, rel=1e-5)
    test = toy_fit["test"].astype(np.float64)
    lt, lj = test @ w + b, test @ toy_fit["w"] + toy_fit["b"]
    np.testing.assert_array_equal(lt.argmax(1), lj.argmax(1))
    np.testing.assert_allclose(lt - lt.mean(1, keepdims=True),
                               lj - lj.mean(1, keepdims=True), atol=1e-2)


def test_evaluate_linear_matches_jax(toy_fit):
    clf = tl.LinearClassifier(torch.from_numpy(toy_fit["w"]).float(),
                              torch.from_numpy(toy_fit["b"]).float())
    loss, acc = tl.evaluate_linear(clf, torch.from_numpy(toy_fit["test"]),
                                   torch.from_numpy(toy_fit["test_labels"]))
    jloss, jacc = toy_fit["eval"]
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert acc == pytest.approx(jacc, abs=1e-9)


def test_lbfgs_runs_in_true_float32_and_restores_the_tf32_flag():
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        seen = []
        with tl._true_float32():
            seen.append(matmul.allow_tf32)
        assert seen == [False] and matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# The msgpack reader and the JAX export.
# ---------------------------------------------------------------------------

def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_reader_restores_the_jax_export_bit_for_bit():
    raw = open(_repo_file(EXPORT), "rb").read()
    got, want = _leaves(msgpack.unpackb(raw)), _leaves(
        fser.msgpack_restore(raw))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 96
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    params, stats, cfg = ck.load_jax_export(_repo_file(EXPORT))
    assert set(params) == {"f", "g"} and set(stats) == {"f", "g"}
    assert cfg["model"]["width"] == 2


def test_reader_decodes_every_type_flax_writes():
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 62],
        "scalars": {"f64": np.float64(2.5), "i8": np.int8(-3),
                    "u16": np.uint16(7), "c": 3 + 4j, "pyfloat": 1.25,
                    "none": None, "t": True, "f": False},
        "strings": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000,
                    "café"],
        "bin": b"\x00\x01" * 200,
        "empty": np.zeros((0, 4), np.int64),
        "bf16": np.array([1.5, -2.25, 3e38], dtype=ml_dtypes.bfloat16),
        "0d": np.array(4.0, np.float16),
        "wide": {str(i): np.full((3,), i, np.int32) for i in range(20)},
        "long": list(range(20)),
    }
    encoded = fser.msgpack_serialize(tree)
    got, want = msgpack.unpackb(encoded), fser.msgpack_restore(encoded)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if isinstance(b, np.ndarray) and b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b.astype(np.float32))
        elif isinstance(b, (np.ndarray, np.generic)):
            assert type(a) is type(b) and a.dtype == b.dtype, path
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
        else:
            assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "begins no object"),
    (b"\x92\x01", "truncated"),
    (b"\x01\x02", "trailing"),
    (b"\xd4\x07\x00", "unknown extension type 7"),
])
def test_reader_refuses_what_it_cannot_read(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(data)


def test_reader_refuses_chunked_leaves():
    big = {"__msgpack_chunked_array__": True, "shape": {"0": 2},
           "chunks": {"0": np.zeros(2, np.float32)}}
    encoded = fser.msgpack_serialize({"params": {"w": big}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(encoded)


@pytest.fixture(scope="module")
def jax_export_forward():
    """JAX's eval-mode SimCLR forward of the in-repo bf16 export on 6
    images."""
    params, stats, cfg = ck.load_jax_export(_repo_file(EXPORT))
    m = dict(cfg["model"], stage_sizes=tuple(cfg["model"]["stage_sizes"]))
    images, _ = synthetic_dataset(6, 16, seed=5)
    x = ja.augment_test(jnp.asarray(images), jcfg.CIFAR10)
    jmodel = JSimCLR(cfg=jcfg.ModelConfig(**m))
    h, z = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    return dict(model=m, images=images, h=np.asarray(h), z=np.asarray(z))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_port_simclr_from_the_jax_export_matches_jaxs_forward(
        jax_export_forward, tmp_path):
    ref = jax_export_forward
    sd, cfg = ck.load_pretrained(_repo_file(EXPORT))
    model = SimCLR(tcfg.ModelConfig(**ref["model"]))
    model.load_state_dict(sd)
    model.eval()
    x = ta.augment_test(torch.from_numpy(ref["images"]), tcfg.CIFAR10)
    with torch.no_grad():
        h, z = model(x.permute(0, 3, 1, 2))
    assert _rel(h.numpy(), ref["h"]) < 2e-2
    assert _rel(z.numpy(), ref["z"]) < 2e-2
    # The same weights through a port export load alike.
    ck.export_model(str(tmp_path / "m.pt"), model, json.dumps(cfg))
    sd_pt, cfg_pt = ck.load_pretrained(str(tmp_path / "m.pt"))
    assert cfg_pt == cfg and sd_pt.keys() == sd.keys()
    assert all(torch.equal(sd_pt[k], sd[k]) for k in sd)


def test_linear_evaluation_accepts_either_export(tmp_path):
    """The same weights as a JAX .msgpack and as a port .pt export give
    the same linear evaluation."""
    sd, cfg = ck.load_pretrained(_repo_file(EXPORT))
    ck.export_model(str(tmp_path / "m.pt"), sd, json.dumps(cfg))
    m = dict(cfg["model"], stage_sizes=tuple(cfg["model"]["stage_sizes"]))
    tc = tcfg.Config(model=tcfg.ModelConfig(**m),
                     train=tcfg.TrainConfig(n_epoch_lin_eval=1))
    images, labels = synthetic_dataset(60, 16, seed=6)
    train = DeviceDataset.from_numpy(images[:40], labels[:40], "cpu")
    test = DeviceDataset.from_numpy(images[40:], labels[40:], "cpu")
    results = []
    for path in (EXPORT, str(tmp_path / "m.pt")):
        model = SimCLR(tc.model)
        model.load_state_dict(ck.load_pretrained(_repo_file(path))[0])
        results.append(tl.linear_evaluation(model, train, test, tc,
                                            log=_quiet))
    assert results[0] == results[1]
    assert all(np.isfinite(results[0]))


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_cli_help_and_flags(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--n_steps" in out and "model_path" in out
    args = cli.parse_args(["m.pt", "--dataset", "stl10", "--n_steps", "3",
                           "--data_dir", "d"])
    cfg = cli.config_from_args(args)
    assert cfg.train.n_epoch_lin_eval == 3 and cfg.dataset.name == "stl10"
    assert cfg.data_dir == "d" and args.device == "cuda"
    assert cli.config_from_args(cli.parse_args(["m.pt"])).to_json() == \
        tcfg.Config.for_dataset("cifar10").to_json()


def test_cli_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([_repo_file(EXPORT)])


def test_dataclass_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tl.LinearClassifier)] == \
        [f.name for f in dataclasses.fields(jl.LinearClassifier)]
