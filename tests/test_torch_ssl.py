"""The port's semi-supervised fine-tuning against the JAX package's, on the
CPU. With tests/test_torch_lin_eval.py in one process: 29-31 s on the CPU
box, about 12 s of it importing torch, JAX, flax and orbax.

Models: a tiny ``SimCLRFineTune`` (``stage_sizes=(1,1,1,1)``, width 2,
feature_dim 64, compressed_dim 16) in float32, with JAX-layout weights
made by the port from a seed and perturbed running statistics, carried
across with ``simclr_from_jax``; 16x16 images from a numpy seed. One JAX
oracle, a module-scoped fixture of jitted programs.

Tolerances and why:

* ``augment_fine_tune``'s apply: atol 2e-5 on normalised values of order
  1, as tests/test_torch_augment.py (the crop matmuls sum in another
  order).
* ``weighted_sample_indices``: frequencies within five standard errors of
  the probabilities that the JAX side's ``p = weights / sum(weights)``
  gives (PyTorch's and JAX's generators differ, so only the distributions
  can agree).
* ``sgd_nesterov`` against ``optax.sgd(nesterov=True)``: rtol 1e-6, atol
  1e-7 (float32 updates, one rounding apart).
* the forward, one fine-tune epoch in ``augment='none'`` mode and the
  eval batches (float32 on both sides): losses rtol 1e-4; accuracies
  equal; parameters within 1e-4 of their change in relative norm and
  running statistics rtol 1e-4, atol 1e-5 (XLA and PyTorch sum the
  convolutions in other orders; SGD's update is linear in the gradient,
  so nothing amplifies that).
"""

import dataclasses
import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data import pipeline as jpipe
from simclr_tpu.models.simclr import SimCLRFineTune as JFineTune
from simclr_tpu.ops import augment as ja
from simclr_tpu.train import common as jcommon
from simclr_tpu.train import ssl as jssl
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data import pipeline as tpipe
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.models.simclr import SimCLR, SimCLRFineTune
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.scripts import train_ssl as cli
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train import ssl as tssl
from simclr_tpu_torch.utils import checkpoint as ck
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

TINY = dict(feature_dim=64, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=2, compute_dtype="float32", bn_dtype="float32",
            fuse_identity_blocks=False, fold_bn_scales=False,
            bn_relu_fused=False)
EXPORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))),
    "results/simclr_bs16_nepoch8_cifar10_temp05.msgpack")
BATCH, STEPS, SIZE = 16, 3, 16


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


def _config(**train):
    return tcfg.Config(model=tcfg.ModelConfig(**TINY),
                       train=tcfg.TrainConfig(micro_batch_size=BATCH,
                                              **train))


# ---------------------------------------------------------------------------
# Pieces: the fine-tune view, weighted draws, SGD.
# ---------------------------------------------------------------------------

def test_augment_fine_tune_apply_matches_jax():
    rng = np.random.default_rng(0)
    images, _ = synthetic_dataset(8, 32, seed=3)
    n = images.shape[0]
    h = rng.uniform(4.0, 32.0, n).astype(np.float32)
    w = rng.uniform(4.0, 32.0, n).astype(np.float32)
    top = (rng.uniform(0.0, 1.0, n) * (32 - h)).astype(np.float32)
    left = (rng.uniform(0.0, 1.0, n) * (32 - w)).astype(np.float32)
    flip = rng.uniform(0.0, 1.0, n) < 0.5
    ds = jcfg.CIFAR10

    @jax.jit
    def jax_view(images, boxes, flip):
        x = ja.crop_resize_flip(ja.to_float(images), boxes,
                                (ds.img_size, ds.img_size), flip)
        return ja.normalize(x, ds.mean, ds.std)

    want = jax_view(jnp.asarray(images), (top, left, h, w), flip)
    params = ta.CropParams(tuple(torch.from_numpy(b)
                                 for b in (top, left, h, w)),
                           torch.from_numpy(flip))
    got = ta.augment_fine_tune_apply(torch.from_numpy(images), params, ds)
    assert got.shape == (n, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # The sampling entry point is its draws, then the apply.
    aug = tcfg.AugmentConfig()
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    drawn = ta.sample_fine_tune_params(g1, n, 32, 32, aug)
    assert torch.equal(
        ta.augment_fine_tune(g2, torch.from_numpy(images), aug, ds),
        ta.augment_fine_tune_apply(torch.from_numpy(images), drawn, ds))


def test_weighted_sample_indices_balances_the_classes():
    labels = np.repeat(np.arange(4), [5, 15, 30, 50])
    weights = tpipe.class_weights(labels)
    np.testing.assert_array_equal(weights, jpipe.class_weights(labels))
    n_draw, batch = 20000, 64
    gen = torch.Generator().manual_seed(0)
    idx = tpipe.weighted_sample_indices(gen, torch.from_numpy(weights),
                                        n_draw, batch)
    assert idx.shape == (n_draw // batch, batch)
    assert idx.dtype == torch.int64
    m = idx.numel()
    drawn = idx.numpy().ravel()
    # Every class at 1/4, as the JAX side's p = weights / sum(weights)
    # gives it.
    freq = np.bincount(labels[drawn], minlength=4) / m
    assert np.all(np.abs(freq - 0.25) < 5 * np.sqrt(0.25 * 0.75 / m)), freq
    # Within a class, every sample alike: class 0's five at 1/20 each.
    per = np.bincount(drawn, minlength=100)[:5] / m
    assert np.all(np.abs(per - 0.05) < 5 * np.sqrt(0.05 * 0.95 / m)), per
    # The same generator state draws the same rows.
    again = tpipe.weighted_sample_indices(
        torch.Generator().manual_seed(0), torch.from_numpy(weights), n_draw,
        batch)
    assert torch.equal(idx, again)


def test_sgd_nesterov_follows_optax():
    rng = np.random.default_rng(1)
    shapes = ((4, 3, 3, 3), (7,), (5, 6))
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = tcommon.sgd_nesterov(params, 0.02, 0.98)
    tx = optax.sgd(0.02, momentum=0.98, nesterov=True)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        updates, state = update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, q in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-7)
    # The first step's buffer is the gradient; a parameter with no
    # gradient stays where it is.
    first = torch.nn.Parameter(torch.ones(3))
    idle = torch.nn.Parameter(torch.ones(2))
    opt = tcommon.sgd_nesterov([first, idle], 0.5, 0.9)
    first.grad = torch.full((3,), 2.0)
    opt.step()
    assert torch.equal(opt.state[first]["momentum_buffer"],
                       torch.full((3,), 2.0))
    # g + m * buf = 2 + 0.9 * 2; times lr 0.5.
    torch.testing.assert_close(first.detach(), torch.full((3,), 1 - 1.9))
    assert torch.equal(idle.detach(), torch.ones(2))


# ---------------------------------------------------------------------------
# The model, one epoch and the eval batches against JAX.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    """JAX-layout SimCLRFineTune weights (the port's init from seed 3,
    running statistics perturbed), 40 16x16 images, and JAX's eval-mode
    logits on the first 8, one fine-tune epoch of 3 steps in 'none' mode
    and evaluate_classifier at batch 16 (a padded tail of 8)."""
    cfg = _config()
    model = SimCLRFineTune(cfg.model, 10,
                           generator=torch.Generator().manual_seed(3))
    params, stats = simclr_to_jax(model.state_dict())
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 1.5, leaf.shape)
                            if path[-1].key == "var"
                            else rng.normal(0.0, 0.2, leaf.shape)
                            ).astype(np.float32), stats)
    images, labels = synthetic_dataset(40, SIZE, seed=1)
    idx = np.random.default_rng(2).integers(0, 40, (STEPS, BATCH))
    jc = jcfg.Config(model=jcfg.ModelConfig(**TINY),
                     train=jcfg.TrainConfig(micro_batch_size=BATCH))
    jmodel = JFineTune(cfg=jc.model, num_classes=10)
    logits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats},
        ja.augment_test(jnp.asarray(images[:8]), jc.dataset))
    tx = jcommon.sgd_nesterov(jc.optim.lr_ssl, jc.optim.momentum_ssl)
    state = jcommon.TrainState.create(params, stats, tx)
    train_epoch, eval_batch = jssl.build_supervised_epoch_fns(
        jmodel, tx, jc, augment="none")
    ds = jpipe.DeviceDataset.from_numpy(images, labels)
    eval_before = jssl.evaluate_classifier(eval_batch, state, ds,
                                           batch_size=BATCH)
    state, (losses, accs) = train_epoch(state, ds.images, ds.labels,
                                        jnp.asarray(idx), jax.random.key(0))
    return dict(cfg=cfg, params=params, stats=stats, images=images,
                labels=labels, idx=idx, logits=np.asarray(logits),
                losses=np.asarray(losses), accs=np.asarray(accs),
                after=simclr_from_jax(state.params, state.batch_stats),
                eval_before=eval_before)


def _port(oracle):
    model = SimCLRFineTune(oracle["cfg"].model, 10)
    model.load_state_dict(simclr_from_jax(oracle["params"],
                                          oracle["stats"]))
    return model


def test_finetune_model_tree_and_forward_match_jax(oracle):
    model = _port(oracle)
    params, stats = simclr_to_jax(model.state_dict())
    want = jax.tree.map(np.shape, (oracle["params"], oracle["stats"]))
    assert jax.tree.map(np.shape, (params, stats)) == want
    assert set(params) == {"f", "g", "supervised_head"}
    assert model.supervised_head.weight.dtype == torch.float32
    # f and g carry SimCLR's names: an export loads into them whole.
    simclr = SimCLR(oracle["cfg"].model).state_dict()
    assert {k for k in model.state_dict()
            if not k.startswith("supervised_head.")} == set(simclr)
    model.eval()
    x = ta.augment_test(torch.from_numpy(oracle["images"][:8]),
                        oracle["cfg"].dataset)
    with torch.no_grad():
        logits = model(x.permute(0, 3, 1, 2))
    assert logits.shape == (8, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), oracle["logits"], rtol=1e-4,
                               atol=1e-5)


def _rel_change(got, want, start):
    diff = sum(float((got[k] - want[k]).double().norm() ** 2)
               for k in want) ** 0.5
    change = sum(float((want[k] - start[k]).double().norm() ** 2)
                 for k in want) ** 0.5
    return diff / change


def test_one_finetune_epoch_matches_jax(oracle):
    model = _port(oracle)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcommon.sgd_nesterov(model.parameters(), 0.02, 0.98)
    train_epoch, _ = tssl.build_supervised_epoch_fns(
        model, opt, oracle["cfg"], augment="none")
    state = tcommon.TrainState(model, opt)
    images = torch.from_numpy(oracle["images"])
    labels = torch.from_numpy(oracle["labels"].astype(np.int32))
    state, (losses, accs) = train_epoch(
        state, images, labels, torch.from_numpy(oracle["idx"]),
        torch.Generator().manual_seed(0))
    assert state.step == STEPS and losses.shape == (STEPS,)
    np.testing.assert_allclose(losses.numpy(), oracle["losses"], rtol=1e-4)
    np.testing.assert_array_equal(accs.numpy(), oracle["accs"])
    got, want = model.state_dict(), oracle["after"]
    weights = [k for k in want if "running" not in k]
    assert _rel_change(got, {k: want[k] for k in weights}, start) < 1e-4
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    # g never runs: its parameters and statistics are where they were.
    assert all(torch.equal(got[k], start[k]) for k in got
               if k.startswith("g."))
    assert not torch.equal(got["f.stem_conv.weight"],
                           start["f.stem_conv.weight"])


def test_evaluate_classifier_matches_jax_with_a_ragged_tail(oracle):
    model = _port(oracle)
    engine = tssl.SupervisedEngine(model, tcommon.sgd_nesterov(
        model.parameters(), 0.02, 0.98), oracle["cfg"], augment="none")
    state = tcommon.TrainState(model, engine.optimizer)
    ds = tpipe.DeviceDataset.from_numpy(oracle["images"], oracle["labels"],
                                        "cpu")
    loss, acc = tssl.evaluate_classifier(engine.eval_batch, state, ds,
                                         batch_size=BATCH)
    jloss, jacc = oracle["eval_before"]
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert acc == pytest.approx(jacc, abs=1e-9)
    # Padding rows (label -1) are left out of the loss and the count.
    padded = torch.cat([ds.labels[:8], torch.full((4,), -1,
                                                  dtype=torch.int32)])
    images = torch.cat([ds.images[:8], ds.images[:4]])
    nll, correct = engine.eval_batch(state, images, padded)
    nll8, correct8 = engine.eval_batch(state, ds.images[:8], ds.labels[:8])
    torch.testing.assert_close(nll, nll8)
    assert int(correct) == int(correct8)
    assert model.training


def test_supervised_mode_waits_for_its_augmentation():
    """The supervised view is ported: 'supervised' mode draws
    ``SupervisedParams`` and trains on ``augment_supervised_apply``'s
    views; an unknown mode is refused."""
    model = SimCLRFineTune(_config().model, 10)
    opt = tcommon.sgd_nesterov(model.parameters(), 0.02, 0.98)
    engine = tssl.SupervisedEngine(model, opt, _config(), "supervised")
    draws = engine.sample_params(torch.Generator().manual_seed(0), 4, SIZE,
                                 SIZE)
    assert isinstance(draws, ta.SupervisedParams)
    images = torch.from_numpy(synthetic_dataset(4, SIZE, seed=5)[0])
    _, (loss, _) = engine.train_step_on_params(
        tcommon.TrainState(model, opt), images,
        torch.zeros(4, dtype=torch.int32), draws)
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="unknown augment"):
        tssl.build_supervised_epoch_fns(model, opt, _config(), "other")


# ---------------------------------------------------------------------------
# init_finetune and the driver.
# ---------------------------------------------------------------------------

def _export_config():
    with open(EXPORT + ".json") as f:
        m = json.load(f)["model"]
    m["stage_sizes"] = tuple(m["stage_sizes"])
    return tcfg.Config(model=tcfg.ModelConfig(**m),
                       train=tcfg.TrainConfig(micro_batch_size=BATCH))


def test_init_finetune_grafts_either_export(tmp_path):
    cfg = _export_config()
    with open(EXPORT, "rb") as f:
        restored = fser.msgpack_restore(f.read())
    want = simclr_from_jax(restored["params"], restored["batch_stats"])
    ck.export_model(str(tmp_path / "m.pt"), want, "{}")
    fresh, _, _ = tssl.init_finetune(cfg, seed=7, device="cpu")
    fresh = fresh.state_dict()
    for path in (EXPORT, str(tmp_path / "m.pt")):
        model, state, opt = tssl.init_finetune(cfg, seed=7,
                                               pretrained_path=path,
                                               device="cpu")
        sd = model.state_dict()
        assert {k for k in sd if not k.startswith("supervised_head.")} == \
            set(want)
        assert all(torch.equal(sd[k], want[k]) for k in want)
        assert all(torch.equal(sd[k], fresh[k]) for k in sd
                   if k.startswith("supervised_head."))
        assert state.model is model and state.optimizer is opt
        assert isinstance(opt, torch.optim.SGD)
        group = opt.param_groups[0]
        assert (group["lr"], group["momentum"], group["nesterov"]) == (
            0.02, 0.98, True)
    # The MC-dropout encoder takes the same weights (dropout has none).
    dropout, _, _ = tssl.init_finetune(
        cfg.replace(model=dataclasses.replace(cfg.model, encoder="dropout")),
        seed=7, pretrained_path=EXPORT, device="cpu")
    assert dropout.f.mc_dropout
    assert all(torch.equal(dropout.state_dict()[k], want[k]) for k in want)


def test_train_ssl_stops_early_and_restores_the_best_parameters(
        monkeypatch):
    """Scripted validation accuracies 50, 60, 40, 30 with patience 2: the
    best is epoch 2, the run stops after epoch 4, and the parameters of
    epoch 2 come back before the test evaluation."""
    scripted = iter([50.0, 60.0, 40.0, 30.0, 99.0])
    seen = []

    def evaluate(eval_batch, state, ds, batch_size=512):
        seen.append([p.detach().clone()
                     for p in state.model.parameters()])
        return 1.0, next(scripted)

    monkeypatch.setattr(tssl, "evaluate_classifier", evaluate)
    images, labels = synthetic_dataset(2 * BATCH, SIZE, seed=2)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    lines = []
    result = tssl.train_ssl(_config(ssl_label_size=1.0), ds, val_ds=ds,
                            test_ds=ds, n_epochs=10, patience=2,
                            log=lines.append)
    assert len(result.history.loss["train"]) == 4
    assert result.history.accuracy["valid"] == [50.0, 60.0, 40.0, 30.0]
    assert result.best_acc == 60.0 and result.test_acc == 99.0
    assert len(result.epoch_seconds) == 4
    assert lines.count("Found a better model, saving...") == 2
    assert "Early stopping ... " in lines
    restored = seen[-1]
    assert all(torch.equal(a, b) for a, b in zip(restored, seen[1]))
    assert not all(torch.equal(a, b) for a, b in zip(restored, seen[3]))
    assert result.state.step == 4 * 2


def test_train_ssl_from_the_jax_export_with_weighted_draws():
    """10% labels: each epoch is max(floor(0.1 * n), batch) = 16 weighted
    draws, one step; f moves, g stays the export's."""
    cfg = _export_config().replace(train=dataclasses.replace(
        _export_config().train, ssl_label_size=0.1))
    images, labels = synthetic_dataset(120, SIZE, seed=4)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    lines = []
    result = tssl.train_ssl(cfg, ds, test_ds=ds, pretrained_path=EXPORT,
                            n_epochs=2, log=lines.append)
    assert result.state.step == 2
    values = [v for d in result.history.to_dict().values()
              for s in d.values() for v in s]
    assert len(result.history.loss["train"]) == 2 and np.all(
        np.isfinite(values))
    assert result.best_acc == 0.0 and 0.0 <= result.test_acc <= 100.0
    sd, _ = ck.load_pretrained(EXPORT)
    got = result.state.model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd if k.startswith("g."))
    assert not torch.equal(got["f.stem_conv.weight"],
                           sd["f.stem_conv.weight"])
    # The same seed draws the same epochs.
    again = tssl.train_ssl(cfg, ds, pretrained_path=EXPORT, n_epochs=2,
                           log=_quiet)
    assert again.history.loss["train"] == result.history.loss["train"]


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_cli_help_and_flags(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--model_path", "--n_epoch", "--batch_size",
                 "--ssl_label_size", "--device"):
        assert flag in out
    cfg = cli.config_from_args(cli.parse_args(
        ["--model_path", "m.pt", "--batch_size", "32", "--ssl_label_size",
         "1.0", "--dataset", "stl10"]))
    assert (cfg.train.micro_batch_size, cfg.train.ssl_label_size,
            cfg.dataset.name) == (32, 1.0, "stl10")


def test_cli_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_path", EXPORT])
