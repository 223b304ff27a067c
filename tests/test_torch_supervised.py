"""The port's supervised baseline against the JAX package's, on the CPU.

Models: ``SupervisedResNet`` at ``stage_sizes=(1,1,1,1)`` and width 4,
its weights made by the port from a seed and carried to JAX with
``simclr_to_jax``; 16x16 uint8 images from a numpy seed. The JAX oracles
are jitted once each, in module-scoped fixtures; no JAX training loop
runs.

Tolerances and why:

* ``translate_apply``: bit for bit. Integer shifts give tent weights of
  exactly 0 and 1, so each output is one input value or zero.
* ``augment_supervised_apply``: the flip and translate bit for bit; the
  whole view atol 1e-5 on normalised values. The colour chain is float32
  on both sides (the port's plain version of kernel B2, JAX's XLA ops),
  but its hue step alone differs by up to 9e-7 in [0, 1] (measured: the
  HSV round trip divides by max - min, which magnifies the one-ulp
  differences that contrast and saturation leave, and XLA orders its
  float32 ops otherwise); normalising divides by std ~ 0.25. Measured
  worst 6.9e-6.
* ``SupervisedResNet`` in float32: logits and loss rtol 1e-4, atol 1e-5;
  gradients within 1e-4 of each tensor's largest entry; running
  statistics rtol 1e-4, atol 1e-5 (XLA and PyTorch sum the convolutions
  in other orders).
* in bfloat16 (compute and BN application): logits within 3e-2 of
  JAX's in relative norm (measured 1.1e-2). The gradients of the encoder
  are mostly bf16 rounding at batch 8: JAX's bf16 gradients are 0.30 from
  its float32 ones in relative norm, the port's as far, and the two bf16
  sets 0.105 from each other (measured). So the port's must lie within
  half of JAX's own bf16 error from JAX's bf16 gradients, and no more
  than 1.25 times that error from the float32 ones.
* one Adam half-step: loss rtol 1e-4; each tensor's change within 25% of
  JAX's change in norm, all tensors together within 12%, as
  tests/test_torch_pretrain.py holds Adam (its first step moves each
  entry by about lr * sign(gradient), so an entry whose gradient is
  float noise can move the other way); the fc layer, far from that
  noise, rtol 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.models.resnet import SupervisedResNet as JSupervised
from simclr_tpu.ops import augment as ja
from simclr_tpu.ops.losses import cross_entropy as j_cross_entropy
from simclr_tpu.train import common as jcommon
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data import pipeline as tpipe
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.models.resnet import SupervisedResNet
from simclr_tpu_torch.ops import augment as ta
from simclr_tpu_torch.scripts import train_supervised as cli
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train import ssl as tssl
from simclr_tpu_torch.train import supervised as tsup
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

SIZE, N = 16, 8
DS = dataclasses.replace(jcfg.CIFAR10, img_size=SIZE)
TDS = dataclasses.replace(tcfg.CIFAR10, img_size=SIZE)
MODEL = dict(stage_sizes=(1, 1, 1, 1), width=4)
# JAX's supervised view, compiled once for every (N, 16, 16, 3) batch here.
jax_view = jax.jit(functools.partial(ja.augment_supervised, ds=DS))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: PyTorch's thread pool costs more
    than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _u8(n, size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_supervised_params(key, n, h, w):
    """The draws ``augment_supervised(key, ...)`` makes (augment.py:499-503,
    :186-195 and :290-305), as the port's ``SupervisedParams``."""
    k_flip, k_trans, k_jit = jax.random.split(key, 3)
    flip = jax.random.uniform(k_flip, (n,)) < 0.5
    k_x, k_y = jax.random.split(k_trans)
    ty = jnp.round(jax.random.uniform(k_y, (n,), minval=-0.3 * h,
                                      maxval=0.3 * h))
    tx = jnp.round(jax.random.uniform(k_x, (n,), minval=-0.3 * w,
                                      maxval=0.3 * w))
    k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(k_jit, 6)
    applied = jax.random.uniform(k_apply, (n,)) < 0.5

    def factor(k):
        f = jax.random.uniform(k, (n,), minval=0.6, maxval=1.4)
        return jnp.where(applied, f, 1.0)

    fh = jnp.where(applied, jax.random.uniform(k_h, (n,), minval=-0.1,
                                               maxval=0.1), 0.0)
    zero = jnp.zeros((n,))
    factors = jnp.stack([factor(k_b), factor(k_c), factor(k_s), fh, zero,
                         zero, zero, zero], axis=1)
    schedule = jnp.asarray(ja._PERMS)[
        jax.random.randint(k_perm, (n,), 0, len(ja._PERMS))]
    return ta.SupervisedParams(_t(flip), _t(ty), _t(tx), _t(factors),
                               _t(schedule).to(torch.int32))


# ---------------------------------------------------------------------------
# The supervised view.
# ---------------------------------------------------------------------------

def test_translate_matches_jax_bit_for_bit_with_all_zero_rows():
    """Shifts up to 0.9 of the image: some beyond half of it, which leaves
    whole rows and columns empty (zero fill)."""
    images = _u8(6, SIZE, 0).astype(np.float32) / 255.0
    key = jax.random.key(3)
    want = np.asarray(ja.random_translate(key, jnp.asarray(images),
                                          (0.9, 0.9)))
    k_x, k_y = jax.random.split(key)
    ty = jnp.round(jax.random.uniform(k_y, (6,), minval=-0.9 * SIZE,
                                      maxval=0.9 * SIZE))
    tx = jnp.round(jax.random.uniform(k_x, (6,), minval=-0.9 * SIZE,
                                      maxval=0.9 * SIZE))
    assert np.abs(np.concatenate([ty, tx])).max() > SIZE / 2
    got = ta.translate_apply(torch.from_numpy(images), _t(ty), _t(tx))
    np.testing.assert_array_equal(got.numpy(), want)
    empty_rows = (got.numpy() == 0).all(axis=(2, 3))
    assert empty_rows.sum() >= SIZE / 2
    # An image shifted by (1, -2): row 0 empty, the last two columns too.
    one = ta.translate_apply(torch.from_numpy(images[:1]),
                             torch.tensor([1.0]), torch.tensor([-2.0]))
    np.testing.assert_array_equal(one[0, 1:, :-2].numpy(),
                                  images[0, :-1, 2:])
    assert not one[0, 0].any() and not one[0, :, -2:].any()


def test_sample_translate_draws_rounded_shifts_in_range():
    gen = torch.Generator().manual_seed(0)
    ty, tx = ta.sample_translate(gen, 20000, 32, 16, (0.25, 0.5))
    assert ty.dtype == tx.dtype == torch.float32
    assert torch.equal(ty, ty.round()) and torch.equal(tx, tx.round())
    assert ty.abs().max() == 16 and tx.abs().max() == 4
    # Symmetric about zero: means within five standard errors.
    for t, half in ((ty, 16.0), (tx, 4.0)):
        se = half / np.sqrt(3 * t.numel())
        assert abs(float(t.mean())) < 5 * se
    images = torch.rand(3, 8, 8, 3)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    shifts = ta.sample_translate(g1, 3, 8, 8, (0.3, 0.3))
    assert torch.equal(ta.random_translate(g2, images, (0.3, 0.3)),
                       ta.translate_apply(images, *shifts))


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_supervised_apply_matches_jax(seed):
    images = _u8(N, SIZE, seed)
    key = jax.random.key(seed)
    want = jax_view(key, jnp.asarray(images))
    params = jax_supervised_params(key, N, SIZE, SIZE)
    got = ta.augment_supervised_apply(torch.from_numpy(images), params, TDS)
    assert got.shape == (N, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # Up to the colour step, bit for bit (augment.py:499-502).
    _, k_trans, _ = jax.random.split(key, 3)
    x = ja.to_float(jnp.asarray(images))
    x = jnp.where(jnp.asarray(params.flip.numpy())[:, None, None, None],
                  x[:, :, ::-1, :], x)
    want_geo = ja.random_translate(k_trans, x, (0.3, 0.3))
    x = ta.to_float(torch.from_numpy(images))
    x = torch.where(params.flip[:, None, None, None], x.flip(2), x)
    np.testing.assert_array_equal(
        ta.translate_apply(x, params.ty, params.tx).numpy(),
        np.asarray(want_geo))


def test_sample_supervised_params_draws_the_jax_distributions():
    n = 4000
    gen = torch.Generator().manual_seed(1)
    p = ta.sample_supervised_params(gen, n, 32, 32)
    assert p.flip.dtype == torch.bool and p.schedule.dtype == torch.int32
    assert p.factors.shape == (n, 8) and p.schedule.shape == (n, 4)
    # Every grayscale flag 0: B2's grayscale step never fires.
    assert not p.factors[:, 4:].any()
    applied = p.factors[:, 3] != 0
    frac = float(applied.float().mean())
    assert abs(frac - 0.5) < 5 * np.sqrt(0.25 / n)
    f = p.factors[applied]
    assert f[:, :3].min() >= 0.6 and f[:, :3].max() <= 1.4
    assert f[:, 3].abs().max() <= 0.1
    assert torch.equal(p.factors[~applied, :4],
                       torch.tensor([1.0, 1.0, 1.0, 0.0]).expand(
                           int((~applied).sum()), 4))
    assert abs(float(p.flip.float().mean()) - 0.5) < 5 * np.sqrt(0.25 / n)
    assert p.ty.abs().max() <= round(0.3 * 32)
    # The sampling entry point is its draws, then the apply.
    images = torch.from_numpy(_u8(3, SIZE, 2))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    drawn = ta.sample_supervised_params(g1, 3, SIZE, SIZE)
    assert torch.equal(ta.augment_supervised(g2, images, TDS),
                       ta.augment_supervised_apply(images, drawn, TDS))


# ---------------------------------------------------------------------------
# SupervisedResNet and one half-step against JAX.
# ---------------------------------------------------------------------------

def _port_model(dtype):
    return SupervisedResNet(10, dtype=dtype, bn_dtype=dtype, **MODEL,
                            generator=torch.Generator().manual_seed(3))


def _jax_oracle(dtype, with_adam):
    """JAX's train-mode logits, loss, gradients and statistics, eval-mode
    logits and (``with_adam``) one torch-semantics Adam step, all in one
    jitted program."""
    jmodel = JSupervised(num_classes=10, dtype=dtype, bn_dtype=dtype,
                         **MODEL)
    tx = jcommon.adam_torch(1e-3, 1e-6)

    @jax.jit
    def run(params, stats, x, y):
        def objective(p):
            logits, up = jmodel.apply({"params": p, "batch_stats": stats},
                                      x, train=True, mutable=["batch_stats"])
            return j_cross_entropy(logits, y), (logits, up["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            objective, has_aux=True)(params)
        eval_logits = jmodel.apply({"params": params, "batch_stats": stats},
                                   x, train=False)
        out = dict(loss=loss, logits=logits, stats=new_stats, grads=grads,
                   eval_logits=eval_logits)
        if with_adam:
            updates, _ = tx.update(grads, tx.init(params), params)
            out["params"] = jax.tree.map(lambda p, u: p + u, params,
                                         updates)
        return out

    return jmodel, run


@pytest.fixture(scope="module")
def oracle():
    """Weights of the port's float32 model from seed 3, 8 images and their
    labels, JAX's supervised view of them and JAX's results in float32
    (with an Adam step) and bfloat16."""
    model = _port_model(torch.float32)
    params, stats = simclr_to_jax(model.state_dict())
    images = _u8(N, SIZE, 7)
    labels = np.random.default_rng(8).integers(0, 10, N).astype(np.int32)
    key = jax.random.key(11)
    x = jax_view(key, jnp.asarray(images))
    out = {"params": params, "stats": stats, "images": images,
           "labels": labels, "draws": jax_supervised_params(key, N, SIZE,
                                                            SIZE)}
    for name, dtype, adam in (("f32", jnp.float32, True),
                              ("bf16", jnp.bfloat16, False)):
        jmodel, run = _jax_oracle(dtype, adam)
        if name == "f32":
            init = jax.eval_shape(
                lambda: jmodel.init(jax.random.key(0), x, train=False))
            out["init_shapes"] = jax.tree.map(lambda a: a.shape, init)
        out[name] = jax.device_get(run(params, stats, x, jnp.asarray(labels)))
    return out


def _loaded(oracle, dtype):
    model = _port_model(dtype)
    model.load_state_dict(simclr_from_jax(oracle["params"], oracle["stats"]))
    return model.to(memory_format=torch.channels_last)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _views(oracle):
    return ta.augment_supervised_apply(torch.from_numpy(oracle["images"]),
                                       oracle["draws"], TDS)


def test_weights_carry_both_ways_on_the_supervised_tree(oracle):
    model = _port_model(torch.float32)
    sd = model.state_dict()
    assert {k.split(".")[0] for k in sd} == {"encoder", "fc"}
    assert model.fc.weight.dtype == torch.float32
    params, stats = simclr_to_jax(sd)
    shapes = oracle["init_shapes"]
    assert jax.tree.map(np.shape, {"params": params,
                                   "batch_stats": stats}) == shapes
    back = simclr_from_jax(params, stats)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_supervised_resnet_forward_and_gradients_match_jax_in_float32(
        oracle):
    want = oracle["f32"]
    model = _loaded(oracle, torch.float32)
    x = _views(oracle).permute(0, 3, 1, 2)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), want["eval_logits"],
                                   rtol=1e-4, atol=1e-5)
    model.train()
    logits = model(x)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(oracle["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), want["loss"],
                               rtol=1e-4)
    grads = {k: p.grad for k, p in model.named_parameters()}
    tgrads = dict(_flat(simclr_to_jax(grads)[0]))
    for name, g in _flat(want["grads"]):
        np.testing.assert_allclose(tgrads[name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)
    tstats = dict(_flat(simclr_to_jax(model.state_dict())[1]))
    for name, s in _flat(want["stats"]):
        np.testing.assert_allclose(tstats[name], s, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(np.asarray(b, np.float64)))


def test_supervised_resnet_is_close_to_jax_in_bfloat16(oracle):
    want = oracle["bf16"]
    model = _loaded(oracle, torch.bfloat16)
    logits = model(_views(oracle).permute(0, 3, 1, 2))
    assert logits.dtype == torch.float32
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(oracle["labels"]).long()).backward()
    assert _rel(logits.detach().numpy(), want["logits"]) < 3e-2
    grads = {k: p.grad for k, p in model.named_parameters()}
    tgrads = dict(_flat(simclr_to_jax(grads)[0]))

    def flat(tree):
        return np.concatenate([g.ravel() for _, g in _flat(tree)])

    port = np.concatenate([tgrads[n].ravel() for n, _ in
                           _flat(want["grads"])])
    jax_bf16, jax_f32 = flat(want["grads"]), flat(oracle["f32"]["grads"])
    noise = _rel(jax_bf16, jax_f32)
    assert _rel(port, jax_bf16) <= 0.5 * noise
    assert _rel(port, jax_f32) <= 1.25 * noise


def test_one_supervised_half_step_matches_jax(oracle):
    """``SupervisedEngine('supervised')``'s step with JAX's draws, from the
    same weights, against JAX's half-step body (supervised.py:80-94)."""
    cfg = tcfg.Config(dataset=TDS, model=tcfg.ModelConfig(
        compute_dtype="float32", bn_dtype="float32", **MODEL))
    model = _loaded(oracle, torch.float32)
    opt = tcommon.adam_torch(model.parameters(), 1e-3, 1e-6)
    engine = tssl.SupervisedEngine(model, opt, cfg, augment="supervised")
    state = tcommon.TrainState(model, opt)
    p0 = dict(_flat(oracle["params"]))
    state, (loss, acc) = engine.train_step_on_params(
        state, torch.from_numpy(oracle["images"]),
        torch.from_numpy(oracle["labels"]), oracle["draws"])
    assert state.step == 1
    want = oracle["f32"]
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    logits = want["logits"]
    assert float(acc) == pytest.approx(
        100.0 * np.mean(logits.argmax(-1) == oracle["labels"]))
    got = dict(_flat(simclr_to_jax(model.state_dict())[0]))
    jp = dict(_flat(want["params"]))
    for name in jp:
        dj, dt = jp[name] - p0[name], got[name] - p0[name]
        assert np.linalg.norm(dt - dj) <= 0.25 * np.linalg.norm(dj), name
        if name.startswith("fc/"):
            np.testing.assert_allclose(got[name], jp[name], rtol=1e-4,
                                       atol=1e-7, err_msg=name)
    dj = np.concatenate([(jp[n] - p0[n]).ravel() for n in jp])
    dt = np.concatenate([(got[n] - p0[n]).ravel() for n in jp])
    assert np.linalg.norm(dt - dj) <= 0.12 * np.linalg.norm(dj)


# ---------------------------------------------------------------------------
# train_supervised.
# ---------------------------------------------------------------------------

BATCH = 8


def _config():
    return tcfg.Config(dataset=TDS, model=tcfg.ModelConfig(
        compute_dtype="float32", bn_dtype="float32", stage_sizes=(1, 1, 1, 1),
        width=2), train=tcfg.TrainConfig(micro_batch_size=BATCH))


def test_train_supervised_takes_two_half_steps_a_batch(monkeypatch):
    """Every batch twice in a row, each time with its own draws and its own
    optimizer step; the logged per-batch loss is the pair's mean."""
    calls = []
    update = tssl.SupervisedEngine._update

    def spy(self, batch, targets, params, generator):
        metrics = update(self, batch, targets, params, generator)
        calls.append((batch.clone(), params, float(metrics[0]),
                      [p.detach().clone() for p in self.model.parameters()]))
        return metrics

    monkeypatch.setattr(tssl.SupervisedEngine, "_update", spy)
    images, labels = synthetic_dataset(3 * BATCH + 3, SIZE, seed=2)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    lines = []
    result = tsup.train_supervised(_config(), ds, n_epochs=1,
                                   log=lines.append)
    assert len(calls) == 6 and result.state.step == 6
    assert isinstance(result.state.optimizer, torch.optim.Adam)
    for i in range(0, 6, 2):
        (b1, d1, l1, p1), (b2, d2, l2, p2) = calls[i], calls[i + 1]
        assert torch.equal(b1, b2)
        assert not torch.equal(d1.factors, d2.factors)
        assert not all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert not torch.equal(calls[0][0], calls[2][0])
    pair_means = [(calls[i][2] + calls[i + 1][2]) / 2 for i in (0, 2, 4)]
    assert f"Train Loss: {pair_means[-1]:.3f} |" in lines[0]
    assert result.history.loss["train"][0] == pytest.approx(
        np.mean(pair_means), rel=1e-6)
    assert result.test_acc is None and result.best_acc == 0.0


def test_train_supervised_stops_early_and_restores_only_the_parameters(
        monkeypatch):
    """Scripted validation accuracies 50, 60, 40, 30 with patience 2: the
    best is epoch 2, the run stops after epoch 4, and the parameters of
    epoch 2 come back before the test evaluation, while the BN running
    statistics stay those of epoch 4 (JAX restores ``params`` only)."""
    scripted = iter([50.0, 60.0, 40.0, 30.0, 99.0])
    seen = []

    def evaluate(eval_batch, state, ds, batch_size=512):
        seen.append({k: v.clone() for k, v in
                     state.model.state_dict().items()})
        return 1.0, next(scripted)

    monkeypatch.setattr(tsup, "evaluate_classifier", evaluate)
    images, labels = synthetic_dataset(BATCH + 2, SIZE, seed=3)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    lines = []
    result = tsup.train_supervised(_config(), ds, val_ds=ds, test_ds=ds,
                                   n_epochs=10, patience=2,
                                   log=lines.append)
    assert len(result.history.loss["train"]) == 4
    assert result.history.accuracy["valid"] == [50.0, 60.0, 40.0, 30.0]
    assert result.best_acc == 60.0 and result.test_acc == 99.0
    assert len(result.epoch_seconds) == 4 and result.state.step == 8
    assert lines.count("Found a better model. Saving...") == 2
    assert "Early stopping, reverting to the previous model ..." in lines
    restored, best, last = seen[-1], seen[1], seen[3]
    names = [k for k, _ in result.state.model.named_parameters()]
    assert all(torch.equal(restored[k], best[k]) for k in names)
    assert not all(torch.equal(restored[k], last[k]) for k in names)
    running = [k for k in restored if "running" in k]
    assert running and all(torch.equal(restored[k], last[k])
                           for k in running)
    assert not all(torch.equal(best[k], last[k]) for k in running)


def test_train_supervised_evaluates_through_the_engine():
    """The real evaluation: finite history, accuracies in range."""
    images, labels = synthetic_dataset(2 * BATCH, SIZE, seed=4)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    result = tsup.train_supervised(_config(), ds, val_ds=ds, test_ds=ds,
                                   n_epochs=1, log=lambda m: None)
    values = [v for d in result.history.to_dict().values()
              for s in d.values() for v in s]
    assert len(values) == 4 and np.all(np.isfinite(values))
    assert 0.0 <= result.test_acc <= 100.0


def test_init_supervised_takes_only_the_baseline_fields():
    """Kernel and BN-mode flags of the SimCLR config do not reach the
    baseline, as on the JAX side."""
    cfg = _config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, bn_relu_fused=True, bn_grad_mode="st",
        bn3_shadow_stats=True, encoder="dropout"))
    model, state, opt = tsup.init_supervised(cfg, seed=1, device="cpu")
    plain, _, _ = tsup.init_supervised(_config(), seed=1, device="cpu")
    assert model.state_dict().keys() == plain.state_dict().keys()
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), plain.state_dict().values()))
    assert not model.encoder.mc_dropout
    assert opt.param_groups[0]["lr"] == 1e-3
    assert opt.param_groups[0]["weight_decay"] == 1e-6


def test_cli_flags_and_device(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert "--export_path" in out and "--device" in out
    args = cli.parse_args(["--batch_size", "32", "--dataset", "stl10",
                           "--n_epoch", "3"])
    cfg = cli.config_from_args(args)
    assert cfg.train.micro_batch_size == 32 and cfg.dataset.name == "stl10"
    assert args.device == "cuda" and args.n_epoch == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
