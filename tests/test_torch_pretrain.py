"""The port's pretraining slice against the JAX package's, end to end.

Same weights (made by the port, carried over with ``simclr_to_jax``), the
same uint8 batch and the same augmentation draws (reproduced from the JAX
step's key splits) go through three ``train_step_on_batch`` steps with
``adam_torch`` on both sides: the JAX engine's jitted step on its plain
paths (``use_pallas_ntxent=False``, XLA colour ops, as its own CPU tests
run it) and the port's plain versions on the CPU. A width-16 model
(``stage_sizes=(1,1,1,1)``), batch 40 so 2N = 80 > k = 64.

Tolerances (float32): loss rtol 1e-4; accuracy within one row (1.25
points), since a float tie can flip one row's argmax; the running
statistics and the parameters as each test states.

Also: the data layer (synthetic set byte-identical, split indices), the
config tree, and a loose bfloat16 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data import datasets as jds
from simclr_tpu.data import pipeline as jpipe
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.train import common as jcommon
from simclr_tpu.train.pretrain import build_engine as jax_build_engine
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data import datasets as tds
from simclr_tpu_torch.data import pipeline as tpipe
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train.pretrain import build_engine, init_simclr
from simclr_tpu_torch.utils.weights import simclr_to_jax
from test_torch_augment import jax_view_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SMALL = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16)
F32 = dict(compute_dtype="float32", bn_dtype="float32")
BATCH, STEPS = 40, 3


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _configs(jax_over=None, **model):
    kw = dict(SMALL, **model)
    train = dict(batch_size=BATCH, temperature=0.5)
    return (
        tcfg.Config(model=tcfg.ModelConfig(**kw),
                    train=tcfg.TrainConfig(**train)),
        jcfg.Config(model=jcfg.ModelConfig(**kw, **(jax_over or {})),
                    train=jcfg.TrainConfig(**train)),
    )


def _run_both(steps, jax_over=None, **model):
    """``steps`` steps on both sides from the same weights, batch and
    draws; ``jax_over`` overrides ModelConfig fields on the JAX side only.
    Returns per-step metrics and running statistics, and the parameters
    before and after."""
    tc, jc = _configs(jax_over, **model)
    tmodel, tstate, topt = init_simclr(tc, seed=0, device="cpu")
    engine = build_engine(tc, tmodel, topt)
    params, stats = simclr_to_jax(tmodel.state_dict())

    jmodel = JSimCLR(cfg=jc.model)
    tx = jcommon.adam_torch(jc.optim.lr, jc.optim.wt_decay)
    jstate = jcommon.TrainState.create(params, stats, tx)
    jengine = jax_build_engine(jc, jmodel, tx, use_pallas_ntxent=False)

    images, _ = jds.synthetic_dataset(BATCH, img_size=32, seed=3)
    batch = torch.from_numpy(images)
    run = {"p0": dict(_flat(params)), "metrics": [], "stats": []}
    for step in range(steps):
        key = jax.random.key(10 + step)
        jstate, (jloss, jacc) = jengine.train_step_direct(
            jstate, jnp.asarray(images), key)
        k_aug, _ = jax.random.split(key)
        k1, k2 = jax.random.split(k_aug)
        pair = (jax_view_params(k1, BATCH, 32, 32, tc.augment),
                jax_view_params(k2, BATCH, 32, 32, tc.augment))
        tstate, (tloss, tacc) = engine.train_step_on_params(tstate, batch,
                                                            pair)
        run["metrics"].append(((float(tloss), float(tacc)),
                               (float(jloss), float(jacc))))
        run["stats"].append((
            dict(_flat(simclr_to_jax(tmodel.state_dict())[1])),
            dict(_flat(jax.device_get(jstate.batch_stats)))))
    run["port"] = dict(_flat(simclr_to_jax(tmodel.state_dict())[0]))
    run["jax"] = dict(_flat(jax.device_get(jstate.params)))
    run["step"] = tstate.step
    return run


@pytest.fixture(scope="module")
def f32_run():
    return _run_both(STEPS, **F32)


def test_losses_and_accuracies_track_jax(f32_run):
    for (tl, ta), (jl, ja) in f32_run["metrics"]:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert abs(ta - ja) <= 100.0 / (2 * BATCH) + 1e-4
    assert f32_run["step"] == STEPS


def test_running_statistics_track_jax(f32_run):
    """After the first step the running statistics depend only on the
    shared initial weights and the batch: rtol 1e-4, atol 1e-5. (Later
    ones follow parameters that differ by Adam-amplified float noise, see
    below; the matching later losses cover them.)"""
    ts, js = f32_run["stats"][0]
    assert ts.keys() == js.keys()
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_parameters_after_three_steps_track_jax(f32_run):
    """Each tensor's change over the three steps against JAX's. Adam's
    first steps are close to lr * sign(gradient) for every entry, so an
    entry whose gradient is within the float32 noise (1e-3 to 1e-2 of the
    largest entry upstream of the stride-2 convolutions, measured against
    float64) can move the other way: per tensor the difference stays
    within 25% of the change's norm (measured worst 17%), over all tensors
    together within 12%. The head's first bias is left out: a BN follows
    it, so its gradient is zero in exact arithmetic and pure noise."""
    p0, tp, jp = f32_run["p0"], f32_run["port"], f32_run["jax"]
    assert tp.keys() == jp.keys() == p0.keys()
    names = [n for n in jp if n != "g/linear0/bias"]
    for name in names:
        dj, dt = jp[name] - p0[name], tp[name] - p0[name]
        assert np.linalg.norm(dt - dj) <= 0.25 * np.linalg.norm(dj), name
    dj = np.concatenate([(jp[n] - p0[n]).ravel() for n in names])
    dt = np.concatenate([(tp[n] - p0[n]).ravel() for n in names])
    assert np.linalg.norm(dt - dj) <= 0.12 * np.linalg.norm(dj)


def test_adam_torch_matches_the_jax_chain():
    """The optimizer alone, three steps on the same gradients: float32
    to rtol 1e-6, atol 1e-9."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * 10 ** -i
             for i in range(3)]
    tx = jcommon.adam_torch(1e-3, 1e-2)
    jp = jnp.asarray(p)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = tcommon.adam_torch([tp], 1e-3, 1e-2)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = jp + upd
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-9)


def test_bfloat16_step_is_close_to_jax():
    """Default bf16 compute and bf16 BN application: the two frameworks
    round to bf16 at other places, so one step's loss agrees to 2%."""
    (tl, _), (jl, _) = _run_both(1)["metrics"][0]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


@pytest.mark.parametrize("difficulty", ["hard", "easy"])
def test_synthetic_dataset_is_byte_identical(difficulty):
    for n, size, seed in ((64, 32, 0), (8, 96, 5)):
        a = tds.synthetic_dataset(n, size, seed=seed, difficulty=difficulty)
        b = jds.synthetic_dataset(n, size, seed=seed, difficulty=difficulty)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_load_dataset_synthetic_fallback_matches_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), synthetic_size=32)
    with pytest.warns(UserWarning):
        a = tds.load_dataset("cifar10", "train", **kw)
    with pytest.warns(UserWarning):
        b = jds.load_dataset("cifar10", "train", **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not tds.is_real_data("cifar10", str(tmp_path))


def test_cifar10_python_batches_decode_like_jax(tmp_path):
    import pickle
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (3, 3072),
                                              dtype=np.uint8),
                         "labels": list(rng.integers(0, 10, 3))}, f)
    for train in (True, False):
        a = tds.load_cifar10(str(tmp_path), train)
        b = jds.load_cifar10(str(tmp_path), train)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_split_indices_match_jax():
    for n, frac in ((100, 0.2), (37, 0.5)):
        for a, b in zip(tpipe.split_indices(n, frac),
                        jpipe.split_indices(n, frac)):
            np.testing.assert_array_equal(a, b)


def test_epoch_permutation_and_take_batch():
    images, labels = tds.synthetic_dataset(50, 32, seed=1)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    gen = torch.Generator().manual_seed(0)
    idx = tpipe.epoch_permutation(gen, ds.n, 16)
    assert idx.shape == (3, 16)
    assert len(set(idx.flatten().tolist())) == 48
    full = tpipe.epoch_permutation(gen, ds.n, 16, drop_remainder=False)
    assert full.shape == (4, 16)
    assert set(full.flatten().tolist()) == set(range(50))
    x, y = tpipe.take_batch(ds, idx[0])
    np.testing.assert_array_equal(x.numpy(), images[idx[0].numpy()])
    np.testing.assert_array_equal(y.numpy(), labels[idx[0].numpy()])


def test_train_epoch_runs_every_row():
    tc, _ = _configs(**F32)
    images, labels = tds.synthetic_dataset(3 * BATCH, 32, seed=2)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    model, state, opt = init_simclr(tc, seed=1, device="cpu")
    engine = build_engine(tc, model, opt)
    gen = torch.Generator().manual_seed(0)
    idx = tpipe.epoch_permutation(gen, ds.n, BATCH)
    state, (losses, accs) = engine.train_epoch(state, ds.images, idx, gen)
    assert losses.shape == accs.shape == (3,)
    assert torch.isfinite(losses).all() and state.step == 3


def test_config_tree_matches_jax():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(
        jcfg.Config())
    for name in ("cifar10", "stl10"):
        assert dataclasses.asdict(tcfg.dataset_config(name)) == \
            dataclasses.asdict(jcfg.dataset_config(name))
    assert tcfg.Config.for_dataset("stl10").to_json() == \
        jcfg.Config.for_dataset("stl10").to_json()


def test_modified_loss_and_accumulation_selection():
    tc, _ = _configs(**F32)
    mod = tc.replace(train=dataclasses.replace(tc.train, modified_loss=True))
    model, state, opt = init_simclr(mod, seed=0, device="cpu")
    engine = build_engine(mod, model, opt)
    z = torch.randn(8, 128)
    from simclr_tpu_torch.ops.losses import modified_contrastive_loss
    torch.testing.assert_close(engine.loss_fn(z[:4], z[4:]),
                               modified_contrastive_loss(z[:4], z[4:], 0.5))
    acc = tc.replace(train=dataclasses.replace(tc.train, accum_steps=2))
    model, state, opt = init_simclr(acc, seed=0, device="cpu")
    assert isinstance(opt, tcommon.GradAccumulation) and opt.k == 2
    assert state.optimizer is opt and build_engine(acc, model, opt).accum == 2
    assert not isinstance(init_simclr(tc, seed=0, device="cpu")[2],
                          tcommon.GradAccumulation)


def test_contrastive_fn_uses_kernel_b1_and_refuses_what_it_cannot_run():
    """NT-Xent always goes through kernel B1's wrapper (its plain version
    for CPU tensors, to rtol 1e-5 of the plain loss); on a CUDA device a
    shape the kernel cannot run raises instead of training through the
    plain path. Selecting the loss needs no card."""
    from simclr_tpu_torch.ops.kernels import ntxent as tk
    from simclr_tpu_torch.ops.losses import nt_xent_loss
    from simclr_tpu_torch.train.pretrain import contrastive_fn

    tc, _ = _configs(**F32)
    z = torch.randn(8, 128, generator=torch.Generator().manual_seed(0))
    launches = tk.ntxent_fwd.launches
    loss, acc = contrastive_fn(tc, "cpu")(z[:4], z[4:])
    ref_loss, ref_acc = nt_xent_loss(z[:4], z[4:], 0.5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc, ref_acc)
    assert tk.ntxent_fwd.launches == launches
    contrastive_fn(tc, "cuda")
    wide = tc.replace(model=dataclasses.replace(
        tc.model, compressed_dim=tk.MAX_DIM + 1))
    with pytest.raises(ValueError, match="does not support"):
        contrastive_fn(wide, "cuda")
    contrastive_fn(wide, "cpu")
