"""Gradient accumulation in the port against the JAX package's
``optax.MultiSteps`` (``with_grad_accumulation``), on the CPU.

* The optimizer alone: ``GradAccumulation`` around ``adam_torch`` against
  ``optax.MultiSteps`` around the JAX ``adam_torch`` chain, fed the same
  gradients, k = 2 and 3: float32 to rtol 1e-6, atol 1e-9 (both compute
  optax's running mean ``acc + (g - acc) / (i + 1)`` and the same Adam).
* Whole pretrain micro-steps on a width-16 model (``stage_sizes=
  (1,1,1,1)``, batch 40, float32): the port's engine against the JAX package's
  ``build_engine`` with the optimizer its ``init_simclr`` builds
  (``with_grad_accumulation``) for ``accum_steps`` 2 and 3, the same weights,
  batch and augmentation draws. Logged losses are loss / k: rtol 1e-5 until
  Adam first steps (measured 2.2e-7), 1e-3 after (measured 1.2e-4: Adam's first
  step moves each parameter by about lr * sign(gradient), so entries whose
  gradient is within float32 noise move the other way, as
  tests/test_torch_pretrain.py measures). The accumulated mean after each
  micro-step against JAX's ``acc_grads``: after the first it is that step's
  gradient on each side, so their difference is the two frameworks' float32
  gradient noise at 32 x 32 views (measured: 4.1e-3 of the whole gradient's
  norm, 1.1e-2 of a tensor's norm at worst; an entry near zero can be 4% of its
  tensor's largest entry off), and the mean of two stays as close (6.4e-3,
  1.1e-2). Held to 1e-2 of the whole norm and 2.5e-2 of each tensor's norm; the
  head's first bias, zero in exact arithmetic, to the norm of the whole
  gradient. The parameters do not move on an accumulating micro-step (bit for
  bit, both sides) and move by Adam's step on the k-th; that change within 25%
  of JAX's per tensor, as tests/test_torch_pretrain.py states why.
* Within the port (a tiny model, ``pretrain()`` on the CPU): epochs of 4
  steps with k = 3, so the cycle runs across the epoch boundary; two
  epochs equal one run of 8 steps, and a run resumed from the first
  epoch's checkpoint (mid-cycle) equals the uninterrupted one, bit for
  bit. The CLI takes ``--accum_steps``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data import datasets as jds
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.train import common as jcommon
from simclr_tpu.train.pretrain import build_engine as jax_build_engine
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import (
    DeviceDataset, Split, epoch_permutation, split_indices)
from simclr_tpu_torch.scripts import pretrain as cli
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.utils.weights import simclr_to_jax
from test_torch_augment import jax_view_params

SMALL = dict(feature_dim=512, stage_sizes=(1, 1, 1, 1), width=16,
             compute_dtype="float32", bn_dtype="float32")
BATCH = 40
TINY = dict(feature_dim=32, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=4, compute_dtype="float32", bn_dtype="float32")


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


# ---------------------------------------------------------------------------
# The optimizer alone.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_adam_matches_optax_multisteps(k):
    rng = np.random.default_rng(k)
    p = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * 10 ** -(i % 3)
             for i in range(2 * k + 1)]
    tx = optax.MultiSteps(jcommon.adam_torch(1e-3, 1e-2), every_k_schedule=k)
    jp = jnp.asarray(p)
    opt_state = tx.init(jp)

    @jax.jit
    def update(g_, state_, p_):
        upd, state_ = tx.update(g_, state_, p_)
        return p_ + upd, state_

    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = tcommon.with_grad_accumulation(tcommon.adam_torch([tp], 1e-3, 1e-2),
                                         k)
    assert isinstance(opt, tcommon.GradAccumulation)
    for i, g in enumerate(grads):
        before = tp.detach().clone()
        jp, opt_state = update(jnp.asarray(g), opt_state, jp)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(opt.acc[0].numpy(),
                                   np.asarray(opt_state.acc_grads),
                                   rtol=1e-6, atol=1e-9)
        assert opt.mini == int(opt_state.mini_step) == (i + 1) % k
        if (i + 1) % k:
            assert torch.equal(tp.detach(), before)
    assert int(opt.state[tp]["step"]) == len(grads) // k
    assert tcommon.with_grad_accumulation(opt.optimizer, 1) is opt.optimizer


def test_accumulator_state_round_trips():
    tp = torch.nn.Parameter(torch.ones(3))
    opt = tcommon.GradAccumulation(tcommon.adam_torch([tp], 1e-3), 3)
    tp.grad = torch.full((3,), 2.0)
    opt.step()
    sd = opt.state_dict()
    other = tcommon.GradAccumulation(tcommon.adam_torch([tp], 1e-3), 3)
    other.load_state_dict(sd)
    assert other.mini == 1 and float(other.count) == 1.0
    assert torch.equal(other.acc[0], opt.acc[0])
    with pytest.raises(ValueError, match="accumulates over 3"):
        tcommon.GradAccumulation(tcommon.adam_torch([tp], 1e-3),
                                 2).load_state_dict(sd)


# ---------------------------------------------------------------------------
# Within the port: epochs, resume, the CLI.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    images, labels = synthetic_dataset(80, 16, seed=0)
    tr, va = split_indices(80, 0.2)
    return Split(DeviceDataset.from_numpy(images[tr], labels[tr], "cpu"),
                 DeviceDataset.from_numpy(images[va], labels[va], "cpu"))


def _tiny(root, n_epoch, name, k=3):
    cfg = tcfg.Config(model=tcfg.ModelConfig(**TINY),
                      train=tcfg.TrainConfig(n_epoch=n_epoch, batch_size=16,
                                             save_ckpt_every=1,
                                             accum_steps=k),
                      out_dir=str(root / name / "out"),
                      ckpt_dir=str(root / name / "ckpt"))
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, img_size=16))


def _pretrain(cfg, split, **kw):
    return tpre.pretrain(cfg, split, log=lambda _: None, device="cpu",
                         save_plots=False, **kw)


def test_cycle_carries_across_epochs(split, tmp_path):
    """Two epochs of 4 rows with k = 3 take the same 8 micro-steps as one
    epoch of the same 8 rows: Adam steps after micro-steps 3 and 6."""
    cfg = _tiny(tmp_path, 1, "x")
    states = []
    for chunks in ((8,), (4, 4)):
        model, state, opt = tpre.init_simclr(cfg, seed=0, device="cpu")
        engine = tpre.build_engine(cfg, model, opt)
        gen = torch.Generator().manual_seed(1)
        idx = torch.cat([epoch_permutation(gen, split.train.n, 16)
                         for _ in range(2)])
        gen = torch.Generator().manual_seed(2)
        start, losses = 0, []
        for size in chunks:
            state, (loss, _) = engine.train_epoch(
                state, split.train.images, idx[start:start + size], gen)
            losses.append(loss)
            start += size
        assert state.step == 8 and opt.mini == 2
        assert int(next(iter(opt.state.values()))["step"]) == 2
        states.append((torch.cat(losses), model.state_dict(),
                       [a.clone() for a in opt.acc]))
    (la, sa, aa), (lb, sb, ab) = states
    assert torch.equal(la, lb)
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert all(torch.equal(a, b) for a, b in zip(aa, ab))


def test_mid_cycle_resume_equals_the_uninterrupted_run(split, tmp_path):
    straight = _pretrain(_tiny(tmp_path, 2, "straight"), split)
    first = _tiny(tmp_path, 1, "first")
    _pretrain(first, split)
    ckpt = tpre.ckpt_lib.latest_checkpoint(first.ckpt_dir)
    payload = torch.load(f"{ckpt}/state.pt", weights_only=True)
    assert payload["optimizer"]["accumulation"]["mini"] == 1
    resumed = _pretrain(_tiny(tmp_path, 2, "resumed"), split,
                        resume_from=ckpt)
    a = straight.state.model.state_dict()
    b = resumed.state.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert straight.history.to_dict() == resumed.history.to_dict()
    oa, ob = straight.state.optimizer, resumed.state.optimizer
    assert oa.mini == ob.mini == 2 and straight.state.step == 8
    assert all(torch.equal(x, y) for x, y in zip(oa.acc, ob.acc))


def test_cli_takes_accum_steps(monkeypatch):
    seen = {}

    def fake_pretrain(cfg, **kw):
        seen["cfg"] = cfg
        return tpre.PretrainResult(state=None, history=None,
                                   export_path=None, steps_per_sec=0.0)

    monkeypatch.setattr(tpre, "pretrain", fake_pretrain)
    cli.main(["--accum_steps", "2", "--device", "cpu"])
    assert seen["cfg"].train.accum_steps == 2
# ---------------------------------------------------------------------------
# Whole micro-steps against the JAX engine.
# ---------------------------------------------------------------------------

def _configs(k):
    train = dict(batch_size=BATCH, temperature=0.5, accum_steps=k)
    return (tcfg.Config(model=tcfg.ModelConfig(**SMALL),
                        train=tcfg.TrainConfig(**train)),
            jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                        train=jcfg.TrainConfig(**train)))


def _both_engines(k):
    """The port's engine with ``accum_steps`` k and JAX's on the port's
    weights, with the optimizer JAX's ``init_simclr`` builds
    (``with_grad_accumulation``; its ``model.init`` runs eagerly, some 25 s
    here, and the weights come from the port anyway), JAX's step lowered
    for the batch: (lowered step, JAX's state, the port's side)."""
    tc, jc = _configs(k)
    tmodel, tstate, topt = tpre.init_simclr(tc, seed=0, device="cpu")
    engine = tpre.build_engine(tc, tmodel, topt)
    params, stats = simclr_to_jax(tmodel.state_dict())
    jmodel = JSimCLR(cfg=jc.model)
    tx = jcommon.with_grad_accumulation(
        jcommon.adam_torch(jc.optim.lr, jc.optim.wt_decay), k)
    jstate = jcommon.TrainState.create(params, stats, tx)
    jengine = jax_build_engine(jc, jmodel, tx, use_pallas_ntxent=False)
    images, _ = jds.synthetic_dataset(BATCH, img_size=32, seed=3)
    lowered = jengine.train_step_direct.lower(
        jstate, jnp.asarray(images), jax.random.key(10))
    return lowered, jstate, dict(tc=tc, model=tmodel, state=tstate,
                                 opt=topt, engine=engine, images=images)


def _port_steps(side, steps):
    """``steps`` micro-steps of the port's engine on the batch, each with
    the augmentation draws of JAX's key for that step."""
    tc, tmodel, tstate = side["tc"], side["model"], side["state"]
    topt, engine = side["opt"], side["engine"]
    names = [n for n, _ in tmodel.named_parameters()]
    batch = torch.from_numpy(side["images"])
    records = []
    for step in range(steps):
        before = dict(_flat(simclr_to_jax(tmodel.state_dict())[0]))
        k_aug, _ = jax.random.split(jax.random.key(10 + step))
        k1, k2 = jax.random.split(k_aug)
        pair = (jax_view_params(k1, BATCH, 32, 32, tc.augment),
                jax_view_params(k2, BATCH, 32, 32, tc.augment))
        tstate, (tloss, _) = engine.train_step_on_params(tstate, batch, pair)
        acc = dict(_flat(simclr_to_jax(dict(zip(names, topt.acc)))[0]))
        records.append(dict(
            loss=float(tloss), before=before,
            after=dict(_flat(simclr_to_jax(tmodel.state_dict())[0])),
            acc=acc, mini=topt.mini, step=tstate.step))
    return records


@pytest.fixture(scope="module", autouse=True)
def jax_steps():
    """JAX's two steps (k = 2 and 3), traced here, before the first test,
    and compiled on a thread pool: XLA releases the GIL while it compiles,
    which is most of each oracle's time, so the compiles overlap the tests
    that run meanwhile and the port's micro-steps. k -> (future of the
    compiled step, JAX's state, the port's side)."""
    pool = ThreadPoolExecutor(max_workers=2)
    steps = {}
    for k in (2, 3):
        lowered, jstate, side = _both_engines(k)
        steps[k] = (pool.submit(lowered.compile), jstate, side)
    yield steps
    for future, _, _ in steps.values():
        future.result()
    pool.shutdown()


@pytest.fixture(scope="module")
def both_runs(jax_steps):
    """Both engines for k = 2 and 3, three micro-steps each, from the same
    weights, batch and augmentation draws: the port's first, while JAX's
    steps compile, then JAX's. k -> one record a micro-step, (port, JAX)
    pairs."""
    ports = {k: _port_steps(side, 3) for k, (_, _, side) in jax_steps.items()}
    runs = {}
    for k, (compiled, jstate, side) in jax_steps.items():
        step_fn, images = compiled.result(), jnp.asarray(side["images"])
        runs[k] = []
        for step, p in enumerate(ports[k]):
            before = dict(_flat(jax.device_get(jstate.params)))
            jstate, (jloss, _) = step_fn(jstate, images,
                                         jax.random.key(10 + step))
            runs[k].append(dict(
                loss=(p["loss"], float(jloss)),
                before=(p["before"], before),
                after=(p["after"],
                       dict(_flat(jax.device_get(jstate.params)))),
                acc=(p["acc"], dict(_flat(jax.device_get(
                    jstate.opt_state.acc_grads)))),
                mini=(p["mini"], int(jstate.opt_state.mini_step)),
                step=(p["step"], int(jstate.step))))
    return runs


@pytest.fixture(scope="module", params=[2, 3], ids=["k2", "k3"])
def accum_run(request, both_runs):
    return request.param, both_runs[request.param]


def test_micro_steps_log_loss_over_k_as_jax(accum_run):
    k, run = accum_run
    for i, r in enumerate(run):
        tl, jl = r["loss"]
        np.testing.assert_allclose(tl, jl, rtol=1e-5 if i < k else 1e-3)
        # A step's NT-Xent on 2N = 80 rows lies near ln(79) = 4.37.
        assert 3.0 / k < tl < 6.0 / k
        assert r["mini"] == ((i + 1) % k,) * 2
        assert r["step"] == (i + 1,) * 2


def test_accumulated_gradients_track_jax(accum_run):
    k, run = accum_run
    for i, r in enumerate(run[:k - 1]):
        ta, ja = r["acc"]
        assert ta.keys() == ja.keys()
        diff = np.concatenate([(ta[n] - ja[n]).ravel() for n in ja])
        whole = np.linalg.norm(np.concatenate([ja[n].ravel() for n in ja]))
        assert np.linalg.norm(diff) <= 1e-2 * whole
        for name, jv in ja.items():
            scale = whole if name == "g/linear0/bias" else np.linalg.norm(jv)
            assert np.linalg.norm(ta[name] - jv) <= 2.5e-2 * scale, \
                f"micro-step {i}: {name}"


def test_parameters_move_only_on_the_kth_micro_step(accum_run):
    k, run = accum_run
    for i, r in enumerate(run):
        (tb, jb), (ta, ja) = r["before"], r["after"]
        if (i + 1) % k:
            assert all(np.array_equal(tb[n], ta[n]) for n in tb)
            assert all(np.array_equal(jb[n], ja[n]) for n in jb)
            continue
        names = [n for n in ja if n != "g/linear0/bias"]
        for name in names:
            dj, dt = ja[name] - jb[name], ta[name] - tb[name]
            assert np.linalg.norm(dj) > 0, name
            assert np.linalg.norm(dt - dj) <= 0.25 * np.linalg.norm(dj), name
