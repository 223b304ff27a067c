"""Data parallelism in the port (``parallel/mesh.py``, ``parallel/
explicit.py``, the BN axis of ``models/norm.py``, ``pretrain(mesh=...)``)
on the CPU, with two gloo ranks spawned once for the whole module.

One module-scoped fixture spawns the two ranks (``parallel/launch.py``:
ports from the OS, a deadline after which every child is killed, so a
hung collective fails the fixture and never stalls the run) and runs every
multi-rank check there; the tests compare its results with one process.

* ``_local_nt_xent`` and ``_local_modified`` against the JAX package's, run
  inside a two-device ``shard_map`` on the CPU: per-rank sums and the
  gradient of their total with respect to every row, float32, within 1e-6
  relative (the same float32 ops in another order).
* ``SubsetBatchNorm(axis_name='data')`` on two ranks against one process
  on the concatenated batch (exact, ``subset_st`` and ``fused_vjp``, whose
  route is skipped under an axis): outputs, input and affine gradients
  (summed over ranks) and running statistics within 1e-5 relative
  (float32 means over 2 x 3 x 4 x 4 elements, summed per rank, then over
  ranks).
* One explicit step on two ranks against the one-device engine on the
  global batch (``bn_stats_fraction=1.0``, float32), NT-Xent and the
  modified loss, with SGD as JAX's tight test (``tests/test_explicit.py``)
  uses it, so that the parameters' change is proportional to the
  gradient: loss within 1e-6 and every parameter within 1e-5 relative
  (measured 6.5e-6 at worst, a BN bias), but the head's hidden bias, zero
  in exact arithmetic (below), within 1e-6 absolute.
* ``pretrain()`` on two ranks, 2 epochs of one step with a checkpoint
  after the first, and again resumed from it (Adam, as the driver builds
  it), against ``pretrain()`` in one process: the resumed run equals the
  uninterrupted one bit for bit; the first step's loss, from the same
  weights, within 1e-6 relative. After it, Adam's first step moves every
  parameter by about lr * sign(gradient), so a coordinate whose gradient
  is within float32 noise of 0 can move the other way (2e-3 apart), and
  the modified loss's clamp at 1e-4 moves other gradients by more than
  noise: the second step's loss within 1e-4 relative (measured 4.6e-6),
  the parameters within 2.5e-4 in relative norm over the whole tree
  (measured 2.1e-5 for NT-Xent and 6.5e-5 for the modified loss),
  leaving out the head's hidden bias (below); the
  validation loss (eval-mode BN, where that bias counts) within 1e-3.
* The refusals (``accum_steps > 1``; ``engine='explicit'`` without a mesh;
  an NCCL or a default-device mesh without a GPU) and the CLI's
  ``--engine explicit`` and ``--n_devices``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from simclr_tpu_torch.config import Config, ModelConfig, TrainConfig
from simclr_tpu_torch.data.pipeline import DeviceDataset, Split
from simclr_tpu_torch.models.norm import SubsetBatchNorm
from simclr_tpu_torch.parallel import explicit, mesh as tmesh
from simclr_tpu_torch.parallel.launch import spawn_ranks
from simclr_tpu_torch.scripts import pretrain as cli
from simclr_tpu_torch.train import pretrain as tpre

RANKS, M, D = 2, 3, 5               # local-loss shapes: 2m rows a rank
TEMP = 0.5
BN_SHAPE = (3, 4, 4, 4)             # a rank's (n, C, H, W)
BN_MODES = (("exact", False), ("subset_st", False), ("exact", True))
BATCH, SIZE = 8, 16                 # the engine checks' batch and images
# The head's hidden bias: a BN follows it, so its gradient is zero in exact
# arithmetic and float32 noise (about 1e-9) in either run.
_NOISE = ("g.linear0.bias",)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(modified=False, root=None):
    model = ModelConfig(feature_dim=32, compressed_dim=16,
                        stage_sizes=(1, 1, 1, 1), width=4,
                        compute_dtype="float32", bn_dtype="float32",
                        bn_stats_fraction=1.0)
    cfg = Config(model=model, train=TrainConfig(
        batch_size=BATCH, n_epoch=2, save_ckpt=True, save_ckpt_every=1,
        modified_loss=modified))
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                  img_size=SIZE))
    if root is not None:
        cfg = cfg.replace(out_dir=os.path.join(root, "out"),
                          ckpt_dir=os.path.join(root, "ckpt"))
    return cfg


def _inputs():
    rng = np.random.RandomState(0)
    return dict(
        z=rng.standard_normal((RANKS * 2 * M, D)).astype(np.float32),
        x=rng.standard_normal((RANKS * BN_SHAPE[0],) + BN_SHAPE[1:])
        .astype(np.float32) * 2 + 1,
        g=rng.standard_normal((RANKS * BN_SHAPE[0],) + BN_SHAPE[1:])
        .astype(np.float32),
        images=rng.randint(0, 256, (2 * BATCH, SIZE, SIZE, 3))
        .astype(np.uint8))


def _split(images):
    labels = np.zeros(len(images), np.int32)
    return Split(DeviceDataset.from_numpy(images[:BATCH], labels[:BATCH],
                                          "cpu"),
                 DeviceDataset.from_numpy(images[BATCH:], labels[BATCH:],
                                          "cpu"))


def _numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _sgd_step(cfg, images, mesh):
    model, state, _ = tpre.init_simclr(cfg, 0, "cpu", mesh=mesh)
    sgd = torch.optim.SGD(model.parameters(), lr=0.05)
    engine = tpre.build_engine(cfg, model, sgd, mesh=mesh)
    state, (loss, acc) = engine.train_step_on_batch(
        state, torch.from_numpy(images[:BATCH]),
        torch.Generator().manual_seed(3))
    return float(loss), float(acc), _numpy_state(model)


def _pretrain_twice(cfg, images, mesh):
    quiet = dict(save_plots=False, log=lambda _: None, device="cpu")
    run = tpre.pretrain(cfg, _split(images), mesh=mesh, **quiet)
    out = dict(history=run.history.to_dict(), state=_numpy_state(
        run.state.model))
    if mesh is not None:
        resumed = tpre.pretrain(
            cfg, _split(images), mesh=mesh, engine="explicit",
            resume_from=os.path.join(cfg.ckpt_dir, "epoch_00000"),
            save_checkpoints=False, **quiet)
        out.update(resumed_history=resumed.history.to_dict(),
                   resumed_state=_numpy_state(resumed.state.model))
    return out


def _rank_checks(mesh, inputs, root):
    """Every multi-rank check of the module, on one rank."""
    r = mesh.rank
    out = {"rank": r, "size": mesh.size}
    z = inputs["z"][r * 2 * M:(r + 1) * 2 * M]
    for name, fn in (("nt_xent", explicit._local_nt_xent),
                     ("modified", explicit._local_modified)):
        zt = torch.from_numpy(z.copy()).requires_grad_()
        ce, hits = fn(zt, RANKS * M, TEMP, mesh)
        ce.backward()
        out[name] = (ce.item(), hits.item(), zt.grad.numpy().copy())
    n = BN_SHAPE[0]
    x = inputs["x"][r * n:(r + 1) * n]
    g = inputs["g"][r * n:(r + 1) * n]
    for mode, fused in BN_MODES:
        bn = SubsetBatchNorm(BN_SHAPE[1], dtype=torch.float32,
                             stats_fraction=1.0, grad_mode=mode,
                             fused_vjp=fused, axis_name=tmesh.DATA_AXIS)
        xt = torch.from_numpy(x.copy()).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(g)).sum().backward()
        out["bn", mode, fused] = (
            y.detach().numpy().copy(), xt.grad.numpy().copy(),
            bn.weight.grad.numpy().copy(), bn.bias.grad.numpy().copy(),
            bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())
    for modified in (False, True):
        out["step", modified] = _sgd_step(_cfg(modified), inputs["images"],
                                          mesh)
        out["pretrain", modified] = _pretrain_twice(
            _cfg(modified, os.path.join(root, f"mod{int(modified)}")),
            inputs["images"], mesh)
    try:
        explicit.build_explicit_engine(
            _cfg().replace(train=dataclasses.replace(_cfg().train,
                                                     accum_steps=2)),
            *tpre.init_simclr(_cfg(), 0, mesh=mesh)[::2], mesh)
    except ValueError as e:
        out["accum_refusal"] = str(e)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ranks"))
    return spawn_ranks(_rank_checks, RANKS, inputs, root, timeout=240)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30)


# ---------------------------------------------------------------------------
# The local losses against JAX's inside shard_map.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_local(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from simclr_tpu.parallel import explicit as jex
    from simclr_tpu.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(RANKS)
    out = {}
    for name, fn in (("nt_xent", jex._local_nt_xent),
                     ("modified", jex._local_modified)):
        def per_shard(z, fn=fn):
            ce, hits = fn(z, RANKS * M, TEMP)
            return ce[None], hits[None]

        f = jex._shard_map(per_shard, mesh=mesh, in_specs=P(DATA_AXIS),
                           out_specs=(P(DATA_AXIS), P(DATA_AXIS)))
        ce, hits = jax.jit(f)(inputs["z"])
        grad = jax.jit(jax.grad(lambda z, f=f: jnp.sum(f(z)[0])))(
            inputs["z"])
        out[name] = (np.asarray(ce), np.asarray(hits), np.asarray(grad))
    return out


@pytest.mark.parametrize("name", ["nt_xent", "modified"])
def test_local_losses_match_jax_shard_map(ranks, jax_local, name):
    ce, hits, grad = jax_local[name]
    for r, res in enumerate(ranks):
        got_ce, got_hits, got_grad = res[name]
        np.testing.assert_allclose(got_ce, ce[r], rtol=1e-6)
        assert got_hits == hits[r]
        rows = slice(r * 2 * M, (r + 1) * 2 * M)
        assert _rel(got_grad, grad[rows]) <= 1e-6


# ---------------------------------------------------------------------------
# SubsetBatchNorm with an axis.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,fused", BN_MODES,
                         ids=["exact", "subset_st", "fused_vjp"])
def test_bn_axis_equals_one_process_on_the_whole_batch(ranks, inputs, mode,
                                                       fused):
    bn = SubsetBatchNorm(BN_SHAPE[1], dtype=torch.float32,
                         stats_fraction=1.0, grad_mode=mode, fused_vjp=fused)
    x = torch.from_numpy(inputs["x"].copy()).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inputs["g"])).sum().backward()
    n = BN_SHAPE[0]
    for r, res in enumerate(ranks):
        y_r, dx_r, dw, db, rm, rv = res["bn", mode, fused]
        rows = slice(r * n, (r + 1) * n)
        assert _rel(y_r, y.detach().numpy()[rows]) <= 1e-5
        assert _rel(dx_r, x.grad.numpy()[rows]) <= 1e-5
        assert _rel(rm, bn.running_mean.numpy()) <= 1e-5
        assert _rel(rv, bn.running_var.numpy()) <= 1e-5
    for i, want in ((2, bn.weight.grad), (3, bn.bias.grad)):
        total = sum(res["bn", mode, fused][i] for res in ranks)
        assert _rel(total, want.numpy()) <= 1e-5


def test_bn_axis_name_must_be_bound():
    bn = SubsetBatchNorm(4, axis_name="unbound")
    with pytest.raises(NameError, match="unbound axis name"):
        bn(torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# The explicit step and pretrain() on two ranks against one process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modified", [False, True],
                         ids=["nt_xent", "modified"])
def test_two_rank_step_equals_the_one_process_step(ranks, inputs, modified):
    loss, acc, state = _sgd_step(_cfg(modified), inputs["images"], None)
    for res in ranks:
        got_loss, got_acc, got_state = res["step", modified]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
        assert got_acc == acc
        for k, v in state.items():
            if k in _NOISE:
                assert np.abs(got_state[k] - v).max() <= 1e-6, k
            else:
                assert _rel(got_state[k], v) <= 1e-5, k


@pytest.mark.parametrize("modified", [False, True],
                         ids=["nt_xent", "modified"])
def test_two_rank_pretrain_with_a_resume_equals_one_process(
        ranks, inputs, tmp_path, modified):
    one = _pretrain_twice(_cfg(modified, str(tmp_path)), inputs["images"],
                          None)
    want = one["history"]["loss"]
    params = [k for k in one["state"] if "running" not in k
              and k not in _NOISE]
    for res in ranks:
        two = res["pretrain", modified]
        assert two["resumed_history"] == two["history"]
        for k, v in two["state"].items():
            assert np.array_equal(two["resumed_state"][k], v), k
        got = two["history"]["loss"]
        np.testing.assert_allclose(got["train"][0], want["train"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["train"][1], want["train"][1],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["valid"], want["valid"], rtol=1e-3)
        diff = np.sqrt(sum(np.sum((two["state"][k] - one["state"][k])
                                  .astype(np.float64) ** 2) for k in params))
        size = np.sqrt(sum(np.sum(one["state"][k].astype(np.float64) ** 2)
                           for k in params))
        assert diff / size <= 2.5e-4
    assert ranks[0]["pretrain", modified]["state"].keys() == one[
        "state"].keys()


# ---------------------------------------------------------------------------
# Refusals and the CLI.
# ---------------------------------------------------------------------------

def test_explicit_engine_refuses_grad_accumulation(ranks):
    for res in ranks:
        assert "accum_steps > 1" in res["accum_refusal"]


def test_explicit_engine_needs_a_mesh_and_meshes_need_the_card(monkeypatch):
    with pytest.raises(ValueError, match="requires a device mesh"):
        tpre.pretrain(_cfg(), engine="explicit", device="cpu")
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        tmesh.make_mesh(device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_cli_takes_the_explicit_engine_and_a_device_count(monkeypatch):
    args = cli.parse_args(["--engine", "explicit", "--n_devices", "2",
                           "--device", "cpu"])
    assert args.engine == "explicit" and cli.n_devices(args) == 2
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert cli.n_devices(cli.parse_args([])) == 4
    assert cli.config_from_args(args).train.batch_size == 512
