"""The pieces of the port's pretrain() against the JAX package's, on the CPU.

``History``, ``MetricsLogger``/``read_metrics``, ``class_weights`` and
``make_split`` in all five modes (the loaders replaced by one small
deterministic stand-in on both sides) must give what the JAX functions
give. The eval step: a tiny model (``stage_sizes=(1,1,1,1)``, width 4,
float32) with JAX-layout weights and perturbed running statistics,
carried across with ``simclr_from_jax``, and two given views; the port's
``eval_step_on_views`` against JAX's eval-mode ``model.apply`` plus
``nt_xent_loss`` (the one JAX oracle of this file). Tolerance as
tests/test_torch_pretrain.py: loss rtol 1e-4 in float32, accuracy within
one row (a float tie can flip one row's argmax).

Also: the capture-safety repairs keep their values bit for bit, the
engine's step variants, and the CLI's ``--help`` and refusals.
"""

import copy
import dataclasses
import itertools
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.data import pipeline as jpipe
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops.losses import nt_xent_loss as jax_nt_xent
from simclr_tpu.train import common as jcommon
from simclr_tpu.utils import profiling as jprof
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data import pipeline as tpipe
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.models.norm import stats_rows, subset_scale
from simclr_tpu_torch.ops import augment
from simclr_tpu_torch.ops.kernels import winograd
from simclr_tpu_torch.scripts import pretrain as cli
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.utils import profiling as tprof
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

TINY = dict(feature_dim=32, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=4, compute_dtype="float32", bn_dtype="float32",
            fuse_identity_blocks=False, fold_bn_scales=False,
            bn_relu_fused=False)
N = 8  # pairs: 2N = 16 rows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tiny_config(img_size=16):
    """The tiny model on img_size x img_size CIFAR-like views."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(**TINY),
                      train=tcfg.TrainConfig(batch_size=N))
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                   img_size=img_size))


# ---------------------------------------------------------------------------
# History, metrics, data.
# ---------------------------------------------------------------------------

def test_history_matches_jax():
    th, jh = tcommon.History(), jcommon.History()
    for split, loss, acc in (("train", 3.5, 10.0), ("train", np.float32(3.25),
                                                    12.5), ("valid", 3.0, 20)):
        th.append(split, loss, acc)
        jh.append(split, loss, acc)
    assert th.to_dict() == jh.to_dict()
    d = json.loads(json.dumps(th.to_dict()))
    assert tcommon.History.from_dict(d).to_dict() == \
        jcommon.History.from_dict(d).to_dict()
    assert tcommon.History.from_dict(None).to_dict() == \
        jcommon.History.from_dict(None).to_dict()


def test_metrics_logger_records_match_jax(tmp_path):
    values = dict(epoch=2, train_loss=np.float32(3.5), train_acc=12.5,
                  steps=np.int64(7), flag=True, note="text",
                  tensor=torch.tensor(1.5))
    jvalues = dict(values, tensor=1.5)
    for name, lib, kw in (("t", tprof, values), ("j", jprof, jvalues)):
        with lib.MetricsLogger(str(tmp_path / name / "m.jsonl")) as m:
            m.log(3, **kw)
            m.log(4, valid_loss=2.0)
    t = tprof.read_metrics(str(tmp_path / "t" / "m.jsonl"))
    j = jprof.read_metrics(str(tmp_path / "j" / "m.jsonl"))
    assert [r.keys() for r in t] == [r.keys() for r in j]
    for a, b in zip(t, j):
        a.pop("time"), b.pop("time")
        assert a == b


def test_step_timer_and_trace(tmp_path):
    timer = tprof.StepTimer()
    for _ in range(3):
        with timer.step([torch.ones(2)]):
            torch.ones(4).sum()
    summary = timer.summary()
    assert summary["n"] == 3 and summary["steps_per_sec"] > 0
    tprof.block_on({"a": [torch.zeros(1)]})
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.annotate("region"):
            torch.ones(8).cumsum(0)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "region" in files[0].read_text()


def _stand_in(name, split, data_dir="data", **kw):
    """A small deterministic dataset per (name, split)."""
    n = {"train": 50, "test": 20, "unlabeled": 60}[split]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{split}".encode()))
    return (rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


@pytest.mark.parametrize("name,mode,label_size", [
    ("cifar10", "pretrain", 0.1), ("stl10", "pretrain", 0.1),
    ("cifar10", "lin_eval", 0.1), ("cifar10", "supervised_bm", 0.1),
    ("cifar10", "fine_tune", 0.1), ("cifar10", "fine_tune", 1.0),
    ("stl10", "test", 0.1)])
def test_make_split_matches_jax(monkeypatch, name, mode, label_size):
    monkeypatch.setattr(tpipe, "load_dataset", _stand_in)
    monkeypatch.setattr(jpipe, "load_dataset", _stand_in)
    t = tpipe.make_split(tcfg.Config.for_dataset(
        name, ssl_label_size=label_size), mode, "cpu")
    j = jpipe.make_split(jcfg.Config.for_dataset(
        name, ssl_label_size=label_size), mode)
    assert (t.val is None) == (j.val is None)
    for td, jd in ((t.train, j.train), (t.val, j.val)):
        if td is None:
            continue
        assert td.n == jd.n
        np.testing.assert_array_equal(td.images.numpy(),
                                      np.asarray(jd.images))
        np.testing.assert_array_equal(td.labels.numpy(),
                                      np.asarray(jd.labels))
        assert td.labels.dtype == torch.int32


def test_make_split_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setattr(tpipe, "load_dataset", _stand_in)
    with pytest.raises(NotImplementedError, match="unknown mode"):
        tpipe.make_split(tcfg.Config(), "nope", "cpu")


def test_class_weights_and_iterators():
    labels = np.array([0, 1, 1, 2, 2, 2, 5])
    np.testing.assert_array_equal(tpipe.class_weights(labels),
                                  jpipe.class_weights(labels))
    images, labels = synthetic_dataset(50, 8, seed=1)
    ds = tpipe.DeviceDataset.from_numpy(images, labels, "cpu")
    seq = list(tpipe.iterate_sequential(ds, 16))
    assert [x.shape[0] for x, _ in seq] == [16, 16, 16, 2]
    np.testing.assert_array_equal(torch.cat([x for x, _ in seq]).numpy(),
                                  images)
    gen = torch.Generator().manual_seed(0)
    batches = list(tpipe.iterate_epoch(ds, gen, 16))
    assert len(batches) == 3
    seen = torch.cat([y for _, y in batches])
    assert seen.shape == (48,)


# ---------------------------------------------------------------------------
# Capture-safety repairs keep their values.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fraction", [0.0625, 0.1, 0.25, 0.3, 1 / 3, 0.7,
                                      1.0])
def test_subset_scale_has_the_bits_of_the_old_constant(dtype, fraction):
    for n in (40, 80, 333, 512, 1000, 1024):
        for min_rows in (1, 7, 64):
            k = stats_rows(n, fraction, min_rows)
            new = subset_scale(n, k, dtype, "cpu")
            old = torch.tensor(n / k, dtype=dtype)
            assert new.dtype == old.dtype and new.shape == old.shape
            assert torch.equal(new.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               old.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32))


def test_colour_schedule_table_is_unchanged_and_built_once():
    table = augment._perm_table(torch.device("cpu"))
    want = torch.tensor(list(itertools.permutations(range(4))),
                        dtype=torch.int32)
    assert torch.equal(table, want)
    assert torch.equal(table, torch.as_tensor(augment._PERMS))
    assert augment._perm_table(torch.device("cpu")) is table
    gen = torch.Generator().manual_seed(0)
    _, schedule = augment.sample_color_params(gen, 64, 0.5, 0.8, 0.2)
    assert schedule.dtype == torch.int32 and schedule.shape == (64, 4)
    assert all(tuple(r) in set(itertools.permutations(range(4)))
               for r in schedule.tolist())


def test_winograd_filter_transform_matrix_is_unchanged_and_built_once():
    g = winograd._gmat(torch.device("cpu"))
    assert torch.equal(g, torch.tensor(winograd._G, dtype=torch.float32))
    assert winograd._gmat(torch.device("cpu")) is g


# ---------------------------------------------------------------------------
# The eval step against JAX, and the engine's step variants.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_eval():
    """JAX-layout weights (made by the port from another seed) with
    perturbed running statistics, two views, and JAX's eval-mode loss and
    accuracy on them."""
    model, _, _ = tpre.init_simclr(_tiny_config(32), seed=3, device="cpu")
    params, stats = simclr_to_jax(model.state_dict())
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 1.5, leaf.shape)
                            if path[-1].key == "var"
                            else rng.normal(0.0, 0.2, leaf.shape)
                            ).astype(np.float32), stats)
    v1, v2 = (rng.normal(0.0, 1.0, (N, 32, 32, 3)).astype(np.float32)
              for _ in range(2))
    jc = jcfg.Config(model=jcfg.ModelConfig(**TINY))
    jmodel = JSimCLR(cfg=jc.model)

    @jax.jit
    def loss_acc(variables, a, b):
        _, z1 = jmodel.apply(variables, a, train=False)
        _, z2 = jmodel.apply(variables, b, train=False)
        return jax_nt_xent(z1, z2, jc.train.temperature, normalize=True)

    loss, acc = loss_acc({"params": params, "batch_stats": stats}, v1, v2)
    return dict(params=params, stats=stats, v1=v1, v2=v2, loss=float(loss),
                acc=float(acc))


def _engine(cfg, seed=0, two_pass=False):
    model, state, opt = tpre.init_simclr(cfg, seed=seed, device="cpu")
    return tpre.build_engine(cfg, model, opt, two_pass), state


def test_eval_step_matches_jax_eval_forward_and_ntxent(jax_eval):
    engine, _ = _engine(_tiny_config(32))
    engine.model.load_state_dict(simclr_from_jax(jax_eval["params"],
                                                 jax_eval["stats"]))
    before = copy.deepcopy(engine.model.state_dict())
    loss, acc = engine.eval_step_on_views(torch.from_numpy(jax_eval["v1"]),
                                          torch.from_numpy(jax_eval["v2"]))
    np.testing.assert_allclose(float(loss), jax_eval["loss"], rtol=1e-4)
    assert abs(float(acc) - jax_eval["acc"]) <= 100.0 / (2 * N) + 1e-4
    assert engine.model.training
    after = engine.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_eval_epoch_is_the_mean_of_its_steps_and_scales_by_accum():
    cfg = _tiny_config()
    engine, state = _engine(cfg)
    images, _ = synthetic_dataset(3 * N, 16, seed=2)
    images = torch.from_numpy(images)
    idx = tpipe.epoch_permutation(torch.Generator().manual_seed(1),
                                  3 * N, N)
    gen = torch.Generator().manual_seed(5)
    steps = [engine.eval_step(state, images, row, gen) for row in idx]
    gen = torch.Generator().manual_seed(5)
    loss, acc = engine.eval_epoch(state, images, idx, gen)
    torch.testing.assert_close(loss, torch.stack([s[0] for s in steps]).mean())
    torch.testing.assert_close(acc, torch.stack([s[1] for s in steps]).mean())
    ds = tpipe.DeviceDataset.from_numpy(images.numpy(), np.zeros(3 * N),
                                        "cpu")
    a = tpre.evaluate_auxiliary(engine, state, ds, seed=4)
    assert a == tpre.evaluate_auxiliary(engine, state, ds, seed=4)
    assert all(np.isfinite(a))


def test_train_step_direct_is_the_step_on_a_gathered_batch():
    cfg = _tiny_config()
    images, _ = synthetic_dataset(2 * N, 16, seed=3)
    images = torch.from_numpy(images)
    idx = torch.arange(N, 2 * N)
    results = []
    for direct in (True, False):
        engine, state = _engine(cfg)
        gen = torch.Generator().manual_seed(9)
        if direct:
            state, (loss, acc) = engine.train_step_direct(
                state, images[N:], gen)
        else:
            state, (loss, acc) = engine.train_step(state, images, idx, gen)
        results.append((loss, acc, state.step,
                        [p.detach().clone()
                         for p in engine.model.parameters()]))
    (la, aa, sa, pa), (lb, ab, sb, pb) = results
    assert torch.equal(la, lb) and torch.equal(aa, ab) and sa == sb == 1
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_two_pass_views_runs_two_forwards_with_their_own_statistics():
    cfg = _tiny_config()
    images, _ = synthetic_dataset(N, 16, seed=4)
    batch = torch.from_numpy(images)
    engine, state = _engine(cfg, two_pass=True)
    twin = copy.deepcopy(engine.model)
    pair = engine.sample_pair_params(torch.Generator().manual_seed(2), N,
                                     16, 16)
    state, (loss, _) = engine.train_step_on_params(state, batch, pair)
    views = [augment.augment_train_apply(batch, p, cfg.dataset)
             for p in pair]
    twin.train()
    z1 = twin(views[0].permute(0, 3, 1, 2))[1]
    z2 = twin(views[1].permute(0, 3, 1, 2))[1]
    assert torch.equal(loss, engine.loss_fn(z1, z2)[0].detach())
    one_pass, state1 = _engine(cfg)
    _, (loss1, _) = one_pass.train_step_on_params(state1, batch, pair)
    assert not torch.equal(loss, loss1)
    ran = {k: v for k, v in twin.state_dict().items() if "running" in k}
    got = engine.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ran.items())


def test_epoch_seed_depends_on_seed_and_epoch_alone():
    seeds = {tpre.epoch_seed(s, e) for s in range(3) for e in range(4)}
    assert len(seeds) == 12
    assert tpre.epoch_seed(1, 2) == tpre.epoch_seed(1, 2)


def test_entry_points_default_to_cuda_and_refuse_what_is_not_ported(
        monkeypatch):
    """Nothing of ``pretrain`` is unported since data parallelism came
    (``tests/test_torch_parallel.py``): the default device needs a GPU,
    the explicit engine needs a mesh (as in JAX), and an unknown engine
    name is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.pretrain(_tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.init_simclr(_tiny_config())
    with pytest.raises(ValueError, match="requires a device mesh"):
        tpre.pretrain(_tiny_config(), engine="explicit", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tpre.pretrain(_tiny_config(), engine="other", device="cpu")


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_cli_help(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--resume_training_path" in out


@pytest.mark.parametrize("flags,item", [
    (["--n_devices", "2"], "item 11"), (["--engine", "explicit"], "item 11"),
    (["--accum_steps", "2"], "item 3")])
def test_cli_refuses_unported_flags(flags, item):
    """No flag is refused any more: data parallelism (ROADMAP Queue A item
    11) and gradient accumulation (item 3) are ported. ``--n_devices 2``
    needs two ranks, which torchrun starts: a lone process refuses it
    before it builds anything. ``--engine explicit`` parses (one rank runs
    a group of one; ``tests/test_torch_parallel.py`` runs the step)."""
    args = cli.parse_args(flags + ["--device", "cpu"])
    if item == "item 3":
        assert cli.config_from_args(args).train.accum_steps == 2
    elif flags[0] == "--engine":
        assert args.engine == "explicit" and cli.n_devices(args) == 1
    else:
        assert cli.n_devices(args) == 2
        with pytest.raises(ValueError, match="world of 2 ranks"):
            cli.main(flags + ["--device", "cpu"])


def test_cli_takes_the_dropout_encoder():
    """``--encoder_model dropout`` is ported: no refusal, and the config
    carries it."""
    args = cli.parse_args(["--encoder_model", "dropout"])
    assert cli.config_from_args(args).model.encoder == "dropout"


def test_cli_flags_build_the_jax_scripts_config(monkeypatch):
    args = cli.parse_args(["--n_epoch", "3", "--batch_size", "64", "--temp",
                           "0.2", "--save_every", "2", "--modified_loss",
                           "--no_save_ckpt", "--dataset", "stl10",
                           "--seed", "4", "--path_for_saving", "out"])
    cfg = cli.config_from_args(args)
    t = cfg.train
    assert (t.n_epoch, t.batch_size, t.temperature, t.save_ckpt_every,
            t.modified_loss, t.save_ckpt, t.seed) == (3, 64, 0.2, 2, True,
                                                      False, 4)
    assert cfg.out_dir == "out" and cfg.dataset.name == "stl10"
    assert not cfg.model.low_quality_img
    defaults = cli.config_from_args(cli.parse_args([]))
    assert defaults.to_json() == tcfg.Config.for_dataset("cifar10").replace(
        train=dataclasses.replace(tcfg.Config().train)).to_json()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
