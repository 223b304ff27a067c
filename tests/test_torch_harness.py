"""The port's analysis, STL-10 and experiment entry points
(``simclr_tpu_torch/scripts/{analysis,stl10_artifact,parity_run,
merge_parity,temp_sweep,batch_sweep}.py``) on the CPU.

* ``analyze`` on a tiny SimCLR (and a tiny ``SupervisedResNet``) writes
  ``metrics.json`` and ``analogy.json`` with the JAX CLI's keys; its
  one-batch gradient flow leaves every parameter, buffer, ``.grad`` and
  the training flag bit for bit as it found them (``draw``, which needs
  seaborn, is tested in ``tests/test_torch_viz_serving.py``).
* The harness tables equal the JAX scripts': ``VARIANTS``, and the
  training settings of each batch-sweep mode as the JAX ``run_one``
  builds them (its ``pretrain`` replaced by a recorder). Each CLI takes
  its JAX script's flags plus ``--device``.
* ``merge_parity`` writes the JAX script's parity.json and parity.md byte
  for byte.
* Each CLI answers ``--help``; its default device raises here.
* One tiny run of each harness: a width-2 model, one epoch of two steps.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import DeviceDataset, Split
from simclr_tpu_torch.models.resnet import SupervisedResNet
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.scripts import (
    analysis, batch_sweep, merge_parity, parity_run, stl10_artifact,
    temp_sweep)
from simclr_tpu_torch.utils.metrics import _METRIC_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"analysis": analysis, "stl10_artifact": stl10_artifact,
        "parity_run": parity_run, "temp_sweep": temp_sweep,
        "batch_sweep": batch_sweep}
TINY = dict(feature_dim=32, compressed_dim=8, stage_sizes=(1, 1, 1, 1),
            width=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's thread pool costs more than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_script(name):
    """A JAX script of ``scripts/`` as a module (its top level imports
    only the standard library and ``simclr_tpu.config``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_cfg(tmp_path, **train):
    return tcfg.Config(
        model=tcfg.ModelConfig(**TINY),
        train=tcfg.TrainConfig(n_epoch_lin_eval=2, **train),
        data_dir=str(tmp_path / "data"), out_dir=str(tmp_path / "out"),
        ckpt_dir=str(tmp_path / "ckpt"))


# ---------------------------------------------------------------------------
# analyze and its gradient flow.
# ---------------------------------------------------------------------------

def _state(model):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [None if p.grad is None else p.grad.clone()
             for p in model.parameters()], model.training)


def _same_state(model, state):
    sd, grads, training = state
    now = model.state_dict()
    assert sd.keys() == now.keys()
    for k in sd:
        assert torch.equal(sd[k], now[k]), k
    for p, g in zip(model.parameters(), grads):
        assert (p.grad is None and g is None) or torch.equal(p.grad, g)
    assert model.training == training


def test_analyze_writes_jax_keys_and_leaves_the_model_alone(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    model = SimCLR(cfg.model, generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    sup = SupervisedResNet(stage_sizes=(1, 1, 1, 1), width=2,
                           generator=torch.Generator().manual_seed(1))
    images, labels = synthetic_dataset(48, 32, seed=3)
    test = DeviceDataset.from_numpy(images[:40], labels[:40], "cpu")
    train = DeviceDataset.from_numpy(images[40:], labels[40:], "cpu")
    model.train()
    before = _state(model)
    lines = []
    res = analysis.analyze(cfg, model, test, train, tmp_path / "a",
                           n_batches=2, supervised=sup, batch_size=16,
                           log=lines.append)
    _same_state(model, before)
    assert lines[0] == "computing similarity metrics ..."

    metrics = json.loads((tmp_path / "a" / "metrics.json").read_text())
    assert sorted(metrics) == sorted(_METRIC_KEYS)
    for summary in metrics.values():
        assert sorted(summary) == sorted(
            ["n", "mean", "std", "q05", "q25", "median", "q75", "q95"])
        assert summary["n"] == 32
    analogy = json.loads((tmp_path / "a" / "analogy.json").read_text())
    assert sorted(analogy) == ["model1_l1", "model1_l2", "model2_l1",
                               "model2_l2"]
    assert analogy["model1_l1"] == analogy["model2_l1"]
    for key in ("metrics_z", "metrics_sup"):
        assert res[key]["pos_cos"].shape == (32,)
    assert res["h"].shape == (40, 64) and res["z"].shape == (40, 8)
    # The gradient flow: every parameter, named as the JAX tree names it.
    names = list(res["grads"])
    assert len(names) == len(list(model.parameters()))
    assert names == sorted(names) and names[0].startswith("['f']")
    assert all(np.isfinite(g).all() for g in res["grads"].values())
    assert np.isfinite(res["grad_loss"])

    # From eval mode, with filled gradients, it leaves them as they were.
    model.eval()
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    before = _state(model)
    grads, loss = analysis.grad_flow(cfg, model, train.images)
    _same_state(model, before)
    assert loss == pytest.approx(res["grad_loss"], rel=1e-6)



# ---------------------------------------------------------------------------
# The CLIs and the tables against the JAX scripts.
# ---------------------------------------------------------------------------

def _options(help_text):
    """The long options argparse lists, each at the start of its line."""
    import re
    return set(re.findall(r"^  (?:-\w, )?(--\w+)", help_text, re.M))


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_takes_the_jax_flags_and_device_and_answers_help(name,
                                                             monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--help"])
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        _jax_script(name).main()
    assert e.value.code == 0
    want = _options(out.getvalue()) | {"--device"}
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        CLIS[name].main(["--help"])
    assert e.value.code == 0
    assert _options(out.getvalue()) == want
    args = CLIS[name].parse_args(["x.pt"] if name == "analysis" else [])
    assert args.device == "cuda"
    assert args.out.endswith("_torch")


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_default_device_raises_without_cuda(name):
    argv = ["x.pt"] if name == "analysis" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name].main(argv)


def test_merge_parity_answers_help():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        merge_parity.main(["--help"])
    assert e.value.code == 0 and "fragments" in out.getvalue()


def test_parity_variants_equal_the_jax_table():
    want = _jax_script("parity_run").VARIANTS
    assert parity_run.VARIANTS == want
    assert list(parity_run.VARIANTS) == list(want)
    # Every override names a field of the port's ModelConfig and every
    # keyword one of pretrain's.
    import inspect
    from simclr_tpu_torch.train.pretrain import pretrain
    fields = set(tcfg.ModelConfig.__dataclass_fields__)
    for model_over, kw in parity_run.VARIANTS.values():
        assert set(model_over) <= fields
        assert set(kw) <= set(inspect.signature(pretrain).parameters)


@pytest.mark.parametrize("mode", ["global", "accum"])
@pytest.mark.parametrize("batch", [32, 64, 96, 1024])
def test_batch_sweep_modes_equal_the_jax_scripts(mode, batch, monkeypatch,
                                                 tmp_path):
    """The JAX ``run_one`` builds its config and calls ``pretrain``, which
    records the config and stops the run."""
    import simclr_tpu.config as jcfg
    # The package re-exports pretrain(), which hides the module's name.
    jpre = importlib.import_module("simclr_tpu.train.pretrain")

    class Stop(Exception):
        pass

    seen = {}

    def record(cfg, **kw):
        seen["train"] = cfg.train
        raise Stop

    monkeypatch.setattr(jpre, "pretrain", record)
    with pytest.raises(Stop):
        _jax_script("batch_sweep").run_one(
            jcfg.Config(), None, batch, mode, 3, 64, tmp_path, False)
    got = batch_sweep.sweep_train(tcfg.TrainConfig(), batch, mode, 3, 64)
    for field in ("batch_size", "accum_steps", "n_epoch", "save_ckpt"):
        assert getattr(got, field) == getattr(seen["train"], field), field


def _rows(variants, seeds, shift):
    return [{"variant": v, "seed": s, "lin_eval_top1": 50.0 + i + shift,
             "lin_eval_loss": 1.0 + 0.1 * i,
             "final_val_acc": None if v == "stgrad" else 30.0 + i + s,
             "steps_per_sec": 7.123, "real_data": False}
            for i, (v, s) in enumerate((v, s) for s in seeds
                                       for v in variants)]


def test_merge_parity_matches_the_jax_script_byte_for_byte(tmp_path,
                                                           monkeypatch):
    frags = []
    for i, (variants, seeds) in enumerate(
            ((["default", "stats25", "stgrad"], [0]),
             (["default", "stgrad"], [1, 2]),
             (["stats25"], [0, 1]))):
        path = tmp_path / f"frag{i}.json"
        path.write_text(json.dumps(_rows(variants, seeds, i)))
        frags.append(str(path))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(sys, "argv", ["merge_parity.py",
                                      str(tmp_path / "jax")] + frags)
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_script("merge_parity").main()
        merge_parity.main([str(tmp_path / "port")] + frags)
    for name in ("parity.json", "parity.md"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
    assert b"| stats25 | 2 |" in (tmp_path / "port" / "parity.md"
                                  ).read_bytes()


# ---------------------------------------------------------------------------
# One tiny run of each harness.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_splits():
    """Pretrain: 8 training images (2 steps of 4) and 4 validation ones;
    linear evaluation: 12 and 8."""
    images, labels = synthetic_dataset(32, 32, seed=9)

    def ds(lo, hi):
        return DeviceDataset.from_numpy(images[lo:hi], labels[lo:hi], "cpu")

    splits = {"pretrain": Split(ds(0, 8), ds(8, 12)),
              "lin_eval": Split(ds(12, 24)), "test": Split(ds(24, 32))}
    return splits.__getitem__


def _args(module, tmp_path, *argv):
    return module.parse_args(["--out", str(tmp_path / "out"),
                              "--device", "cpu", "--n_epoch", "1",
                              *argv])


def _quiet(_):
    pass


def test_parity_run_tiny(tmp_path, tiny_splits):
    args = _args(parity_run, tmp_path, "--batch_size", "4", "--variants",
                 "default", "stats25")
    rows = parity_run.run(args, _tiny_cfg(tmp_path), tiny_splits, "cpu",
                          real=False, log=_quiet)
    assert [r["variant"] for r in rows] == ["default", "stats25"]
    saved = json.loads((tmp_path / "out" / "parity.json").read_text())
    assert saved == json.loads(json.dumps(rows))
    md = (tmp_path / "out" / "parity.md").read_text()
    assert md.startswith("# Accuracy-parity results\n\nData: synthetic "
                         "stand-in | epochs 1 | batch 4\n")
    assert "| default | 0 |" in md and "+0.00%" in md
    assert (tmp_path / "out" / "model_stats25.pt").is_file()


def test_temp_sweep_tiny(tmp_path, tiny_splits):
    args = _args(temp_sweep, tmp_path, "--batch_size", "4", "--temps",
                 "0.5")
    hist = temp_sweep.run(args, _tiny_cfg(tmp_path), tiny_splits, "cpu",
                          log=_quiet)
    saved = json.loads((tmp_path / "out" / "histories.json").read_text())
    assert list(saved) == ["0.5"] and saved["0.5"] == hist[0.5]
    assert len(hist[0.5]["loss"]["valid"]) == 1
    for split in ("train", "valid"):
        assert (tmp_path / "out" / f"loss_acc_by_temp_{split}.png").is_file()
    assert (tmp_path / "out" / "model_temp0.5.pt").is_file()


def test_batch_sweep_tiny_in_both_modes(tmp_path, tiny_splits):
    args = _args(batch_sweep, tmp_path, "--batch_sizes", "4",
                 "--micro_batch_size", "2", "--lin_eval")
    recs = batch_sweep.run(args, _tiny_cfg(tmp_path), tiny_splits, "cpu",
                           log=_quiet)
    assert [(r["mode"], r["batch"]) for r in recs] == [("global", 4),
                                                       ("accum", 4)]
    for r in recs:
        assert np.isfinite(r["lin_eval_top1"]) and r["val_acc"] is not None
    assert (tmp_path / "out" / "varying_batch_size.png").is_file()
    assert (tmp_path / "out" / "model_accum_bs4.pt").is_file()


def test_stl10_artifact_tiny(tmp_path, monkeypatch):
    args = stl10_artifact.parse_args([
        "--out", str(tmp_path / "out"), "--device", "cpu", "--n_epoch", "1",
        "--batch_size", "4", "--n_unlabeled", "10", "--n_train", "8",
        "--n_test", "4"])
    base = tcfg.Config.for_dataset("stl10").replace(
        model=tcfg.ModelConfig(**TINY, low_quality_img=False),
        train=tcfg.TrainConfig(n_epoch_lin_eval=2),
        data_dir=str(tmp_path / "data"))
    cfg = stl10_artifact.config_from_args(args, base)
    assert cfg.out_dir == str(tmp_path / "out")
    # Two augmentation calls a run, not 20: the rate's arithmetic is the
    # same, and 80 calls at 96x96 are slow on the CPU.
    rate = stl10_artifact.aug_pairs_per_sec
    monkeypatch.setattr(stl10_artifact, "aug_pairs_per_sec",
                        lambda cfg, batch: rate(cfg, batch, iters=2))
    with pytest.warns(UserWarning, match="synthetic stand-in"):
        result = stl10_artifact.run(args, cfg, "cpu", log=_quiet)
    saved = json.loads((tmp_path / "out" / "stl10.json").read_text())
    assert saved == result
    assert result["img_size"] == 96 and result["device"] == "cpu"
    assert len(result["train_loss"]) == 1 and result["aug_pairs_per_sec"] > 0
    assert sorted(result) == sorted(
        ["config", "img_size", "steps_per_sec", "steps_per_sec_incl_compile",
         "images_per_sec", "aug_pairs_per_sec", "train_loss", "val_loss",
         "lin_eval_top1", "lin_eval_loss", "device"])
    assert (tmp_path / "out" / "README.md").is_file()
    assert (tmp_path / "out" /
            "simclr_bs4_nepoch1_stl10_temp05.pt").is_file()
