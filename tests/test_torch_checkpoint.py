"""The port's ``pretrain()`` entry point, checkpoints and export, on the CPU.

A tiny model (``stage_sizes=(1,1,1,1)``, width 4, float32) on 80
synthetic 16x16 images (an 80/20 split: 4 steps of 16 and a one-batch
validation epoch). ``pretrain()`` must write its history, metrics (the
JAX ``pretrain()``'s records, key for key), checkpoints, export, plots and
profile; one epoch, a resume and one more epoch must equal two epochs
straight bit for bit (the per-epoch draws come from (seed, epoch) alone);
``"auto"`` resumes from the newest checkpoint or starts fresh with its
message; the export and the checkpoint files round-trip; JAX-layout
``init_variables`` seed the weights through ``simclr_from_jax``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import DeviceDataset, Split, split_indices
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.train.common import adam_torch
from simclr_tpu_torch.utils import checkpoint as ck
from simclr_tpu_torch.utils.profiling import read_metrics
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TINY = dict(feature_dim=32, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=4, compute_dtype="float32", bn_dtype="float32")
N_IMAGES, BATCH, SIZE = 80, 16, 16


@pytest.fixture(scope="module")
def split():
    images, labels = synthetic_dataset(N_IMAGES, SIZE, seed=0)
    tr, va = split_indices(N_IMAGES, 0.2)
    return Split(DeviceDataset.from_numpy(images[tr], labels[tr], "cpu"),
                 DeviceDataset.from_numpy(images[va], labels[va], "cpu"))


def _config(root, n_epoch, name="run"):
    cfg = tcfg.Config(model=tcfg.ModelConfig(**TINY),
                      train=tcfg.TrainConfig(n_epoch=n_epoch,
                                             batch_size=BATCH,
                                             save_ckpt_every=1),
                      out_dir=str(root / name / "out"),
                      ckpt_dir=str(root / name / "ckpt"))
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                   img_size=SIZE))


def _run(cfg, split, **kw):
    lines = []
    result = tpre.pretrain(cfg, split, log=lines.append, device="cpu", **kw)
    return result, lines


def _tensors_equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def straight(split, tmp_path_factory):
    """Two epochs straight, with metrics, plots and a profile."""
    root = tmp_path_factory.mktemp("straight")
    cfg = _config(root, 2)
    result, lines = _run(cfg, split, metrics_path=str(root / "m.jsonl"),
                         profile_dir=str(root / "profile"))
    return dict(root=root, cfg=cfg, result=result, lines=lines)


def test_pretrain_writes_history_metrics_checkpoints_export_plots(straight):
    root, cfg, result = straight["root"], straight["cfg"], straight["result"]
    h = result.history.to_dict()
    assert [len(h[k][s]) for k in ("loss", "accuracy")
            for s in ("train", "valid")] == [2, 2, 2, 2]
    assert all(np.isfinite(v) for k in h for s in h[k] for v in h[k][s])
    assert result.state.step == 2 * 4
    assert result.steps_per_sec > 0 and result.steady_steps_per_sec > 0
    # The JAX pretrain()'s records, key for key (simclr_tpu/train/pretrain.py).
    records = read_metrics(str(root / "m.jsonl"))
    train_keys = {"step", "time", "epoch", "train_loss", "train_acc",
                  "epoch_seconds", "steps_per_sec"}
    valid_keys = {"step", "time", "epoch", "valid_loss", "valid_acc"}
    assert [set(r) for r in records] == [train_keys, valid_keys] * 2
    assert [r["step"] for r in records] == [4, 4, 8, 8]
    assert records[2]["train_loss"] == pytest.approx(h["loss"]["train"][1])
    ckpts = sorted(os.listdir(cfg.ckpt_dir))
    assert ckpts == ["epoch_00000", "epoch_00001"]
    meta = json.load(open(os.path.join(cfg.ckpt_dir, ckpts[-1],
                                       "meta.json")))
    assert meta["epoch"] == 1 and meta["history"] == h
    tag = "bs16_nepoch2_cifar10_temp05"
    assert result.export_path == os.path.join(cfg.out_dir,
                                              f"simclr_{tag}.pt")
    assert os.path.isfile(result.export_path + ".json")
    for png in (f"train_{tag}.png", f"valid_{tag}.png"):
        assert os.path.getsize(os.path.join(cfg.out_dir, png)) > 0
    assert len(list((root / "profile").glob("*.pt.trace.json"))) == 1
    lines = straight["lines"]
    assert lines[0].startswith("Epoch: 1 | Iteration 0 | Loss = ")
    assert any(l.startswith("Epoch: 2 | avg valid loss: ") for l in lines)
    assert any(l.startswith("checkpoint saved: ") for l in lines)
    assert lines[-2] == f"exported model: {result.export_path}"


def test_one_epoch_resume_one_epoch_equals_two_straight(straight, split,
                                                        tmp_path):
    first, _ = _run(_config(tmp_path, 1), split, save_plots=False)
    cfg = _config(tmp_path, 2)
    resumed, lines = _run(cfg, split, save_plots=False,
                          resume_from=os.path.join(cfg.ckpt_dir,
                                                   "epoch_00000"))
    assert lines[0] == (f"resumed from {cfg.ckpt_dir}/epoch_00000 at "
                        "epoch 1")
    want = straight["result"]
    assert _tensors_equal(resumed.state.model.state_dict(),
                          want.state.model.state_dict())
    got_opt = resumed.state.optimizer.state_dict()["state"]
    want_opt = want.state.optimizer.state_dict()["state"]
    assert all(_tensors_equal(got_opt[i], want_opt[i]) for i in want_opt)
    assert resumed.history.to_dict() == want.history.to_dict()
    assert resumed.state.step == want.state.step
    assert first.state.step == 4


def test_auto_resume_finds_the_latest_or_starts_fresh(split, tmp_path):
    cfg = _config(tmp_path, 1)
    fresh, lines = _run(cfg, split, save_plots=False, resume_from="auto")
    assert lines[0] == "auto-resume: no checkpoint found, starting fresh"
    assert ck.latest_checkpoint(cfg.ckpt_dir).endswith("epoch_00000")
    os.makedirs(os.path.join(cfg.ckpt_dir, "epoch_00007"))  # no meta.json
    assert ck.latest_checkpoint(cfg.ckpt_dir).endswith("epoch_00000")
    again, lines = _run(cfg, split, save_plots=False, resume_from="auto")
    assert lines == [f"resumed from {cfg.ckpt_dir}/epoch_00000 at epoch 1"]
    assert again.export_path is None and again.state.step == 4
    assert _tensors_equal(again.state.model.state_dict(),
                          fresh.state.model.state_dict())
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None


def test_export_round_trips(straight):
    result, cfg = straight["result"], straight["cfg"]
    sd, cfg_dict = ck.load_exported_model(result.export_path)
    assert cfg_dict == json.loads(cfg.to_json())
    assert _tensors_equal(sd, result.state.model.state_dict())
    model = SimCLR(tpre.resolve_model_config(cfg).model)
    model.load_state_dict(sd)
    path = os.path.join(cfg.out_dir, "again.pt")
    ck.export_model(path, sd)
    again, empty = ck.load_exported_model(path)
    assert _tensors_equal(again, sd) and empty == {}


def test_checkpoint_restores_model_optimizer_step_and_generator(split,
                                                                tmp_path):
    cfg = _config(tmp_path, 1)
    engine_state = tpre.init_simclr(cfg, seed=1, device="cpu")[1]
    engine = tpre.build_engine(cfg, engine_state.model,
                               engine_state.optimizer)
    gen = torch.Generator().manual_seed(4)
    images = split.train.images
    engine.train_step(engine_state, images, torch.arange(BATCH), gen)
    path = ck.save_checkpoint(cfg.ckpt_dir, 3, engine_state,
                              {"loss": {"train": [1.0]}}, {"note": "x"},
                              generator=gen)
    model_sd = {k: v.clone() for k, v in
                engine_state.model.state_dict().items()}
    next_draw = torch.rand(5, generator=gen)
    engine.train_step(engine_state, images, torch.arange(BATCH), gen)
    state, meta = ck.load_checkpoint(path, engine_state, gen)
    assert meta == {"epoch": 3, "history": {"loss": {"train": [1.0]}},
                    "note": "x"}
    assert state.step == 1
    assert _tensors_equal(state.model.state_dict(), model_sd)
    assert torch.equal(torch.rand(5, generator=gen), next_draw)


def test_load_keeps_the_optimizers_capturable_setting(tmp_path):
    """A checkpoint of a CPU (default) Adam resumes into a capturable one
    and the other way round: the loaded state follows the optimizer's own
    setting, as a CUDA graph of ``step()`` needs."""
    torch.manual_seed(0)
    for saved, wanted in ((False, True), (True, False)):
        model = torch.nn.Linear(3, 2)
        opt = adam_torch(model.parameters(), 1e-3, capturable=saved)
        model(torch.ones(1, 3)).sum().backward()
        if not saved:
            opt.step()
        else:
            opt.state[model.weight]["step"] = torch.tensor(1.0)
        state = tpre.TrainState(model, opt, 1)
        path = ck.save_checkpoint(str(tmp_path / str(saved)), 0, state)
        other = torch.nn.Linear(3, 2)
        other_opt = adam_torch(other.parameters(), 1e-3, capturable=wanted)
        ck.load_checkpoint(path, tpre.TrainState(other, other_opt))
        assert other_opt.param_groups[0]["capturable"] is wanted
        assert torch.equal(other.weight, model.weight)


def test_init_variables_seed_the_weights_from_jax_layout(split, tmp_path):
    donor = tpre.init_simclr(_config(tmp_path, 0), seed=7, device="cpu")[0]
    params, stats = simclr_to_jax(donor.state_dict())
    cfg = _config(tmp_path, 0)
    path = str(tmp_path / "init.pt")
    result, lines = _run(cfg, split, export_path=path,
                         init_variables={"params": params,
                                         "batch_stats": stats})
    assert lines == [f"exported model: {path}"]
    assert result.history.loss["train"] == []
    sd, _ = ck.load_exported_model(path)
    assert _tensors_equal(sd, simclr_from_jax(params, stats))
