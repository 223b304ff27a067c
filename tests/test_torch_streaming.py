"""Host-streaming pretraining in the port (``data/pipeline.py:host_stream``,
``train/streaming.py:pretrain_streaming``) on the CPU, at a tiny width.

* ``host_stream`` yields the batches that a numpy gather of
  ``epoch_permutation``'s rows gives (bit for bit), and with a mesh each
  rank's contiguous slice of them.
* A streamed epoch (``PretrainEngine.train_stream``) against the resident
  ``train_epoch`` from the same permutation and generator: the losses,
  parameters, buffers and Adam state bit for bit (the same ops on the same
  bytes in the same order).
* ``pretrain_streaming`` with the numpy feed and with the native pipeline:
  finite losses and the JAX test's descending trend
  (``tests/test_streaming.py``); without a GPU its default device raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simclr_tpu_torch.config import Config, ModelConfig, TrainConfig
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.data.pipeline import epoch_permutation, host_stream
from simclr_tpu_torch.parallel.mesh import Mesh
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.train.streaming import pretrain_streaming

TINY = ModelConfig(feature_dim=64, compressed_dim=16,
                   stage_sizes=(1, 1, 1, 1), width=2,
                   compute_dtype="float32", bn_dtype="float32")


SIZE = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: PyTorch's intra-op thread pool
    costs more than it gives, most of all beside other test processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_cfg(n_epoch=2, size=SIZE):
    cfg = Config(model=TINY, train=TrainConfig(n_epoch=n_epoch,
                                               batch_size=16,
                                               save_ckpt=False))
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                   img_size=size))


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(80, img_size=SIZE, seed=0)


def test_host_stream_is_a_gather_of_the_epoch_permutation(data):
    images, labels = data
    rows = epoch_permutation(torch.Generator().manual_seed(3), 80, 16)
    got = list(host_stream(images, labels, 16,
                           torch.Generator().manual_seed(3), device="cpu"))
    assert len(got) == 5
    for (imgs, labs), row in zip(got, rows.numpy()):
        assert imgs.dtype == torch.uint8 and labs.dtype == torch.int32
        np.testing.assert_array_equal(imgs.numpy(), images[row])
        np.testing.assert_array_equal(labs.numpy(), labels[row])
    rank1 = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"),
                 backend="gloo")
    half = list(host_stream(images, labels, 16,
                            torch.Generator().manual_seed(3), device="cpu",
                            mesh=rank1))
    for (imgs, _), row in zip(half, rows.numpy()):
        np.testing.assert_array_equal(imgs.numpy(), images[row[8:]])


def test_host_stream_defaults_to_the_card(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_stream(*data, 16, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_streaming(tiny_cfg(), *data)


def _state(model, opt):
    out = {f"m.{k}": v.clone() for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        out.update({f"o.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def test_streamed_epoch_equals_the_resident_epoch(data):
    images, labels = data
    cfg = tiny_cfg()
    runs = []
    for streamed in (False, True):
        model, state, opt = tpre.init_simclr(cfg, 0, "cpu")
        engine = tpre.build_engine(cfg, model, opt)
        gen = torch.Generator().manual_seed(tpre.epoch_seed(0, 0))
        if streamed:
            batches = (b for b, _ in host_stream(images, labels, 16, gen,
                                                 device="cpu"))
            like = torch.empty((16, SIZE, SIZE, 3), dtype=torch.uint8)
            state, (losses, accs) = engine.train_stream(state, batches, 5,
                                                        like, gen)
        else:
            idx_mat = epoch_permutation(gen, 80, 16)
            state, (losses, accs) = engine.train_epoch(
                state, torch.from_numpy(images), idx_mat, gen)
        runs.append((losses, accs, _state(model, opt), state.step,
                     gen.get_state()))
    (l0, a0, s0, n0, g0), (l1, a1, s1, n1, g1) = runs
    assert n0 == n1 == 5 and torch.equal(g0, g1)
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert s0.keys() == s1.keys() and len(s0) > 100
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_pretrain_streaming_runs_and_learns(native):
    """The JAX test's data and sizes: 64 CIFAR-sized images, batch 16."""
    images, labels = synthetic_dataset(80, img_size=32, seed=0)
    n_epochs = 2 if native else 6
    res = pretrain_streaming(tiny_cfg(size=32), images[:64], labels[:64],
                             n_epochs=n_epochs, use_native_pipeline=native,
                             log=lambda m: None, device="cpu")
    losses = np.asarray(res.history.loss["train"])
    assert len(losses) == n_epochs and np.isfinite(losses).all()
    assert res.state.step == 4 * n_epochs and res.steps_per_sec > 0
    if not native:
        # Tiny-scale contrastive losses are noisy; a downward trend, as
        # the JAX test asks.
        assert losses[2:].min() < losses[0]
