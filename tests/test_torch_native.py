"""The port's C++ data plane (``simclr_tpu_torch/data/native``) against the
JAX package's (``simclr_tpu/data/native``) and against the numpy decoders,
on the CPU. Every comparison is bit for bit: both libraries are builds of
the same C source, and decoding and batch assembly copy bytes."""

import numpy as np
import pytest

from simclr_tpu.data import native as jnative
from simclr_tpu_torch.data import datasets as tds
from simclr_tpu_torch.data import native


def _write_cifar_bin(root, n=8, seed=0):
    d = root / "cifar-10-batches-bin"
    d.mkdir()
    rng = np.random.RandomState(seed)
    rows = np.concatenate(
        [rng.randint(0, 10, size=(n, 1)),
         rng.randint(0, 256, size=(n, 3072))], axis=1).astype(np.uint8)
    for i in range(1, 6):
        # A distinct batch per file, so the five files' order shows.
        np.roll(rows, i, axis=0).tofile(d / f"data_batch_{i}.bin")
    rows.tofile(d / "test_batch.bin")
    return d


def _write_stl10(root, n=3, labelled=True, seed=2):
    d = root / "stl10_binary"
    d.mkdir()
    rng = np.random.RandomState(seed)
    rng.randint(0, 256, size=(n, 3, 96, 96), dtype=np.uint8).tofile(
        d / "train_X.bin")
    if labelled:
        rng.randint(1, 11, size=n, dtype=np.uint8).tofile(d / "train_y.bin")
    return d


def test_library_builds_into_the_port_build_directory():
    lib = native.load_library()
    assert lib is not None
    path = native.library_path()
    assert path.is_file() and path.parent.parent == native.BUILD_DIR
    assert native.SRC.parent != path.parent


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_cifar_decode_matches_jax_and_numpy(tmp_path, train):
    d = _write_cifar_bin(tmp_path)
    got = native.decode_cifar10_binary(str(d), train)
    want = jnative.decode_cifar10_binary(str(d), train)
    plain = tds._cifar10_binary_numpy(str(d), train)
    assert got is not None and want is not None
    assert got[0].shape == ((40 if train else 8), 32, 32, 3)
    for a, b, c in zip(got, want, plain):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # load_dataset's route (native first) gives the same bytes.
    loaded = tds.load_cifar10(str(tmp_path), train=train)
    for a, c in zip(loaded, plain):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("labelled", [True, False],
                         ids=["labelled", "unlabelled"])
def test_stl10_decode_matches_jax_and_numpy(tmp_path, labelled):
    d = _write_stl10(tmp_path, labelled=labelled)
    x, y = str(d / "train_X.bin"), str(d / "train_y.bin")
    y = y if labelled else None
    got = native.decode_stl10(x, y, 3)
    want = jnative.decode_stl10(x, y, 3)
    plain = tds._stl10_numpy(x, str(d / "train_y.bin"))
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    loaded = tds.load_stl10(str(tmp_path), "train")
    for a, c in zip(loaded, plain):
        np.testing.assert_array_equal(a, c)


def test_without_the_library_decoders_fall_back_and_the_pipeline_raises(
        tmp_path, monkeypatch):
    d = _write_cifar_bin(tmp_path, n=4, seed=1)
    with_lib = tds.load_cifar10(str(tmp_path), train=False)
    monkeypatch.setattr(native, "load_library", lambda: None)
    assert native.decode_cifar10_binary(str(d), False) is None
    assert native.decode_stl10("x", None, 1) is None
    for a, b in zip(tds.load_cifar10(str(tmp_path), train=False), with_lib):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativePipeline(np.zeros((4, 2, 2, 3), np.uint8),
                              np.zeros(4, np.int32), 2)


def _indexed(n, shape=(2, 2, 3)):
    images = (np.arange(n, dtype=np.uint8)[:, None, None, None]
              * np.ones((1,) + shape, np.uint8))
    return images, np.arange(n, dtype=np.int32)


def test_pipeline_matches_jax_over_two_epochs():
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, size=(50, 4, 4, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, size=50).astype(np.int32)
    with native.NativePipeline(images, labels, 16, seed=11) as pipe, \
            jnative.NativePipeline(images, labels, 16, seed=11) as jpipe:
        assert pipe.steps_per_epoch == jpipe.steps_per_epoch == 3
        for _ in range(2 * pipe.steps_per_epoch):
            got, want = pipe.next(), jpipe.next()
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        # next_device on the CPU gives the same batch, as tensors.
        imgs, labs = pipe.next_device()
        jimgs, jlabs = jpipe.next()
        np.testing.assert_array_equal(imgs.numpy(), jimgs)
        np.testing.assert_array_equal(labs.numpy(), jlabs)


def test_pipeline_covers_each_epoch_and_reshuffles():
    n, batch = 64, 16
    images, labels = _indexed(n)
    with native.NativePipeline(images, labels, batch, seed=7) as pipe:
        assert pipe.steps_per_epoch == 4
        epochs = [[], []]
        for e in range(2):
            for _ in range(4):
                imgs, labs = pipe.next(copy=False)
                assert imgs.shape == (batch, 2, 2, 3)
                np.testing.assert_array_equal(imgs[:, 0, 0, 0],
                                              labs.astype(np.uint8))
                epochs[e].extend(labs.tolist())
    assert sorted(epochs[0]) == sorted(epochs[1]) == list(range(n))
    assert epochs[0] != epochs[1]


def test_pipeline_refuses_an_oversized_batch():
    images, labels = _indexed(4)
    with pytest.raises(ValueError, match="batch > n"):
        native.NativePipeline(images, labels, batch_size=8)
