"""The port's visualisation suite and serving artifact, on the CPU.

* Every drawing function saves a PNG (matplotlib, seaborn and
  scikit-learn are imported inside them, as on the JAX side), and so does
  the analysis CLI's ``draw``.
* ``flatten_grads`` names, orders and lays out the leaves as the JAX
  side's ``flatten_grads`` does its gradient tree: checked bit for bit on
  the 61 KB JAX export (``stage_sizes (1,1,1,1)``, width 2), with each
  parameter's gradient set to the parameter, so the two trees hold the
  same numbers.
* Serving: one ``torch.export`` artifact of a tiny SimCLR and one of the
  same model with MC dropout, each made once for the module. The loaded
  artifact equals the eager eval forward (NHWC in) within 1e-6 (the same
  ATen ops on the CPU; measured equal); it loads and runs while no
  module of ``simclr_tpu_torch`` can be imported; the MC-dropout artifact
  gives the same output on two loads and equals the eager forward whose
  generator is seeded ``dropout_seed``.
* Serving under the kernel flags: a tiny bf16 SimCLR (``stage_sizes (1,
  2)``, width 64: layer1_0's conv2 at 64 channels takes B4f, layer2_1's at
  128 B5f, the identity block layer2_1 B6f) exported and loaded once a
  module under ``conv64_pallas``, ``winograd_conv2``, both, and
  ``fuse_identity_blocks``, all from one set of weights. Each loaded
  artifact equals the eager eval forward bit for bit (the plain versions
  on both sides) and holds one operator node a kernel launch, the
  convolutions it replaces gone from the graph; each agrees with the JAX
  package's own artifact of the same weights without the flag (XLA's
  convolutions) within ``tests/test_torch_conv.py``'s bound for a bf16
  kernel path: 1e-2 in h and 4e-2 in z, in relative norm; and the
  conv64 + winograd one loads and runs in a fresh interpreter in which
  ``simclr_tpu_torch.models``, ``.train`` and ``.utils`` cannot be
  imported, with only the operator registry.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simclr_tpu.config import ModelConfig as JModelConfig
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.utils import checkpoint as jck
from simclr_tpu.utils import serving as jserving
from simclr_tpu.utils import visualizations as jviz
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops.augment import normalize
from simclr_tpu_torch.utils import serving
from simclr_tpu_torch.utils import visualizations as viz
from simclr_tpu_torch.utils.checkpoint import load_pretrained
from simclr_tpu_torch.utils.weights import simclr_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT,
                      "results/simclr_bs16_nepoch8_cifar10_temp05.msgpack")
SHAPE = (4, 16, 16, 3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's thread pool costs more than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# Plots and image helpers.
# ---------------------------------------------------------------------------

def _metrics(seed):
    rng = np.random.default_rng(seed)
    return {f"{w}_{k}": rng.normal(0.5 if w == "pos" else 0.0, 0.2, 64)
            for w in ("pos", "neg") for k in ("ned", "cc", "cos", "nmi")}


_PLOTS = {
    "kde_multi_plot": lambda p: viz.kde_multi_plot(
        [_metrics(0), _metrics(1), _metrics(2)], "cos",
        labels=("h", "z", "supervised"), save_path=p),
    "kde_comparison_plot": lambda p: viz.kde_comparison_plot(
        _metrics(0), _metrics(1), "nmi", save_path=p),
    "kde_single_model_plot": lambda p: viz.kde_single_model_plot(
        _metrics(0), "ned", save_path=p),
    "tsne_plot": lambda p: viz.tsne_plot(
        np.random.default_rng(0).normal(size=(40, 8)),
        np.arange(40) % 4, title="t-SNE", max_points=30, save_path=p),
    "plot_grad_flow": lambda p: viz.plot_grad_flow(
        {"['f']['a']": np.ones(3), "['g']['b']": -np.ones(2)},
        save_path=p),
    "show_images": lambda p: viz.show_images(
        np.random.default_rng(0).normal(size=(5, 8, 8, 3)),
        mean=tcfg.CIFAR10.mean, std=tcfg.CIFAR10.std, n_cols=3,
        save_path=p),
    "plot_loss_acc": lambda p: viz.plot_loss_acc(
        [3.0, 2.0, 1.5], [10.0, 20.0, 30.0], title="curves",
        save_plot=True, save_dir=os.path.dirname(p)),
}


@pytest.mark.parametrize("name", sorted(_PLOTS))
def test_every_plot_saves_a_png(name, tmp_path):
    path = str(tmp_path / "sub" / f"{name}.png")
    fig = _PLOTS[name](path)
    if name == "plot_loss_acc":
        path = str(tmp_path / "sub" / "curves.png")
    assert fig is not None
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("supervised", [False, True])
def test_analysis_draws_the_jax_clis_figures(supervised, tmp_path):
    """``scripts/analysis.py:draw`` on a result of ``analyze``'s shape:
    the single-model KDEs, or the three-way overlay with a supervised
    model; both t-SNE plots and the gradient flow."""
    from simclr_tpu_torch.scripts.analysis import draw

    rng = np.random.default_rng(0)
    res = {"metrics": _metrics(0), "h": rng.normal(size=(40, 16)),
           "z": rng.normal(size=(40, 4)), "targets": np.arange(40) % 4,
           "grads": {"['f']['a']": np.ones(3), "['g']['b']": np.ones(2)}}
    if supervised:
        res.update(metrics_z=_metrics(1), metrics_sup=_metrics(2))
    draw(res, tmp_path, tsne_points=30)
    for name in ("ned_comp", "cc_comp", "cos_comp", "nmi_comp", "tsne_h",
                 "tsne_z", "grad_flow"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name


def test_denormalize_image_round_trips_and_clips():
    ds = tcfg.CIFAR10
    x = np.random.default_rng(0).uniform(0, 1, (3, 8, 8, 3)).astype(
        np.float32)
    normed = normalize(torch.from_numpy(x), ds.mean, ds.std).numpy()
    np.testing.assert_allclose(viz.denormalize_image(normed, ds.mean,
                                                     ds.std), x, atol=1e-6)
    np.testing.assert_array_equal(
        viz.denormalize_image(normed, ds.mean, ds.std),
        jviz.denormalize_image(normed, ds.mean, ds.std))
    wide = viz.denormalize_image(np.full((2, 2, 3), 9.0), ds.mean, ds.std)
    assert (wide == 1.0).all()


def test_flatten_grads_names_and_lays_out_leaves_as_jax():
    params, _, _ = jck.load_exported_model(EXPORT)
    want = jviz.flatten_grads(params)
    sd, cfg = load_pretrained(EXPORT)
    model = SimCLR(tcfg.ModelConfig(
        feature_dim=cfg["model"]["feature_dim"],
        compressed_dim=cfg["model"]["compressed_dim"],
        stage_sizes=tuple(cfg["model"]["stage_sizes"]),
        width=cfg["model"]["width"]))
    model.load_state_dict(sd)
    for p in model.parameters():
        p.grad = p.detach().clone()
    got = viz.flatten_grads(model)
    assert list(got) == list(want) and len(got) == 58
    assert list(got)[0] == "['f']['layer1_0']['bn1']['bias']"
    for name, leaf in want.items():
        assert got[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], np.asarray(leaf, np.float32),
                                      err_msg=name)
    # A parameter without a gradient is left out.
    model.g.bn1.weight.grad = None
    assert "['g']['bn1']['scale']" not in viz.flatten_grads(model)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def _randomize_stats(model, seed):
    """Running statistics away from their initial values."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(0, 0.2, buf.shape).astype(np.float32)))


def _tiny(**over):
    mcfg = tcfg.ModelConfig(feature_dim=32, compressed_dim=8,
                            stage_sizes=(1, 1, 1, 1), width=2,
                            compute_dtype="float32", bn_dtype="float32",
                            **over)
    model = SimCLR(mcfg, generator=torch.Generator().manual_seed(5))
    _randomize_stats(model, 5)
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tiny SimCLR and its MC-dropout twin, each exported once."""
    out = {}
    for name, over in (("plain", {}),
                       ("dropout", {"encoder": "dropout",
                                    "drop_prob": 0.3})):
        model = _tiny(**over)
        model.train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        path = str(tmp_path_factory.mktemp(name) / "forward.pt2")
        serving.export_forward(path, model, SHAPE, dropout_seed=7)
        assert model.training
        after = model.state_dict()
        assert all(torch.equal(before[k], after[k]) for k in before)
        out[name] = (model, path)
    return out


def _x(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=SHAPE).astype(np.float32))


def _eager(model, x, generator=None):
    model.eval()
    try:
        with torch.no_grad():
            return model(x.permute(0, 3, 1, 2), generator)
    finally:
        model.train()


def test_round_trip_equals_the_eager_forward(artifacts):
    model, path = artifacts["plain"]
    fn = serving.load_forward(path)
    for seed in (0, 1):
        x = _x(seed)
        h, z = fn(x)
        want_h, want_z = _eager(model, x)
        assert h.shape == (4, 64) and z.shape == (4, 8)
        np.testing.assert_allclose(h.numpy(), want_h.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(z.numpy(), want_z.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_artifacts_load_without_the_model_and_repeat(artifacts,
                                                     monkeypatch):
    """With every module of the port (and of the JAX package) made
    unimportable, the MC-dropout artifact loads and runs; two loads give
    the same output, which equals the eager forward with the masks of a
    generator seeded 7."""
    model, path = artifacts["dropout"]
    x = _x(2)
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("simclr_tpu_torch", "simclr_tpu")]:
        monkeypatch.setitem(sys.modules, name, None)
    first = torch.export.load(path).module()
    second = torch.export.load(path).module()
    monkeypatch.undo()
    with torch.no_grad():
        h, z = first(x)
        h2, z2 = second(x)
    assert torch.equal(h, h2) and torch.equal(z, z2)
    want_h, want_z = _eager(model, x, torch.Generator().manual_seed(7))
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(z.numpy(), want_z.numpy(), rtol=1e-6,
                               atol=1e-6)
    # The masks matter: another seed's forward differs.
    other, _ = _eager(model, x, torch.Generator().manual_seed(8))
    assert not torch.allclose(other, h)
    # The model keeps drawing its own masks after the export.
    assert all(m.baked is None for m in model.modules()
               if hasattr(m, "baked"))


# ---------------------------------------------------------------------------
# Serving under the kernel flags.
# ---------------------------------------------------------------------------

KERNEL_BASE = dict(feature_dim=256, compressed_dim=32, stage_sizes=(1, 2),
                   width=64)
# The model's 12 convolutions: the stem, three a block, two downsamples.
N_CONV = 12
# case -> (flags, operator nodes of the artifact, convolutions replaced).
KERNEL_CASES = {
    "conv64_pallas": ({"conv64_pallas": True}, {"conv_c64": 1}, 1),
    "winograd_conv2": ({"winograd_conv2": True}, {"winograd_fwd": 1}, 1),
    "conv64_pallas+winograd_conv2": (
        {"conv64_pallas": True, "winograd_conv2": True},
        {"conv_c64": 1, "winograd_fwd": 1}, 2),
    "fuse_identity_blocks": ({"fuse_identity_blocks": True},
                             {"bottleneck_fwd": 1}, 3),
}


# A fresh interpreter in which the port's models, trainers and utilities
# cannot be imported: it imports torch and the operator registry, waits
# for its standard input to close, then loads the artifacts named after
# the directory, runs them on its x.pt and saves the outputs.
_LOAD_ALONE = """
import sys
for name in ("jax", "simclr_tpu", "simclr_tpu_torch.models",
             "simclr_tpu_torch.train", "simclr_tpu_torch.utils"):
    sys.modules[name] = None
import torch
import simclr_tpu_torch.ops.kernels.registry
torch.set_num_threads(1)
sys.stdin.read()
tmp = sys.argv[1]
x = torch.load(tmp + "/x.pt")
with torch.no_grad():
    outs = [torch.export.load(f"{tmp}/{case}.pt2").module()(x)
            for case in sys.argv[2:]]
torch.save(outs, tmp + "/out.pt")
print(" ".join(sorted(m for m in sys.modules
                      if m.startswith("simclr_tpu") and sys.modules[m])))
"""
# The artifacts it loads: together they hold all three operators.
ALONE_CASES = ("conv64_pallas+winograd_conv2", "fuse_identity_blocks")


@pytest.fixture(scope="module")
def kernel_artifacts(tmp_path_factory):
    """Each case's model (bf16, the flags-off model's weights), its
    artifact's path and the loaded artifact, exported and loaded once;
    the weights; and the fresh interpreter of ``_LOAD_ALONE``, started
    first so that its imports overlap the exports."""
    tmp = tmp_path_factory.mktemp("kernels")
    stdin, go = os.pipe()
    alone = subprocess.Popen(
        [sys.executable, "-c", _LOAD_ALONE, str(tmp), *ALONE_CASES],
        cwd=ROOT, stdin=stdin, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    os.close(stdin)
    try:
        with os.fdopen(go, "w"):
            ref = SimCLR(tcfg.ModelConfig(**KERNEL_BASE),
                         generator=torch.Generator().manual_seed(3))
            _randomize_stats(ref, 3)
            weights = ref.state_dict()
            out = {}
            for case, (flags, _, _) in KERNEL_CASES.items():
                model = SimCLR(tcfg.ModelConfig(**KERNEL_BASE, **flags))
                model.load_state_dict(weights)
                model = model.to(memory_format=torch.channels_last)
                path = str(tmp / f"{case}.pt2")
                serving.export_forward(path, model, SHAPE)
                assert model.training
                out[case] = (model, path)
            torch.save(_x(5), tmp / "x.pt")
        # Its standard input has ended: the interpreter loads while this
        # process does.
        for case, (model, path) in out.items():
            out[case] = (model, path, serving.load_forward(path))
        yield out, weights, (alone, tmp)
    finally:
        alone.kill()
        alone.communicate()


def _ops(module):
    """Operator nodes of the port's namespace, and aten convolutions, in
    a loaded artifact's graph."""
    ops, convs = {}, 0
    for node in module.graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        if name.startswith("simclr_tpu_torch."):
            key = name.split(".")[1]
            ops[key] = ops.get(key, 0) + 1
        convs += "conv" in name and name.startswith("aten.")
    return ops, convs


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_a_kernel_flag_artifact_equals_the_eager_forward(case,
                                                         kernel_artifacts):
    model, _, fn = kernel_artifacts[0][case]
    _, want_ops, replaced = KERNEL_CASES[case]
    ops, convs = _ops(fn)
    assert ops == want_ops and min(ops.values()) >= 1
    assert convs == N_CONV - replaced
    for seed in (0, 1):
        x = _x(seed)
        h, z = fn(x)
        want_h, want_z = _eager(model, x)
        assert h.shape == (4, 512) and z.shape == (4, 32)
        assert torch.equal(h, want_h) and torch.equal(z, want_z)


def test_kernel_flag_artifacts_agree_with_the_jax_artifact(
        kernel_artifacts, tmp_path):
    """The JAX package's ``load_forward(export_forward(...))`` of the same
    weights without the flags: XLA computes the convolutions that the
    port's artifacts run through the operators (their plain versions
    here). bf16 on both sides, each rounding in its own places: the bound
    of ``tests/test_torch_conv.py`` for a bf16 kernel path, 1e-2 in h and
    4e-2 in z in relative norm."""
    artifacts, weights, _ = kernel_artifacts
    params, stats = simclr_to_jax(weights)
    path = str(tmp_path / "jax_forward.bin")
    jserving.export_forward(path, JSimCLR(cfg=JModelConfig(**KERNEL_BASE)),
                            params, stats, SHAPE)
    x = _x(4)
    jh, jz = (np.asarray(t, np.float32)
              for t in jserving.load_forward(path)(x.numpy()))
    for case, (_, _, fn) in sorted(artifacts.items()):
        h, z = fn(x)
        err_h = np.linalg.norm(h.float().numpy() - jh) / np.linalg.norm(jh)
        err_z = np.linalg.norm(z.float().numpy() - jz) / np.linalg.norm(jz)
        assert err_h < 1e-2 and err_z < 4e-2, (case, err_h, err_z)


def test_kernel_flag_artifacts_load_with_only_the_op_registry(
        kernel_artifacts):
    """A fresh interpreter without the port's models, trainers and
    utilities loads the conv64 + winograd and the fused artifacts (all
    three operators) and gives the eager forward's outputs."""
    artifacts, _, (alone, tmp) = kernel_artifacts
    stdout, stderr = alone.communicate(timeout=120)
    assert alone.returncode == 0, stderr
    loaded = set(stdout.split())
    assert "simclr_tpu_torch.ops.kernels.registry" in loaded
    assert not {m for m in loaded if m.startswith(
        ("simclr_tpu_torch.models", "simclr_tpu_torch.train",
         "simclr_tpu_torch.utils", "simclr_tpu."))}
    x = torch.load(tmp / "x.pt")
    for case, (h, z) in zip(ALONE_CASES, torch.load(tmp / "out.pt")):
        want_h, want_z = _eager(artifacts[case][0], x)
        assert torch.equal(h, want_h) and torch.equal(z, want_z), case
