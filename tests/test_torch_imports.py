"""The port never imports JAX or the JAX package: every module of
``simclr_tpu_torch`` imports in a fresh interpreter in which ``jax``,
``flax``, ``optax``, ``orbax``, ``msgpack`` and ``simclr_tpu`` cannot be
imported (and, here, with no CUDA). The port's C++ data plane is its own
file, not a path into the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import simclr_tpu_torch

BLOCKED = ("jax", "flax", "optax", "orbax", "msgpack", "simclr_tpu")

_SCRIPT = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None
for name in {modules!r}:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print(len({modules!r}))
"""


def _modules():
    pkg = simclr_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    modules = _modules()
    assert "simclr_tpu_torch.ops.kernels.bn_relu" in modules
    assert "simclr_tpu_torch.ops.subset_bn" in modules
    assert "simclr_tpu_torch.ops.kernels.conv64" in modules
    assert "simclr_tpu_torch.ops.kernels.winograd" in modules
    assert "simclr_tpu_torch.ops.kernels.bottleneck" in modules
    for name in ("utils.checkpoint", "utils.profiling",
                 "utils.visualizations", "scripts.pretrain",
                 "train.pretrain", "data.pipeline", "utils.msgpack",
                 "train.lin_eval", "train.ssl", "scripts.lin_eval",
                 "scripts.train_ssl", "models.mine", "train.supervised",
                 "train.mine", "scripts.train_supervised",
                 "scripts.train_mine", "ops.foldconv", "ops.subset_wgrad",
                 "data.native", "train.streaming", "parallel.mesh",
                 "parallel.explicit", "parallel.launch", "entry",
                 "utils.metrics", "utils.serving", "scripts.analysis",
                 "scripts.stl10_artifact", "scripts.parity_run",
                 "scripts.merge_parity", "scripts.temp_sweep",
                 "scripts.batch_sweep", "scripts.bench_variants",
                 "scripts.profile_step", "scripts.bn_relu_microbench",
                 "scripts.bench_winograd", "_lazy"):
        assert f"simclr_tpu_torch.{name}" in modules
    root = Path(simclr_tpu_torch.__file__).resolve().parents[1]
    result = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(blocked=BLOCKED,
                                              modules=modules)],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.split()[-1] == str(len(modules))


def test_the_data_plane_source_is_the_ports_own_file():
    from simclr_tpu_torch.data import native

    root = Path(simclr_tpu_torch.__file__).resolve().parents[1]
    src = native.SRC
    assert src.is_file() and not src.is_symlink()
    assert src.resolve().parent == root / "simclr_tpu_torch/data/native"
    assert "simclr_tpu/" not in str(src.resolve().relative_to(root))
    jax_src = root / "simclr_tpu/data/native/dataplane.cpp"
    assert not src.samefile(jax_src)
    # Nothing is built beside the source.
    assert native.BUILD_DIR == root / "simclr_tpu_torch/_build"
