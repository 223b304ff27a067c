"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled to an object file by its own ``nvcc``, all
started together, and the objects are linked into one shared library with a
plain C interface. The sources include only the CUDA runtime's headers, not
PyTorch's, which keeps a build to seconds. The library goes to
``simclr_tpu_torch/_build/<hash of sources and flags>/`` at first use and is
reused while the sources do not change. Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libsimclr_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p so that 64-bit addresses are not cut to int).
SIGNATURES = {
    "ntxent_max_dim": (),
    "ntxent_geometry": (_I, _I, _I, _P),
    "ntxent_max_active_clusters": (_I, _I),
    "ntxent_fwd": (_P, _P, _P, _P, _I, _I, _F, _P),
    "ntxent_bwd": (_P, _P, _P, _P, _I, _I, _F, _P),
    "color_max_hw": (),
    "color_geometry": (_I, _I, _P),
    "color_distort": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    "bn_bwd_row_blocks": (_I, _I),
    "bn_bwd_relu": (_P,) * 6 + (_I, _I, _I, _P),
    "bn_bwd_add_relu": (_P,) * 10 + (_I, _I, _I, _P),
    "bn_bwd_norelu": (_P,) * 8 + (_I, _I, _I, _P),
    "conv64_geometry": (_I,) * 4 + (_P,),
    "conv64_fwd": (_P, _P, _P, _I, _I, _I, _P),
    "conv64_wgrad": (_P,) * 4 + (_I, _I, _I, _P),
    "winograd_geometry": (_I,) * 4 + (_P,),
    "winograd_dw_ranges": (_I,) * 5,
    "winograd_fwd": (_P, _P, _P) + (_I,) * 5 + (_P,),
    "winograd_dw": (_P,) * 4 + (_I,) * 5 + (_P,),
    "bottleneck_geometry": (_I,) * 4 + (_P,),
    "bottleneck_bwd_workspace": (_I,) * 4,
    "bottleneck_fwd": (_P,) * 4 + (_I,) * 4 + (_P,),
    "bottleneck_bwd": (_P,) * 11 + (_I,) * 4 + (_P,),
}
# Entry points that return something other than a CUDA error code.
RESTYPES = {"bottleneck_bwd_workspace": ctypes.c_longlong}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path(flags: tuple = NVCC_FLAGS) -> Path:
    """Where the library for the current sources and these nvcc flags
    lives (built or not)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build(extra_flags: tuple = ()) -> Path:
    """Compile the sources if their library is not built yet; return its
    path. The compiler's output (register and shared-memory use per
    kernel) is kept beside it as ``build.log``. ``extra_flags`` (e.g. a
    -D of an instrumented build) give a library of their own."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    lib = library_path(flags)
    if lib.is_file():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [src for src in _sources() if src.suffix == ".cu"]
        objs = [Path(tmp) / (src.stem + ".o") for src in units]
        procs = [subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(units, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log
                  in zip(units, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(Path(tmp) / LIB_NAME),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        lib.parent.mkdir(parents=True, exist_ok=True)
        (lib.parent / "build.log").write_text("".join(logs) + link.stdout)
        os.replace(Path(tmp) / LIB_NAME, lib)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """A built library with its entry points' argument types set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return load(build())


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")
