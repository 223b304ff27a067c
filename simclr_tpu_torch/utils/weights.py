"""Weight interchange with the JAX package.

``simclr_from_jax`` turns the JAX ``SimCLR``'s nested ``params`` and
``batch_stats`` dicts of arrays into the port's ``state_dict``;
``simclr_to_jax`` goes back. The port names its modules after the JAX
tree (``f.layer1_0.conv1`` is ``params['f']['layer1_0']['conv1']``), so
only the leaves change:

  * conv ``kernel`` (kh, kw, I, O)  <-> ``weight`` (O, I, kh, kw)
  * dense ``kernel`` (in, out)      <-> ``weight`` (out, in)
  * BN ``scale`` / ``bias``         <-> ``weight`` / ``bias``
  * BN ``mean`` / ``var`` (batch_stats) <-> ``running_mean`` / ``running_var``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value, np.float32)


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


def _kernel_to_jax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def simclr_from_jax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` -> port ``state_dict`` (CPU float32)."""
    sd = {}
    for path, value in _leaves(params):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            sd[f"{module}.weight"] = _kernel_to_torch(value)
        elif leaf == "scale":
            sd[f"{module}.weight"] = value
        elif leaf == "bias":
            sd[f"{module}.bias"] = value
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
    for path, value in _leaves(batch_stats):
        sd[".".join(path[:-1]) + "." + _STATS[path[-1]]] = value
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def _set(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def simclr_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Port ``state_dict`` -> JAX ``(params, batch_stats)`` of numpy
    float32 arrays. A 1-D ``weight`` is a BN scale; 2-D and 4-D weights are
    dense and conv kernels."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *module, leaf = name.split(".")
        value = tensor.detach().cpu().to(torch.float32).numpy()
        if leaf in _STATS_BACK:
            _set(batch_stats, module + [_STATS_BACK[leaf]], value.copy())
        elif leaf == "weight":
            if value.ndim == 1:
                _set(params, module + ["scale"], value.copy())
            else:
                _set(params, module + ["kernel"],
                     np.ascontiguousarray(_kernel_to_jax(value)))
        elif leaf == "bias":
            _set(params, module + ["bias"], value.copy())
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
    return params, batch_stats
