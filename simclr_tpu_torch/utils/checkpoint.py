"""Checkpointing and model export.

Counterpart of ``simclr_tpu/utils/checkpoint.py``, in torch-native files:

  (a) resumable training checkpoints (reference: utils/model_utils.py:
      141-154): ``<ckpt_dir>/epoch_{epoch:05d}/state.pt`` holds the
      model's ``state_dict`` (buffers included), the optimizer's
      ``state_dict`` (with gradient accumulation, the accumulator and its
      micro-step count too: ``train/common.py:GradAccumulation``), the
      step count and the sampling generator's state;
      ``meta.json`` beside it holds ``epoch``, ``history`` and any extras
      and is written last, so a directory without it is no checkpoint;
  (b) an inference artifact (the analogue of the reference's TorchScript
      export, utils/model_utils.py:165-173): the model's ``state_dict`` on
      the CPU in one file, with the config JSON in ``path + ".json"``.

Both are read with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers only. The JAX package's exports (flax msgpack,
``.msgpack``) are read by ``load_jax_export`` through the port's own
decoder (``utils/msgpack.py``); ``load_pretrained`` takes either kind,
chosen by the file's suffix.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from simclr_tpu_torch.train.common import TrainState
from simclr_tpu_torch.utils import msgpack
from simclr_tpu_torch.utils.weights import simclr_from_jax

_STATE = "state.pt"
_META = "meta.json"


# ---------------------------------------------------------------------------
# (a) Resumable training checkpoints.
# ---------------------------------------------------------------------------

def save_checkpoint(
    ckpt_dir: str,
    epoch: int,
    state: TrainState,
    history: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
    generator: Optional[torch.Generator] = None,
) -> str:
    """Write the checkpoint for ``epoch``; returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch_{epoch:05d}"))
    os.makedirs(path, exist_ok=True)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    if generator is not None:
        payload["generator"] = generator.get_state()
    torch.save(payload, os.path.join(path, _STATE))
    meta = {"epoch": epoch, "history": history or {}, **(extra or {})}
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(
        e for e in os.listdir(ckpt_dir)
        if e.startswith("epoch_")
        and os.path.isfile(os.path.join(ckpt_dir, e, _META))
    )
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


def load_checkpoint(
    path: str, state: TrainState,
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore ``state`` (and ``generator``, where the checkpoint has its
    state) in place from a checkpoint; returns (state, meta).

    The parameters are copied into the model's own tensors. The optimizer
    keeps its ``capturable`` setting whatever the checkpoint's device was,
    so a CPU checkpoint resumes on a card and the other way round. Load
    before the engine captures its step: the optimizer's state tensors are
    new after the load."""
    payload = torch.load(os.path.join(path, _STATE), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    opt = payload["optimizer"]
    for saved, group in zip(opt["param_groups"],
                            state.optimizer.param_groups):
        saved["capturable"] = group["capturable"]
    state.optimizer.load_state_dict(opt)
    state.step = int(payload["step"])
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    return state, meta


# ---------------------------------------------------------------------------
# (b) Inference artifact.
# ---------------------------------------------------------------------------

def export_model(path: str,
                 model: "nn.Module | Mapping[str, torch.Tensor]",
                 config_json: str = "") -> None:
    """Write a model's ``state_dict`` (CPU tensors) to ``path`` and the
    config JSON to ``path + ".json"``."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    payload = {k: v.detach().cpu() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    with open(path + ".json", "w") as f:
        f.write(config_json or "{}")


def _config_beside(path: str) -> Dict[str, Any]:
    if not os.path.isfile(path + ".json"):
        return {}
    with open(path + ".json") as f:
        return json.load(f)


def load_exported_model(path: str
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (state_dict, config_dict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd, _config_beside(path)


def load_jax_export(path: str) -> Tuple[Dict[str, Any], Dict[str, Any],
                                        Dict[str, Any]]:
    """A JAX package export (``simclr_tpu/utils/checkpoint.py:
    export_model``, flax msgpack): returns (params, batch_stats,
    config_dict), the first two nested dicts of numpy arrays, as the JAX
    ``load_exported_model`` returns them."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    if not isinstance(payload, dict) or not {"params",
                                             "batch_stats"} <= set(payload):
        raise ValueError(f"{path}: not a JAX model export (no 'params' and "
                         "'batch_stats')")
    return payload["params"], payload["batch_stats"], _config_beside(path)


def load_pretrained(path: str
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, config_dict) of either export: a JAX ``.msgpack`` one
    through ``simclr_from_jax``, anything else as the port's ``.pt``."""
    if path.endswith(".msgpack"):
        params, stats, cfg = load_jax_export(path)
        return simclr_from_jax(params, stats), cfg
    return load_exported_model(path)
