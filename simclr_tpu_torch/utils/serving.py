"""A serialised serving artifact of the eval forward, on ``torch.export``.

Counterpart of ``simclr_tpu/utils/serving.py`` (reference: the traced
TorchScript module of utils/model_utils.py:165-173). ``export_forward``
writes the eval-mode forward with its weights baked in as a
``torch.export`` program (``.pt2``); ``load_forward`` reads it back as a
callable that needs no Python model class: NHWC float32 images in, the
model's output (``(h, z)`` for a ``SimCLR``) out, as the JAX artifact.

* **MC dropout.** JAX bakes one dropout key into its artifact. Here the
  masks that a generator seeded with ``dropout_seed`` draws for
  ``input_shape`` are baked in (``models/resnet.py:MCDropout.baked``), so
  the artifact is deterministic and equals the eager forward given that
  generator.
* **Kernel flags.** Under ``conv64_pallas``, ``winograd_conv2`` (alone or
  together) and ``fuse_identity_blocks`` the eval forward runs kernels
  B4f, B5f and B6f, which are PyTorch operators
  (``ops/kernels/registry.py``): the artifact holds one node of each per
  launch, and the weight transforms before them (B5f's filter transform,
  B6f's packing) as graph nodes over the baked weights. Loading such an
  artifact needs the operators registered: ``load_forward`` imports the
  registry, which needs no model class and no CUDA. On the card the
  loaded artifact launches the kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
import torch.nn as nn

from simclr_tpu_torch.models.resnet import MCDropout
# Registers the operators that a kernel-flag artifact holds.
from simclr_tpu_torch.ops.kernels import registry  # noqa: F401


class _NHWCForward(nn.Module):
    """The model's eval forward on NHWC images (its NCHW input in
    channels_last memory is the same bytes)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        return self.model(x.permute(0, 3, 1, 2), None)


@torch.no_grad()
def _first_forward(model: nn.Module, drops: Sequence[MCDropout],
                   input_shape: Sequence[int], device: torch.device,
                   dropout_seed: int) -> None:
    """One real eval forward at ``input_shape`` before the trace. It
    builds what the kernel wrappers build lazily (index and constant
    tensors, which the trace then holds as constants; on the card the
    kernel library), and it draws every MC-dropout mask from a generator
    seeded ``dropout_seed`` and fixes them in ``baked``."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    x = torch.zeros(tuple(input_shape), device=device)
    for m in drops:
        m.record, m.mask = True, None
    model(x.permute(0, 3, 1, 2), gen)
    for m in drops:
        # Rates 0 and 1 draw nothing; any mask marks the module baked.
        m.baked = (m.mask if m.mask is not None
                   else torch.ones((), dtype=torch.bool, device=device))
        m.record, m.mask = False, None


def export_forward(
    path: str,
    model: nn.Module,
    input_shape: Sequence[int],
    dropout_seed: int = 0,
) -> None:
    """Serialise ``model``'s eval-mode forward, weights baked in, for
    float32 NHWC inputs of ``input_shape`` on the model's device, to
    ``path``. The model is left as it was (training flag, no baked
    masks)."""
    device = next(model.parameters()).device
    drops = [m for m in model.modules() if isinstance(m, MCDropout)]
    training = model.training
    model.eval()
    try:
        _first_forward(model, drops, input_shape, device, dropout_seed)
        x = torch.zeros(tuple(input_shape), device=device)
        program = torch.export.export(_NHWCForward(model), (x,),
                                      strict=False)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.export.save(program, path)
    finally:
        for m in drops:
            m.baked = None
        model.train(training)


def load_forward(path: str) -> Callable:
    """Read an artifact of ``export_forward``; returns a module mapping
    NHWC float32 images to the model's output, on the device it was
    exported from, its weights frozen (no autograd). No model class is
    needed to load it; an artifact of a kernel flag needs the operators of
    ``ops/kernels/registry.py``, which this module imports."""
    return torch.export.load(path).module().requires_grad_(False)
