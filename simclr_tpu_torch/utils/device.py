"""Device resolution shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise for a CUDA device when
    no GPU is present instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev
