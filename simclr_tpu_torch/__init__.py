"""PyTorch/CUDA port of ``simclr_tpu`` for one NVIDIA H100.

Same sub-layout as the JAX package: ``config``, ``data/``, ``ops/`` (with
hand-written Hopper kernels under ``ops/kernels/`` and their CUDA sources in
``csrc/``), ``models/``, ``train/``, ``utils/``. Imports ``torch`` only.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from simclr_tpu_torch.config import (
    AugmentConfig,
    Config,
    DatasetConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    dataset_config,
)

__all__ = [
    "AugmentConfig",
    "Config",
    "DatasetConfig",
    "ModelConfig",
    "OptimConfig",
    "TrainConfig",
    "dataset_config",
    "__version__",
]
