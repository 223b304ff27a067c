"""Device selection and weight interchange with the JAX package."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "checkpoint": (
        "export_model", "latest_checkpoint", "load_checkpoint",
        "load_exported_model", "save_checkpoint",
    ),
    "profiling": (
        "MetricsLogger", "StepTimer", "annotate", "block_on", "read_metrics",
        "trace",
    ),
})
