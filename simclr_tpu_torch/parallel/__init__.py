"""Data parallelism on torch.distributed (counterpart of
``simclr_tpu/parallel``): ``mesh`` (the process group, batch sharding,
replication) and ``explicit`` (the hand-placed-collective train step)."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "mesh": (
        "DATA_AXIS", "batch_sharding", "make_mesh", "put_replicated",
        "replicated", "shard_batch",
    ),
})
