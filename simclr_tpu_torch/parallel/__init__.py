"""Data parallelism on torch.distributed (counterpart of
``simclr_tpu/parallel``): ``mesh`` (the process group, batch sharding,
replication) and ``explicit`` (the hand-placed-collective train step)."""
