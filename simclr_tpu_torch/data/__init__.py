"""Dataset decoding and the device-resident pipeline."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "datasets": (
        "load_cifar10", "load_dataset", "load_stl10", "synthetic_dataset",
    ),
    "pipeline": (
        "DeviceDataset", "Split", "class_weights", "epoch_permutation",
        "host_stream", "infinite_stream", "iterate_epoch",
        "iterate_sequential", "make_split", "split_indices", "take_batch",
        "weighted_sample_indices",
    ),
})
