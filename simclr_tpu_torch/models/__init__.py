"""SimCLR model: ResNet encoder, projection head, subset-statistics BN."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "resnet": ("Bottleneck", "ResNetEncoder", "SupervisedResNet"),
    "simclr": ("ProjectionHead", "SimCLR", "SimCLRFineTune"),
    "mine": ("MineNet",),
})
