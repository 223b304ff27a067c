"""Losses, augmentation and the hand-written kernels."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "losses": (
        "cross_entropy", "mine_loss", "modified_contrastive_loss",
        "nt_xent_logits", "nt_xent_loss", "top1_accuracy",
    ),
})
