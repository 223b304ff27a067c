"""Representation similarity metrics.

Counterpart of ``simclr_tpu/utils/metrics.py`` (reference
utils/metrics.py:11-272): normalised Euclidean distance, normalised
squared Euclidean distance, correlation coefficient, cosine similarity
over positive pairs and shuffled-batch negatives, the bucketize helper,
per-row normalised mutual information, and the model-comparison loops
(contrastive against supervised features; original against flipped
representations).

A *feature function* maps NHWC float32 images and a ``torch.Generator``
(which draws MC-dropout masks, where the model has them) to features:
``contrastive_feature_fn`` and ``supervised_feature_fn`` build one from a
``SimCLR`` and a ``SupervisedResNet``, as ``train/lin_eval.py:
extract_features`` runs its model (eval mode, no autograd, the training
flag restored). The JAX side's feature functions take ``(variables, x,
key)`` and come with their variables; here the weights live in the
module.

The batch math runs on the features' device. The loops draw each
batch's two views through ``augment_train_pair`` (kernel B2 twice a batch
on a CUDA device) and the negatives' permutation from the same
generator, and collect the metrics on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import DeviceDataset, iterate_sequential
from simclr_tpu_torch.ops.augment import augment_test, augment_train_pair
from simclr_tpu_torch.ops.losses import l2_normalize

FeatureFn = Callable[[torch.Tensor, Optional[torch.Generator]],
                     torch.Tensor]


def calc_ned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalised Euclidean distance after unit-norm scaling (reference:
    metrics.py:11-26)."""
    a = l2_normalize(a, dim=1)
    b = l2_normalize(b, dim=1)
    return torch.sqrt(torch.mean((a - b) ** 2, dim=1))


def calc_nsed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalised squared Euclidean distance (reference: metrics.py:29-39):
    the centred SED over the sum of the centred squared norms."""
    va = a - a.mean(dim=1, keepdim=True)
    vb = b - b.mean(dim=1, keepdim=True)
    sed = torch.sum((va - vb) ** 2, dim=1)
    denom = (torch.linalg.vector_norm(va, dim=1) ** 2
             + torch.linalg.vector_norm(vb, dim=1) ** 2)
    return sed / denom


def calc_corrcoeff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row correlation coefficient (reference: metrics.py:42-55)."""
    va = a - a.mean(dim=1, keepdim=True)
    vb = b - b.mean(dim=1, keepdim=True)
    return torch.sum(va * vb, dim=1) / torch.sqrt(
        torch.sum(va ** 2, dim=1) * torch.sum(vb ** 2, dim=1))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Per-row cosine with each norm clamped on its own,
    ``sum(a b) / (max(|a|, eps) max(|b|, eps))`` (reference:
    metrics.py:95, ``nn.CosineSimilarity(dim=1)``): a row of zeros gives
    0."""
    na = torch.linalg.vector_norm(a, dim=1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=1).clamp_min(eps)
    return torch.sum(a * b, dim=1) / (na * nb)


def bucketize_feature_values(feat: torch.Tensor) -> torch.Tensor:
    """Bucket feature values into ``D // 2`` buckets spanning the tensor's
    own range (reference: metrics.py:58-73): the boundaries by JAX's
    ``linspace`` formula, ``lo (1 - i/m) + hi (i/m)`` with the last one
    ``hi``, and each value's index by a left-side search. Returns int32
    indices with a leading axis of 1, as the JAX side's ``[None]``."""
    m = feat.shape[-1] // 2
    lo, hi = feat.min(), feat.max()
    t = torch.arange(m, dtype=feat.dtype, device=feat.device) / m
    bdr = torch.cat([lo * (1 - t) + hi * t, hi[None]])
    return torch.searchsorted(bdr, feat.contiguous()).to(torch.int32)[None]


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -torch.where(p > 0, p * torch.log(p),
                        torch.zeros_like(p)).sum(dim=-1)


def calc_nmi(a: torch.Tensor, b: torch.Tensor,
             n_buckets: int = 16) -> torch.Tensor:
    """Per-row normalised mutual information between bucketed feature
    vectors, ``I(A;B) / sqrt(H(A) H(B))``. Each row is bucketed over its
    own range (truncated toward zero, then clipped), and the joint
    histogram over the feature axis is the float32 product of the two
    one-hot tensors, (N, K, D) x (N, D, K)."""
    def one_hot(x):
        lo = x.min(dim=1, keepdim=True).values
        hi = x.max(dim=1, keepdim=True).values
        t = (x - lo) / (hi - lo).clamp_min(1e-12)
        idx = (t * n_buckets).to(torch.int32).clamp(0, n_buckets - 1)
        return F.one_hot(idx.long(), n_buckets).to(torch.float32)

    d = a.shape[1]
    joint = torch.bmm(one_hot(a).transpose(1, 2), one_hot(b)) / d
    pa = joint.sum(dim=2)
    pb = joint.sum(dim=1)
    outer = pa[:, :, None] * pb[:, None, :]
    mi = torch.where(
        joint > 0,
        joint * (torch.log(joint.clamp_min(1e-12))
                 - torch.log(outer.clamp_min(1e-12))),
        torch.zeros_like(joint)).sum(dim=(1, 2))
    return mi / torch.sqrt(_entropy(pa) * _entropy(pb)).clamp_min(1e-12)


_METRIC_KEYS = ("pos_ned", "pos_cc", "pos_cos",
                "neg_ned", "neg_cc", "neg_cos",
                "pos_nmi", "neg_nmi")


def _pairwise_metrics(feat: torch.Tensor, feat_pos: torch.Tensor,
                      perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One batch of positive and negative similarity statistics; the
    negatives are the positive batch shuffled by ``perm`` (reference:
    metrics.py:116). ``*_ned`` is the normalised squared distance, as on
    the JAX side."""
    feat = feat.reshape(feat.shape[0], -1)
    feat_pos = feat_pos.reshape(feat_pos.shape[0], -1)
    feat_neg = feat_pos[perm]
    return {
        "pos_ned": calc_nsed(feat, feat_pos),
        "neg_ned": calc_nsed(feat, feat_neg),
        "pos_cc": calc_corrcoeff(feat, feat_pos),
        "neg_cc": calc_corrcoeff(feat, feat_neg),
        "pos_cos": cosine_similarity(feat, feat_pos),
        "neg_cos": cosine_similarity(feat, feat_neg),
        "pos_nmi": calc_nmi(feat, feat_pos),
        "neg_nmi": calc_nmi(feat, feat_neg),
    }


def _default_generator(ds: DeviceDataset,
                        generator: Optional[torch.Generator]
                        ) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=ds.images.device).manual_seed(0)


@torch.no_grad()
def get_similarity_metrics(
    feature_fn: FeatureFn,
    ds: DeviceDataset,
    cfg: Config,
    batch_size: int = 256,
    generator: Optional[torch.Generator] = None,
    n_batches: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Similarity-metric distributions over augmented pairs of ``ds``'s
    batches in order (reference: metrics.py:76-129, 132-176). Each batch:
    two views by ``augment_train_pair``, the features of each (masks, if
    any, from ``generator``), then the negatives' permutation, all drawn
    from ``generator`` (by default one seeded 0 on the dataset's device).
    Stops at a ragged last batch and after ``n_batches``. Returns
    {metric: float array over the rows}."""
    gen = _default_generator(ds, generator)
    out = {k: [] for k in _METRIC_KEYS}
    for i, (images, _) in enumerate(iterate_sequential(ds, batch_size)):
        if images.shape[0] < batch_size:
            break
        if n_batches is not None and i >= n_batches:
            break
        v1, v2 = augment_train_pair(gen, images, cfg.augment, cfg.dataset)
        feat = feature_fn(v1, gen)
        feat_pos = feature_fn(v2, gen)
        perm = torch.randperm(images.shape[0], generator=gen,
                              device=gen.device)
        m = _pairwise_metrics(feat, feat_pos, perm)
        for k in _METRIC_KEYS:
            out[k].append(m[k].float().cpu().numpy())
    return {k: (np.concatenate(v) if v else np.zeros(0, np.float32))
            for k, v in out.items()}


def _feature_fn(model: torch.nn.Module,
                pick: Callable[[object], torch.Tensor]) -> FeatureFn:
    @torch.no_grad()
    def fn(x: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        training = model.training
        model.eval()
        try:
            return pick(model(x.permute(0, 3, 1, 2), generator))
        finally:
            model.train(training)

    return fn


def contrastive_feature_fn(model: torch.nn.Module,
                           use_hidden_feat: bool = True) -> FeatureFn:
    """A ``SimCLR``'s h (or z) features of NHWC images (reference:
    metrics.py:105-110)."""
    return _feature_fn(model, lambda out: out[0] if use_hidden_feat
                       else out[1])


def supervised_feature_fn(model: torch.nn.Module) -> FeatureFn:
    """A ``SupervisedResNet``'s output (logits) of NHWC images (reference:
    metrics.py:157-160)."""
    return _feature_fn(model, lambda out: out)


def get_similarity_metrics_pairs(
    contrastive_fn: FeatureFn, supervised_fn: FeatureFn,
    ds: DeviceDataset, cfg: Config, **kw
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Both models on the same data (reference: metrics.py:179-210); each
    run draws from its own generator seeded alike unless one is given."""
    return (get_similarity_metrics(contrastive_fn, ds, cfg, **kw),
            get_similarity_metrics(supervised_fn, ds, cfg, **kw))


@torch.no_grad()
def get_representation_analogy(
    feature_fn1: FeatureFn,
    feature_fn2: FeatureFn,
    ds: DeviceDataset,
    cfg: Config,
    batch_size: int = 256,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, float]:
    """Mean L1 and mean squared distance between the representations of
    the first ``batch_size`` test views and of the same views flipped
    along the width axis (reference: metrics.py:229-272,
    ``RandomHorizontalFlip(p=1)``), for two models. The views are NHWC,
    so the flip is ``flip(2)``."""
    gen = _default_generator(ds, generator)
    orig = augment_test(ds.images[:batch_size], cfg.dataset)
    flipped = orig.flip(2)
    out = {}
    for name, fn in (("model1", feature_fn1), ("model2", feature_fn2)):
        r_orig = fn(orig, gen)
        r_aug = fn(flipped, gen)
        out[f"{name}_l1"] = float(torch.mean(torch.abs(r_orig - r_aug)))
        out[f"{name}_l2"] = float(torch.mean((r_orig - r_aug) ** 2))
    return out
