"""Training objectives: NT-Xent, the probabilistic contrastive variant and
MINE's Donsker-Varadhan bound.

Plain PyTorch counterparts of ``simclr_tpu/ops/losses.py``, and the plain
version that the NT-Xent kernel (``ops/kernels/ntxent.py``) is held against.
Similarities are computed in float32 whatever the embedding dtype, as the
JAX side asks with ``preferred_element_type=float32``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

VERY_LARGE_NUM = 1e9  # Diagonal mask value (reference: objective.py:21).


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross-entropy over integer labels; with per-class weights the
    mean is weighted by the label's class weight (sum(w_y*nll)/sum(w_y)),
    as torch.nn.CrossEntropyLoss(weight) does."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels[:, None].long())[:, 0]
    if weight is None:
        return nll.mean()
    w = weight[labels.long()]
    return (w * nll).sum() / w.sum()


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent (reference: objective.py:51-54)."""
    pred = logits.argmax(dim=-1)
    return 100.0 * (pred == labels).float().mean()


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) parity: divide by clamp(norm, min=eps)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)


def nt_xent_logits(
    z1: torch.Tensor,
    z2: torch.Tensor,
    temperature: float,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 2Nx2N logits ``[[ab, aa], [bb, ba]]`` and labels ``arange(2N)``,
    with the self-similarity diagonals of aa/bb masked to -1e9."""
    n = z1.shape[0]
    if normalize:
        z1 = l2_normalize(z1, dim=1)
        z2 = l2_normalize(z2, dim=1)
    z1, z2 = z1.float(), z2.float()
    inv_t = 1.0 / temperature
    mask = VERY_LARGE_NUM * torch.eye(n, dtype=torch.float32,
                                      device=z1.device)
    logits_aa = (z1 @ z1.T) * inv_t - mask
    logits_bb = (z2 @ z2.T) * inv_t - mask
    logits_ab = (z1 @ z2.T) * inv_t
    logits_ba = (z2 @ z1.T) * inv_t
    logits = torch.cat([torch.cat([logits_ab, logits_aa], dim=1),
                        torch.cat([logits_bb, logits_ba], dim=1)], dim=0)
    labels = torch.arange(2 * n, device=z1.device)
    return logits, labels


def nt_xent_loss(
    z1: torch.Tensor,
    z2: torch.Tensor,
    temperature: float = 1.0,
    normalize: bool = True,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NT-Xent loss and positive-pair top-1 accuracy in percent
    (reference: objective.py:6-55)."""
    logits, labels = nt_xent_logits(z1, z2, temperature, normalize)
    return cross_entropy(logits, labels, weight), top1_accuracy(
        logits, labels)


def softplus_beta(x: torch.Tensor, beta: float) -> torch.Tensor:
    """F.softplus(x, beta) with its threshold-20 linear tail, spelled out
    as the JAX side does."""
    scaled = beta * x
    return torch.where(scaled > 20.0, x, F.softplus(scaled) / beta)


def modified_contrastive_loss(
    x1: torch.Tensor,
    x2: torch.Tensor,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probabilistic contrastive loss (reference: objective.py:58-98):
    softplus(beta=0.8), L1 normalisation, logits log(clamp(x1 x2^T N,
    1e-4)) / T in both directions, CE against arange(N) twice."""
    n = x1.shape[0]
    x1 = softplus_beta(x1.float(), 0.8)
    x2 = softplus_beta(x2.float(), 0.8)
    x1 = x1 / x1.abs().sum(dim=1, keepdim=True).clamp_min(1e-12)
    x2 = x2 / x2.abs().sum(dim=1, keepdim=True).clamp_min(1e-12)
    logits_ab = (x1 @ x2.T * n).clamp_min(1e-4)
    logits_ba = (x2 @ x1.T * n).clamp_min(1e-4)
    log_logits = torch.cat(
        [torch.log(logits_ab), torch.log(logits_ba)], dim=0) / temperature
    idx = torch.arange(n, device=x1.device)
    labels = torch.cat([idx, idx])
    return cross_entropy(log_logits, labels), top1_accuracy(
        log_logits, labels)


def log_mean_exp(t: torch.Tensor) -> torch.Tensor:
    """log(mean(exp(t))) over every entry, via logsumexp: never
    overflows."""
    return torch.logsumexp(t.flatten(), dim=0) - math.log(t.numel())


def mine_loss(
    t_joint: torch.Tensor,
    t_marginal: torch.Tensor,
    last_log_ma: Optional[torch.Tensor],
    ma_rate: float = 1e-2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Donsker-Varadhan MI bound with an EMA-debiased gradient (reference:
    mine.py:97-109), in log space as on the JAX side: the moving average
    is carried as log(ma), updated by logaddexp(last + log1p(-r),
    log_mean_et + log r), and the debiased term is exp(log_mean_et -
    log_ma) with ``log_ma`` detached, whose gradient et_i / (N ma) is the
    reference's. ``t_*`` are (N, 1) statistics-network outputs; pass
    ``last_log_ma=None`` on the first step (log_ma = log_mean_et).

    Returns (surrogate loss, MI lower bound, new log-EMA state)."""
    log_mean_et = log_mean_exp(t_marginal)
    mean_t = t_joint.mean()
    mi_lower_bound = mean_t - log_mean_et
    if last_log_ma is None:
        log_ma = log_mean_et
    else:
        log_ma = torch.logaddexp(last_log_ma + math.log1p(-ma_rate),
                                 log_mean_et + math.log(ma_rate))
    debias = torch.exp(log_mean_et - log_ma.detach())
    loss = -(mean_t - debias)
    return loss, mi_lower_bound, log_ma
