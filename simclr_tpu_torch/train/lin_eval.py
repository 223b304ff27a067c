"""Linear evaluation: frozen-feature extraction and a full-batch L-BFGS
linear head.

Counterpart of ``simclr_tpu/train/lin_eval.py`` (reference
utils/model_utils.py:176-297): extract the 2048-d encoder features h over
the un-augmented train split, fit Linear(2048 -> 10) with L-BFGS and an L2
penalty ``reg * ||W||^2`` on the weight matrix only, and report CE and
top-1 on the test features.

The whole feature matrix (40,000 x 2,048 float32, 328 MB, for the CIFAR-10
train split) stays on the device, and each L-BFGS iteration evaluates the
full-batch objective and its gradient there. The optimizer is
``torch.optim.LBFGS`` with the reference's settings (memory 10, strong-Wolfe
line search, ``max_iter`` iterations a ``step()``, ``n_steps`` steps with
persistent state; model_utils.py:272-295). The JAX side runs optax's L-BFGS
with its zoom line search for ``n_steps * max_iter`` iterations; the parity
target is the fitted objective and the final top-1, not the line search's
internals.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from simclr_tpu_torch.config import Config
from simclr_tpu_torch.data.pipeline import DeviceDataset
from simclr_tpu_torch.ops.augment import augment_test
from simclr_tpu_torch.ops.losses import cross_entropy, top1_accuracy


@torch.no_grad()
def extract_features(
    model: torch.nn.Module,
    ds: DeviceDataset,
    cfg: Config,
    batch_size: int = 512,
    use_hidden_feat: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode forward of a ``SimCLR`` over the un-augmented, normalised
    images (``augment_test``), collecting h (or z) and the labels
    (reference: model_utils.py:176-200). Batches run in order and the last
    may be ragged: eval-mode BN is per sample, so this equals the JAX
    side's padded tail. A model with MC dropout draws its masks from
    ``generator``, by default one seeded 0 on the dataset's device, as the
    JAX side defaults to ``key(0)``. Returns float32 features (N, D) and
    the labels, on the dataset's device."""
    if generator is None:
        generator = torch.Generator(
            device=ds.images.device).manual_seed(0)
    training = model.training
    model.eval()
    try:
        feats = []
        for start in range(0, ds.n, batch_size):
            x = augment_test(ds.images[start:start + batch_size],
                             cfg.dataset)
            h, z = model(x.permute(0, 3, 1, 2), generator)
            feats.append(h if use_hidden_feat else z)
    finally:
        model.train(training)
    return torch.cat(feats).float(), ds.labels


@dataclasses.dataclass
class LinearClassifier:
    w: torch.Tensor  # (D, C)
    b: torch.Tensor  # (C,)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


@contextlib.contextmanager
def _true_float32() -> Iterator[None]:
    """float32 products without TF32 on a CUDA device: TF32's 10-bit
    mantissa would change the fitted head."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def train_linear_classifier(
    features: torch.Tensor,
    targets: torch.Tensor,
    reg_weight: float = 1e-3,
    n_steps: int = 100,
    max_iter: int = 20,
    n_class: int = 10,
    log: Callable[[str], None] = print,
) -> Tuple[LinearClassifier, np.ndarray]:
    """Fit ``x @ w + b`` from zeros in float32 to CE + ``reg_weight *
    sum(w**2)`` by L-BFGS (reference: model_utils.py:242-297):
    ``n_steps`` calls of ``LBFGS(max_iter=max_iter).step`` with persistent
    state, at most ``n_steps * max_iter`` iterations. The tolerances are
    set so that it stops early only where float32 can see no more
    progress: a gradient of exactly zero, or a step or loss change below
    1e-12.

    Returns the classifier and the objective trace, ``n_steps + 1``
    entries: entry 0 the objective at zero (ln C), entry s the objective
    after step s (the last is the final objective)."""
    dev = features.device
    x = features.float()
    y = targets.long()
    w = torch.zeros((x.shape[1], n_class), device=dev, requires_grad=True)
    b = torch.zeros((n_class,), device=dev, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=max_iter,
                            history_size=10, line_search_fn="strong_wolfe",
                            tolerance_grad=0.0, tolerance_change=1e-12)

    def objective() -> torch.Tensor:
        return cross_entropy(x @ w + b, y) + reg_weight * (w * w).sum()

    def closure() -> torch.Tensor:
        opt.zero_grad()
        loss = objective()
        loss.backward()
        return loss.detach()

    with _true_float32():
        # step() returns the objective where it starts: at zero, then
        # after each earlier step.
        values = [float(opt.step(closure)) for _ in range(n_steps)]
        with torch.no_grad():
            values.append(float(objective()))
    n_iter = opt.state[w].get("n_iter", 0)
    log(f"lin-eval L-BFGS: loss {values[0]:.4f} -> {values[-1]:.4f} "
        f"({n_iter} iterations)")
    return (LinearClassifier(w.detach(), b.detach()),
            np.asarray(values, np.float64))


@torch.no_grad()
def evaluate_linear(clf: LinearClassifier, features: torch.Tensor,
                    targets: torch.Tensor) -> Tuple[float, float]:
    """CE loss and top-1 accuracy % (reference: model_utils.py:203-239)."""
    with _true_float32():
        logits = clf(features.float())
    return (float(cross_entropy(logits, targets)),
            float(top1_accuracy(logits, targets)))


def linear_evaluation(
    model: torch.nn.Module,
    train_ds: DeviceDataset,
    test_ds: DeviceDataset,
    cfg: Config,
    log: Callable[[str], None] = print,
) -> Tuple[float, float]:
    """End-to-end linear evaluation of a ``SimCLR``'s encoder; returns
    (test loss, test top-1 %)."""
    feats, targs = extract_features(model, train_ds, cfg)
    clf, _ = train_linear_classifier(
        feats, targs,
        reg_weight=cfg.optim.reg_wt_lin_eval,
        n_steps=cfg.train.n_epoch_lin_eval,
        max_iter=cfg.optim.lbfgs_max_iter,
        n_class=cfg.dataset.num_classes,
        log=log,
    )
    test_feats, test_targs = extract_features(model, test_ds, cfg)
    loss, acc = evaluate_linear(clf, test_feats, test_targs)
    log(f"Test Loss: {loss:.4f} | Test Top 1 Accuracy: {acc:.4f}%")
    return loss, acc
