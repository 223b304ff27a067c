"""Visualisation suite: KDE comparisons, t-SNE embeddings, loss/accuracy
curves, gradient-flow bars, image helpers.

Counterpart of ``simclr_tpu/utils/visualizations.py`` (reference:
visualizations.py:11-276). Matplotlib, seaborn and scikit-learn are
imported inside the functions, so training never pays for them and runs
where they are missing (``pretrain(save_plots=False)``). Every function
that draws accepts a save path and returns the figure; a saved figure is
closed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def plotting_available() -> bool:
    """Whether matplotlib, seaborn and scikit-learn can be imported (the
    command-line tools draw their figures only then)."""
    import importlib.util

    return all(importlib.util.find_spec(name) is not None
               for name in ("matplotlib", "seaborn", "sklearn"))


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, save_path: Optional[str]):
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                    exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
        _plt().close(fig)
    return fig


def kde_multi_plot(
    metrics_list: Sequence[Dict[str, np.ndarray]],
    metric_key: str,
    labels: Sequence[str],
    title: str = "",
    save_path: Optional[str] = None,
):
    """KDE of a similarity metric for N models, positive pairs beside
    negative ones: the reference's three-way overlay of contrastive h,
    contrastive z and the supervised baseline (reference:
    visualizations.py:11-47, examples/{ned,cc,cos,nmi}_comp.png)."""
    plt = _plt()
    import seaborn as sns

    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    for ax, which in zip(axes, ("pos", "neg")):
        key = f"{which}_{metric_key}"
        for metrics, label in zip(metrics_list, labels):
            sns.kdeplot(metrics[key], ax=ax, label=label, fill=True,
                        alpha=0.4)
        ax.set_title(f"{which} pairs")
        ax.set_xlabel(metric_key)
        ax.legend()
    fig.suptitle(title or f"{metric_key} comparison")
    return _save(fig, save_path)


def kde_comparison_plot(
    metrics_a: Dict[str, np.ndarray],
    metrics_b: Dict[str, np.ndarray],
    metric_key: str,
    labels: Tuple[str, str] = ("contrastive", "supervised"),
    title: str = "",
    save_path: Optional[str] = None,
):
    """Two-model KDE comparison (reference: visualizations.py:11-47)."""
    return kde_multi_plot([metrics_a, metrics_b], metric_key, labels,
                          title=title, save_path=save_path)


def kde_single_model_plot(
    metrics: Dict[str, np.ndarray],
    metric_key: str,
    title: str = "",
    save_path: Optional[str] = None,
):
    """Positive-against-negative KDE for one model (reference:
    visualizations.py:50-87)."""
    plt = _plt()
    import seaborn as sns

    fig, ax = plt.subplots(figsize=(6, 4))
    sns.kdeplot(metrics[f"pos_{metric_key}"], ax=ax, label="positive",
                fill=True, alpha=0.4)
    sns.kdeplot(metrics[f"neg_{metric_key}"], ax=ax, label="negative",
                fill=True, alpha=0.4)
    ax.set_xlabel(metric_key)
    ax.legend()
    fig.suptitle(title or metric_key)
    return _save(fig, save_path)


def tsne_plot(
    features: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    title: str = "t-SNE",
    max_points: int = 5000,
    perplexity: float = 30.0,
    seed: int = 0,
    save_path: Optional[str] = None,
):
    """t-SNE of representations coloured by class (reference:
    visualizations.py:90-202, sklearn ``TSNE(init='pca')``) over at most
    ``max_points`` rows drawn without replacement from ``seed``."""
    plt = _plt()
    from sklearn.manifold import TSNE

    n = min(features.shape[0], max_points)
    rng = np.random.RandomState(seed)
    sel = rng.choice(features.shape[0], size=n, replace=False)
    feats = np.asarray(features)[sel].reshape(n, -1)
    labs = np.asarray(labels)[sel]

    emb = TSNE(n_components=2, init="pca",
               perplexity=min(perplexity, max(n - 2, 1) / 3),
               random_state=seed).fit_transform(feats)
    fig, ax = plt.subplots(figsize=(7, 6))
    cmap = plt.get_cmap("tab10")
    for i, c in enumerate(np.unique(labs)):
        mask = labs == c
        name = class_names[c] if class_names is not None else str(c)
        ax.scatter(emb[mask, 0], emb[mask, 1], s=4,
                   color=cmap(i % 10), label=name)
    ax.legend(markerscale=3, fontsize=8)
    ax.set_title(title)
    return _save(fig, save_path)


def plot_loss_acc(
    loss: Sequence[float],
    accuracy: Sequence[float],
    title: str = "loss_acc",
    save_plot: bool = False,
    save_dir: str = "results",
):
    """Twin-axis loss/accuracy curves over epochs (reference:
    visualizations.py:222-242); with ``save_plot`` the figure goes to
    ``<save_dir>/<title>.png`` and is closed. Returns the figure."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(loss, color="tab:red", label="loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss", color="tab:red")
    ax2 = ax1.twinx()
    ax2.plot(accuracy, color="tab:blue", label="accuracy")
    ax2.set_ylabel("accuracy (%)", color="tab:blue")
    fig.suptitle(title)
    return _save(fig, os.path.join(save_dir, f"{title}.png")
                 if save_plot else None)


def plot_grad_flow(
    grads_flat: Dict[str, np.ndarray],
    title: str = "gradient flow",
    save_path: Optional[str] = None,
):
    """Mean |grad| bars per leaf, for gradient-health debugging
    (reference: visualizations.py:245-276); ``grads_flat`` as
    ``flatten_grads`` gives it."""
    plt = _plt()
    names = list(grads_flat)
    means = [float(np.mean(np.abs(grads_flat[n]))) for n in names]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.25), 4))
    ax.bar(range(len(names)), means, color="tab:cyan")
    ax.hlines(0, 0, len(names) + 1, lw=2, color="k")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation="vertical", fontsize=5)
    ax.set_ylabel("mean |grad|")
    ax.set_title(title)
    return _save(fig, save_path)


def _keystr_leaves(tree, prefix: str = ""):
    """Leaves of a nested dict in ``jax.tree_util`` order (sorted keys),
    named as ``jax.tree_util.keystr`` names them: ``['f']['conv']...``."""
    for key in sorted(tree):
        name = f"{prefix}[{key!r}]"
        if isinstance(tree[key], dict):
            yield from _keystr_leaves(tree[key], name)
        else:
            yield name, tree[key]


def flatten_grads(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The filled ``.grad`` of every parameter of ``model`` as {name:
    float32 numpy array}, named, ordered and laid out as the JAX side's
    ``flatten_grads`` gives its gradient tree (``utils/weights.py``'s
    mapping: conv kernels (kh, kw, I, O), dense kernels (in, out),
    ``scale`` for a BN weight), so that the two packages' gradient-flow
    bars line up label for label. A parameter without a gradient is left
    out."""
    from simclr_tpu_torch.utils.weights import simclr_to_jax

    grads = {name: p.grad for name, p in model.named_parameters()
             if p.grad is not None}
    params, _ = simclr_to_jax(grads)
    return dict(_keystr_leaves(params))


def denormalize_image(
    img: np.ndarray, mean: Sequence[float], std: Sequence[float]
) -> np.ndarray:
    """Invert the normalisation for display, clipped to [0, 1]
    (reference: visualizations.py:205-219)."""
    x = np.asarray(img) * np.asarray(std) + np.asarray(mean)
    return np.clip(x, 0.0, 1.0)


def show_images(
    images: np.ndarray,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    n_cols: int = 8,
    save_path: Optional[str] = None,
):
    """Grid of (normalised, if ``mean`` and ``std`` are given) NHWC
    images."""
    plt = _plt()
    images = np.asarray(images)
    n = images.shape[0]
    n_rows = -(-n // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(n_cols * 1.3, n_rows * 1.3))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            img = images[i]
            if mean is not None and std is not None:
                img = denormalize_image(img, mean, std)
            ax.imshow(img)
    return _save(fig, save_path)
