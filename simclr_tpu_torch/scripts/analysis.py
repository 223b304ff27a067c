"""Representation-analysis CLI: similarity-metric KDEs, t-SNE cluster
plots, original-against-flipped analogy numbers and one batch's gradient
flow for a pretrained model.

Counterpart of ``scripts/analysis.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). It reads the port's ``.pt`` export or the JAX package's
``.msgpack`` and writes, under ``--out`` (by default the port's own
``results/analysis_torch``):

    metrics.json, analogy.json           (always)
    ned_comp.png, cc_comp.png, cos_comp.png, nmi_comp.png,
    tsne_h.png, tsne_z.png, grad_flow.png (with matplotlib, seaborn and
                                           scikit-learn installed)

``analyze`` does the computation and writes the JSON files; ``main``
draws the figures. Run from the repository root:

    python -m simclr_tpu_torch.scripts.analysis <export>.pt --n_batches 4
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from simclr_tpu_torch.config import Config

_KDE_KEYS = ("ned", "cc", "cos", "nmi")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_path",
                   help="pretrained SimCLR export (.pt or JAX .msgpack)")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "stl10"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out", default="results/analysis_torch")
    p.add_argument("--n_batches", type=int, default=20,
                   help="batches of 256 for the similarity metrics")
    p.add_argument("--tsne_points", type=int, default=3000)
    p.add_argument("--use_final_feat", action="store_true",
                   help="analyze z instead of h")
    p.add_argument("--supervised_model", default=None,
                   help="supervised baseline export (.pt or JAX .msgpack "
                        "of a SupervisedResNet); when given, the "
                        "*_comp.png KDEs become the reference's three-way "
                        "overlay: contrastive h, contrastive z, supervised "
                        "(reference visualizations.py:11-47)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def summarize(values: np.ndarray) -> Dict[str, float]:
    """The scalar distribution of one metric, with the JAX CLI's keys."""
    a = np.asarray(values, np.float64)
    qs = np.quantile(a, [0.05, 0.25, 0.5, 0.75, 0.95])
    return {"n": int(a.size), "mean": float(a.mean()),
            "std": float(a.std()),
            "q05": float(qs[0]), "q25": float(qs[1]),
            "median": float(qs[2]), "q75": float(qs[3]),
            "q95": float(qs[4])}


def grad_flow(cfg: Config, model, images, seed: int = 0):
    """The gradients of one NT-Xent batch (reference
    visualizations.py:245-276, which the reference calls mid-training):
    a train-mode forward of two views of the uint8 NHWC ``images`` (and
    MC-dropout masks, where the model has them, from a generator seeded
    ``seed``), NT-Xent through kernel B1 on a CUDA device, the backward.
    Returns (``flatten_grads`` of it, the loss). Every parameter, buffer
    (the BN running statistics that the train-mode forward writes), filled
    ``.grad`` and the training flag are as they were before: JAX throws
    its updated statistics away."""
    import torch

    from simclr_tpu_torch.ops.augment import augment_train_pair
    from simclr_tpu_torch.train.pretrain import _forward_pair, contrastive_fn
    from simclr_tpu_torch.utils.visualizations import flatten_grads

    gen = torch.Generator(device=images.device).manual_seed(seed)
    loss_fn = contrastive_fn(cfg, images.device)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    saved_grads = {n: p.grad for n, p in model.named_parameters()}
    training = model.training
    try:
        model.train()
        with torch.no_grad():
            v1, v2 = augment_train_pair(gen, images, cfg.augment,
                                        cfg.dataset)
        for p in model.parameters():
            p.grad = None
        z1, z2 = _forward_pair(model, v1, v2, generator=gen)
        loss, _ = loss_fn(z1, z2)
        loss.backward()
        grads = flatten_grads(model)
    finally:
        model.train(training)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(buffers[n])
        for n, p in model.named_parameters():
            p.grad = saved_grads[n]
    return grads, float(loss.detach())


def analyze(cfg: Config, model, test_ds, train_ds, out: "str | Path",
            n_batches: Optional[int] = 20, use_final_feat: bool = False,
            supervised=None, batch_size: int = 256,
            log=print) -> Dict[str, Any]:
    """The analysis of a ``SimCLR`` (and, if given, a ``SupervisedResNet``)
    on the test split ``test_ds``; ``train_ds`` feeds the gradient flow.

    Returns ``metrics`` (h, or z with ``use_final_feat``), and with a
    supervised model ``metrics_z`` and ``metrics_sup``; ``h``, ``z`` and
    ``targets`` over the test split (numpy); ``analogy``; ``grads``
    (``flatten_grads`` of one batch of ``min(256, n)`` training images)
    and ``grad_loss``. Writes ``metrics.json`` (a summary of each metric
    of ``metrics``) and ``analogy.json`` under ``out``, with the JAX CLI's
    keys."""
    from simclr_tpu_torch.train.lin_eval import extract_features
    from simclr_tpu_torch.utils.metrics import (
        contrastive_feature_fn, get_representation_analogy,
        get_similarity_metrics, supervised_feature_fn)

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    feature_fn = contrastive_feature_fn(
        model, use_hidden_feat=not use_final_feat)
    res: Dict[str, Any] = {}

    log("computing similarity metrics ...")
    res["metrics"] = get_similarity_metrics(
        feature_fn, test_ds, cfg, batch_size=batch_size, n_batches=n_batches)
    if supervised is not None:
        res["metrics_z"] = get_similarity_metrics(
            contrastive_feature_fn(model, use_hidden_feat=False), test_ds,
            cfg, batch_size=batch_size, n_batches=n_batches)
        res["metrics_sup"] = get_similarity_metrics(
            supervised_feature_fn(supervised), test_ds, cfg,
            batch_size=batch_size, n_batches=n_batches)
    m = res["metrics"]
    log(f"pos/neg cosine means: {m['pos_cos'].mean():.3f} / "
        f"{m['neg_cos'].mean():.3f}")

    log("extracting features for t-SNE ...")
    h, targets = extract_features(model, test_ds, cfg, use_hidden_feat=True)
    z, _ = extract_features(model, test_ds, cfg, use_hidden_feat=False)
    res["h"], res["z"] = h.cpu().numpy(), z.cpu().numpy()
    res["targets"] = targets.cpu().numpy()

    log("analogy analysis (orig vs flipped) ...")
    res["analogy"] = get_representation_analogy(feature_fn, feature_fn,
                                                test_ds, cfg)
    (out / "analogy.json").write_text(json.dumps(res["analogy"], indent=2))
    (out / "metrics.json").write_text(json.dumps(
        {k: summarize(v) for k, v in m.items()}, indent=2))

    log("one-batch gradient flow ...")
    batch = train_ds.images[:min(256, train_ds.n)]
    res["grads"], res["grad_loss"] = grad_flow(cfg, model, batch)
    return res


def _load_simclr(cfg: Config, path: str, device):
    import torch

    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.train.pretrain import resolve_model_config
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    sd, _ = load_pretrained(path)
    model = SimCLR(resolve_model_config(cfg).model)
    model.load_state_dict(sd)
    return model.to(device, memory_format=torch.channels_last)


def _load_supervised(cfg: Config, path: str, device):
    import torch

    from simclr_tpu_torch.models.resnet import SupervisedResNet
    from simclr_tpu_torch.models.simclr import dtype_of
    from simclr_tpu_torch.utils.checkpoint import load_pretrained

    sd, _ = load_pretrained(path)
    m = cfg.model
    model = SupervisedResNet(
        num_classes=cfg.dataset.num_classes,
        low_quality_img=m.low_quality_img, stage_sizes=m.stage_sizes,
        width=m.width, dtype=dtype_of(m.compute_dtype),
        bn_dtype=dtype_of(m.bn_dtype),
        bn_stats_fraction=m.bn_stats_fraction)
    model.load_state_dict(sd)
    return model.to(device, memory_format=torch.channels_last)


def draw(res: Dict[str, Any], out: "str | Path",
         tsne_points: int = 3000) -> None:
    """The figures of ``analyze``'s result (matplotlib, seaborn and
    scikit-learn)."""
    from simclr_tpu_torch.utils.visualizations import (
        kde_multi_plot, kde_single_model_plot, plot_grad_flow, tsne_plot)

    out = Path(out)
    for key in _KDE_KEYS:
        title = f"{key} (positive vs negative pairs)"
        path = str(out / f"{key}_comp.png")
        if "metrics_sup" in res:
            kde_multi_plot(
                [res["metrics"], res["metrics_z"], res["metrics_sup"]], key,
                labels=("contrastive h", "contrastive z", "supervised"),
                title=title, save_path=path)
        else:
            kde_single_model_plot(res["metrics"], key, title=title,
                                  save_path=path)
    for name in ("h", "z"):
        tsne_plot(res[name], res["targets"],
                  title=f"t-SNE of {name} (test set)",
                  max_points=tsne_points,
                  save_path=str(out / f"tsne_{name}.png"))
    plot_grad_flow(res["grads"], title="gradient flow (one NT-Xent batch)",
                   save_path=str(out / "grad_flow.png"))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = Config.for_dataset(args.dataset).replace(data_dir=args.data_dir)

    from simclr_tpu_torch.data.pipeline import make_split
    from simclr_tpu_torch.utils.device import resolve_device
    from simclr_tpu_torch.utils.visualizations import plotting_available

    dev = resolve_device(args.device)
    model = _load_simclr(cfg, args.model_path, dev)
    supervised = (_load_supervised(cfg, args.supervised_model, dev)
                  if args.supervised_model else None)
    split = make_split(cfg, "lin_eval", dev)
    test = make_split(cfg, "test", dev)
    res = analyze(cfg, model, test.train, split.train, args.out,
                  n_batches=args.n_batches,
                  use_final_feat=args.use_final_feat, supervised=supervised)
    if plotting_available():
        draw(res, args.out, args.tsne_points)
    else:
        print("matplotlib, seaborn or scikit-learn is not installed: "
              "metrics.json and analogy.json only, no figures")
    print(f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
