"""Entry points: a forward on the flagship model, and a multi-process dry
run of the data-parallel training path.

Counterparts of ``__graft_entry__.py``'s ``entry()`` and
``dryrun_multichip(n)``:

    python -m simclr_tpu_torch.entry        # entry() on the card, then
                                            # dryrun_multiprocess(2)
    python -m simclr_tpu_torch.entry 4      # dryrun_multiprocess(4) only

``entry(device)`` returns a forward step on SimCLR with the CIFAR-stem
ResNet-50 (``Config()``) and its example arguments.

``dryrun_multiprocess(n)`` spawns n gloo ranks on the CPU
(``parallel/launch.py``) and runs, on a reduced Bottleneck ResNet
(``stage_sizes=(1, 1, 1, 1)``, width 16) at 2 images a rank, every piece
of the multi-rank path: a 4-step epoch of the data-parallel step
(``parallel/explicit.py``: the global batch's draws, each rank's slice,
BN statistics averaged over the ranks, NT-Xent over the all-gathered
projections, summed gradients, Adam); a checkpoint written by rank 0,
one more step, a restore on every rank and that step again, whose loss
must reproduce; one modified-loss step; and one step of the explicit
engine against the one-device engine on the global batch (same weights,
rows and draws; bf16, so within 2e-2 as in JAX's dry run).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from typing import Callable, List, Tuple


def entry(device: str = "cuda") -> Tuple[Callable, tuple]:
    """(forward, (model, x)): ``forward(model, x) -> (h, z)`` in eval mode
    on 8 zero CIFAR images, the flagship model built from seed 0."""
    import torch

    from simclr_tpu_torch.config import Config
    from simclr_tpu_torch.models.simclr import SimCLR
    from simclr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = Config()
    model = SimCLR(cfg.model, generator=torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    x = torch.zeros((8, 3, 32, 32), device=dev).to(
        memory_format=torch.channels_last)

    @torch.no_grad()
    def forward(model, x):
        return model(x)

    return forward, (model, x)


def _dryrun_rank(mesh, tmp: str) -> List[float]:
    """One rank of ``dryrun_multiprocess``; returns its numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from simclr_tpu_torch.config import Config, ModelConfig, TrainConfig
    from simclr_tpu_torch.data.pipeline import epoch_permutation
    from simclr_tpu_torch.train.pretrain import (
        build_engine, init_simclr, mesh_config)
    from simclr_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    n = mesh.size
    batch = 2 * n
    cfg = Config(model=ModelConfig(stage_sizes=(1, 1, 1, 1), width=16,
                                   feature_dim=512, compressed_dim=64),
                 train=TrainConfig(batch_size=batch, n_epoch=1,
                                   save_ckpt=False))
    say = print if mesh.is_main else (lambda *a, **k: None)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    model, state, opt = init_simclr(cfg, 0, mesh=mesh)
    engine = build_engine(cfg, model, opt, mesh=mesh)
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, size=(4 * batch, 32, 32, 3)).astype(np.uint8))
    idx_mat = epoch_permutation(gen(1), images.shape[0], batch)[:4]
    state, (losses, accs) = engine.train_epoch(state, images, idx_mat,
                                               gen(2))
    losses = losses.tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    say(f"dryrun_multiprocess({n}): 4-step epoch ok | losses="
        f"{[round(v, 4) for v in losses]} | acc={float(accs[-1]):.2f}%",
        flush=True)

    # Checkpoint round trip: rank 0 writes, every rank restores and
    # reruns the step after the save, which must give the same loss.
    step_idx = epoch_permutation(gen(3), images.shape[0], batch)[:1]
    path = os.path.join(tmp, "epoch_00000")
    if mesh.is_main:
        save_checkpoint(tmp, 0, state)
    dist.barrier(group=mesh.group)
    _, (loss_a, _) = engine.train_epoch(state, images, step_idx, gen(4))
    state, _ = load_checkpoint(path, state)
    _, (loss_b, _) = engine.train_epoch(state, images, step_idx, gen(4))
    loss_a, loss_b = float(loss_a[0]), float(loss_b[0])
    if not np.isclose(loss_a, loss_b, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"checkpoint restore diverged: {loss_a} vs "
                             f"{loss_b}")
    say(f"dryrun_multiprocess({n}): checkpoint save/restore ok | loss "
        f"{loss_a:.6f} == {loss_b:.6f}", flush=True)

    mcfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 modified_loss=True))
    m_model, m_state, m_opt = init_simclr(mcfg, 0, mesh=mesh)
    m_engine = build_engine(mcfg, m_model, m_opt, mesh=mesh)
    _, (m_loss, _) = m_engine.train_epoch(m_state, images, idx_mat[:1],
                                          gen(2))
    m_loss = float(m_loss[0])
    if not np.isfinite(m_loss):
        raise AssertionError(f"non-finite modified loss {m_loss}")
    say(f"dryrun_multiprocess({n}): modified-loss step ok | "
        f"loss={m_loss:.4f}", flush=True)

    # The explicit step against the one-device engine on the global batch,
    # from the same weights (exact statistics on both), rows and draws.
    one_cfg = mesh_config(cfg, mesh)
    o_model, o_state, o_opt = init_simclr(one_cfg, 0, device="cpu")
    o_engine = build_engine(one_cfg, o_model, o_opt)
    _, (o_loss, _) = o_engine.train_epoch(o_state, images, idx_mat[:1],
                                          gen(2))
    ex_loss, o_loss = losses[0], float(o_loss[0])
    if abs(ex_loss - o_loss) > 2e-2 * max(abs(o_loss), 1.0):
        raise AssertionError(f"engine disagreement: one-device {o_loss:.4f}"
                             f" explicit {ex_loss:.4f}")
    say(f"dryrun_multiprocess({n}): explicit engine ok | loss="
        f"{ex_loss:.4f} | one-device {o_loss:.4f} | "
        f"|dloss|={abs(ex_loss - o_loss):.5f}", flush=True)
    return [*losses, loss_a, loss_b, m_loss, o_loss]


def dryrun_multiprocess(n: int, timeout: float = 600.0) -> List[List[float]]:
    """The dry run on n gloo ranks (module docstring); returns each rank's
    numbers (the epoch's losses, the step before and after the restore,
    the modified loss, the one-device loss), which agree across ranks."""
    from simclr_tpu_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        out = spawn_ranks(_dryrun_rank, n, tmp, timeout=timeout,
                          threads=max(1, (os.cpu_count() or 1) // n))
    if any(o != out[0] for o in out):
        raise AssertionError(f"ranks disagree: {out}")
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1:
        dryrun_multiprocess(int(sys.argv[1]))
    else:
        fn, args = entry()
        h, z = fn(*args)
        print(f"entry: h {tuple(h.shape)}, z {tuple(z.shape)}")
        dryrun_multiprocess(2)
