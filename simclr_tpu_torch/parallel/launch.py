"""Run a function on n ranks of a gloo group, each a spawned process.

``spawn_ranks(fn, n, *args)`` starts n processes, makes each one's mesh
(``parallel/mesh.py:make_mesh``, gloo, at a port the OS reports free),
calls ``fn(mesh, *args)`` there and returns the ranks' results in rank
order. ``fn`` must be importable by name (a module-level function) and its
result picklable. Every rank's failure is raised here with its traceback;
the whole run has a deadline, after which every child still alive is
killed and ``TimeoutError`` raised, so a hung collective fails one call
and never hangs the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, List

_RESULT_GRACE_S = 10.0


def _rank_main(fn, rank, n, port, device, backend, threads, args, results):
    import torch
    import torch.distributed as dist

    from simclr_tpu_torch.parallel.mesh import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(n, device=device, backend=backend,
                         init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                         world_size=n)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], n: int, *args,
                timeout: float = 120.0, device: str = "cpu",
                backend: str = "gloo", threads: int = 1) -> List[Any]:
    """``[fn(mesh_r, *args) for r in range(n)]``, each in its own process
    (module docstring). ``threads``: torch's intra-op threads per rank (0
    keeps torch's default)."""
    from simclr_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, port, device, backend, threads,
                               args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks did not finish in "
                                   f"{timeout:.0f} s (ranks done: "
                                   f"{sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    time.sleep(0.5)  # let a dying rank's report arrive
                    if results.empty():
                        raise RuntimeError(f"ranks {dead} exited with "
                                           f"codes {[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=_RESULT_GRACE_S if len(got) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]
