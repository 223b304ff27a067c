"""Data-parallel process group: the port's counterpart of
``simclr_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX builds a 1-D ``'data'`` mesh over the devices of one program. Here each
rank is a process with one device (``torchrun --nproc_per_node N``, or
ranks spawned by the caller), and ``make_mesh`` returns a small ``Mesh``:
the process group, this rank, the world size and the rank's device. The
batch axis is sharded by ``shard_batch`` (this rank's contiguous slice of
the leading axis: ``batch_sharding``), parameters are replicated by
``put_replicated`` (broadcast from rank 0: ``replicated``), and
``DATA_AXIS`` names the group for the BNs' cross-rank statistics
(``models/norm.py``), as JAX's ``axis_name`` names the mesh axis.

The backend is NCCL for CUDA devices and gloo for the CPU. gloo on CUDA
tensors runs only where the caller asks for it (``backend='gloo'``): NCCL
refuses two ranks on one card, so that is how two ranks can share one.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from simclr_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"

# Axis name -> the Mesh whose group reduces over it (make_mesh binds it).
_AXES: Dict[str, "Mesh"] = {}


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel group."""

    group: Any           # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def free_port() -> int:
    """A TCP port the OS reports free on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None,
              device: "str | torch.device" = "cuda",
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """This rank's ``Mesh`` over ``n_devices`` ranks (default: the world).

    The rank, world size and local rank come from the arguments or from
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` sets them
    (a lone process is rank 0 of 1). The default process group is created
    if there is none: at ``init_method``, else ``env://`` where torchrun set
    ``MASTER_ADDR``, else (one rank) a free port on localhost. A CUDA
    device is ``cuda:LOCAL_RANK`` and needs a GPU; its backend is NCCL
    unless ``backend`` says otherwise."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} ranks, not {world} (start one process "
                         "per device, e.g. torchrun --nproc_per_node "
                         f"{n_devices})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if init_method is None:
            if "MASTER_ADDR" in os.environ:
                init_method = "env://"
            elif world == 1:
                init_method = f"tcp://127.0.0.1:{free_port()}"
            else:
                raise ValueError("a world of several ranks needs "
                                 "init_method or MASTER_ADDR/MASTER_PORT")
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kwargs)
    group = dist.group.WORLD
    if dist.get_backend(group) != backend:
        raise ValueError(f"the process group runs {dist.get_backend(group)},"
                         f" not {backend}")
    mesh = Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev,
                backend)
    _AXES[DATA_AXIS] = mesh
    return mesh


def axis_mesh(name: str) -> Mesh:
    """The mesh bound to an axis name; raises for an unbound one, as JAX
    raises for an axis name outside its shard_map."""
    try:
        return _AXES[name]
    except KeyError:
        raise NameError(f"unbound axis name: {name!r} (make_mesh binds "
                        f"{DATA_AXIS!r})") from None


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Where a tensor's values live on a mesh, JAX's ``NamedSharding`` of
    ``P('data')`` or ``P()`` on its 1-D mesh. ``'batch'``: each rank holds
    its contiguous slice of the leading axis. ``'replicated'``: each rank
    holds the whole tensor, rank 0's values. Calling it on a tensor
    places the tensor so: a slice, or a broadcast in place."""

    mesh: Mesh
    kind: str

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if self.kind == "batch":
            n = t.shape[0]
            if n % mesh.size:
                raise ValueError(f"a leading axis of {n} does not split "
                                 f"over {mesh.size} ranks")
            m = n // mesh.size
            return t[mesh.rank * m:(mesh.rank + 1) * m]
        dist.broadcast(t, src=0, group=mesh.group)
        return t


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading axis sharded over the mesh's ranks."""
    return Sharding(mesh, "batch")


def replicated(mesh: Mesh) -> Sharding:
    """The whole tensor on every rank, rank 0's values."""
    return Sharding(mesh, "replicated")


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis (the whole tensor
    without a mesh or on one rank)."""
    if mesh is None or mesh.size == 1:
        return x
    return batch_sharding(mesh)(x)


@torch.no_grad()
def put_replicated(tree, mesh: Optional[Mesh]):
    """Broadcast from rank 0, in place: a module's parameters and buffers,
    an optimizer's state tensors (and, for ``GradAccumulation``, its
    accumulator), a tensor, or a list/tuple of these. Returns ``tree``."""
    if mesh is None:
        return tree
    if isinstance(tree, (list, tuple)):
        for t in tree:
            put_replicated(t, mesh)
        return tree
    if isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif hasattr(tree, "state") and hasattr(tree, "param_groups"):
        tensors = [v for s in tree.state.values() for v in s.values()
                   if isinstance(v, torch.Tensor)]
        tensors += list(getattr(tree, "acc", []))
    else:
        raise TypeError(f"cannot replicate a {type(tree).__name__}")
    place = replicated(mesh)
    for t in tensors:
        if mesh.backend == "nccl" and t.device.type != "cuda":
            continue  # a host step count: the same on every rank
        place(t.data)
    return tree


class _AllReduceMean(torch.autograd.Function):
    """The mean over ranks (JAX's ``pmean``). Every rank gets the same
    value and uses it in its own loss, so the cotangent of a rank's input
    is the mean over ranks of the cotangents of that value."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / size

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.size, None, None


class _AllGather(torch.autograd.Function):
    """The ranks' tensors stacked on a new leading axis, rank order (JAX's
    ``all_gather``). Backward: each rank's rows get the sum over ranks of
    their cotangents, an all-reduce of the whole cotangent and this rank's
    slice of it, which gloo and NCCL both run (gloo has no reduce-scatter);
    the tensors are small (the 2N x d projections)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank = group, rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank], None, None, None


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``mesh``, differentiable."""
    return _AllReduceMean.apply(x, mesh.group, mesh.size)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order, differentiable."""
    return _AllGather.apply(x, mesh.group, mesh.rank, mesh.size)


@torch.no_grad()
def all_reduce_sum_(tensors, mesh: Mesh) -> None:
    """Sum each tensor over the ranks, in place (gradients, metrics): one
    all-reduce of their concatenation (they share a dtype)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
