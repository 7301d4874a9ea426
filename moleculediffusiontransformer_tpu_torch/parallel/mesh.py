"""The data mesh and the batch's placement on it (port of
`parallel/mesh.py`).

JAX lays a 1-D ``('data',)`` mesh over its devices, shards the batch over
it and lets XLA insert the gradient all-reduce.  PyTorch has no such
compiler pass: the port runs one process per card, its mesh is a 1-D
``DeviceMesh`` over the ranks of the process group, each rank takes its
contiguous rows of the global batch, and the train step all-reduces the
grads itself (``train/trainer.py``), over a few flat buckets
(:func:`all_reduce_mean`).  Rows gathered back (a request's samples) are
summed into a zero-filled global buffer (:func:`gather_rows`): exact, since
x + 0 = x, and one collective that gloo takes on CUDA tensors.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree

from .multihost import distributed_init

# the most elements one flat bucket of a collective holds: 64 MB of float32
BUCKET_ELEMENTS = 2 ** 24


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device: str = "cuda"):
    """The 1-D data mesh over every rank of the process group, on the card
    unless ``device="cpu"``; ``num_devices``, where given, must be the
    group's size (one process a card: the mesh is the group).  Joins a
    group of one first when this process has none (``distributed_init``);
    every rank of the group calls it."""
    from torch.distributed.device_mesh import init_device_mesh
    distributed_init(device=device)
    world = dist.get_world_size()
    if num_devices not in (None, world):
        raise ValueError(f"num_devices {num_devices}: the mesh is the "
                         f"process group, of {world} ranks")
    return init_device_mesh(device, (world,), mesh_dim_names=(axis_name,))


def mesh_2d(data: int, other: int, names: tuple, device: str = "cuda"):
    """A 2-D mesh ``names`` of ``data`` x ``other`` ranks over the process
    group (joined first as ``make_mesh`` does), row-major: the ranks of one
    ``other`` group are consecutive.  Every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh
    distributed_init(device=device)
    world = dist.get_world_size()
    if data * other != world:
        raise ValueError(f"a {data} x {other} mesh over a group of {world} "
                         f"ranks")
    return init_device_mesh(device, (data, other), mesh_dim_names=names)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh) -> list:
    """The placement of a batch: its leading axis sharded over the mesh."""
    from torch.distributed.tensor import Shard
    return [Shard(0)]


def replicated(mesh) -> list:
    """The placement of what every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return [Replicate()]


def local_rows(mesh, batch: int) -> slice:
    """This rank's contiguous rows of a global batch of ``batch`` rows."""
    n = mesh.size()
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over the "
                         f"{n}-rank mesh")
    rank, per = mesh.get_local_rank(), batch // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of a global host batch (a tensor or array, or a
    tuple, list or dict of them), as tensors on its device."""
    device = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x)
        return x[local_rows(mesh, x.shape[0])].to(device)

    return _pytree.tree_map(put, batch)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and at most
    ``BUCKET_ELEMENTS`` elements each (one tensor at least)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if run and (size + t.numel() > BUCKET_ELEMENTS
                    or t.dtype != run[0].dtype):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(flat)`` on each bucket of ``tensors`` flattened, the
    result copied back in place."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def all_reduce_mean(mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the mesh's ranks, in place, a flat bucket a
    collective: every rank ends with the same bits."""
    group, n = mesh.get_group(), mesh.size()

    def mean(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced(tensors, mean)


def replicate(mesh, module: nn.Module) -> nn.Module:
    """Give every rank rank 0's parameters and buffers (in place): JAX's
    convention of one seed on every process, made exact."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        _coalesced([*module.parameters(), *module.buffers()],
                   lambda flat: dist.broadcast(flat, src, group=group))
    return module


def gather_rows(mesh, local: torch.Tensor, batch: int) -> torch.Tensor:
    """The (batch, ...) global tensor of which this rank holds ``local``,
    its ``local_rows``, on every rank: a zero-filled buffer that each rank
    fills in its own rows, summed over the mesh."""
    out = local.new_zeros((batch, *local.shape[1:]))
    out[local_rows(mesh, batch)] = local
    dist.all_reduce(out, group=mesh.get_group())
    return out


def barrier(mesh) -> None:
    """Wait for every rank of the mesh."""
    dist.barrier(group=mesh.get_group())


def is_first_rank(mesh) -> bool:
    """True on the mesh's rank 0, and where there is no mesh."""
    return mesh is None or mesh.get_local_rank() == 0


def pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading axis up to a multiple (for even device division)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = np.repeat(x[:1], rem, axis=0)
    return np.concatenate([x, pad], axis=0)
