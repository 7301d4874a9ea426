"""Joining the process group, and the helpers of a global batch across
processes (port of `parallel/multihost.py`).

JAX runs one process per host over all of its chips; PyTorch runs one
process per card.  So the port's "multi-host" layer is the process group
itself: :func:`distributed_init` joins it (the counterpart of
``jax.distributed.initialize``), the global mesh is the 1-D mesh over every
rank, ordered as ``torchrun`` numbers them (host-major, a host's cards
contiguous), and a process's share of a global batch is its own rows, which
it makes itself: :func:`shard_batch_global` only puts them on the rank's
card.  Collectives go through NCCL between cards and gloo on the CPU (or
for two ranks sharing one card, which NCCL refuses).
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

# a collective that waits longer than this raises instead of blocking on a
# peer that is gone
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, *, device: str = "cuda",
                     timeout: datetime.timedelta = COLLECTIVE_TIMEOUT,
                     **extra: Any) -> None:
    """Join the default process group (idempotent: a second call returns).

    The values come from the arguments, else from ``torchrun``'s
    environment: ``MASTER_ADDR``/``MASTER_PORT`` (the rendezvous),
    ``WORLD_SIZE`` (``num_processes``), ``RANK`` (``process_id``) and
    ``LOCAL_RANK``.  ``coordinator_address`` is ``host:port`` (TCP) or an
    ``init_method`` URL (``tcp://...``, ``file://...``).  A lone process
    with none of these joins a group of one, kept in memory.

    ``device`` is "cuda" unless the caller asks for the CPU: the rank is
    bound to ``cuda:{LOCAL_RANK % device_count}`` and the backend is NCCL;
    with ``device="cpu"`` the backend is gloo.  ``backend`` overrides the
    choice (gloo for two ranks on one card, which NCCL refuses).  Every
    collective raises after ``timeout``; ``extra`` goes to
    ``torch.distributed.init_process_group``."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    world = 1 if world is None else world
    rank = 0 if rank is None else rank
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init(device='cuda'): no CUDA "
                               "device here; pass device='cpu' for gloo")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((rank if local is None else local)
                              % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    kwargs = dict(backend=backend, world_size=world, rank=rank,
                  timeout=timeout, **extra)
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kwargs["init_method"] = "env://"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(f"a group of {world} processes needs a coordinator:"
                         f" pass coordinator_address= or run under torchrun")
    dist.init_process_group(**kwargs)


def make_global_mesh(axis_name: str = "data", device: str = "cuda"):
    """The 1-D data mesh over every rank of every host, host-major as
    ``torchrun`` numbers the ranks; in one process, ``make_mesh()``."""
    from .mesh import make_mesh
    return make_mesh(axis_name=axis_name, device=device)


def mesh_process_count(mesh) -> int:
    """The processes taking part in ``mesh``: one a card, so its size."""
    return mesh.size()


def process_local_batch_size(global_batch: int, mesh) -> int:
    """The rows of the global batch this process makes."""
    n = mesh_process_count(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def shard_batch_global(mesh, batch: Any) -> Any:
    """This process's rows of a global batch, as it made them (leading axis
    ``process_local_batch_size``), as tensors on its device: a process's
    local rows are its shard, so nothing is copied between processes."""
    from .mesh import mesh_device
    device = mesh_device(mesh)
    return _pytree.tree_map(lambda x: torch.as_tensor(x, device=device),
                            batch)


def _placements(spec, axis_name: str):
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(spec, (list, tuple)) and spec and not isinstance(
            spec[0], (str, type(None))):
        return list(spec)                           # placements already
    dims = [i for i, a in enumerate(spec or ()) if a == axis_name]
    return [Shard(dims[0])] if dims else [Replicate()]


def _local_part(x: torch.Tensor, placements, mesh) -> torch.Tensor:
    from torch.distributed.tensor import Shard
    (p,) = placements
    if not isinstance(p, Shard):
        return x
    return torch.chunk(x, mesh.size(), dim=p.dim)[mesh.get_local_rank()]


def place_global(mesh, tree: Any, specs: Any, axis_name: str = "data"
                 ) -> Any:
    """Host values that every process holds in full (the same-seed
    convention), placed on the mesh by ``specs``: a spec is a tuple naming
    ``axis_name`` at the sharded dim (the form ``fsdp_specs`` returns; ``()``
    replicates) or a list of placements, one for each leaf of ``tree`` (a
    dict, list or tuple like it) or one for all.  Each process keeps only
    its slice; returns ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    from .mesh import mesh_device
    device = mesh_device(mesh)
    leaves, treedef = _pytree.tree_flatten(tree)
    if _is_spec(specs):
        spec_leaves = [specs] * len(leaves)
    else:
        spec_leaves = _pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
        if len(spec_leaves) != len(leaves):
            raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                             f"leaves")

    def put(x, spec):
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device)
        placements = _placements(spec, axis_name)
        local = _local_part(x, placements, mesh).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return _pytree.tree_unflatten(
        [put(x, s) for x, s in zip(leaves, spec_leaves)], treedef)


def replicate_global(mesh, tree: Any) -> Any:
    """Host values every process holds in full (parameters, a seed's
    draws), replicated over the mesh: each process contributes its copy."""
    from .mesh import replicated
    return place_global(mesh, tree, replicated(mesh))


def _is_spec(s) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return s == () or (isinstance(s, (tuple, list)) and all(
        a is None or isinstance(a, (str, Placement)) for a in s))
