"""Expert parallelism: the stacked MoE experts sharded over an 'expert'
axis (port of `parallel/ep.py`).

JAX places the stacked ``(E, ...)`` expert leaves ``P('expert')`` and the
batch ``P('data')`` and lets GSPMD lower the dispatch.  The port holds each
rank's E / n experts as a ``DTensor`` shard (``Shard(0)`` on 'expert',
``Replicate()`` on 'data') and gives ``nn.moe.MoEFeedForward`` an
expert-parallel route: routing and capacity are computed as before, on
every expert rank alike; the tokens and the (t, k) gates enter through
``copy_to`` (each rank's grad is its experts' part, summed over 'expert':
t x k floats for the gates, never the (t, E, capacity) combine weights,
of which each rank takes its experts' columns); each rank runs only its
experts and combines their outputs, and ``reduce_from`` sums the partial
combines over 'expert' (identity backward: every expert rank computes the
same thing after it).

GSPMD keeps the global batch's semantics over 'data', so the port does too
(:func:`set_data_axis`, which ``shard_params_ep`` calls): the token count
of the capacity is the global batch's, a data rank's capacity positions
add, slot by slot and expert by expert, the picks of the data ranks before
it (slot-major priority over the global batch), and the load-balance
loss's top-1 fractions and mean probabilities are global means.  Only
dropped tokens show this; the tests run a capacity factor at which some
drop.  The dispatch stays the dense one-hot of ``nn/moe.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils import _pytree

from .collectives import axis as mesh_axis
from .mesh import mesh_2d, mesh_device

_EXPERT_LEAVES = ("w_in", "w_out")


def make_mesh_ep(n_data: int, n_expert: int, device: str = "cuda"):
    """The 2-D ``("data", "expert")`` mesh of ``n_data`` x ``n_expert``
    ranks over the process group ('expert' innermost), on the card unless
    ``device="cpu"``."""
    return mesh_2d(n_data, n_expert, ("data", "expert"), device)


def expert_parallel_specs(model: nn.Module, num_experts: int,
                          axis: str = "expert") -> Dict[str, tuple]:
    """Each parameter's spec by name: the stacked expert leaves (``w_in``,
    ``w_out`` with a leading E axis) ``(axis, None, ...)``; every other,
    the router included, ``()``."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = ((axis,) + (None,) * (p.dim() - 1)
                     if leaf in _EXPERT_LEAVES and p.dim() >= 2
                     and p.shape[0] == num_experts else ())
    return out


def set_data_axis(model: nn.Module, mesh, data_axis: str = "data") -> None:
    """Give every MoE layer of ``model`` the mesh's data axis, over which
    its capacity and load-balance loss are the global batch's."""
    from ..nn.moe import MoEFeedForward
    ax = mesh_axis(mesh, data_axis)
    for m in model.modules():
        if isinstance(m, MoEFeedForward):
            m.data_axis = ax


def shard_params_ep(mesh, model: nn.Module, num_experts: int,
                    batch_axis: str = "data",
                    expert_axis: str = "expert") -> Tuple[nn.Module, Dict]:
    """Replace each stacked expert leaf by this rank's ``DTensor`` shard of
    its experts (in place; every rank must hold the same parameters first)
    and set the data axis on the MoE layers.  Returns ``(model, specs)``.
    Make the optimizer state after."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    specs = expert_parallel_specs(model, num_experts, expert_axis)
    ax = mesh_axis(mesh, expert_axis)
    if num_experts % ax.size:
        raise ValueError(f"{num_experts} experts over {ax.size} ranks")
    at = list(mesh.mesh_dim_names).index(expert_axis)
    placements = [Replicate()] * mesh.ndim
    placements[at] = Shard(0)
    for mod_name, module in model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            if not specs[f"{mod_name}.{leaf}" if mod_name else leaf] or (
                    isinstance(p, DTensor)):
                continue
            local = torch.chunk(p.detach(), ax.size, 0)[ax.rank].contiguous()
            module._parameters[leaf] = nn.Parameter(DTensor.from_local(
                local, mesh, placements, run_check=False, shape=p.shape,
                stride=p.stride()), requires_grad=p.requires_grad)
    if batch_axis in mesh.mesh_dim_names:
        set_data_axis(model, mesh, batch_axis)
    return model, specs


def shard_batch_ep(mesh, tree: Any, batch_axis: str = "data") -> Any:
    """This rank's rows over ``batch_axis`` of each leaf with a batch axis
    (the same on every expert rank), scalars whole, on its device."""
    device = mesh_device(mesh)
    n = mesh.size(list(mesh.mesh_dim_names).index(batch_axis))
    rank = mesh.get_local_rank(batch_axis)

    def put(x):
        x = torch.as_tensor(x)
        if x.dim():
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} over {n} data ranks")
            x = torch.chunk(x, n, 0)[rank]
        return x.contiguous().to(device)

    return _pytree.tree_map(put, tree)
