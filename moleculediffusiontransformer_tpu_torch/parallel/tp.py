"""Tensor parallelism over a 2-D (data, model) mesh (port of
`parallel/tp.py`).

JAX shards the large kernels on the 'model' axis and lets GSPMD insert the
collectives.  The port holds each sharded parameter as its rank's
``DTensor`` shard (placed ``Shard(dim)`` on 'model', ``Replicate()`` on
'data'), so that a rank keeps about 1/n of those bytes, and the products
run on the shards:

* column-parallel (the output features sharded): the local product on
  ``copy_to(x)``, then the output channels gathered, with a slice for
  backward (every model rank computes the same thing after it);
* row-parallel (the input features sharded): the product of the rank's
  slice of the input (``split_along``), then ``reduce_from``.

A bias (rank 1, never sharded) is added after either.  The kernels take
whole weights: a ``Transformer1d`` stack on the kernel route gathers its
sharded weights (:func:`full`) before each call and casts them afresh, as
GSPMD replicates the operands of a custom call it cannot partition; the
stack's weight cache, keyed on a storage a gathered buffer can reuse, is
dropped.  Any other reader of a sharded parameter takes :func:`full` too.

Grads: a shard's grad is the slice of the grad every model rank computed
alike (never a sum over 'model', which would be n-fold); grads average over
'data' only (``collectives.sync_grads``), and ``ClipAdam``'s global norm sums
each shard's squares once over 'model'.  The resnet-run kernel (K8) is not
taken under tensor parallelism: ``nn.unet`` refuses the pair.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.primitives import Conv1d, ConvTranspose1d, Dense
from .collectives import (Axis, axis, copy_to, gather_along, reduce_from,
                          split_along)
from .fsdp import _jax_dims
from .mesh import mesh_2d

# the torch dim of each module's weight that holds its output features
_OUT_DIM = {Dense: 0, Conv1d: 0, ConvTranspose1d: 1}


def make_mesh_2d(data: int, model: int, device: str = "cuda"):
    """The 2-D ``("data", "model")`` mesh of ``data`` x ``model`` ranks over
    the process group, on the card unless ``device="cpu"``."""
    return mesh_2d(data, model, ("data", "model"), device)


def _axis_size(mesh, name: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(name))


def tensor_parallel_specs(model: nn.Module, mesh, axis: str = "model",
                          min_elements: int = 4096) -> Dict[str, tuple]:
    """Each parameter's spec by name: a tuple with ``axis`` at the torch
    dim sharded and None elsewhere, or ``()`` for one kept whole.  JAX's
    rule, on JAX's layout of each leaf (``fsdp._jax_dims``), so that both
    packages cut every leaf along the same axis: a leaf of rank < 2 or of
    fewer than ``min_elements`` stays whole; a rank-2 (in, out) kernel
    shards 'out' when it divides, else 'in'; a rank-3 (k, in, out) conv
    kernel likewise; any other stays whole.  On a sharded model, the report
    of its placements."""
    from torch.distributed.tensor import DTensor, Shard
    n = _axis_size(mesh, axis)
    at = list(mesh.mesh_dim_names).index(axis)
    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(p, DTensor):
                pl = p.placements[at]
                out[name] = (tuple(axis if i == pl.dim else None
                                   for i in range(p.dim()))
                             if isinstance(pl, Shard) else ())
                continue
            out[name] = ()
            if p.dim() not in (2, 3) or p.numel() < min_elements:
                continue
            dims = _jax_dims(module, leaf, p.dim())   # torch dim of each
            for j in (p.dim() - 1, p.dim() - 2):      # 'out', then 'in'
                if p.shape[dims[j]] % n == 0:
                    out[name] = tuple(axis if i == dims[j] else None
                                      for i in range(p.dim()))
                    break
    return out


def shard_params_tp(model: nn.Module, mesh, axis: str = "model",
                    min_elements: int = 4096) -> Dict[str, tuple]:
    """Replace each parameter ``tensor_parallel_specs`` shards by this
    rank's ``DTensor`` shard of it (in place; every rank must hold the same
    parameters first, ``parallel.mesh.replicate``).  Returns the specs.
    Make the optimizer state after: its moments are then shards too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    specs = tensor_parallel_specs(model, mesh, axis, min_elements)
    n, rank = _axis_size(mesh, axis), mesh.get_local_rank(axis)
    at = list(mesh.mesh_dim_names).index(axis)
    for mod_name, module in model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            spec = specs[f"{mod_name}.{leaf}" if mod_name else leaf]
            if not spec or isinstance(p, DTensor):
                continue
            dim = spec.index(axis)
            placements = [Replicate()] * mesh.ndim
            placements[at] = Shard(dim)
            local = torch.chunk(p.detach(), n, dim)[rank].contiguous()
            module._parameters[leaf] = nn.Parameter(DTensor.from_local(
                local, mesh, placements, run_check=False, shape=p.shape,
                stride=p.stride()), requires_grad=p.requires_grad)
    return specs


def sharding(p) -> Optional[Tuple[Axis, int]]:
    """The mesh axis and the dim a ``DTensor`` parameter is sharded along;
    None for a whole one."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(p, DTensor):
        return None
    for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
        if isinstance(pl, Shard):
            return axis(p.device_mesh, name), pl.dim
    return None


def is_sharded(model: nn.Module) -> bool:
    """Whether any parameter of ``model`` is a sharded ``DTensor``."""
    return any(sharding(p) is not None for p in model.parameters())


def full(p: torch.Tensor) -> torch.Tensor:
    """``p`` whole: a sharded parameter's shards gathered over its axis,
    its grad sliced back to the shard (every rank of the axis computes the
    same thing with it); anything else as it is."""
    where = sharding(p)
    if where is None:
        from torch.distributed.tensor import DTensor
        return p.to_local() if isinstance(p, DTensor) else p
    ax, dim = where
    return gather_along(p.to_local(), ax, dim, "slice")


def product(module: nn.Module, x: torch.Tensor,
            local: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
            ) -> torch.Tensor:
    """``module``'s product on its sharded weight: ``local(x, w)`` is the
    bias-free product of channels-last ``x`` with a weight in the module's
    layout (column-parallel where the weight's output features are sharded,
    row-parallel where its input features are); then the bias."""
    w = module.weight
    ax, dim = sharding(w)
    dtype = module.dtype
    w = w.to_local().to(dtype)
    x = x.to(dtype)
    if dim == _OUT_DIM[type(module)]:
        y = gather_along(local(copy_to(x, ax), w), ax, -1, "slice")
    else:
        y = reduce_from(local(split_along(x, ax, -1), w), ax)
    bias = getattr(module, "bias", None)
    if bias is not None:
        y = y + full(bias).to(dtype)
    return y
