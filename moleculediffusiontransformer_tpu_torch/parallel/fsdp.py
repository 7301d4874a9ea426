"""Fully-sharded data parallelism over the 'data' mesh (port of
`parallel/fsdp.py`).

JAX places the state with ``NamedSharding``s and lets XLA insert the
all-gathers and reduce-scatters.  The port applies PyTorch's FSDP2
(``torch.distributed.fsdp.fully_shard``) to each UNet block and to the
root: a block's parameters are gathered just before its forward (and again
for its backward) and freed after, its grads are reduce-scattered, and
between steps every rank holds only its shard.  The Adam moments are
allocated as the parameters' local shards (``DTensor``s placed as their
parameters), so the state a rank holds drops about n-fold.
``train.trainer.ClipAdam.update`` works on the local shards and
all-reduces the clip's sum of squares.

Which dim is sharded is JAX's rule (``fsdp_specs``): the largest dim
divisible by the mesh size, ties to the dim JAX's layout of the same
weight lists first (the port keeps torch layouts: a dense kernel (in, out)
is (out, in) here, a conv's (k, in, out) is (out, in, k)), so both packages
cut every weight along the same axis.  ``min_elements`` (``TrainConfig.
fsdp_min_elements``) means in the port what it means in JAX: a parameter of
fewer elements (biases, norm scales), or with no divisible dim, stays
whole on every rank.  FSDP2 shards every parameter of a module it wraps, so
those are handed to it as ``ignored_params``; the train step averages their
grads over the mesh as it does under plain data parallelism.

The kernels' weight caches (``Transformer1d.kernel_params``, the resnet
runs' ``WeightCache``) are keyed on each parameter's storage and version,
which FSDP2's free-and-gather cycle can leave as they were while the
values change: each wrapped module drops the caches beneath it before its
forward, so the kernels always read this step's weights.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Tuple

import torch
from torch import nn

from ..nn.attention import Transformer1d
from ..nn.primitives import Conv1d, ConvTranspose1d, Dense
from ..nn.unet import BottleneckBlock1d, DownsampleBlock1d, UpsampleBlock1d
from ..ops.resnet_fusion import WeightCache

# the torch dim of each dim of a weight in JAX's layout, by module
_JAX_DIMS = {Dense: (1, 0), Conv1d: (2, 1, 0), ConvTranspose1d: (2, 0, 1)}
# the modules wrapped one by one (the root is wrapped last)
BLOCKS = (DownsampleBlock1d, BottleneckBlock1d, UpsampleBlock1d)


def _jax_dims(module: nn.Module, leaf: str, ndim: int) -> Tuple[int, ...]:
    dims = _JAX_DIMS.get(type(module)) if leaf == "weight" else None
    return dims if dims is not None and len(dims) == ndim \
        else tuple(range(ndim))


def fsdp_specs(model: nn.Module, mesh, axis: str = "data",
               min_elements: int = 16384) -> Dict[str, tuple]:
    """Each parameter's spec by name: a tuple with ``axis`` at the dim
    sharded and None at the others, or ``()`` for a parameter kept whole
    (JAX's ``PartitionSpec`` as a tuple).  A parameter of at least
    ``min_elements`` is sharded along its largest dim divisible by the
    mesh size, among equal dims the one JAX's layout lists first; the
    others stay whole.  On a model already sharded, the report of its
    ``DTensor`` placements."""
    from torch.distributed.tensor import DTensor, Shard
    n = mesh.size()
    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(p, DTensor):
                dims = [pl.dim for pl in p.placements if isinstance(pl, Shard)]
                out[name] = tuple(axis if dims and i == dims[0] else None
                                  for i in range(p.dim())) if dims else ()
                continue
            shape = tuple(p.shape)
            out[name] = ()
            if not shape or p.numel() < min_elements:
                continue
            order = _jax_dims(module, leaf, len(shape))
            for d in sorted(order, key=lambda d: -shape[d]):
                if shape[d] % n == 0:
                    out[name] = tuple(axis if i == d else None
                                      for i in range(len(shape)))
                    break
    return out


def _drop_kernel_caches(module: nn.Module, args) -> None:
    """A forward pre-hook: the kernel weight caches beneath ``module`` are
    rebuilt from the parameters FSDP2 has just gathered."""
    for m in module.modules():
        if isinstance(m, Transformer1d):
            m.drop_kernel_cache()
        cache = getattr(m, "resnet_weights", None)
        if isinstance(cache, WeightCache):
            cache.drop()


def _local_shard(full: torch.Tensor, like) -> Any:
    """``full`` cut as the sharded parameter ``like`` is: a ``DTensor``
    with ``like``'s mesh and placements holding this rank's slice."""
    from torch.distributed.tensor import DTensor, Shard
    (placement,) = like.placements
    local = full
    if isinstance(placement, Shard):
        mesh = like.device_mesh
        local = torch.chunk(full, mesh.size(), dim=placement.dim)[
            mesh.get_local_rank()]
    return DTensor.from_local(local.contiguous().to(like.device),
                              like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def shard_state_fsdp(model: nn.Module, state, mesh, axis: str = "data",
                     min_elements: int = 16384) -> Tuple[Any, Dict]:
    """Shard ``model`` with FSDP2 over ``mesh`` (each UNet block, then the
    root) and ``state`` (a ``train.trainer.TrainState`` whose moments
    follow ``model.parameters()``) with it, in place: each moment becomes
    its parameter's shard of the full moment every rank holds.  Every rank
    must hold the same parameters first (``parallel.mesh.replicate``).
    Returns ``(state, specs)``, ``specs`` as ``fsdp_specs`` gives them."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Shard
    specs = fsdp_specs(model, mesh, axis, min_elements)
    named = dict(model.named_parameters())
    whole = {p for name, p in named.items() if not specs[name]}
    dims = {p: specs[name].index(axis) for name, p in named.items()
            if specs[name]}

    def wrap(module: nn.Module) -> None:
        fully_shard(module, mesh=mesh, ignored_params=whole,
                    shard_placement_fn=lambda p: Shard(dims[p]))
        module.register_forward_pre_hook(_drop_kernel_caches)

    for module in [m for m in model.modules() if isinstance(m, BLOCKS)]:
        wrap(module)
    wrap(model)
    if state is not None:
        adam = state.opt_state
        params = list(model.parameters())
        adam.mu = [_local_shard(m, p) if isinstance(p, DTensor) else m
                   for m, p in zip(adam.mu, params)]
        adam.nu = [_local_shard(v, p) if isinstance(p, DTensor) else v
                   for v, p in zip(adam.nu, params)]
    return state, specs


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """The block with every FSDP-sharded module of ``model`` gathered whole
    on every rank (a collective: every rank enters it), so that any of the
    model's methods runs, not only its forward; resharded after.  Nothing
    happens to a model FSDP does not shard."""
    from torch.distributed.fsdp import FSDPModule
    sharded = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for m in sharded:
        m.unshard()
    if sharded:
        _drop_kernel_caches(model, None)
    try:
        yield
    finally:
        for m in sharded:
            m.reshard()
