"""Sequence parallelism: the length axis of the activations sharded over a
mesh's 'seq' axis (port of `parallel/sp.py`, whose axis is 'model').

JAX only places the step's inputs (``shard_batch_sp``) and GSPMD inserts,
op by op, the halo exchanges, the K/V gathers and the sums over the length.
The port writes each of them out.  The mesh says the mode:
:func:`make_mesh_sp` names its axes ``("data", "seq")``, where JAX reuses
the tensor-parallel ``("data", "model")`` mesh, so that a train step tells
a sequence mesh from a tensor-parallel one by its names and never from the
model's state.  The axis is set on the model once
(:func:`set_sequence_axis`, which the train steps call for a sequence
mesh): every ``Conv1d``, ``ConvTranspose1d``, ``GroupNorm``, ``Attention``
and ``Transformer1d`` beneath it, and its objective, then read
``seq_axis``.  Each rank holds its rows of the batch (over 'data') and its
contiguous range of the length (over 'seq'):

* a conv with a window across the length (kernel > 1 or a stride) takes a
  halo from each neighbour through ``ppermute``: ``padding`` columns from
  the left, ``kernel - stride - padding`` from the right; the ends of the
  whole sequence get zeros, its padding (the strided downsample, kernel
  2f + 1, stride f, padding f: f columns from the left and 1 from the
  right; the local length must divide by f);
* the transposed-conv upsample (kernel 2f, stride f, padding f/2 + f%2)
  takes ``(kernel - 1 - padding) // f`` input columns from the left and
  ``(padding + f - 1) // f`` from the right (1 and 1 at f = 2 and 4), runs
  unpadded and keeps its own ``f`` x length outputs;
* a GroupNorm sums its statistics over the ranks: the mean, then the
  centred squares (the plain version's two passes);
* self-attention keeps its queries and gathers K/V along the length, whose
  backward is the reduce-scatter of the ranks' parts: the streaming
  kernels then run at n = L / ranks and m = L.  A relative position bias
  (self- or cross-attention) takes the rank's query positions in the
  whole sequence, as GSPMD computes it on global positions.  A stack on
  the fused route (K1) gathers x, runs on the whole sequence and keeps its
  rows, as GSPMD does around a Pallas call;
* the loss's means: the local sum, summed over the ranks
  (``reduce_from``: every rank has the same loss after it), over the
  global count.

Nearest upsampling, ``Patcher``/``Unpatcher`` and the per-token ops are
local.  The trap at the edges: the halo at the ends of the whole sequence
is zeros, not a neighbour's; the tests hold levels whose local length
equals the halo.  A parameter's grad on a rank is its rows' part:
``collectives.sync_grads`` sums them over 'seq'.  The step's draws are
the global batch's (``trainer.global_draws``), each rank keeping its
(rows, length) block, so the step equals one process's up to the order
of the sums, as JAX's threefry noise is the same wherever it is placed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree

from .collectives import (Axis, axis, gather_along, ppermute, psum,
                          reduce_from)
from .mesh import mesh_2d, mesh_device

SEQ_AXIS = "seq"


def make_mesh_sp(data: int, seq: int, device: str = "cuda"):
    """The 2-D ``("data", "seq")`` mesh of ``data`` x ``seq`` ranks over the
    process group, on the card unless ``device="cpu"``: each rank its rows
    over 'data' and its range of the length over 'seq'."""
    return mesh_2d(data, seq, ("data", SEQ_AXIS), device)


def seq_sharding(mesh, batch_axis: str = "data",
                 seq_axis: str = SEQ_AXIS) -> list:
    """The placement of a (b, L, ...) tensor: its batch over
    ``batch_axis``, its length over ``seq_axis``."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    out = [None] * len(names)
    out[names.index(batch_axis)] = Shard(0)
    out[names.index(seq_axis)] = Shard(1)
    return out


def _block(x: torch.Tensor, mesh, dims: Tuple[str, ...]) -> torch.Tensor:
    """This rank's contiguous block of ``x``: dim i cut over ``dims[i]``."""
    for d, name in enumerate(dims):
        n = mesh.size(list(mesh.mesh_dim_names).index(name))
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over the {n} ranks of '{name}'")
        x = torch.chunk(x, n, d)[mesh.get_local_rank(name)]
    return x


def shard_seq(mesh, tree: Any, batch_axis: str = "data",
              seq_axis: str = SEQ_AXIS) -> Any:
    """This rank's part of each (global) leaf of ``tree``, on its device,
    by JAX's rank routing: rank >= 3 its (rows, length) block, rank 2 its
    rows, rank 1 and scalars whole."""
    device = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        dims = ((batch_axis, seq_axis) if x.dim() >= 3 else
                (batch_axis,) if x.dim() == 2 else ())
        return _block(x, mesh, dims).contiguous().to(device)

    return _pytree.tree_map(put, tree)


def shard_batch_sp(mesh, conditioning: Any, target: Any,
                   batch_axis: str = "data", seq_axis: str = SEQ_AXIS):
    """A diffusion step's batch placed sequence-parallel: ``conditioning``
    (b, n) by rows, ``target`` (b, L, C) by (rows, length)."""
    device = mesh_device(mesh)
    cond = _block(torch.as_tensor(conditioning), mesh, (batch_axis,))
    tgt = _block(torch.as_tensor(target), mesh, (batch_axis, seq_axis))
    return cond.contiguous().to(device), tgt.contiguous().to(device)


def set_sequence_axis(model: nn.Module, mesh, seq_axis: str = SEQ_AXIS
                      ) -> Axis:
    """Set the sequence axis on every module of ``model`` that reads it
    (and on its objective), once; returns the axis."""
    from ..nn.attention import Attention, Transformer1d
    from ..nn.primitives import Conv1d, ConvTranspose1d, GroupNorm
    ax = axis(mesh, seq_axis)
    for m in model.modules():
        if isinstance(m, (Conv1d, ConvTranspose1d, GroupNorm, Transformer1d,
                          Attention)):
            m.seq_axis = ax
    objective = getattr(model, "objective", None)
    if objective is not None:
        if getattr(objective, "dynamic_threshold", 0.0):
            raise ValueError("a dynamic threshold is a quantile over the "
                             "whole length: not sequence-parallel")
        model.objective = dataclasses.replace(objective, seq_axis=ax)
    return ax


def sequence_axis(model: nn.Module):
    """The sequence axis set on ``model``'s objective, or None."""
    objective = getattr(model, "objective", None)
    return getattr(objective, "seq_axis", None)


# ------------------------------------------------------------- the ops --

def halo(x: torch.Tensor, ax: Axis, left: int, right: int) -> torch.Tensor:
    """(b, Lr, C) -> (b, left + Lr + right, C): the last ``left`` columns
    of the rank before and the first ``right`` of the rank after, zeros
    past the ends of the whole sequence."""
    length = x.shape[1]
    if left > length or right > length:
        raise ValueError(f"a local length of {length} is shorter than its "
                         f"halo ({left}, {right})")
    n = ax.size
    parts = [x]
    if left:
        parts.insert(0, ppermute(x[:, length - left:], ax,
                                 [(i, i + 1) for i in range(n - 1)]))
    if right:
        parts.append(ppermute(x[:, :right], ax,
                              [(i + 1, i) for i in range(n - 1)]))
    return torch.cat(parts, dim=1)


def conv1d(module, x: torch.Tensor) -> torch.Tensor:
    """``nn.primitives.Conv1d`` on this rank's slice of the length."""
    k, s, p = module.kernel_size, module.stride, module.padding
    if x.shape[1] % s:
        raise ValueError(f"a local length of {x.shape[1]} does not divide "
                         f"by the stride {s}")
    if k - s - p < 0:
        raise ValueError(f"conv k {k}, stride {s}, padding {p}: its windows "
                         f"skip columns")
    dtype = module.dtype
    xh = halo(x.to(dtype), module.seq_axis, p, k - s - p)
    y = F.conv1d(xh.transpose(1, 2), module.weight.to(dtype),
                 module.bias.to(dtype), stride=s)
    return y.transpose(1, 2)


def conv_transpose1d(module, x: torch.Tensor) -> torch.Tensor:
    """``nn.primitives.ConvTranspose1d`` on this rank's slice of the
    length: the inputs that reach its outputs, unpadded, its own
    ``stride`` x length outputs kept."""
    k, f, p = module.kernel_size, module.stride, module.padding
    left, right = (k - 1 - p) // f, (p + f - 1) // f
    dtype = module.dtype
    length = x.shape[1]
    xh = halo(x.to(dtype), module.seq_axis, left, right)
    y = F.conv_transpose1d(xh.transpose(1, 2), module.weight.to(dtype),
                           module.bias.to(dtype), stride=f)
    return y[:, :, left * f + p:left * f + p + length * f].transpose(1, 2)


def group_stats(xf: torch.Tensor, ax: Axis
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A GroupNorm's mean and biased variance over dims (1, 3) of the
    (b, Lr, groups, C/groups) float32 ``xf`` and the other ranks' slices."""
    count = xf.shape[1] * xf.shape[3] * ax.size
    mean = psum(xf.sum(dim=(1, 3), keepdim=True), ax) / count
    var = psum((xf - mean).square().sum(dim=(1, 3), keepdim=True),
               ax) / count
    return mean, var


def gather_length(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The whole length of ``x`` (b, Lr, C), its grad the ranks' parts
    summed and sliced back."""
    return gather_along(x, ax, 1, "reduce_scatter")


def own_rows(y: torch.Tensor, ax: Axis) -> torch.Tensor:
    """This rank's slice of the length of a whole-length ``y``."""
    n = y.shape[1] // ax.size
    return y.narrow(1, ax.rank * n, n)


def mean(t: torch.Tensor, ax: Axis, dims=None) -> torch.Tensor:
    """The mean of ``t`` over ``dims`` (every dim when None), whose dim 1
    is this rank's slice of the length: the local sum summed over the
    ranks, over the global count.  Every rank has the same value after."""
    dims = tuple(range(t.dim())) if dims is None else tuple(dims)
    count = int(np.prod([t.shape[d] for d in dims])) * ax.size
    return reduce_from(t.sum(dim=dims), ax) / count
