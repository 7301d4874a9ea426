"""The collectives every parallel axis rests on, over one named axis of a
``DeviceMesh``, each with the backward that autograd needs.

JAX gets its axes from GSPMD, which places the arrays and inserts the
collectives and their transposes.  PyTorch has no such pass, so the port
writes them out once here:

* Megatron's pair: :func:`copy_to` is the identity forward and a sum over
  the axis backward (a replicated input entering per-rank work: each rank's
  grad is a part of the whole); :func:`reduce_from` is a sum forward and
  the identity backward (the parts leaving it, where every rank then
  computes the same thing).  The trap this pair avoids: where every rank of
  an axis computes the same thing after a sum, the sum's backward is the
  identity; a backward that sums again scales the grads by the axis size.
  A loss does not show that; a grad does.
* :func:`psum`: a sum forward and a sum backward, for a sum whose result
  each rank then uses on its own part (a norm's statistics over a length
  that is sharded).
* :func:`gather_along` and :func:`split_along`: the whole tensor from the
  ranks' slices, and a rank's slice of a whole one.  The caller names the
  gather's backward: a reduce-scatter where each rank's downstream work
  differs (its grad is a part of the whole's), or a slice where every rank
  computes the same thing (its grad is the whole's already).
* :func:`ppermute`: ``lax.ppermute``: each rank sends to the rank a
  permutation names and receives from the one naming it (zeros where none
  does); its backward is the reverse permutation, as JAX transposes it.

gloo, which two ranks sharing one card need (NCCL refuses a card twice),
takes some collectives on CUDA tensors itself (it stages them through the
host) and passes others the device pointer.  The collectives in
``GLOO_STAGED`` (``chip_smoke.py`` phase 33's probe says which) are moved
through pinned host buffers here: the route is chosen from the group's
backend and the tensor's device before the call, never by retrying after a
failure, and every staged call is counted in ``STAGED``.  Under NCCL
nothing is staged.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

# what gloo does not take on CUDA tensors, of what these helpers call
GLOO_STAGED = frozenset({"send_recv"})
# staged calls, by collective
STAGED: collections.Counter = collections.Counter()
# seconds in each collective while ``timing()`` is on
SECONDS: collections.Counter = collections.Counter()
_TIMING = [False]


@contextlib.contextmanager
def timing() -> Iterator[collections.Counter]:
    """Time every collective of the block into ``SECONDS`` (cleared first):
    each call synchronises the card before and after, so that its time is
    its own and not the queue's (which serialises the step: a measurement
    of the collectives' share, not of the step's speed)."""
    SECONDS.clear()
    _TIMING[0] = True
    try:
        yield SECONDS
    finally:
        _TIMING[0] = False


@contextlib.contextmanager
def _timed(name: str, t: torch.Tensor) -> Iterator[None]:
    if not _TIMING[0]:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    SECONDS[name] += time.perf_counter() - t0


class Axis:
    """One named axis of a mesh: its process group, its size, this rank's
    index along it and the global rank at each index."""

    def __init__(self, mesh, name: str):
        self.mesh, self.name = mesh, name
        self.group = mesh.get_group(name)
        self.size = mesh.size(list(mesh.mesh_dim_names).index(name))
        self.rank = mesh.get_local_rank(name)
        self.ranks = [dist.get_global_rank(self.group, i)
                      for i in range(self.size)]
        self.backend = dist.get_backend(self.group)

    def staged(self, t: torch.Tensor, collective: str) -> bool:
        """Whether ``collective`` on ``t`` goes through the host."""
        return (self.backend == "gloo" and t.is_cuda
                and collective in GLOO_STAGED)


@functools.lru_cache(maxsize=None)
def axis(mesh, name: str) -> Axis:
    """The :class:`Axis` ``name`` of ``mesh`` (made once a mesh)."""
    return Axis(mesh, name)


# ----------------------------------------------------------- the calls --

def _all_reduce(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the axis, into a fresh tensor."""
    out = t.contiguous().clone()
    if ax.size > 1:
        with _timed("all_reduce", out):
            dist.all_reduce(out, group=ax.group)
    return out


def _all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim``, in axis order."""
    if ax.size == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ax.size * x.shape[0], *x.shape[1:]))
    with _timed("all_gather", x):
        dist.all_gather_into_tensor(out, x, group=ax.group)
    return out.movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The sum over the axis of ``g``, this rank's slice along ``dim``."""
    if ax.size == 1:
        return g
    g = g.movedim(dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // ax.size, *g.shape[1:]))
    with _timed("reduce_scatter", g):
        dist.reduce_scatter_tensor(out, g, group=ax.group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


def _ppermute(x: torch.Tensor, ax: Axis,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` along ``perm`` (pairs of axis indices); what this rank
    receives, or zeros where no pair names it."""
    me = ax.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return x.clone()
    with _timed("send_recv", x):
        return _send_recv(x, ax, me, dst, src)


def _send_recv(x, ax, me, dst, src) -> torch.Tensor:
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    send, recv = x.contiguous(), out
    staged = ax.staged(x, "send_recv")
    if staged:
        send = torch.empty(send.shape, dtype=send.dtype, pin_memory=True
                           ).copy_(send)
        recv = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        STAGED["send_recv"] += 1
    ops = [dist.P2POp(dist.isend, send, ax.ranks[d], ax.group) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, ax.ranks[s], ax.group) for s in src]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged and src:
        out.copy_(recv)
    return out


# ----------------------------------------------- the autograd functions --

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, backward):
        ctx.ax, ctx.dim, ctx.backward_kind = ax, dim, backward
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_kind == "reduce_scatter":
            return _reduce_scatter(g, ctx.ax, ctx.dim), None, None, None
        return _slice(g, ctx.ax, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _slice(x, ax, dim).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _ppermute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.ax, back), None, None


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Identity forward; the grad summed over the axis backward."""
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the axis forward; the identity backward (every rank
    computes the same thing after it)."""
    return _ReduceFrom.apply(x, ax)


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the axis forward and backward (each rank uses the sum
    on its own part)."""
    return _Psum.apply(x, ax)


def gather_along(x: torch.Tensor, ax: Axis, dim: int,
                 backward: str) -> torch.Tensor:
    """The ranks' slices joined along ``dim``.  ``backward``:
    "reduce_scatter" where each rank's downstream work differs, "slice"
    where every rank computes the same thing."""
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"backward must be 'reduce_scatter' or 'slice', "
                         f"got {backward!r}")
    return _Gather.apply(x, ax, dim % x.dim(), backward)


def split_along(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank holds whole;
    its grad gathered back (every rank's part of the whole's grad)."""
    return _Split.apply(x, ax, dim % x.dim())


def ppermute(x: torch.Tensor, ax: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` pairs (source, destination) of axis
    indices; zeros where no pair sends to this rank.  Backward: the reverse
    permutation."""
    return _PPermute.apply(x, ax, tuple(map(tuple, perm)))


# --------------------------------------------------------- train steps --

def sync_grads(mesh, grads: List[torch.Tensor], loss: torch.Tensor, *,
               partial: bool) -> None:
    """The grads and loss of a step over a 2-D mesh (``data``, X), in
    place: the loss and every grad averaged over ``data``; a grad of a
    parameter X does not shard (not a ``DTensor``) also over X, summed where
    ``partial`` (sequence parallelism: each X rank holds its rows' part of
    it) and averaged otherwise (a mean of the equal grads that every X rank
    computed: no rank's last bits drift, where a sum would be X-fold)."""
    with _timed("grads", loss):
        _sync_grads(mesh, grads, loss, partial)


def _sync_grads(mesh, grads, loss, partial) -> None:
    from torch.distributed.tensor import DTensor

    from .mesh import _coalesced, all_reduce_mean
    data, other = mesh.mesh_dim_names
    whole = [g for g in grads if not isinstance(g, DTensor)]
    sharded = [g.to_local() for g in grads if isinstance(g, DTensor)]
    x_mesh = mesh[other]
    if x_mesh.size() > 1 and whole:
        if partial:
            _coalesced(whole, lambda flat: dist.all_reduce(
                flat, group=x_mesh.get_group()))
        else:
            all_reduce_mean(x_mesh, whole)
    if mesh[data].size() > 1:
        all_reduce_mean(mesh[data], [loss, *whole, *sharded])


def gather_stacked(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every rank's ``t``, stacked in axis order (no grad): (size,
    *t.shape)."""
    return _all_gather(t[None], ax, 0)
