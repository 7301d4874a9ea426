"""Mixture-of-Experts feed-forward (port of `nn/moe.py`): a GShard/Switch
style sparsely activated FF, the JAX package's extension of the GPT.

* router: a bias-free (dim, E) matrix ``router``; probabilities by a float32
  softmax; top-k experts a token, their gates renormalised over the k.
* capacity: an expert takes at most ``moe_capacity(T, E, k, factor)`` tokens
  (T = b * n).  Slot 0 picks of every token come before slot 1 picks
  (GShard's priority), and within a slot earlier tokens first.  A token past
  capacity is dropped from that expert: its contribution is exactly zero.
* load-balance loss (Switch eq. 4): ``E * sum_e f_e * p_e``, f_e the share
  of tokens whose top-1 pick is e, p_e the mean router probability of e.
  The JAX module ``sow``s it; this one keeps the last value as ``aux_loss``
  for the model to gather.

The experts are stacked: ``w_in`` (E, dim, hidden) and ``w_out`` (E, hidden,
dim), each expert ``Linear -> GELU -> Linear`` without biases.  Routing
(softmax, cumulative sums, combine) is float32 throughout; the expert
products run in the compute dtype.

Over a mesh (``parallel/ep.py``): with ``w_in``/``w_out`` expert-parallel
``DTensor`` shards, each rank runs only its experts on the tokens and
takes its experts' columns of the dispatch and combine weights; the tokens
and the (t, k) gates enter through ``copy_to``, whose backward sums each
rank's part of their grads over 'expert' (t x k floats for the gates, not
the (t, E, capacity) combine), and ``reduce_from`` sums the partial
combines.  With
``data_axis`` set, T, the capacity, the slot-major priority and the
load-balance loss are the global batch's, as GSPMD keeps them: a data
rank's positions follow the picks of the data ranks before it.
``dropped`` counts the picks past capacity (this rank's tokens).

The dispatch is the dense (T, E, capacity) one-hot of the JAX package, as it
is: its float32 tensors take ``T * E * capacity * 4`` bytes each (2.7 GB at
16,384 tokens, 8 experts, top 2).  An index-based dispatch is queued in
ROADMAP.md.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from .primitives import default_init, gelu


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity (a python int)."""
    return max(1, int(math.ceil(
        num_tokens * top_k * capacity_factor / num_experts)))


class MoEFeedForward(nn.Module):
    """Sparsely activated FF over (b, n, dim): no norm of its own (callers
    wrap it like the dense FF it replaces); ``hidden = dim * mult``.
    Parameters in the JAX package's layout (``router`` (dim, E) is not a
    torch Linear weight)."""

    def __init__(self, dim: int, num_experts: int, mult: int = 4,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in 1..{num_experts}")
        self.dim, self.num_experts, self.top_k = dim, num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        hidden = int(dim * mult)
        self.router = nn.Parameter(torch.empty(dim, num_experts))
        self.w_in = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.aux_loss: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None
        # parallel.ep.set_data_axis: the data axis of a mesh, over which T,
        # the capacity, the priority and the aux loss are global
        self.data_axis = None
        default_init(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in dim for the router
        and ``w_in``, hidden for ``w_out`` (torch's Linear init)."""
        with torch.no_grad():
            for p, fan_in in ((self.router, self.dim), (self.w_in, self.dim),
                              (self.w_out, self.w_out.shape[1])):
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=generator)

    def capacity(self, num_tokens: int) -> int:
        return moe_capacity(num_tokens, self.num_experts, self.top_k,
                            self.capacity_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        if d != self.dim:
            raise ValueError(f"input width {d}, expected {self.dim}")
        e, k = self.num_experts, self.top_k
        t = b * n
        data = self.data_axis
        ranks = 1 if data is None else data.size
        cap = self.capacity(t * ranks)

        # routing, float32 throughout
        xt = x.reshape(t, d)
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)          # (t, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        w_in, w_out = self.w_in, self.w_out
        expert = isinstance(w_in, DTensor)
        if expert:
            # expert parallelism: this rank's experts and their columns of
            # the dispatch and combine weights; each rank's grads of the
            # gates and tokens reach only its experts, so they sum
            from ..parallel import tp
            from ..parallel.collectives import copy_to
            ax, _ = tp.sharding(w_in)
            w_in, w_out = w_in.to_local(), w_out.to_local()
            lo, el = ax.rank * w_in.shape[0], w_in.shape[0]
            gate_vals = copy_to(gate_vals, ax)
        picks = [nn.functional.one_hot(gate_idx[:, j], e).float()
                 for j in range(k)]                                 # (t, e)
        counts = torch.stack([m.sum(dim=0) for m in picks])         # (k, e)
        before = torch.zeros_like(counts)
        if data is not None:
            from ..parallel.collectives import gather_stacked
            every = gather_stacked(counts, data)                # (ranks, k, e)
            before, counts = every[:data.rank].sum(dim=0), every.sum(dim=0)

        # capacity: slot-major priority; a position past the capacity (or
        # before a token's first pick) selects no slot, as jax.nn.one_hot
        # of an index out of range gives zeros
        slots = torch.arange(cap, device=x.device)
        dispatch = torch.zeros(t, e, cap, device=x.device)
        combine = torch.zeros(t, e, cap, device=x.device)
        used = torch.zeros(e, device=x.device)
        dropped = torch.zeros((), device=x.device)
        for j, m in enumerate(picks):
            pos = torch.cumsum(m, dim=0) - 1.0 + (used + before[j])[None, :]
            used = used + counts[j]
            keep = m * (pos < cap)
            dropped = dropped + (m - keep).sum()
            slot = ((pos.long()[..., None] == slots).float()
                    * keep[..., None])
            dispatch = dispatch + slot
            combine = combine + slot * gate_vals[:, j, None, None]
        self.dropped = dropped

        # load-balance loss from the top-1 fractions
        frac, mean_probs = picks[0].mean(dim=0), probs.mean(dim=0)
        if data is not None:
            # the sum of the probabilities feeds every data rank's loss,
            # which the step averages: its backward sums too (psum)
            from ..parallel.collectives import psum, reduce_from
            frac = reduce_from(picks[0].sum(dim=0), data) / (t * ranks)
            mean_probs = psum(probs.sum(dim=0), data) / (t * ranks)
        self.aux_loss = e * (frac * mean_probs).sum()

        if expert:
            xt = copy_to(xt, ax)
            dispatch, combine = (dispatch[:, lo:lo + el],
                                 combine[:, lo:lo + el])
        disp = torch.einsum("tec,td->ecd", dispatch.to(self.dtype),
                            xt.to(self.dtype))
        h = gelu(torch.einsum("ecd,edh->ech", disp, w_in.to(self.dtype)))
        y_e = torch.einsum("ech,ehd->ecd", h, w_out.to(self.dtype))
        y = torch.einsum("tec,ecd->td", combine, y_e.float())
        if expert:
            from ..parallel.collectives import reduce_from
            y = reduce_from(y, ax)
        return y.reshape(b, n, d).to(self.dtype)
