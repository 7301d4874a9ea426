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

from .primitives import gelu


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
        self.reset_parameters()

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
        cap = self.capacity(t)

        # routing, float32 throughout
        xt = x.reshape(t, d)
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)          # (t, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        # capacity: slot-major priority; a position past the capacity (or
        # before a token's first pick) selects no slot, as jax.nn.one_hot
        # of an index out of range gives zeros
        slots = torch.arange(cap, device=x.device)
        dispatch = torch.zeros(t, e, cap, device=x.device)
        combine = torch.zeros(t, e, cap, device=x.device)
        used = torch.zeros(e, device=x.device)
        for j in range(k):
            m = nn.functional.one_hot(gate_idx[:, j], e).float()      # (t, e)
            pos = torch.cumsum(m, dim=0) - 1.0 + used[None, :]
            used = used + m.sum(dim=0)
            keep = m * (pos < cap)
            slot = ((pos.long()[..., None] == slots).float()
                    * keep[..., None])
            dispatch = dispatch + slot
            combine = combine + slot * gate_vals[:, j, None, None]

        # load-balance loss from the top-1 fractions
        frac = nn.functional.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
        self.aux_loss = e * (frac * probs.mean(dim=0)).sum()

        disp = torch.einsum("tec,td->ecd", dispatch.to(self.dtype),
                            xt.to(self.dtype))
        h = gelu(torch.einsum("ecd,edh->ech", disp,
                              self.w_in.to(self.dtype)))
        y_e = torch.einsum("ech,ehd->ecd", h, self.w_out.to(self.dtype))
        y = torch.einsum("tec,ecd->td", combine, y_e.float())
        return y.reshape(b, n, d).to(self.dtype)
