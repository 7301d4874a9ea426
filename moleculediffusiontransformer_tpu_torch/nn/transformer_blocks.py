"""Building blocks of the autoregressive transformer models (port of
`nn/transformer_blocks.py`, the parts the Sequence decoder needs): Gumbel /
top-k sampling, the gamma-only LayerNorm (and the affine one under its torch
name) and multi-query attention with a learned null KV.

Distinct from ``nn/attention.py`` (the UNet's attention): one shared KV head
that serves as keys and values, a learned null KV prepended for
classifier-free guidance, bias-free projections.  Every attention module has
a ``step`` / ``cross_step`` pair so that generation runs position by position
against fixed-size KV caches.

The attention core is plain multi-query math (``torch.matmul``): the JAX
package's ``packed_shared_kv_sdpa`` packs batch elements for the TPU's matrix
unit and computes exactly this.  Module and parameter names are the reference
torch keys (``to_q.1.weight``, ``to_out.2.gamma``, ``null_kv``).

torch cannot reproduce JAX's threefry draws, so whatever samples takes a
``torch.Generator`` or the uniforms themselves.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .primitives import Dense, LayerNorm

NEG_INF = -torch.finfo(torch.float32).max


# ------------------------------------------------------------- sampling ----

def log_eps(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(t + eps)


def _uniform(shape: Sequence[int], generator: Optional[torch.Generator],
             device) -> torch.Tensor:
    if generator is not None:
        device = generator.device
    return torch.rand(tuple(shape), generator=generator, device=device)


def gumbel_noise(uniforms: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms in [0, 1)."""
    return -log_eps(-log_eps(uniforms))


def gumbel_sample(logits: torch.Tensor, temperature: float = 1.0,
                  dim: int = -1, *,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-max sampling; the uniforms (of the logits' shape) are handed in
    or drawn from ``generator`` on the logits' device."""
    if uniforms is None:
        uniforms = _uniform(logits.shape, generator, logits.device)
    noise = gumbel_noise(uniforms.to(logits.device))
    return torch.argmax(logits / temperature + noise, dim=dim)


def top_k_filter(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Keep the top ``(1 - thres)`` fraction of the vocabulary (at least one
    entry), ``NEG_INF`` the rest."""
    k = max(int((1 - thres) * logits.shape[-1]), 1)
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def prob_mask_like(shape: Sequence[int], prob: float, *,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """The CFG keep-mask: True with probability ``prob``."""
    if prob == 1:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    if uniforms is None:
        uniforms = _uniform(shape, generator, device)
    return uniforms < prob


# ---------------------------------------------------------------- norms ----

class LNGamma(nn.Module):
    """LayerNorm with a learned ``gamma`` and no beta; float32 statistics,
    output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.gamma = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)
                * self.gamma.float()).to(self.dtype)


# The JAX package's ``TorchLayerNorm``: the affine LayerNorm under torch's
# names (``weight``, ``bias``), eps 1e-5, float32 statistics, output in
# ``dtype`` -- the primitives' ``LayerNorm`` computes exactly this.
TorchLayerNorm = LayerNorm


# ------------------------------------------------------------ attention ----

def _keep_null(mask: torch.Tensor) -> torch.Tensor:
    """A (..., j) keep-mask with a True column for the null KV in front."""
    return F.pad(mask, (1, 0), value=True)


class MQAttention(nn.Module):
    """Multi-query attention: one shared KV projection that serves as keys
    and values, with a learned null KV prepended for CFG.

    q is scaled before the product with the keys; scores and softmax are
    float32 and the probabilities are cast to the compute dtype before the
    product with the values; the causal mask is offset so that the null
    position is always visible.
    """

    def __init__(self, dim: int, context_dim: Optional[int] = None,
                 dim_head: int = 64, heads: int = 8, causal: bool = False,
                 norm_context: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        self.causal, self.dtype = causal, dtype
        kv_in = dim if context_dim is None else context_dim
        self.norm = LNGamma(dim, dtype=dtype)
        self.norm_context_mod = (LNGamma(kv_in, dtype=dtype) if norm_context
                                 else None)
        # index 0 of each Sequential holds no parameters in the reference
        # either (a dropout of 0, a rearrange)
        self.to_q = nn.Sequential(
            nn.Identity(), Dense(dim, heads * dim_head, bias=False,
                                 dtype=dtype))
        self.to_kv = nn.Sequential(
            nn.Identity(), Dense(kv_in, dim_head, bias=False, dtype=dtype))
        self.to_out = nn.Sequential(
            nn.Identity(), Dense(heads * dim_head, dim, bias=False,
                                 dtype=dtype), LNGamma(dim, dtype=dtype))
        self.null_kv = nn.Parameter(torch.empty(dim_head))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.null_kv.normal_(0.0, 1.0, generator=generator)

    def kv(self, context: torch.Tensor) -> torch.Tensor:
        """Project the context to the shared KV track and prepend the null
        KV: (b, 1 + m, dim_head)."""
        if self.norm_context_mod is not None:
            context = self.norm_context_mod(context)
        kv = self.to_kv(context)
        null = self.null_kv.to(kv.dtype).expand(kv.shape[0], 1, self.dim_head)
        return torch.cat([null, kv], dim=1)

    def _queries(self, x: torch.Tensor) -> torch.Tensor:
        """Normed x (b, n, dim) -> scaled queries (b, h, n, d)."""
        b, n, _ = x.shape
        q = self.to_q(x) * (self.dim_head ** -0.5)
        return q.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def _attend(self, q: torch.Tensor, kv: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q (b, h, n, d); kv (b, j, d); mask broadcastable to (b, 1, n, j),
        True = keep."""
        b, h, n, d = q.shape
        sim = torch.matmul(q.float(), kv.float().transpose(1, 2)[:, None])
        if mask is not None:
            sim = torch.where(mask, sim, NEG_INF)
        attn = torch.softmax(sim, dim=-1).to(self.dtype)
        out = torch.matmul(attn, kv.to(self.dtype)[:, None])
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[1]
        x = self.norm(x)
        q = self._queries(x)
        kv = self.kv(x if context is None else context)
        j = kv.shape[1]
        mask = None
        if context_mask is not None:
            mask = _keep_null(context_mask)[:, None, None, :]
        if self.causal:
            causal = ~torch.ones(n, j, dtype=torch.bool,
                                 device=x.device).triu(j - n + 1)
            mask = causal if mask is None else (mask & causal)
        return self._attend(q, kv, mask)

    def step(self, x_t: torch.Tensor, cache: torch.Tensor, pos: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One causal decode step against a fixed-size KV cache.

        x_t (b, 1, dim): the current position (the pre-norm is applied
        here); cache (b, T, dim_head), written in place at ``pos``.
        Returns (out (b, 1, dim), the cache)."""
        x_t = self.norm(x_t)
        q = self._queries(x_t)
        cache[:, pos] = self.to_kv(x_t)[:, 0].to(cache.dtype)
        null = self.null_kv.to(cache.dtype).expand(cache.shape[0], 1,
                                                   self.dim_head)
        kv = torch.cat([null, cache], dim=1)              # (b, 1 + T, d)
        seen = torch.arange(cache.shape[1], device=cache.device) <= pos
        return self._attend(q, kv, _keep_null(seen)), cache

    def cross_step(self, x_t: torch.Tensor, kv: torch.Tensor,
                   context_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Cross-attention decode step against the precomputed ``kv`` of
        :meth:`kv` (null KV already in front); context_mask (b, m)."""
        q = self._queries(self.norm(x_t))
        mask = None
        if context_mask is not None:
            mask = _keep_null(context_mask)[:, None, None, :]
        return self._attend(q, kv, mask)
