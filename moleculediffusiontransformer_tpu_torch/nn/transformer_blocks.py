"""Building blocks of the transformer model zoo (port of
`nn/transformer_blocks.py`): Gumbel / top-k sampling, the gamma-only
LayerNorm (and the affine one under its torch name), parti's feed-forward,
the FF-CNN feed-forward (GLU, causal depthwise-conv sandwiches), the 2-D
relative bias, the dense-adjacency GCN layers, multi-query attention with a
learned null KV (``MQAttention``) and attention with separate q/k/v
projections, optionally one KV head, a null KV and GCN message passing over
the attention matrix (``AttentionQKV``, the GPT models').

Distinct from ``nn/attention.py`` (the UNet's attention): one shared KV head
that serves as keys and values, a learned null KV prepended for
classifier-free guidance, bias-free projections.  Every attention module has
a ``step`` / ``cross_step`` pair so that generation runs position by position
against fixed-size KV caches.

The attention core is plain math (``torch.matmul``): the JAX package's
``packed_shared_kv_sdpa`` packs batch elements for the TPU's matrix unit and
computes exactly this.  Module and parameter names are the reference torch
keys (``to_q.1.weight``, ``to_out.2.gamma``, ``null_kv``), so the JAX
package's parameters load with ``strict=True``.

torch cannot reproduce JAX's threefry draws, so whatever samples takes a
``torch.Generator`` or the uniforms themselves.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .primitives import Dense, LayerNorm, gelu

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


def decode_loop(step: Callable[[torch.Tensor, int], torch.Tensor],
                ids: torch.Tensor, t0: int, *, cond_scale: float,
                filter_thres: float, temperature: float,
                generator: Optional[torch.Generator] = None,
                uniforms=None, return_logits: bool = False):
    """The token loop of KV-cached generation with batched classifier-free
    guidance, shared by ``models.transformers.generate_sequence`` and the
    exported generator that ``design.serve.ArtifactServer`` runs.

    ``ids`` (b, total) holds the prompt in its first ``t0`` columns and is
    written in place.  ``step(token, pos)`` runs one position: token (b,)
    the ids at ``pos``; it returns the (2b, vocab) logits of the doubled
    batch, the conditioned half first.  They are blended ``null + (cond -
    null) * cond_scale`` in float32, filtered to the top ``1 -
    filter_thres`` of the vocabulary and sampled by Gumbel-max with the
    step's uniforms (b, vocab): ``uniforms[pos]`` of a (total - 1, b,
    vocab) tensor, ``uniforms(pos)`` of a callable, or drawn from
    ``generator``.  A position inside the prompt keeps its token.  Returns
    ``ids``, and with ``return_logits`` also the blended logits of every
    step, (total - 1, b, vocab) float32."""
    b, total = ids.shape
    kept: Optional[List[torch.Tensor]] = [] if return_logits else None
    for pos in range(total - 1):
        logits2 = step(ids[:, pos], pos)
        logits_c, logits_n = logits2[:b], logits2[b:]
        logits = (logits_n + (logits_c - logits_n) * cond_scale).float()
        if kept is not None:
            kept.append(logits)
        if pos + 1 < t0:        # inside the prompt: the token stays
            continue
        u = None
        if uniforms is not None:
            u = uniforms(pos) if callable(uniforms) else uniforms[pos]
        ids[:, pos + 1] = gumbel_sample(
            top_k_filter(logits, filter_thres), temperature,
            generator=generator, uniforms=u).to(ids.dtype)
    if return_logits:
        return ids, torch.stack(kept)
    return ids


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


# ---------------------------------------------------------- feedforward ----

class _GELU(nn.Module):
    """The exact (erf) GELU as a module, for a feed-forward Sequential."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def feed_forward_parti(dim: int, mult: int = 4,
                       dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """parti's feed-forward, all bias-free: LN -> Linear -> GELU -> LN ->
    Linear (children 0, 1, 3, 4 hold the parameters)."""
    hidden = int(dim * mult)
    return nn.Sequential(LNGamma(dim, dtype=dtype),
                         Dense(dim, hidden, bias=False, dtype=dtype),
                         _GELU(), LNGamma(hidden, dtype=dtype),
                         Dense(hidden, dim, bias=False, dtype=dtype))


def relu_squared(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


class GLU(nn.Module):
    """Gated linear unit: ``proj`` to 2 x dim_out, ``x * activation(gate)``."""

    def __init__(self, dim_in: int, dim_out: int,
                 activation: Callable = gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * self.activation(gate)


class _DepthwiseKernel(nn.Module):
    """A depthwise conv kernel ``weight`` (channels, 1, k): torch's
    ``Conv1d(groups=channels)`` layout, U(-1/sqrt(k), 1/sqrt(k)) init."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel_size)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)


class CausalDSConv(nn.Module):
    """Causal depthwise conv over (b, n, c): the input left-padded by
    (k - 1) x dilation, k shifted multiply-adds by the float32 kernel
    ``ds_conv`` (so a bf16 input gives a float32 output, as in JAX)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.dilation, self.dtype = (kernel_size, dilation,
                                                       dtype)
        self.ds_conv = _DepthwiseKernel(channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        length = x.shape[1]
        pad = (self.kernel_size - 1) * self.dilation
        x = F.pad(x.to(self.dtype), (0, 0, pad, 0))
        out = torch.zeros_like(x[:, :length])
        kernel = self.ds_conv.weight
        for w in range(self.kernel_size):
            start = w * self.dilation
            out = out + x[:, start:start + length] * kernel[:, 0, w]
        return out


class _ConvSandwich(nn.Module):
    """Residual causal depthwise-conv pair ``x + conv(act(conv(x)))``, the
    convs at the reference's Sequential indices 0 and 2."""

    def __init__(self, channels: int, kernel_size: int, dtype: torch.dtype):
        super().__init__()
        self.add_module("0", CausalDSConv(channels, kernel_size, dtype=dtype))
        self.add_module("2", CausalDSConv(channels, kernel_size, dtype=dtype))

    def forward(self, x: torch.Tensor, act: Callable) -> torch.Tensor:
        return getattr(self, "2")(act(getattr(self, "0")(x))) + x


def _indexed(index: str, module: nn.Module) -> nn.Sequential:
    """A one-module Sequential whose module sits at the reference's
    Sequential index ``index``."""
    return nn.Sequential(OrderedDict([(index, module)]))


class FeedForwardCNN(nn.Module):
    """The reference's ``FeedForward_CNN``: an optional causal depthwise-conv
    sandwich (``resnetblock1``), the in-projection (``project_in``: a GLU or
    Linear + activation), an optional inner sandwich
    (``inner_conv_resnetblock1``), the out-projection (``ff.2``) and a last
    optional sandwich (``resnetblock2``).  The activation is relu squared,
    SiLU (``swish``) or GELU."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 glu: bool = False, swish: bool = False,
                 use_relu_squared: bool = False, conv_kernel_ff: int = 0,
                 ff_inner_conv: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = int(dim * mult)
        dim_out = dim if dim_out is None else dim_out
        self.act = (relu_squared if use_relu_squared
                    else F.silu if swish else gelu)
        self.glu = glu
        self.resnetblock1 = (_ConvSandwich(dim, conv_kernel_ff, dtype)
                             if conv_kernel_ff > 0 else None)
        self.project_in = (GLU(dim, inner, activation=self.act, dtype=dtype)
                           if glu else _indexed("0", Dense(dim, inner,
                                                           dtype=dtype)))
        self.inner_conv_resnetblock1 = (
            _ConvSandwich(inner, ff_inner_conv, dtype)
            if ff_inner_conv > 0 else None)
        self.ff = _indexed("2", Dense(inner, dim_out, dtype=dtype))
        self.resnetblock2 = (_ConvSandwich(dim_out, conv_kernel_ff, dtype)
                             if conv_kernel_ff > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resnetblock1 is not None:
            x = self.resnetblock1(x, self.act)
        x = self.project_in(x)
        if not self.glu:
            x = self.act(x)
        if self.inner_conv_resnetblock1 is not None:
            x = self.inner_conv_resnetblock1(x, self.act)
        x = self.ff(x)
        if self.resnetblock2 is not None:
            x = self.resnetblock2(x, self.act)
        return x


# ------------------------------------------------------------ attention ----

class RelPosBias2d(nn.Module):
    """2-D relative bias over a ``size`` x ``size`` grid (parti heritage;
    unused by the molecule models): a ``pos_bias`` ((2 size - 1)**2, heads)
    table, N(0, 1); ``forward(i, j)`` is the (heads, i, j) bias, its first
    key column 0."""

    def __init__(self, size: int, heads: int):
        super().__init__()
        self.size = size
        self.pos_bias = nn.Parameter(torch.empty((2 * size - 1) ** 2, heads))
        self.reset_parameters()
        pos = np.stack(np.meshgrid(np.arange(size), np.arange(size),
                                   indexing="ij"), axis=-1).reshape(-1, 2)
        rel = pos[:, None] - pos[None, :] + size - 1
        self._idx = rel[..., 0] * (2 * size - 1) + rel[..., 1]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.pos_bias.normal_(0.0, 1.0, generator=generator)

    def forward(self, i: int, j: int) -> torch.Tensor:
        idx = torch.from_numpy(self._idx[:i, :j - 1]).to(
            self.pos_bias.device)
        bias = self.pos_bias[idx].permute(2, 0, 1)
        return F.pad(bias, (j - bias.shape[-1], 0))


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

    def init_cache(self, batch: int, total_len: int,
                   device=None) -> torch.Tensor:
        """A zero KV cache (b, T, dim_head) for :meth:`step`."""
        return torch.zeros(batch, total_len, self.dim_head, dtype=self.dtype,
                           device=device)

    def step(self, x_t: torch.Tensor, cache: torch.Tensor,
             pos: Union[int, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One causal decode step against a fixed-size KV cache.

        x_t (b, 1, dim): the current position (the pre-norm is applied
        here); cache (b, T, dim_head), written in place at ``pos``: an
        ``int``, or a 0-d integer tensor on the cache's device, which the
        write and the mask read on the device (an exported decode step
        takes it so, and it never reaches the host).
        Returns (out (b, 1, dim), the cache)."""
        x_t = self.norm(x_t)
        q = self._queries(x_t)
        kv_t = self.to_kv(x_t).to(cache.dtype)
        if isinstance(pos, torch.Tensor):
            cache.index_copy_(1, pos.reshape(1), kv_t)
        else:
            cache[:, pos] = kv_t[:, 0]
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


# ------------------------------------------------------------------ GCN ----

class GCNLayer(nn.Module):
    """Dense-adjacency GCN layer: ``adj @ projection(x) / num_neighbours``,
    the product in ``dtype``."""

    def __init__(self, c_in: int, c_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.projection = Dense(c_in, c_out, dtype=dtype)

    def forward(self, node_feats: torch.Tensor,
                adj_matrix: torch.Tensor) -> torch.Tensor:
        num_neighbours = adj_matrix.sum(dim=-1, keepdim=True)
        node_feats = self.projection(node_feats)
        node_feats = torch.matmul(adj_matrix.to(self.dtype), node_feats)
        return node_feats / num_neighbours


class GraphConvLayers(nn.Module):
    """``depth`` GCN layers, each ``gelu(gcn(x) + x)`` (without the skip
    when ``have_skip`` is False), then the output Linear ``lin``.  With
    ``deterministic=False`` a dropout of 0.1 precedes ``lin``: its keep mask
    (like x) is handed in or drawn from ``generator``, and kept values are
    divided by 0.9."""

    def __init__(self, c_in: int, hidden_channels: int,
                 num_node_features_out: int, depth: int,
                 have_skip: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.have_skip = have_skip
        self.layers = nn.ModuleList([
            GCNLayer(c_in if i == 0 else hidden_channels, hidden_channels,
                     dtype=dtype) for i in range(depth)])
        self.lin = Dense(hidden_channels if depth else c_in,
                         num_node_features_out, dtype=dtype)

    def forward(self, x: torch.Tensor, adj_matrix: torch.Tensor,
                deterministic: bool = True, *,
                dropout_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = gelu(layer(x, adj_matrix)
                     + x * (1.0 if self.have_skip else 0.0))
        if not deterministic:
            if dropout_keep is None:
                if generator is None:
                    raise ValueError("dropout needs a keep mask or a "
                                     "generator")
                dropout_keep = _uniform(x.shape, generator, x.device) < 0.9
            x = torch.where(dropout_keep.to(x.device), x / 0.9,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return self.lin(x)


class AttentionQKV(nn.Module):
    """Attention with separate q/k/v projections: one KV head
    (``one_kv_head``, multi-query) or one a query head, a learned null KV
    prepended (``use_null_kv``), and optionally ``gnn_layers`` GCN layers
    run over the post-softmax attention matrix as the adjacency of the
    value rows (square self-attention without the null KV), their output
    added to the attention's.

    The adjacency is the softmax in the compute dtype; the identity is
    added (``gnn_add_identity``), then clamped to [0, 1]
    (``gnn_clamp_att_after_identity``), then entries below
    ``gnn_att_threshold_min`` zeroed and entries above
    ``gnn_att_threshold_max`` set to 1, in that order.  ``step`` decodes one
    position against fixed-size K and V caches (one KV head), which it
    writes in place; its keys are those at or before ``pos``, after the null
    slot."""

    def __init__(self, dim: int, context_dim: Optional[int] = None,
                 dim_head: int = 64, heads: int = 8, causal: bool = False,
                 norm_context: bool = False, one_kv_head: bool = True,
                 use_null_kv: bool = True, gnn_layers: int = 0,
                 gnn_have_skip: bool = True,
                 gnn_att_threshold_min: float = 0.0,
                 gnn_att_threshold_max: float = 1.0,
                 gnn_add_identity: bool = True,
                 gnn_clamp_att_after_identity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        kv_dim = dim_head if one_kv_head else inner
        kv_in = dim if context_dim is None else context_dim
        self.dim_head, self.heads, self.causal = dim_head, heads, causal
        self.one_kv_head, self.use_null_kv = one_kv_head, use_null_kv
        self.gnn_layers, self.dtype = gnn_layers, dtype
        self.gnn_add_identity = gnn_add_identity
        self.gnn_clamp_att_after_identity = gnn_clamp_att_after_identity
        self.gnn_att_threshold_min = gnn_att_threshold_min
        self.gnn_att_threshold_max = gnn_att_threshold_max
        self.norm = LNGamma(dim, dtype=dtype)
        self.norm_context_mod = (LNGamma(kv_in, dtype=dtype) if norm_context
                                 else None)
        self.to_q = nn.Sequential(
            nn.Identity(), Dense(dim, inner, bias=False, dtype=dtype))
        self.to_k = nn.Sequential(
            nn.Identity(), Dense(kv_in, kv_dim, bias=False, dtype=dtype))
        self.to_v = nn.Sequential(
            nn.Identity(), Dense(kv_in, kv_dim, bias=False, dtype=dtype))
        self.to_out = nn.Sequential(
            nn.Identity(), Dense(inner, dim, bias=False, dtype=dtype),
            LNGamma(dim, dtype=dtype))
        self.null_k = nn.Parameter(torch.empty(kv_dim))
        self.null_v = nn.Parameter(torch.empty(kv_dim))
        self.GNN_net = (GraphConvLayers(dim_head, dim_head, dim_head,
                                        gnn_layers, have_skip=gnn_have_skip,
                                        dtype=dtype)
                        if gnn_layers > 0 else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.null_k.normal_(0.0, 1.0, generator=generator)
            self.null_v.normal_(0.0, 1.0, generator=generator)

    def _queries(self, x: torch.Tensor) -> torch.Tensor:
        """Normed x (b, n, dim) -> scaled queries (b, h, n, d)."""
        b, n, _ = x.shape
        q = self.to_q(x) * (self.dim_head ** -0.5)
        return q.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def _with_null(self, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = k.shape[0]
        nk = self.null_k.to(k.dtype).expand(b, 1, k.shape[-1])
        nv = self.null_v.to(v.dtype).expand(b, 1, v.shape[-1])
        return torch.cat([nk, k], dim=1), torch.cat([nv, v], dim=1)

    def kv(self, context: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The context's keys and values (b, [1 +] m, kv_dim), the null KV
        in front with ``use_null_kv``."""
        if self.norm_context_mod is not None:
            context = self.norm_context_mod(context)
        k, v = self.to_k(context), self.to_v(context)
        return self._with_null(k, v) if self.use_null_kv else (k, v)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q (b, h, n, d); k, v (b, j, d) with one KV head, else
        (b, h, j, d); mask broadcastable to (b, 1, n, j), True = keep."""
        b, h, n, d = q.shape
        if self.one_kv_head:
            k, v = k[:, None], v[:, None]
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if mask is not None:
            sim = torch.where(mask, sim, NEG_INF)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn.to(self.dtype), v.to(self.dtype))
        if self.GNN_net is not None:
            j = attn.shape[-1]
            adj = attn.reshape(b * h, n, j).to(self.dtype)
            if self.gnn_add_identity:
                adj = adj + torch.eye(n, j, dtype=adj.dtype,
                                      device=adj.device)[None]
                if self.gnn_clamp_att_after_identity:
                    adj = adj.clamp(0.0, 1.0)
            zero = torch.zeros((), dtype=adj.dtype, device=adj.device)
            if self.gnn_att_threshold_min > 0:
                adj = torch.where(adj < self.gnn_att_threshold_min, zero, adj)
            if self.gnn_att_threshold_max < 1:
                adj = torch.where(adj > self.gnn_att_threshold_max,
                                  torch.ones_like(zero), adj)
            v_nodes = v.expand(b, h, *v.shape[2:]).reshape(b * h, j, -1)
            gnn_out = self.GNN_net(v_nodes, adj)
            out = out + gnn_out.reshape(b, h, j, -1)[:, :, :n]
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.norm(x)
        q = self._queries(x)
        k, v = self.kv(x if context is None else context)
        j = k.shape[1]
        if not self.one_kv_head:
            k, v = (t.reshape(b, j, self.heads, self.dim_head).transpose(1, 2)
                    for t in (k, v))
        mask = None
        if context_mask is not None:
            cm = _keep_null(context_mask) if self.use_null_kv else \
                context_mask
            mask = cm[:, None, None, :]
        if self.causal:
            causal = ~torch.ones(n, j, dtype=torch.bool,
                                 device=x.device).triu(j - n + 1)
            mask = causal if mask is None else (mask & causal)
        return self._attend(q, k, v, mask)

    def cross_step(self, x_t: torch.Tensor,
                   kv: Tuple[torch.Tensor, torch.Tensor],
                   context_mask: torch.Tensor) -> torch.Tensor:
        """Cross-attention decode step against the precomputed (k, v) of
        :meth:`kv`; context_mask (b, m) (the null slot is prepended here
        with ``use_null_kv``)."""
        q = self._queries(self.norm(x_t))
        cm = _keep_null(context_mask) if self.use_null_kv else context_mask
        return self._attend(q, *kv, cm[:, None, None, :])

    def init_cache(self, batch: int, total_len: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A zero (k, v) cache pair, each (b, T, dim_head), for
        :meth:`step`."""
        return tuple(torch.zeros(batch, total_len, self.dim_head,
                                 dtype=self.dtype, device=device)
                     for _ in range(2))

    def step(self, x_t: torch.Tensor,
             cache: Tuple[torch.Tensor, torch.Tensor], pos: int
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One causal decode step (one KV head): x_t (b, 1, dim); the cache
        (k, v) of :meth:`init_cache`, written in place at ``pos``.  Returns
        (out (b, 1, dim), the cache)."""
        if not self.one_kv_head:
            raise ValueError("cached decode takes the one-KV-head layout")
        k_cache, v_cache = cache
        x_t = self.norm(x_t)
        q = self._queries(x_t)
        k_cache[:, pos] = self.to_k(x_t)[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = self.to_v(x_t)[:, 0].to(v_cache.dtype)
        k, v = k_cache, v_cache
        mask = torch.arange(k_cache.shape[1], device=k_cache.device) <= pos
        if self.use_null_kv:
            k, v = self._with_null(k, v)
            mask = _keep_null(mask)
        return self._attend(q, k, v, mask), cache
