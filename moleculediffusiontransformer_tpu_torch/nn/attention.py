"""Attention and transformer blocks inside the UNet (port of
`nn/attention.py`).

Channels-last; softmax in float32.  ``AttentionBase`` computes plain
scaled-dot-product attention: the JAX package's ``packed_sdpa`` packs
(batch, head) pairs block-diagonally only to fill the TPU's 128x128 matrix
unit, and its math is exactly this.  With ``use_rel_pos`` it adds the T5
bucketed ``RelativePositionBias`` to the float32 scores before the
``d**-0.5`` scale, as the reference does, in self- and cross-attention.

``Transformer1d`` dispatches the whole stack to
``ops.transformer_fusion.transformer1d`` (the hand-written CUDA kernels on a
GPU tensor, their plain PyTorch versions on a CPU tensor) whenever the stack
is one the kernel takes, as the JAX module dispatches to its Pallas kernel;
otherwise, or with ``disable_fusion``, it runs the module composition below.
Under autograd the dispatch is differentiable: the forward keeps its stash
and the backward runs the stack's backward kernels, giving the stack's own
float32 parameters, x and the context their grads.

With the shared-KV switch on (``ops.transformer_fusion.enable_sharedkv``), a
cross-attention stack called on the doubled batch that ``cfg_forward``
flagged splits it: the conditioned half as above, the null half through
the uniform-context kernel against the one FixedEmbedding table
(``ops.transformer_fusion.null_half_table`` says when that holds).  A stack
with relative position bias is never the kernel's: the gate refuses it, as
the JAX ``fusable`` does.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops import flash_attention as fa
from ..ops import transformer_fusion as tf
from .primitives import Conv1d, Dense, Embed, GroupNorm, LayerNorm, whole


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """T5 bucketing of relative positions (host numpy, int64): half the
    buckets for each sign, exact below half of those, log-spaced up to
    ``max_distance`` above."""
    num_buckets //= 2
    ret = (relative_position >= 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = (max_exact
                    + (np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
                       / math.log(max_distance / max_exact)
                       * (num_buckets - max_exact)).astype(np.int64))
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=64)
def _buckets(num_queries: int, num_keys: int, q_start: int, num_buckets: int,
             max_distance: int) -> np.ndarray:
    """The (i, j) buckets of queries at positions q_start .. q_start + i - 1
    against keys at 0 .. j - 1."""
    i, j = num_queries, num_keys
    q_pos = np.arange(q_start, q_start + i, dtype=np.int64)
    k_pos = np.arange(j, dtype=np.int64)
    return relative_position_bucket(k_pos[None, :] - q_pos[:, None],
                                    num_buckets, max_distance)


class RelativePositionBias(nn.Module):
    """T5-style bucketed relative bias: a float32 (num_buckets, heads) table
    ``relative_attention_bias``; ``forward(i, j)`` is the (1, h, i, j) bias
    of i queries at the last positions of j keys, ``forward(i, j, q_start)``
    that of i queries from position ``q_start`` on (a rank's slice of the
    queries under sequence parallelism)."""

    def __init__(self, num_buckets: int, max_distance: int, num_heads: int):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = Embed(num_buckets, num_heads)

    def forward(self, num_queries: int, num_keys: int,
                q_start: Optional[int] = None) -> torch.Tensor:
        table = whole(self.relative_attention_bias.weight)
        if q_start is None:
            q_start = num_keys - num_queries
        buckets = torch.from_numpy(_buckets(
            num_queries, num_keys, q_start, self.num_buckets,
            self.max_distance)).to(table.device)
        return table.float()[buckets].permute(2, 0, 1)[None]


def feed_forward(features: int, multiplier: int,
                 dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Linear-GELU-Linear, children ``0`` / ``2`` as in the reference."""
    return nn.Sequential(Dense(features, features * multiplier, dtype=dtype),
                         nn.GELU(),
                         Dense(features * multiplier, features, dtype=dtype))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         dtype: torch.dtype) -> torch.Tensor:
    """(b, h, n|m, d) -> (b, h, n, d).  Long sequences stream through
    ``ops.flash_attention`` (the JAX ``packed_sdpa``'s route: the switch on,
    both lengths at least ``LONG_SEQ_THRESHOLD`` and multiples of 128, a
    head size and type the kernels take); the gate reads shapes and the
    switch only.  The kernels take the split-head views as they are and
    return a view of (b, n, h, d) memory.  Anything else is the one-shot
    product: float32 scores and softmax, the probabilities cast to ``dtype``
    before the product with v."""
    n, d = q.shape[2:]
    m = k.shape[2]
    if (fa.flash_enabled() and min(n, m) >= fa.LONG_SEQ_THRESHOLD
            and fa.flash_takes(n, m, d, q.dtype)):
        return fa.flash_attention(q, k, v, scale=scale)
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(dtype), v.to(dtype))


class AttentionBase(nn.Module):
    """Multi-head SDPA core + output projection; with ``use_rel_pos`` the
    relative bias ``rel_pos`` joins the float32 scores before the scale
    (the queries at the last positions of the keys, or from ``q_start``
    on)."""

    def __init__(self, features: int, head_features: int, num_heads: int,
                 use_rel_pos: bool = False,
                 rel_pos_num_buckets: Optional[int] = None,
                 rel_pos_max_distance: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head_features, self.num_heads, self.dtype = (
            head_features, num_heads, dtype)
        self.rel_pos = (RelativePositionBias(rel_pos_num_buckets,
                                             rel_pos_max_distance, num_heads)
                        if use_rel_pos else None)
        self.to_out = Dense(head_features * num_heads, features, dtype=dtype)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_start: Optional[int] = None) -> torch.Tensor:
        b, n, _ = q.shape
        h, d = self.num_heads, self.head_features

        def split_heads(t):
            return t.reshape(b, -1, h, d).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        if self.rel_pos is None:
            out = sdpa(q, k, v, d ** -0.5, self.dtype)
        else:
            sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
            sim = (sim + self.rel_pos(n, k.shape[2], q_start)) * (d ** -0.5)
            attn = torch.softmax(sim, dim=-1)
            out = torch.matmul(attn.to(self.dtype), v.to(self.dtype))
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class Attention(nn.Module):
    """Pre-LN attention with a fused KV projection; cross-attention when
    ``context_features`` is set.  With ``seq_axis`` set (a length that is
    sharded, ``parallel/sp.py``) the queries stay local: self-attention
    gathers K/V along the length, and a relative bias puts the queries at
    this rank's positions of the whole sequence."""

    seq_axis = None

    def __init__(self, features: int, head_features: int, num_heads: int,
                 context_features: Optional[int] = None,
                 use_rel_pos: bool = False,
                 rel_pos_num_buckets: Optional[int] = None,
                 rel_pos_max_distance: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.context_features = context_features
        mid = head_features * num_heads
        ctx = context_features or features
        self.norm = LayerNorm(features, dtype=dtype)
        self.norm_context = LayerNorm(ctx, dtype=dtype)
        self.to_q = Dense(features, mid, bias=False, dtype=dtype)
        self.to_kv = Dense(ctx, mid * 2, bias=False, dtype=dtype)
        self.attention = AttentionBase(
            features, head_features, num_heads, use_rel_pos=use_rel_pos,
            rel_pos_num_buckets=rel_pos_num_buckets,
            rel_pos_max_distance=rel_pos_max_distance, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert not (self.context_features and context is None), \
            "You must provide a context when using context_features"
        context = context if context is not None else x
        q = self.to_q(self.norm(x))
        kv = self.to_kv(self.norm_context(context))
        q_start = None
        seq = self.seq_axis
        if seq is not None:
            if not self.context_features:
                from ..parallel import sp
                kv = sp.gather_length(kv, seq)
            # the whole sequence's queries end at the last key, as one
            # process's do
            n = q.shape[1]
            q_start = kv.shape[1] - n * seq.size + n * seq.rank
        k, v = kv.chunk(2, dim=-1)
        return self.attention(q, k, v, q_start)


class TransformerBlock(nn.Module):
    """Self-attention [+ cross-attention] + feed-forward, all residual."""

    def __init__(self, features: int, num_heads: int, head_features: int,
                 multiplier: int, context_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, **rel_pos):
        super().__init__()
        self.use_cross = context_features is not None and context_features > 0
        self.attention = Attention(features, head_features, num_heads,
                                   dtype=dtype, **rel_pos)
        if self.use_cross:
            self.cross_attention = Attention(
                features, head_features, num_heads,
                context_features=context_features, dtype=dtype, **rel_pos)
        self.feed_forward = feed_forward(features, multiplier, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attention(x) + x
        if self.use_cross:
            x = self.cross_attention(x, context=context) + x
        return self.feed_forward(x) + x


class Transformer1d(nn.Module):
    """Stack of TransformerBlocks wrapped in GroupNorm(32, eps 1e-6) + 1x1
    convs.  Channels-last makes the reference's ``b c t <-> b t c``
    rearranges no-ops: ``to_out.0`` is kept as an identity so the conv stays
    at the reference key ``to_out.1``.

    ``disable_fusion`` pins this instance to the module composition (the JAX
    module's field of the same name); so does ``use_rel_pos``, which the
    stack kernel does not take.

    Over a mesh: with its weights tensor-parallel shards, the kernel route
    takes them gathered whole (``parallel.tp.full``) and cast afresh each
    call; with ``seq_axis`` set (``parallel/sp.py``), the kernel route
    gathers x along the length, runs the whole sequence and keeps this
    rank's rows, and the composition runs on the slice."""

    seq_axis = None

    def __init__(self, num_layers: int, channels: int, num_heads: int,
                 head_features: int, multiplier: int,
                 use_rel_pos: bool = False,
                 rel_pos_num_buckets: Optional[int] = None,
                 rel_pos_max_distance: Optional[int] = None,
                 context_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 disable_fusion: bool = False):
        super().__init__()
        self.use_rel_pos = use_rel_pos
        self.num_layers, self.channels = num_layers, channels
        self.num_heads, self.head_features = num_heads, head_features
        self.multiplier, self.context_features = multiplier, context_features
        self.dtype, self.disable_fusion = dtype, disable_fusion
        self.to_in = nn.Sequential(
            GroupNorm(32, channels, eps=1e-6, dtype=dtype),
            Conv1d(channels, channels, kernel_size=1, padding=0, dtype=dtype))
        self.blocks = nn.ModuleList([
            TransformerBlock(channels, num_heads=num_heads,
                             head_features=head_features,
                             multiplier=multiplier,
                             context_features=context_features, dtype=dtype,
                             use_rel_pos=use_rel_pos,
                             rel_pos_num_buckets=rel_pos_num_buckets,
                             rel_pos_max_distance=rel_pos_max_distance)
            for _ in range(num_layers)])
        self.to_out = nn.Sequential(
            nn.Identity(),
            Conv1d(channels, channels, kernel_size=1, padding=0, dtype=dtype))
        self._stack_params: Optional[tuple] = None
        # set while a serving program is traced (``design.export``): the
        # kernel parameters that are not their parameter as it is (the
        # casts), as the program's inputs, made once per load
        self.given_kernel_params: Optional[Dict[str, torch.Tensor]] = None

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """This stack's parameters as the stack kernel takes them: matmul
        weights in the compute dtype, vectors in float32.  Cached; the cache
        is rebuilt when a parameter is replaced or modified in place.  While
        ``torch.export`` traces a serving program (the parameters are then
        fake tensors, with no storage) they are ``given_kernel_params`` (a
        parameter not there is taken as it is)."""
        params = dict(self.named_parameters())
        if self.given_kernel_params is not None:
            given = self.given_kernel_params
            return {name: given.get(name, p) for name, p in params.items()}
        key = tuple((p.data_ptr(), p._version, p.device)
                    for p in params.values())
        if self._stack_params is None or self._stack_params[0] != key:
            with torch.no_grad():
                casts = self.kernel_casts()
                cast = {name: casts.get(name, p).detach()
                        for name, p in params.items()}
            self._stack_params = (key, cast)
        return self._stack_params[1]

    def drop_kernel_cache(self) -> None:
        """Forget the cached kernel parameters: the next call rebuilds
        them (FSDP2 refills a parameter's storage without a sign the key
        sees, ``parallel/fsdp.py``)."""
        self._stack_params = None

    def kernel_casts(self, params: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
        """The parameters of ``kernel_params`` (or of ``params``) that are
        not in their kernel dtype already (float32 vectors, compute-dtype
        matrices), cast."""
        out = {}
        for name, p in (params or dict(self.named_parameters())).items():
            want = torch.float32 if p.dim() == 1 else self.dtype
            if p.dtype != want:
                out[name] = p.to(want)
        return out

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        has_cross = (self.context_features is not None
                     and self.context_features > 0)
        # refused before the dispatch: the stack kernel would run without
        # the cross-attention where the composition asserts
        assert not (has_cross and context is None), \
            "You must provide a context when using context_features"
        ctx = context if has_cross else None
        seq = self.seq_axis
        # the route is the whole sequence's
        whole_x = x if seq is None else x.new_empty(
            (x.shape[0], x.shape[1] * seq.size, *x.shape[2:]), device="meta")
        if self.disable_fusion or not tf.stack_kernel_takes(
                whole_x, ctx, channels=self.channels, dtype=self.dtype,
                head_dim=self.head_features, use_rel_pos=self.use_rel_pos):
            return self._compose(x, context)
        if seq is not None:
            from ..parallel import sp
            return sp.own_rows(self._kernel_route(
                sp.gather_length(x, seq), ctx), seq)
        return self._kernel_route(x, ctx)

    def _kernel_route(self, x: torch.Tensor,
                      ctx: Optional[torch.Tensor]) -> torch.Tensor:
        # the kernel reads dense (b, L, C) rows; a conv's channels-last
        # output is a transposed view
        x = x.contiguous()
        table = None if ctx is None else tf.null_half_table(ctx)
        if table is not None:
            # batched CFG with the shared-KV switch on: the null half's
            # context is one table, attended as one K/V
            b2 = x.shape[0] // 2
            return torch.cat([self._stack(x[:b2], ctx[:b2]),
                              self._null_half(x[b2:], table)])
        return self._stack(x, ctx)

    def _geometry(self) -> Dict[str, int]:
        return dict(num_layers=self.num_layers, heads=self.num_heads,
                    head_dim=self.head_features, multiplier=self.multiplier)

    def _stack(self, x: torch.Tensor,
               ctx: Optional[torch.Tensor]) -> torch.Tensor:
        params = dict(self.named_parameters())
        if any(isinstance(p, DTensor) for p in params.values()):
            # tensor parallelism: the kernels take whole weights, gathered
            # into fresh buffers a storage-keyed cache could mistake
            self.drop_kernel_cache()
            params = {n: whole(p) for n, p in params.items()}
            with torch.no_grad():
                casts = self.kernel_casts(params)
            kparams = {n: casts.get(n, p).detach()
                       for n, p in params.items()}
        else:
            kparams = self.kernel_params()
        return tf.transformer1d(kparams, params, x, ctx, **self._geometry())

    def _null_half(self, x: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
        """The stack on rows that all attend the one (1, m, C) ``table``:
        the uniform-context kernel, differentiated (when asked) through the
        module composition with the table broadcast."""
        kparams, geometry = self.kernel_params(), self._geometry()
        return tf.recompute(
            lambda xx, tt: tf.transformer1d_forward(
                kparams, xx, tt, uniform_ctx=True, **geometry),
            lambda xx, tt: self._compose(
                xx, tt.expand(xx.shape[0], *tt.shape[1:])),
            [x, table], list(self.parameters()))

    def _compose(self, x: torch.Tensor,
                 context: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.to_in(x)
        for block in self.blocks:
            x = block(x, context=context)
        return self.to_out(x)
