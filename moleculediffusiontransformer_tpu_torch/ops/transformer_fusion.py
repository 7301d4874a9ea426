"""The Transformer1d stack as hand-written CUDA kernels, forward and backward
(port of `ops/transformer_fusion.py`).

``transformer1d_forward`` runs a whole ``nn.attention.Transformer1d`` stack:
GroupNorm(32, eps 1e-6) -> 1x1 conv in -> per layer [pre-LN self-attention;
pre-LN cross-attention on the context; exact-GELU feed-forward], each
residual -> 1x1 conv out; with ``with_stash`` it also returns the input of
every residual sub-block and of conv out, which the backward reads.  The
backward chain ``transformer1d_backward`` runs ``bwd_conv_out`` (K3), then
``bwd_layer`` (K2) per layer from the last, then ``bwd_conv_in_gn`` (K4).
``transformer1d`` joins the two as an autograd function, the counterpart of
the JAX package's ``custom_vjp``.

Every wrapper launches its kernel (``csrc/transformer1d_fwd.cu``,
``csrc/transformer1d_bwd.cu``, built on first use by ``ops.cuda_build``) on a
CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch version
(the ``*_reference`` functions), the same computation.  There is no fallback
from one to the other.  The serving forward (no stash, with or without a
uniform context) is the operator ``mdt_torch::t1d_forward``
(``torch.library.custom_op``, with a fake that gives the output's shape and
dtype), so that ``torch.export`` records it as one node and a CUDA graph
captures its launch; the live path calls the same operator.

Numerics follow the JAX package's Pallas kernels: norm and softmax
statistics in float32, every product accumulated in float32, q/kv cast to
the compute dtype after projection, probabilities cast before P.V, each
projection's (acc + bias) rounded before the residual add, a residual stream
in the compute dtype, and the feed-forward hidden activation float32 through
the GELU.  The backward rounds where the Pallas backward rounds (see
``bwd_layer_reference``); every weight grad is float32.

``params`` is the stack's parameter dict under the reference torch names
(``Transformer1d.named_parameters()``: ``to_in.0.weight``,
``blocks.0.attention.to_q.weight``, ..., ``to_out.1.bias``).  The kernels
want matrices in the compute dtype and vectors in float32
(``Transformer1d.kernel_params`` caches them so); any other dtype is cast
here, per call.  Weight grads come back in torch's layout: (out, in)
matrices (a 1x1 conv's without its kernel axis) and vectors.

Every product of K1-K4 goes through one GEMM, ``csrc/gemm_tc.cuh``: in
bf16 on the tensor cores (``wgmma``), the backward's weight grads split over
rows with a second pass that sums the chunks in order; in float32 on the
CUDA cores, so that float32 keeps its 1e-4 parity with the CPU.
``gemm_tc`` launches that GEMM alone (no model path calls it; the card
tests and ``tools/check_torch_gemm.py`` do), ``gemm_tc_reference`` is its
plain version, and ``gemm_tc_launches`` counts the products the stack
libraries sent to the tensor cores.

``uniform_ctx`` (the JAX ``attention_shared_kv``): the context is one
(1, m, C_ctx) table shared by every row, as the CFG null half's
FixedEmbedding is.  Its LayerNorm and KV projection run once, on m rows, and
every (batch, head) attends that one K/V.  The null-half dispatch behind it
is off by default (``enable_sharedkv``, or ``MDT_CFG_SHAREDKV=1``), as in
the JAX package; ``cfg_forward`` flags its doubled batch with
``cfg_uniform_null_half``.  Its gradient is autograd of the module
composition with the table broadcast (``recompute``), as JAX's is.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from ..nn.primitives import group_norm, layer_norm
from . import cuda_build

SOURCE = "transformer1d_fwd.cu"
BWD_SOURCE = "transformer1d_bwd.cu"
MAX_LENGTH = 64      # rows of q per (batch, head) block in the attention core
MAX_CONTEXT = 64     # rows of k/v per (batch, head) block
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import (or the last reset by the caller), one per
# wrapper call on a CUDA tensor: the stack forward without and with its
# stash and with a uniform context, and the three backward kernels.
LAUNCHES = 0
STASH_LAUNCHES = 0
UNIFORM_LAUNCHES = 0
CONV_OUT_BWD_LAUNCHES = 0
LAYER_BWD_LAUNCHES = 0
CONV_IN_GN_BWD_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None

# The shared-KV CFG null half (the JAX ``enable_sharedkv`` /
# ``cfg_uniform_null_half``).  None: read MDT_CFG_SHAREDKV (default off).
_SHAREDKV: Optional[bool] = None
# (the doubled context cfg_forward built, its null half) while flagged
_NULL_HALF: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def enable_sharedkv(on: bool = True) -> None:
    """Opt in to (or out of) the shared-KV null half; off by default."""
    global _SHAREDKV
    _SHAREDKV = on


def _sharedkv_opt_in() -> bool:
    if _SHAREDKV is not None:
        return _SHAREDKV
    env = os.environ.get("MDT_CFG_SHAREDKV", "")
    return env.strip().lower() in ("1", "true", "on")


@contextlib.contextmanager
def cfg_uniform_null_half(context: torch.Tensor,
                          null_half: torch.Tensor) -> Iterator[None]:
    """While active, flag ``context`` — the doubled [conditioned; null]
    batch that ``cfg_forward`` built — as having ``null_half`` for its
    second half.  ``null_half_table`` then hands a stack the one table the
    null half repeats, if there is one."""
    global _NULL_HALF
    prev = _NULL_HALF
    _NULL_HALF = (context, null_half)
    try:
        yield
    finally:
        _NULL_HALF = prev


def cfg_null_half_active() -> bool:
    return _NULL_HALF is not None and _sharedkv_opt_in()


def null_half_table(context: torch.Tensor) -> Optional[torch.Tensor]:
    """The (1, m, C) table that every row of ``context``'s null half is, or
    None.  Decided on the host, with no read of the device: the switch is
    on, ``context`` is the very tensor ``cfg_forward`` flagged, and its null
    half is one row repeated by its layout (batch stride 0, as
    ``FixedEmbedding`` returns it) — so the JAX package's runtime uniformity
    check holds by construction.  Any other context gets None, and with it
    the exact per-row path."""
    if not cfg_null_half_active():
        return None
    flagged, null = _NULL_HALF
    b = context.shape[0]
    if (context is not flagged or b % 2 or b < 2
            or tuple(null.shape) != (b // 2, *context.shape[1:])
            or not (null.shape[0] == 1 or null.stride(0) == 0)):
        return None
    return null[:1]


def stack_kernel_takes(x: torch.Tensor, context: Optional[torch.Tensor], *,
                       channels: int, dtype: torch.dtype, head_dim: int,
                       use_rel_pos: bool = False) -> bool:
    """The static part of the JAX ``fusable`` gate: a stack the kernel takes.
    A stack with relative position bias never is (the kernel has no bias
    term; the JAX gate refuses it too); the VMEM budget of the TPU gate has
    no counterpart here.  A head size past ``MAX_HEAD_DIM`` is, like a length
    past ``MAX_LENGTH``, the composition's."""
    return (not use_rel_pos and channels % 32 == 0 and x.dim() == 3 and x.shape[-1] == channels
            and x.dtype == dtype and dtype in _DTYPES
            and 1 <= x.shape[1] <= MAX_LENGTH
            and 1 <= head_dim <= MAX_HEAD_DIM
            and (context is None or 1 <= context.shape[1] <= MAX_CONTEXT))


@functools.lru_cache(maxsize=None)
def _abi_names(num_layers: int, cross: bool) -> Tuple[str, ...]:
    """Parameter names in the kernel's order (the JAX ``_abi_paths``)."""
    names = ["to_in.0.weight", "to_in.0.bias", "to_in.1.weight",
             "to_in.1.bias"]

    def attn(prefix: str) -> List[str]:
        return [f"{prefix}.norm.weight", f"{prefix}.norm.bias",
                f"{prefix}.norm_context.weight", f"{prefix}.norm_context.bias",
                f"{prefix}.to_q.weight", f"{prefix}.to_kv.weight",
                f"{prefix}.attention.to_out.weight",
                f"{prefix}.attention.to_out.bias"]

    for i in range(num_layers):
        names += attn(f"blocks.{i}.attention")
        if cross:
            names += attn(f"blocks.{i}.cross_attention")
        names += [f"blocks.{i}.feed_forward.0.weight",
                  f"blocks.{i}.feed_forward.0.bias",
                  f"blocks.{i}.feed_forward.2.weight",
                  f"blocks.{i}.feed_forward.2.bias"]
    return tuple(names + ["to_out.1.weight", "to_out.1.bias"])


def _kernel_weights(params: Dict[str, torch.Tensor], num_layers: int,
                    cross: bool, dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's weight list: 1x1 conv weights (out, in, 1) as (out, in)
    matrices, matrices in ``dtype``, vectors in float32, all contiguous.  A
    tensor that already is so (``Transformer1d.kernel_params`` caches them
    so) is taken as it is, without a call into torch: this list is built at
    every stack call, on the host's critical path."""
    out = []
    for name in _abi_names(num_layers, cross):
        w = params[name]
        if w.dim() == 1:
            if w.dtype != torch.float32 or not w.is_contiguous():
                w = w.float().contiguous()
        elif w.dim() != 2 or w.dtype != dtype or not w.is_contiguous():
            w = w.reshape(w.shape[0], -1).to(dtype).contiguous()
        out.append(w)
    return out


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (rows, C)."""
    return t.reshape(-1, t.shape[-1])


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) . w (N, K)^T in float32 (the kernel's accumulation)."""
    return torch.matmul(a.float(), w.float().t())


def _mm_nn(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (..., N) . w (N, K) in float32: the input grad of ``_mm``."""
    return torch.matmul(g.float(), w.float())


def _mm_tn(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """g^T . a over all rows in float32: the (N, K) weight grad of ``_mm``."""
    return torch.matmul(_rows(g).float().t(), _rows(a).float())


def _colsum(t: torch.Tensor) -> torch.Tensor:
    return _rows(t).float().sum(dim=0)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, inner = t.shape
    return t.reshape(b, n, heads, inner // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _attention(y: torch.Tensor, kv_src: torch.Tensor, w: List[torch.Tensor],
               heads: int, head_dim: int) -> torch.Tensor:
    """One pre-LN attention sub-block's output; a kv_src of batch 1 is
    shared by every row of y (its K/V broadcast in the products)."""
    ns, nb, cs, cb, wq, wkv, wout, bout = w
    dt = y.dtype
    inner = heads * head_dim
    q = _mm(layer_norm(y, ns, nb).to(dt), wq).to(dt)
    kv = _mm(layer_norm(kv_src, cs, cb).to(dt), wkv).to(dt)
    q = _split_heads(q, heads)
    k = _split_heads(kv[..., :inner], heads)
    v = _split_heads(kv[..., inner:], heads)
    sim = (torch.matmul(q.float(), k.float().transpose(-1, -2))
           * head_dim ** -0.5)
    att = torch.softmax(sim, dim=-1).to(dt)
    o = _merge_heads(torch.matmul(att.float(), v.float()).to(dt))
    return (_mm(o, wout) + bout).to(dt)


def _check_context_batch(x: torch.Tensor, context: Optional[torch.Tensor],
                         uniform_ctx: bool) -> None:
    if context is None:
        if uniform_ctx:
            raise ValueError("uniform_ctx needs a context")
        return
    want = 1 if uniform_ctx else x.shape[0]
    if context.dim() != 3 or context.shape[0] != want:
        raise ValueError(f"context must be ({want}, m, C_ctx)"
                         f"{' (uniform_ctx)' if uniform_ctx else ''}, got "
                         f"{tuple(context.shape)}")


def transformer1d_reference(params: Dict[str, torch.Tensor], x: torch.Tensor,
                            context: Optional[torch.Tensor], *,
                            num_layers: int, heads: int, head_dim: int,
                            multiplier: int, with_stash: bool = False,
                            uniform_ctx: bool = False):
    """Plain PyTorch version of the stack kernel, with the kernel's
    rounding.  x (b, L, C); context (b, m, C_ctx), (1, m, C_ctx) shared by
    every row with ``uniform_ctx`` (its LayerNorm and KV projection then run
    once), or None.  Returns the output (b, L, C), and with ``with_stash``
    also the stash (slots, b, L, C), both in x's dtype: each layer's
    self-attention, cross-attention (with a context) and feed-forward input,
    in processing order, then the conv-out input."""
    del multiplier   # implied by the feed-forward weights' shapes
    _check_context_batch(x, context, uniform_ctx)
    cross = context is not None
    dt = x.dtype
    w = iter(_kernel_weights(params, num_layers, cross, dt))
    ctx = context.to(dt) if cross else None
    stash = []

    gn_scale, gn_bias, k_in, b_in = (next(w) for _ in range(4))
    y32 = group_norm(x, gn_scale, gn_bias, num_groups=32, eps=1e-6)
    y = (_mm(y32.to(dt), k_in) + b_in).to(dt)
    for _ in range(num_layers):
        stash.append(y)
        y = _attention(y, y, [next(w) for _ in range(8)], heads, head_dim) + y
        if cross:
            stash.append(y)
            y = _attention(y, ctx, [next(w) for _ in range(8)], heads,
                           head_dim) + y
        w0, b0, w2, b2 = (next(w) for _ in range(4))
        stash.append(y)
        g = torch.nn.functional.gelu(_mm(y, w0) + b0)
        y = (_mm(g.to(dt), w2) + b2).to(dt) + y
    k_out, b_out = next(w), next(w)
    stash.append(y)
    out = (_mm(y, k_out) + b_out).to(dt)
    return (out, torch.stack(stash)) if with_stash else out


def _ln_stats(x: torch.Tensor, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm's forward statistics in float32: (xhat, rstd)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mean) * rstd, rstd


def _ln_bwd(dy32: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
            scale: torch.Tensor):
    """Backward of y = xhat * scale + bias: (dx, dscale, dbias), float32."""
    dxh = dy32 * scale
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxh - m1 - xhat * m2)
    return dx, _colsum(dy32 * xhat), _colsum(dy32)


def _gelu_value_and_grad(h32: torch.Tensor):
    """Exact-erf GELU and its derivative cdf(h) + h * pdf(h), float32."""
    cdf = 0.5 * (1.0 + torch.erf(h32 * 0.7071067811865476))
    return h32 * cdf, cdf + h32 * 0.3989422804014327 * torch.exp(
        -0.5 * h32 * h32)


def _attention_bwd_reference(dy32, a, kv_src, w, heads, head_dim):
    """Backward through one pre-LN attention sub-block evaluated at the
    stashed input ``a`` (q side) and ``kv_src`` (kv side).  Returns the q
    path's and the kv path's input grads (float32) and the 8 weight grads."""
    ns, nb, cs, cb, wq, wkv, wout, _ = w
    dt = a.dtype
    inner = heads * head_dim
    scale = head_dim ** -0.5
    qhat, q_rstd = _ln_stats(a)
    q_in = (qhat * ns + nb).to(dt)
    kvhat, kv_rstd = _ln_stats(kv_src)
    kv_in = (kvhat * cs + cb).to(dt)
    q = _mm(q_in, wq).to(dt)
    kv = _mm(kv_in, wkv).to(dt)
    dy_dt = dy32.to(dt)
    do = _mm_nn(dy_dt, wout).to(dt)
    qh, doh = _split_heads(q, heads).float(), _split_heads(do, heads).float()
    kh = _split_heads(kv[..., :inner], heads).float()
    vh = _split_heads(kv[..., inner:], heads).float()
    att = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, -1)
    att_dt = att.to(dt).float()
    o = _merge_heads(torch.matmul(att_dt, vh)).to(dt)
    datt = torch.matmul(doh, vh.transpose(-1, -2))
    dv = torch.matmul(att_dt.transpose(-1, -2), doh)
    r = (datt * att).sum(dim=-1, keepdim=True)
    ds = (att * (datt - r) * scale).to(dt).float()
    dq = _merge_heads(torch.matmul(ds, kh)).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dkv = torch.cat([_merge_heads(dk), _merge_heads(dv)], dim=-1).to(dt)
    d_wout, d_bout = _mm_tn(dy_dt, o), _colsum(dy32)
    d_wq, d_wkv = _mm_tn(dq, q_in), _mm_tn(dkv, kv_in)
    da, dns, dnb = _ln_bwd(_mm_nn(dq, wq), qhat, q_rstd, ns)
    dkv_src, dcs, dcb = _ln_bwd(_mm_nn(dkv, wkv), kvhat, kv_rstd, cs)
    return da, dkv_src, [dns, dnb, dcs, dcb, d_wq, d_wkv, d_wout, d_bout]


def bwd_conv_out_reference(g: torch.Tensor, y: torch.Tensor,
                           w: torch.Tensor):
    """Plain version of K3: the conv-out backward.  g, y (b, L, C) and
    w (C, C) in the compute dtype -> (dy in the compute dtype, dW (C, C) and
    db (C,) float32)."""
    dt = g.dtype
    return (_mm_nn(g, w.to(dt)).to(dt), _mm_tn(g, y), _colsum(g))


def bwd_layer_reference(dy: torch.Tensor, a: torch.Tensor,
                        c: Optional[torch.Tensor], f: torch.Tensor,
                        context: Optional[torch.Tensor],
                        weights: Sequence[torch.Tensor], *, heads: int,
                        head_dim: int,
                        dctx_sum: Optional[torch.Tensor] = None):
    """Plain version of K2: one layer's backward from its stashed inputs
    ``a`` (self-attention), ``c`` (cross-attention) and ``f``
    (feed-forward), all (b, L, C) in the compute dtype, like ``dy`` and the
    context.  ``weights``: the layer's ABI entries (8 self, 8 cross with a
    context, 4 feed-forward).  Returns (dy_prev in the compute dtype,
    dcontext or None, float32 weight grads in ``weights``' order).

    dcontext is rounded to the compute dtype and added to ``dctx_sum`` (the
    later layers' sum) in that dtype, as the JAX chain sums it.  The running
    dy stays float32 inside the layer and is rounded at its output; dh is
    rounded after the exact GELU derivative."""
    dt = dy.dtype
    cross = context is not None
    ff0 = 16 if cross else 8
    w0, b0, w2 = weights[ff0], weights[ff0 + 1], weights[ff0 + 2]
    dy32 = dy.float()
    # feed-forward backward at the stashed input f
    gval, gder = _gelu_value_and_grad(_mm(f, w0) + b0)
    d_w2, d_b2 = _mm_tn(dy, gval.to(dt)), _colsum(dy32)
    dh32 = _mm_nn(dy, w2) * gder
    dh_dt = dh32.to(dt)
    d_w0, d_b0 = _mm_tn(dh_dt, f), _colsum(dh32)
    dy32 = dy32 + _mm_nn(dh_dt, w0)
    dctx = None
    cross_grads: List[torch.Tensor] = []
    if cross:
        da, dctx32, cross_grads = _attention_bwd_reference(
            dy32, c, context.to(dt), weights[8:16], heads, head_dim)
        dy32 = dy32 + da
        dctx = dctx32.to(dt)
        if dctx_sum is not None:
            dctx = dctx_sum + dctx
    da, dkv_src, self_grads = _attention_bwd_reference(
        dy32, a, a, weights[:8], heads, head_dim)
    dy32 = dy32 + da + dkv_src
    return (dy32.to(dt), dctx,
            self_grads + cross_grads + [d_w0, d_b0, d_w2, d_b2])


def bwd_conv_in_gn_reference(dy0: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, gn_scale: torch.Tensor,
                             gn_bias: torch.Tensor):
    """Plain version of K4: recompute GroupNorm(32, eps 1e-6), then the
    conv-in and GroupNorm backward.  dy0, x (b, L, C) and w (C, C) in the
    compute dtype, gn_scale/gn_bias (C,) -> (dx in the compute dtype, dW,
    db, d gn_scale, d gn_bias float32)."""
    dt = x.dtype
    b, length, c = x.shape
    groups = 32
    xf = x.float().reshape(b, length, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + 1e-6)
    xhat = ((xf - mean) * rstd).reshape(b, length, c)
    gs = gn_scale.float()
    y_dt = (xhat * gs + gn_bias.float()).to(dt)
    d_w, d_b = _mm_tn(dy0, y_dt), _colsum(dy0)
    dy32 = _mm_nn(dy0, w.to(dt))
    d_gs, d_gb = _colsum(dy32 * xhat), _colsum(dy32)
    dxh = (dy32 * gs).reshape(b, length, groups, c // groups)
    xh = xhat.reshape(b, length, groups, c // groups)
    m1 = dxh.mean(dim=(1, 3), keepdim=True)
    m2 = (dxh * xh).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (dxh - m1 - xh * m2)).reshape(b, length, c)
    return dx.to(dt), d_w, d_b, d_gs, d_gb


_EPILOGUES = {"none": 0, "bias": 1, "bias_res": 2, "bias_gelu": 3, "res": 4,
              "mul": 5}


def _gemm_shapes(x: torch.Tensor, y: torch.Tensor, layout: str):
    """(M, N, K) of a product and the strides of its operands, A[m, k] at
    (sam, sak) and B[k, n] at (sbk, sbn): ``nt`` out = x y^T with x (M, K),
    y (N, K); ``nn`` out = x y with y (K, N); ``tn`` out = x^T y with x (K,
    M), y (K, N), the weight grad of ``nt`` summed over K rows."""
    if x.dim() != 2 or y.dim() != 2 or layout not in ("nt", "nn", "tn"):
        raise ValueError(f"gemm_tc takes two matrices and a layout nt, nn or "
                         f"tn, got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{layout!r}")
    if layout == "nt":
        (m, k), (n, k2) = x.shape, y.shape
        strides = (x.stride(0), x.stride(1), y.stride(1), y.stride(0))
    elif layout == "nn":
        (m, k), (k2, n) = x.shape, y.shape
        strides = (x.stride(0), x.stride(1), y.stride(0), y.stride(1))
    else:
        (k, m), (k2, n) = x.shape, y.shape
        strides = (x.stride(1), x.stride(0), y.stride(0), y.stride(1))
    if k != k2:
        raise ValueError(f"gemm_tc {layout}: inner sizes {k} and {k2} differ")
    return m, n, k, strides


def gemm_tc_reference(x: torch.Tensor, y: torch.Tensor, layout: str, *,
                      epi: str = "none", bias: Optional[torch.Tensor] = None,
                      res: Optional[torch.Tensor] = None,
                      mul: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      want_out_t: bool = False):
    """Plain version of the stack kernels' GEMM (``gemm_tc``): the product
    of ``layout`` in float32, then the epilogue in float32 -- ``bias``
    (+ bias[n]), ``bias_res`` ((acc + bias) rounded to the output type, +
    res), ``bias_gelu`` (exact GELU of acc + bias), ``res`` (+ res), ``mul``
    (* mul) -- and the output in ``out_dtype`` (x's by default); with
    ``want_out_t`` also the same value in x's dtype.  Returns (out, out_t or
    None)."""
    _gemm_shapes(x, y, layout)
    odt = out_dtype or x.dtype
    a, b = x.float(), y.float()
    v = a @ b.t() if layout == "nt" else (a @ b if layout == "nn"
                                          else a.t() @ b)
    if epi == "bias":
        v = v + bias.float()
    elif epi == "bias_res":
        v = (v + bias.float()).to(odt).float() + res.float()
    elif epi == "bias_gelu":
        v = torch.nn.functional.gelu(v + bias.float())
    elif epi == "res":
        v = v + res.float()
    elif epi == "mul":
        v = v * mul.float()
    elif epi != "none":
        raise ValueError(f"unknown epilogue {epi!r}")
    return v.to(odt), (v.to(x.dtype) if want_out_t else None)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.t1d_workspace_elems.argtypes = [_I] * 8
        lib.t1d_workspace_elems.restype = ctypes.c_longlong
        lib.t1d_num_weights.argtypes = [_I, _I]
        lib.t1d_num_weights.restype = _I
        lib.t1d_num_stash_slots.argtypes = [_I, _I]
        lib.t1d_num_stash_slots.restype = _I
        lib.t1d_forward.argtypes = [_P] * 5 + [_I, _P] + [_I] * 12 + [_P]
        lib.t1d_forward.restype = _I
        lib.t1d_error_string.argtypes = [_I]
        lib.t1d_error_string.restype = ctypes.c_char_p
        lib.t1d_fwd_gemm_tc_launches.argtypes = [_I]
        lib.t1d_fwd_gemm_tc_launches.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _bwd_library() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        _BWD_LIB = bind_bwd_library(cuda_build.load(BWD_SOURCE))
    return _BWD_LIB


def bind_bwd_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of the entries of a library built from ``BWD_SOURCE``
    (also a copy built with other flags, as ``tools/check_torch_gemm.py
    --trace`` builds one)."""
    lib.t1d_bwd_workspace_bytes.argtypes = [_I] * 9
    lib.t1d_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.t1d_bwd_conv_out.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.t1d_bwd_conv_out.restype = _I
    lib.t1d_bwd_conv_out_partial_elems.argtypes = [_I] * 3
    lib.t1d_bwd_conv_out_partial_elems.restype = ctypes.c_longlong
    lib.t1d_bwd_layer.argtypes = ([_P] * 6 + [_I] + [_P] * 2 + [_I]
                                  + [_P] * 2 + [_I] * 10 + [_P])
    lib.t1d_bwd_layer.restype = _I
    lib.t1d_bwd_conv_in_gn.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.t1d_bwd_conv_in_gn.restype = _I
    lib.t1d_bwd_error_string.argtypes = [_I]
    lib.t1d_bwd_error_string.restype = ctypes.c_char_p
    _L, _IP = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    lib.t1d_gemm_tc.argtypes = ([_P, _L, _L, _P, _L, _L, _P] + [_I] * 5
                                + [_P] * 4 + [_I, _P, _IP, _IP, _I, _I, _P])
    lib.t1d_gemm_tc.restype = _I
    lib.t1d_gemm_partial_elems.argtypes = [_I] * 3
    lib.t1d_gemm_partial_elems.restype = _L
    lib.t1d_bwd_gemm_tc_launches.argtypes = [_I]
    lib.t1d_bwd_gemm_tc_launches.restype = _L
    return lib


def _raise_on(err: int, what: str, lib: ctypes.CDLL, strerror: str) -> None:
    if err != 0:
        msg = getattr(lib, strerror)(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CPU tensors (the plain version's case); False for CUDA
    tensors; raises for anything else, or for a mix."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"stack kernels take CPU or CUDA tensors (all on one), "
                     f"not {sorted(devices)}")


def _check_rows(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                dtype: torch.dtype, device: torch.device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"contiguous={t.is_contiguous()}")


def _check_cuda_args(x: torch.Tensor, context: Optional[torch.Tensor],
                     weights: List[torch.Tensor], heads: int, head_dim: int,
                     multiplier: int) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"stack kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (b, L, C) tensor, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, length, c = x.shape
    if c % 32 or not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"stack kernel takes C % 32 == 0 and 1 <= L <= "
                         f"{MAX_LENGTH}, got L={length}, C={c}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} > {MAX_HEAD_DIM}")
    if context is not None:
        if (not 1 <= context.shape[1] <= MAX_CONTEXT
                or context.device != x.device):
            raise ValueError(f"context must be (b, m <= {MAX_CONTEXT}, "
                             f"C_ctx) on {x.device}, got "
                             f"{tuple(context.shape)} on {context.device}")
    for wt in weights:
        if wt.device != x.device:
            raise ValueError(f"weight on {wt.device}, x on {x.device}")
    if len(weights) > 6:       # at least one layer: check its widths
        to_q, ff0 = weights[8], weights[4 + (16 if context is not None else 8)]
        if tuple(to_q.shape) != (heads * head_dim, c):
            raise ValueError(f"to_q weight {tuple(to_q.shape)} does not fit "
                             f"{heads} heads x {head_dim} at C={c}")
        if tuple(ff0.shape) != (multiplier * c, c):
            raise ValueError(f"feed_forward.0 weight {tuple(ff0.shape)} does "
                             f"not fit multiplier {multiplier} at C={c}")


def _launch_forward(weights: List[torch.Tensor], x: torch.Tensor,
                    context: Optional[torch.Tensor], *, num_layers: int,
                    heads: int, head_dim: int, multiplier: int,
                    with_stash: bool, uniform_ctx: bool):
    """Launch the stack kernel on CUDA tensors (``weights``: the kernel's
    list, ``_kernel_weights``) and count the launch: ``STASH_LAUNCHES``
    with a stash, else ``UNIFORM_LAUNCHES`` or ``LAUNCHES``.  The counters
    move only here, where a kernel is enqueued, so a traced call counts
    nothing and a CUDA graph's replays count nothing either."""
    global LAUNCHES, STASH_LAUNCHES, UNIFORM_LAUNCHES
    cross = context is not None
    _check_cuda_args(x, context, weights, heads, head_dim, multiplier)
    ctx = context.to(x.dtype).contiguous() if cross else None
    b, length, c = x.shape
    ctx_len, ctx_c = (ctx.shape[1], ctx.shape[2]) if cross else (0, 0)

    lib = _library()
    n = lib.t1d_num_weights(num_layers, int(cross))
    if n != len(weights):
        raise ValueError(f"kernel expects {n} weights, got {len(weights)}")
    ptrs = (ctypes.c_void_p * n)(*[wt.data_ptr() for wt in weights])
    out = torch.empty_like(x)
    stash = (torch.empty((lib.t1d_num_stash_slots(num_layers, int(cross)),
                          b, length, c), dtype=x.dtype, device=x.device)
             if with_stash else None)
    work = torch.empty(
        lib.t1d_workspace_elems(b, length, c, ctx_len, ctx_c, heads, head_dim,
                                multiplier),
        dtype=x.dtype, device=x.device)
    err = lib.t1d_forward(
        x.data_ptr(), ctx.data_ptr() if cross else None, out.data_ptr(),
        stash.data_ptr() if with_stash else None, ptrs, n, work.data_ptr(),
        b, length, c, ctx_len, ctx_c, int(uniform_ctx), num_layers, heads,
        head_dim, multiplier, _DTYPES[x.dtype], x.device.index, _stream(x))
    _raise_on(err, "transformer1d stack kernel", lib, "t1d_error_string")
    if with_stash:
        STASH_LAUNCHES += 1
        return out, stash
    if uniform_ctx:
        UNIFORM_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


@torch.library.custom_op("mdt_torch::t1d_forward", mutates_args=())
def t1d_forward_op(x: torch.Tensor, context: Optional[torch.Tensor],
                   weights: List[torch.Tensor], num_layers: int, heads: int,
                   head_dim: int, multiplier: int,
                   uniform_ctx: bool) -> torch.Tensor:
    """K1 (and its uniform-context variant) as a PyTorch operator, so that
    ``torch.export`` records it as one graph node and a CUDA graph captures
    its launch.  ``weights``: the kernel's list (``_kernel_weights``).  On
    CUDA tensors it launches the kernel, on CPU tensors it runs the plain
    version."""
    if x.device.type == "cpu":
        params = dict(zip(_abi_names(num_layers, context is not None),
                          weights))
        return transformer1d_reference(
            params, x, context, num_layers=num_layers, heads=heads,
            head_dim=head_dim, multiplier=multiplier, uniform_ctx=uniform_ctx)
    return _launch_forward(weights, x, context, num_layers=num_layers,
                           heads=heads, head_dim=head_dim,
                           multiplier=multiplier, with_stash=False,
                           uniform_ctx=uniform_ctx)


@t1d_forward_op.register_fake
def _t1d_forward_fake(x, context, weights, num_layers, heads, head_dim,
                      multiplier, uniform_ctx):
    return torch.empty_like(x)


def transformer1d_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                          context: Optional[torch.Tensor], *,
                          num_layers: int, heads: int, head_dim: int,
                          multiplier: int, with_stash: bool = False,
                          uniform_ctx: bool = False):
    """Run a Transformer1d stack: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor; raises for anything the kernel does not
    take.  x (b, L, C); context (b, m, C_ctx), (1, m, C_ctx) with
    ``uniform_ctx``, or None; returns (b, L, C) in x's dtype, and with
    ``with_stash`` also the stash (slots, b, L, C) of
    ``transformer1d_reference``.  ``LAUNCHES`` counts the plain forward's
    launches, ``UNIFORM_LAUNCHES`` the uniform-context ones and
    ``STASH_LAUNCHES`` those with a stash.

    Without a stash (serving) the call goes through the operator
    ``mdt_torch::t1d_forward``; the stash (training) is called directly,
    inside the autograd function ``_Stack``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stack kernel takes CPU or CUDA tensors, not "
                         f"{x.device}")
    _check_context_batch(x, context, uniform_ctx)
    weights = _kernel_weights(params, num_layers, context is not None,
                              x.dtype)
    geometry = dict(num_layers=num_layers, heads=heads, head_dim=head_dim,
                    multiplier=multiplier)
    if not with_stash:
        return torch.ops.mdt_torch.t1d_forward(
            x, context, weights, num_layers, heads, head_dim, multiplier,
            uniform_ctx)
    if x.device.type == "cpu":
        return transformer1d_reference(params, x, context, with_stash=True,
                                       uniform_ctx=uniform_ctx, **geometry)
    return _launch_forward(weights, x, context, with_stash=True,
                           uniform_ctx=uniform_ctx, **geometry)


def bwd_workspace(x: torch.Tensor, context: Optional[torch.Tensor], *,
                  heads: int, head_dim: int, multiplier: int
                  ) -> torch.Tensor:
    """Scratch for ``bwd_layer``, ``bwd_conv_in_gn`` and ``bwd_conv_out`` on
    the card: one buffer serves a whole backward chain."""
    b, length, c = x.shape
    ctx_len, ctx_c = ((context.shape[1], context.shape[2])
                      if context is not None else (0, 0))
    nbytes = _bwd_library().t1d_bwd_workspace_bytes(
        b, length, c, ctx_len, ctx_c, heads, head_dim, multiplier,
        _DTYPES[x.dtype])
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"stack kernels take float32 or bfloat16, not "
                        f"{x.dtype}")


def bwd_conv_out(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 workspace: Optional[torch.Tensor] = None):
    """K3, the conv-out backward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  g, y (b, L, C), w (C, C) in the compute
    dtype -> (dy (b, L, C) in the compute dtype, dW (C, C), db (C,)
    float32).  ``workspace``: scratch for the partial sums of the weight
    grad and of db, split over rows (a ``bwd_workspace`` of the chain, whose
    start it uses); without one the wrapper allocates it."""
    global CONV_OUT_BWD_LAUNCHES
    if _on_cpu(g, y, w, workspace):
        return bwd_conv_out_reference(g, y, w)
    _check_dtype(g)
    dt, dev = g.dtype, g.device
    c = g.shape[-1]
    if c % 32:
        raise ValueError(f"stack kernel takes C % 32 == 0, got C={c}")
    _check_rows("g", g, g.shape, dt, dev)
    _check_rows("y", y, g.shape, dt, dev)
    _check_rows("w", w, (c, c), dt, dev)
    rows = g.numel() // c
    lib = _bwd_library()
    need = 4 * lib.t1d_bwd_conv_out_partial_elems(rows, c, _DTYPES[dt])
    if workspace is None:
        workspace = torch.empty(max(need, 4), dtype=torch.uint8, device=dev)
    elif (workspace.device != dev or not workspace.is_contiguous()
          or workspace.numel() * workspace.element_size() < need):
        raise ValueError(f"conv-out backward needs a contiguous workspace of "
                         f"{need} bytes on {dev}, got "
                         f"{workspace.numel() * workspace.element_size()} on "
                         f"{workspace.device}")
    dy = torch.empty_like(g)
    dw = torch.empty((c, c), dtype=torch.float32, device=dev)
    db = torch.empty((c,), dtype=torch.float32, device=dev)
    err = lib.t1d_bwd_conv_out(g.data_ptr(), y.data_ptr(), w.data_ptr(),
                               dy.data_ptr(), dw.data_ptr(), db.data_ptr(),
                               workspace.data_ptr(), rows, c, _DTYPES[dt],
                               dev.index, _stream(g))
    _raise_on(err, "conv-out backward kernel", lib, "t1d_bwd_error_string")
    CONV_OUT_BWD_LAUNCHES += 1
    return dy, dw, db


def bwd_layer(dy: torch.Tensor, a: torch.Tensor, c: Optional[torch.Tensor],
              f: torch.Tensor, context: Optional[torch.Tensor],
              weights: Sequence[torch.Tensor], *, heads: int, head_dim: int,
              dctx_sum: Optional[torch.Tensor] = None,
              workspace: Optional[torch.Tensor] = None):
    """K2, one layer's backward: the CUDA kernel for CUDA tensors, the plain
    version (``bwd_layer_reference``, which documents the arguments) for
    CPU tensors.  On the card dcontext is added into ``dctx_sum`` in place
    when it is given; either way the sum is returned."""
    global LAYER_BWD_LAUNCHES
    if _on_cpu(dy, a, c, f, context, *weights):
        return bwd_layer_reference(dy, a, c, f, context, weights, heads=heads,
                                   head_dim=head_dim, dctx_sum=dctx_sum)
    _check_dtype(dy)
    dt, dev = dy.dtype, dy.device
    b, length, ch = dy.shape
    cross = context is not None
    if len(weights) != (20 if cross else 12):
        raise ValueError(f"a layer takes {20 if cross else 12} weights, got "
                         f"{len(weights)}")
    if ch % 32 or not 1 <= length <= MAX_LENGTH or not (
            1 <= head_dim <= MAX_HEAD_DIM):
        raise ValueError(f"stack kernel takes C % 32 == 0, 1 <= L <= "
                         f"{MAX_LENGTH} and head_dim <= {MAX_HEAD_DIM}, got "
                         f"L={length}, C={ch}, head_dim={head_dim}")
    if tuple(weights[4].shape) != (heads * head_dim, ch):
        raise ValueError(f"to_q weight {tuple(weights[4].shape)} does not "
                         f"fit {heads} heads x {head_dim} at C={ch}")
    _check_rows("dy", dy, dy.shape, dt, dev)
    _check_rows("a", a, dy.shape, dt, dev)
    _check_rows("f", f, dy.shape, dt, dev)
    mult = weights[-4].shape[0] // ch
    ctx_len = ctx_c = 0
    if cross:
        if c is None:
            raise ValueError("a cross-attention layer needs its stashed "
                             "input c")
        _check_rows("c", c, dy.shape, dt, dev)
        ctx_len, ctx_c = context.shape[1], context.shape[2]
        if not 1 <= ctx_len <= MAX_CONTEXT:
            raise ValueError(f"context length {ctx_len} > {MAX_CONTEXT}")
        _check_rows("context", context, (b, ctx_len, ctx_c), dt, dev)
        if dctx_sum is None:
            dctx = torch.empty_like(context)
        else:
            _check_rows("dctx_sum", dctx_sum, context.shape, dt, dev)
            dctx = dctx_sum
    for w in weights:
        want = torch.float32 if w.dim() == 1 else dt
        _check_rows("weight", w, tuple(w.shape), want, dev)
    if workspace is None:
        workspace = bwd_workspace(dy, context, heads=heads,
                                  head_dim=head_dim, multiplier=mult)
    grads = [torch.empty(w.shape, dtype=torch.float32, device=dev)
             for w in weights]
    dy_prev = torch.empty_like(dy)
    n = len(weights)
    wptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    gptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
    lib = _bwd_library()
    err = lib.t1d_bwd_layer(
        dy.data_ptr(), a.data_ptr(), c.data_ptr() if cross else None,
        f.data_ptr(), context.data_ptr() if cross else None, wptrs, n,
        dy_prev.data_ptr(), dctx.data_ptr() if cross else None,
        int(dctx_sum is not None), gptrs, workspace.data_ptr(), b, length,
        ch, ctx_len, ctx_c, heads, head_dim, mult, _DTYPES[dt], dev.index,
        _stream(dy))
    _raise_on(err, "layer backward kernel", lib, "t1d_bwd_error_string")
    LAYER_BWD_LAUNCHES += 1
    return dy_prev, (dctx if cross else None), grads


def bwd_conv_in_gn(dy0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                   workspace: Optional[torch.Tensor] = None):
    """K4, the GroupNorm + conv-in backward: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  dy0, x (b, L, C), w (C, C)
    in the compute dtype, gn_scale/gn_bias (C,) float32 -> (dx, dW, db,
    d gn_scale, d gn_bias)."""
    global CONV_IN_GN_BWD_LAUNCHES
    if _on_cpu(dy0, x, w, gn_scale, gn_bias):
        return bwd_conv_in_gn_reference(dy0, x, w, gn_scale, gn_bias)
    _check_dtype(x)
    dt, dev = x.dtype, x.device
    b, length, c = x.shape
    if c % 32 or not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"stack kernel takes C % 32 == 0 and 1 <= L <= "
                         f"{MAX_LENGTH}, got L={length}, C={c}")
    _check_rows("x", x, x.shape, dt, dev)
    _check_rows("dy0", dy0, x.shape, dt, dev)
    _check_rows("w", w, (c, c), dt, dev)
    _check_rows("gn_scale", gn_scale, (c,), torch.float32, dev)
    _check_rows("gn_bias", gn_bias, (c,), torch.float32, dev)
    if workspace is None:
        workspace = bwd_workspace(x, None, heads=1, head_dim=1, multiplier=1)
    dx = torch.empty_like(x)
    dw = torch.empty((c, c), dtype=torch.float32, device=dev)
    db, dgs, dgb = (torch.empty((c,), dtype=torch.float32, device=dev)
                    for _ in range(3))
    lib = _bwd_library()
    err = lib.t1d_bwd_conv_in_gn(
        x.data_ptr(), dy0.data_ptr(), w.data_ptr(), gn_scale.data_ptr(),
        gn_bias.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        dgs.data_ptr(), dgb.data_ptr(), workspace.data_ptr(), b, length, c,
        _DTYPES[dt], dev.index, _stream(x))
    _raise_on(err, "GroupNorm + conv-in backward kernel", lib,
              "t1d_bwd_error_string")
    CONV_IN_GN_BWD_LAUNCHES += 1
    return dx, dw, db, dgs, dgb


def gemm_tc(x: torch.Tensor, y: torch.Tensor, layout: str, *,
            epi: str = "none", bias: Optional[torch.Tensor] = None,
            res: Optional[torch.Tensor] = None,
            mul: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None, want_out_t: bool = False,
            split: bool = False, info: Optional[dict] = None):
    """The stack kernels' GEMM (``csrc/gemm_tc.cuh``) alone: the CUDA entry
    ``t1d_gemm_tc`` for CUDA tensors, ``gemm_tc_reference`` (which documents
    the arguments) for CPU tensors.  x and y may be strided views; bf16 calls
    whose strides and sizes the tensor-core loads take run there, the others
    (and all float32 calls) on the CUDA cores.  ``split`` (``tn``, a plain
    float32 sum): split the rows as K2 splits its weight grads.  ``info``,
    if given, gets the ``route`` the call took (0 CUDA cores, 1 tensor cores
    64 x 64, 2 tensor cores 128 x 128) and the ``splits`` it ran.
    ``gemm_tc_launches`` counts the calls that took the tensor cores."""
    kw = dict(epi=epi, bias=bias, res=res, mul=mul, out_dtype=out_dtype,
              want_out_t=want_out_t)
    if _on_cpu(x, y, bias, res, mul):
        return gemm_tc_reference(x, y, layout, **kw)
    _check_dtype(x)
    m, n, k, (sam, sak, sbk, sbn) = _gemm_shapes(x, y, layout)
    dt, dev = x.dtype, x.device
    odt = out_dtype or dt
    if y.dtype != dt or odt not in (dt, torch.float32) or epi not in _EPILOGUES:
        raise ValueError(f"gemm_tc takes y in x's dtype, out in x's dtype or "
                         f"float32 and an epilogue of {sorted(_EPILOGUES)}, "
                         f"got {y.dtype}, {odt}, {epi!r}")
    if (bias is None) != (epi not in ("bias", "bias_res", "bias_gelu")) or (
            res is None) != (epi not in ("bias_res", "res")) or (
            mul is None) != (epi != "mul"):
        raise ValueError(f"epilogue {epi!r} got bias={bias is not None}, "
                         f"res={res is not None}, mul={mul is not None}")
    if bias is not None:
        _check_rows("bias", bias, (n,), torch.float32, dev)
    if res is not None:
        _check_rows("res", res, (m, n), odt, dev)
    if mul is not None:
        _check_rows("mul", mul, (m, n), torch.float32, dev)
    out = torch.empty((m, n), dtype=odt, device=dev)
    out_t = (torch.empty((m, n), dtype=dt, device=dev) if want_out_t
             else None)
    lib = _bwd_library()
    part = torch.empty(max(lib.t1d_gemm_partial_elems(m, n, k) if split
                           else 0, 1), dtype=torch.float32, device=dev)
    route, used = ctypes.c_int(-1), ctypes.c_int(0)
    err = lib.t1d_gemm_tc(
        x.data_ptr(), sam, sak, y.data_ptr(), sbk, sbn, out.data_ptr(),
        int(odt == torch.float32), m, n, k, _EPILOGUES[epi],
        *[None if t is None else t.data_ptr() for t in (bias, res, mul, out_t)],
        int(split), part.data_ptr(), ctypes.byref(route), ctypes.byref(used),
        _DTYPES[dt], dev.index, _stream(x))
    _raise_on(err, "stack GEMM", lib, "t1d_bwd_error_string")
    if info is not None:
        info.update(route=route.value, splits=used.value)
    return out, out_t


# Products one K3 or one K4 call sends through the GEMM: a weight grad and an
# input grad (K3: dW_out, dy; K4: dW_in, dgn).
CONV_BWD_PRODUCTS = 2


def stack_products(num_layers: int, cross: bool,
                   backward: bool = False) -> int:
    """Products one call of a stack kernel sends through the GEMM: the
    forward's (K1, with or without its stash or a uniform context) q, kv and
    out of each attention, the feed-forward pair and the two 1x1 convs; or,
    with ``backward``, K2's over all ``num_layers`` layers: five for the
    feed-forward (recomputed hidden, dW2, dh, dW0, dy) and eight an
    attention (q, kv, dout, dW_out, dW_q, dW_kv, dq_in, dkv_in).  K3 and K4
    add ``CONV_BWD_PRODUCTS`` each to a backward chain."""
    attns = 2 if cross else 1
    if backward:
        return num_layers * (5 + 8 * attns)
    return 2 + num_layers * (3 * attns + 2)


def gemm_tc_launches(reset: bool = False) -> int:
    """Products the stack libraries (K1's and K2-K4's, whichever are loaded)
    have sent to the tensor cores since they were loaded or last reset."""
    total = 0
    if _LIB is not None:
        total += _LIB.t1d_fwd_gemm_tc_launches(int(reset))
    if _BWD_LIB is not None:
        total += _BWD_LIB.t1d_bwd_gemm_tc_launches(int(reset))
    return total


# --------------------------------------------------------------------------
# the backward chain and the autograd function
# --------------------------------------------------------------------------

def _backward_chain(conv_out, layer, conv_in_gn, params, x, context, stash,
                    g, num_layers, heads, head_dim, workspace):
    cross = context is not None
    dt = x.dtype
    w = _kernel_weights(params, num_layers, cross, dt)
    per_layer = (16 if cross else 8) + 4
    per_stash = 3 if cross else 2
    ctx = context.to(dt).contiguous() if cross else None
    extra = {} if workspace is None else {"workspace": workspace}

    dy, dk_out, db_out = conv_out(g, stash[-1], w[-2], **extra)
    layer_grads: List[List[torch.Tensor]] = [[] for _ in range(num_layers)]
    dctx = None
    for i in reversed(range(num_layers)):
        base, s0 = 4 + i * per_layer, i * per_stash
        dy, dctx, layer_grads[i] = layer(
            dy, stash[s0], stash[s0 + 1] if cross else None,
            stash[s0 + per_stash - 1], ctx, w[base:base + per_layer],
            heads=heads, head_dim=head_dim, dctx_sum=dctx, **extra)
    dx, dk_in, db_in, dgs, dgb = conv_in_gn(dy, x, w[2], w[0], w[1], **extra)
    flat = [dgs, dgb, dk_in, db_in]
    for grads in layer_grads:
        flat += grads
    flat += [dk_out, db_out]
    return (dict(zip(_abi_names(num_layers, cross), flat)), dx,
            dctx.to(context.dtype) if cross else None)


def transformer1d_backward_reference(params: Dict[str, torch.Tensor],
                                     x: torch.Tensor,
                                     context: Optional[torch.Tensor],
                                     stash: torch.Tensor, g: torch.Tensor, *,
                                     num_layers: int, heads: int,
                                     head_dim: int):
    """Plain version of the backward chain (the JAX ``_fused_backward``):
    conv out, the layers from the last, GroupNorm + conv in.  Returns
    ({name: float32 grad in the kernel weight's shape}, dx in x's dtype,
    dcontext in the context's dtype or None)."""
    return _backward_chain(bwd_conv_out_reference, bwd_layer_reference,
                           bwd_conv_in_gn_reference, params, x, context,
                           stash, g, num_layers, heads, head_dim, None)


def transformer1d_backward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                           context: Optional[torch.Tensor],
                           stash: torch.Tensor, g: torch.Tensor, *,
                           num_layers: int, heads: int, head_dim: int,
                           multiplier: int):
    """The backward chain through the kernels (CUDA tensors) or their plain
    versions (CPU tensors); returns what
    ``transformer1d_backward_reference`` returns."""
    workspace = None
    if x.device.type == "cuda":
        workspace = bwd_workspace(x, context, heads=heads, head_dim=head_dim,
                                  multiplier=multiplier)
    return _backward_chain(bwd_conv_out, bwd_layer, bwd_conv_in_gn, params,
                           x, context, stash, g, num_layers, heads, head_dim,
                           workspace)


class _Stack(torch.autograd.Function):
    """The stack forward with its stash, and the backward chain.  Inputs:
    the static geometry, the kernel weights (compute-dtype casts, outside
    the graph), x, the context, then the stack's float32 parameters in ABI
    order, whose grads it returns."""

    @staticmethod
    def forward(ctx, geometry, kparams, x, context, *params):
        num_layers, heads, head_dim, multiplier = geometry
        out, stash = transformer1d_forward(
            kparams, x, context, num_layers=num_layers, heads=heads,
            head_dim=head_dim, multiplier=multiplier, with_stash=True)
        ctx.geometry, ctx.kparams = geometry, kparams
        ctx.shapes = [p.shape for p in params]
        ctx.save_for_backward(x, context, stash)
        return out

    @staticmethod
    def backward(ctx, g):
        x, context, stash = ctx.saved_tensors
        num_layers, heads, head_dim, multiplier = ctx.geometry
        grads, dx, dctx = transformer1d_backward(
            ctx.kparams, x, context, stash, g.contiguous(),
            num_layers=num_layers, heads=heads, head_dim=head_dim,
            multiplier=multiplier)
        names = _abi_names(num_layers, context is not None)
        return (None, None, dx, dctx,
                *[grads[n].reshape(s) for n, s in zip(names, ctx.shapes)])


def transformer1d(kparams: Dict[str, torch.Tensor],
                  params: Dict[str, torch.Tensor], x: torch.Tensor,
                  context: Optional[torch.Tensor], *, num_layers: int,
                  heads: int, head_dim: int, multiplier: int) -> torch.Tensor:
    """The stack with gradients: ``params`` are the stack's own (float32)
    parameters, ``kparams`` the same cast as the kernels take them.  With
    grad enabled and anything requiring grad, the forward stashes and the
    backward runs the chain; otherwise this is ``transformer1d_forward``
    (no stash), as in sampling."""
    cross = context is not None
    ordered = [params[n] for n in _abi_names(num_layers, cross)]
    if torch.is_grad_enabled() and (
            x.requires_grad or (cross and context.requires_grad)
            or any(p.requires_grad for p in ordered)):
        return _Stack.apply((num_layers, heads, head_dim, multiplier),
                            kparams, x, context, *ordered)
    return transformer1d_forward(kparams, x, context, num_layers=num_layers,
                                 heads=heads, head_dim=head_dim,
                                 multiplier=multiplier)


# --------------------------------------------------------------------------
# a kernel forward whose gradient is autograd of a composition
# --------------------------------------------------------------------------

class _Recompute(torch.autograd.Function):
    """``kernel(*inputs)`` forward; backward: autograd of
    ``composition(*inputs)`` recomputed from the saved inputs, with respect
    to the inputs and to ``params`` (the tensors the composition reads).
    The counterpart of the JAX ``custom_vjp``s whose ``bwd`` differentiates
    the slow path: ``resnet_stack_fused`` and ``transformer1d_fused`` with
    ``uniform_ctx``."""

    @staticmethod
    def forward(ctx, kernel, composition, n_inputs, *args):
        ctx.composition, ctx.n_inputs = composition, n_inputs
        ctx.params = args[n_inputs:]
        ctx.save_for_backward(*args[:n_inputs])
        return kernel(*args[:n_inputs])

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        inputs = [None if t is None else t.detach().requires_grad_(want)
                  for t, want in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.composition(*inputs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        args = [*inputs, *ctx.params]
        leaves = [t for t, want in zip(args, need) if want]
        got = iter(torch.autograd.grad(outs, leaves, grads,
                                       allow_unused=True))
        return (None, None, None,
                *[next(got) if want else None for want in need])


def recompute(kernel: Callable, composition: Callable,
              inputs: Sequence[Optional[torch.Tensor]],
              params: Sequence[torch.Tensor]):
    """``kernel(*inputs)``; under autograd, with the gradients of
    ``composition(*inputs)`` for the inputs and ``params``.  Both return a
    tensor or a tuple of tensors of the same shapes."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in [*inputs, *params]):
        return _Recompute.apply(kernel, composition, len(inputs), *inputs,
                                *params)
    return kernel(*inputs)
