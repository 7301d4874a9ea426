"""The Transformer1d stack forward as one hand-written CUDA kernel (port of
`ops/transformer_fusion.py`).

``transformer1d_forward`` runs a whole ``nn.attention.Transformer1d`` stack:
GroupNorm(32, eps 1e-6) -> 1x1 conv in -> per layer [pre-LN self-attention;
pre-LN cross-attention on the context; exact-GELU feed-forward], each
residual -> 1x1 conv out.  On a CUDA tensor it launches the kernel in
``csrc/transformer1d_fwd.cu`` (built on first use by ``ops.cuda_build``) or
raises; on a CPU tensor it runs ``transformer1d_reference``, the same
computation in plain PyTorch.  There is no fallback from one to the other.

Numerics follow the JAX package's Pallas kernel (``_kernel``): norm and
softmax statistics in float32, every product accumulated in float32, q/kv
cast to the compute dtype after projection, probabilities cast before P.V,
each projection's (acc + bias) rounded before the residual add, a residual
stream in the compute dtype, and the feed-forward hidden activation float32
through the GELU.

``params`` is the stack's parameter dict under the reference torch names
(``Transformer1d.named_parameters()``: ``to_in.0.weight``,
``blocks.0.attention.to_q.weight``, ..., ``to_out.1.bias``).  The kernel
wants matrices in the compute dtype and vectors in float32
(``Transformer1d.kernel_params`` caches them so); any other dtype is cast
here, per call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from ..nn.primitives import group_norm, layer_norm
from . import cuda_build

SOURCE = "transformer1d_fwd.cu"
MAX_LENGTH = 64      # rows of q per (batch, head) block in the attention core
MAX_CONTEXT = 64     # rows of k/v per (batch, head) block
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Stack kernel launches since import (or the last reset by the caller):
# one per call of transformer1d_forward on a CUDA tensor.
LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None


def stack_kernel_takes(x: torch.Tensor, context: Optional[torch.Tensor], *,
                       channels: int, dtype: torch.dtype) -> bool:
    """The static part of the JAX ``fusable`` gate: a stack the kernel takes.
    (``use_rel_pos`` is refused by the module itself; the VMEM budget of the
    TPU gate has no counterpart here.)"""
    return (channels % 32 == 0 and x.dim() == 3 and x.shape[-1] == channels
            and x.dtype == dtype and dtype in _DTYPES
            and 1 <= x.shape[1] <= MAX_LENGTH
            and (context is None or 1 <= context.shape[1] <= MAX_CONTEXT))


def _abi_names(num_layers: int, cross: bool) -> List[str]:
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
    return names + ["to_out.1.weight", "to_out.1.bias"]


def _kernel_weights(params: Dict[str, torch.Tensor], num_layers: int,
                    cross: bool, dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's weight list: 1x1 conv weights (out, in, 1) as (out, in)
    matrices, matrices in ``dtype``, vectors in float32, all contiguous."""
    out = []
    for name in _abi_names(num_layers, cross):
        w = params[name]
        if w.dim() == 1:
            out.append(w.float().contiguous())
        else:
            out.append(w.reshape(w.shape[0], -1).to(dtype).contiguous())
    return out


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) . w (N, K)^T in float32 (the kernel's accumulation)."""
    return torch.matmul(a.float(), w.float().t())


def _attention(y: torch.Tensor, kv_src: torch.Tensor, w: List[torch.Tensor],
               heads: int, head_dim: int) -> torch.Tensor:
    ns, nb, cs, cb, wq, wkv, wout, bout = w
    dt = y.dtype
    b, n, _ = y.shape
    m = kv_src.shape[1]
    inner = heads * head_dim
    q = _mm(layer_norm(y, ns, nb).to(dt), wq).to(dt)
    kv = _mm(layer_norm(kv_src, cs, cb).to(dt), wkv).to(dt)
    q = q.reshape(b, n, heads, head_dim).transpose(1, 2)
    k = kv[..., :inner].reshape(b, m, heads, head_dim).transpose(1, 2)
    v = kv[..., inner:].reshape(b, m, heads, head_dim).transpose(1, 2)
    sim = (torch.matmul(q.float(), k.float().transpose(-1, -2))
           * head_dim ** -0.5)
    att = torch.softmax(sim, dim=-1).to(dt)
    o = torch.matmul(att.float(), v.float()).to(dt)
    o = o.transpose(1, 2).reshape(b, n, inner)
    return (_mm(o, wout) + bout).to(dt)


def transformer1d_reference(params: Dict[str, torch.Tensor], x: torch.Tensor,
                            context: Optional[torch.Tensor], *,
                            num_layers: int, heads: int, head_dim: int,
                            multiplier: int) -> torch.Tensor:
    """Plain PyTorch version of the stack kernel, with the kernel's
    rounding.  x (b, L, C); context (b, m, C_ctx) or None."""
    del multiplier   # implied by the feed-forward weights' shapes
    cross = context is not None
    dt = x.dtype
    w = iter(_kernel_weights(params, num_layers, cross, dt))
    ctx = context.to(dt) if cross else None

    gn_scale, gn_bias, k_in, b_in = (next(w) for _ in range(4))
    y32 = group_norm(x, gn_scale, gn_bias, num_groups=32, eps=1e-6)
    y = (_mm(y32.to(dt), k_in) + b_in).to(dt)
    for _ in range(num_layers):
        y = _attention(y, y, [next(w) for _ in range(8)], heads, head_dim) + y
        if cross:
            y = _attention(y, ctx, [next(w) for _ in range(8)], heads,
                           head_dim) + y
        w0, b0, w2, b2 = (next(w) for _ in range(4))
        g = torch.nn.functional.gelu(_mm(y, w0) + b0)
        y = (_mm(g.to(dt), w2) + b2).to(dt) + y
    k_out, b_out = next(w), next(w)
    return (_mm(y, k_out) + b_out).to(dt)


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.t1d_workspace_elems.argtypes = [ctypes.c_int] * 8
        lib.t1d_workspace_elems.restype = ctypes.c_longlong
        lib.t1d_num_weights.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.t1d_num_weights.restype = ctypes.c_int
        lib.t1d_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.t1d_forward.restype = ctypes.c_int
        lib.t1d_error_string.argtypes = [ctypes.c_int]
        lib.t1d_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
        if (context.dim() != 3 or context.shape[0] != b
                or not 1 <= context.shape[1] <= MAX_CONTEXT
                or context.device != x.device):
            raise ValueError(f"context must be (b={b}, m <= {MAX_CONTEXT}, "
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


def transformer1d_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                          context: Optional[torch.Tensor], *,
                          num_layers: int, heads: int, head_dim: int,
                          multiplier: int) -> torch.Tensor:
    """Run a Transformer1d stack: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor; raises for anything the kernel does not
    take.  x (b, L, C); context (b, m, C_ctx) or None; returns (b, L, C) in
    x's dtype."""
    global LAUNCHES
    if x.device.type == "cpu":
        return transformer1d_reference(params, x, context,
                                       num_layers=num_layers, heads=heads,
                                       head_dim=head_dim,
                                       multiplier=multiplier)
    if x.device.type != "cuda":
        raise ValueError(f"stack kernel takes CPU or CUDA tensors, not "
                         f"{x.device}")
    cross = context is not None
    weights = _kernel_weights(params, num_layers, cross, x.dtype)
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
    work = torch.empty(
        lib.t1d_workspace_elems(b, length, c, ctx_len, ctx_c, heads, head_dim,
                                multiplier),
        dtype=x.dtype, device=x.device)
    err = lib.t1d_forward(
        x.data_ptr(), ctx.data_ptr() if cross else None, out.data_ptr(),
        ptrs, n, work.data_ptr(), b, length, c, ctx_len, ctx_c, num_layers,
        heads, head_dim, multiplier, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transformer1d stack kernel failed: "
                           f"{lib.t1d_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    return out
