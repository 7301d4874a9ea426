"""Softmax attention with the whole K and V of a (batch, head) resident in
shared memory, as hand-written CUDA kernels (port of `ops/attention.py`,
kernels K9 and K10).

``attention(q, k, v)`` and ``packed_attention(q, k, v)`` compute
``softmax(q k^T * scale) v`` for q (bh, n, d) and k, v (bh, m, d) and return
(bh, n, d) in q's dtype.  On CUDA tensors they launch ``csrc/attention.cu``
(built on first use by ``ops.cuda_build``) or raise; on CPU tensors they run
``attention_reference``, the same arithmetic in PyTorch.  There is no
fallback from one to the other, and neither is differentiable on the card:
the Pallas calls they replace have no ``custom_vjp``.

Which TPU kernel each replaces, what bounds it, what the design does:

* ``attention`` -> ``attn_forward`` replaces ``_attention_kernel``
  (`attention.py:37`): one program per (batch, head) with everything in VMEM
  becomes one block per (batch-head, tile of up to 16 query rows); the block
  stages that batch-head's whole K, later its whole V, in shared memory once,
  a warp carries four rows, and each row's single-pass softmax is done by
  warp shuffles.
* ``packed_attention`` -> ``attn_packed_forward`` replaces
  ``_packed_attention_kernel`` (`attention.py:96`) for n, m <= 64.  The TPU
  kernel's block-diagonal mask exists to fill its matrix unit with several
  head-batches; masked entries contribute exact zeros, so the function is
  per-head-batch attention and the port gives each warp of a block one
  head-batch, with no mask and no ``gcd`` with bh (tail warps idle).  For
  max(n, m) > 64 the JAX function takes its one-shot expression; the port's
  goes to ``attention`` (K9) instead, so that nothing on a CUDA tensor leaves
  the hand-written kernels.
* Both are bound by bytes: at these lengths each element moved takes part in
  a few hundred operations at most.  Every input is read once, every output
  written once, scores and probabilities stay in the block.

"Whole K/V resident" sets the limit: K9 needs ``shared_bytes(n, m, d)`` =
4 (m (d + 1) + R (d + m)) bytes with R = min(16, n rounded up to 4) rows a
block, which must fit the 232,448 bytes a block may opt into whatever the
dtype (tiles are staged as float32): every n, m <= 256 at d in 8 ... 128
does; with 16 query rows a block m <= 386 at d 128 and m <= 704 at d 64.
Beyond that both functions raise and name ``ops.flash_attention``, the
streaming kernels.

Rounding points are the Pallas kernels': q and k widened to float32, scores
float32 and scaled after the product, p / sum rounded to v's dtype before
the product with v, float32 accumulation, one rounding to q's dtype.

Inputs that are not contiguous are refused, not copied: a copy would be one
more pass over tensors whose single pass is the whole cost.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .transformer_fusion import _DTYPES, _on_cpu, _raise_on, _stream

SOURCE = "attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)    # the head sizes the kernels are built for
PACK_MAX = 64                       # K10's longest n and m, as in JAX
SHARED_LIMIT = 232_448              # bytes of shared memory a block may use
_ROWS_PER_WARP, _MAX_WARPS = 4, 4   # K9's tile: up to 16 query rows a block

# Kernel launches since import (or the last reset by the caller), one per
# kernel launched on CUDA tensors: K9, K10.
ATTENTION_LAUNCHES = 0
PACKED_ATTENTION_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None


def shared_bytes(n: int, m: int, d: int) -> int:
    """Shared memory a K9 block needs: K (then V) with a padded row, the
    tile's query rows and its scores, all float32."""
    warps = min(_MAX_WARPS, -(-n // _ROWS_PER_WARP))
    rows = warps * _ROWS_PER_WARP
    return 4 * (m * (d + 1) + rows * (d + m))


def attention_takes(n: int, m: int, d: int, dtype: torch.dtype) -> bool:
    """Shapes and types the kernels take: a head size they are built for,
    float32 or bfloat16, and K and V that fit a block's shared memory."""
    return (n >= 1 and m >= 1 and d in HEAD_DIMS and dtype in _DTYPES
            and shared_bytes(n, m, d) <= SHARED_LIMIT)


# --------------------------------------------------------------------------
# plain PyTorch version (serves both functions)
# --------------------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain version of both kernels: one-shot softmax attention with their
    rounding points (the probabilities are rounded to v's dtype before the
    second product, which ``flash_attention_reference`` does not do)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        for fn in (lib.attn_forward, lib.attn_packed_forward):
            # q k v o, bh n m d scale dtype device stream
            fn.argtypes = [_P] * 4 + [_L, _I, _I, _I, _F, _I, _I, _P]
            fn.restype = _I
        lib.attn_error_string.argtypes = [_I]
        lib.attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (bh, n, d), k and v (bh, m, d) are contiguous tensors
    of one type and device that the kernels take."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"attention takes q (bh, n, d) and k, v (bh, m, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, n, d = q.shape
    m = k.shape[1]
    if bh < 1 or n < 1 or m < 1 or d not in HEAD_DIMS or q.dtype not in _DTYPES:
        raise ValueError(
            f"attention kernels take non-empty tensors with d in {HEAD_DIMS} "
            f"in float32 or bfloat16, got bh={bh}, n={n}, m={m}, d={d}, "
            f"{q.dtype}")
    if shared_bytes(n, m, d) > SHARED_LIMIT:
        raise ValueError(
            f"K and V of m={m} rows at d={d} do not fit a block's shared "
            f"memory ({shared_bytes(n, m, d)} > {SHARED_LIMIT} bytes): use "
            f"ops.flash_attention, the streaming kernels, for long sequences")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()
                or (t.is_cuda and t.data_ptr() % 16)):
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned {q.dtype} "
                f"tensor on {q.device}, got {t.dtype} on {t.device} "
                f"contiguous={t.is_contiguous()}")


def _refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward kernel (the TPU kernel it replaces has "
            f"no custom_vjp): detach the inputs or run under torch.no_grad()")


def _launch(entry: str, what: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, scale: float) -> torch.Tensor:
    lib = _library()
    o = torch.empty_like(q)
    bh, n, d = q.shape
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n,
        k.shape[1], d, scale, _DTYPES[q.dtype], q.device.index, _stream(q))
    _raise_on(err, what, lib, "attn_error_string")
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None) -> torch.Tensor:
    """K9.  Softmax attention over flattened batch * heads: q (bh, n, d);
    k, v (bh, m, d) -> (bh, n, d) in q's dtype; ``scale`` defaults to
    d ** -0.5.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; raises for what the kernel does not take (see
    ``attention_takes``; views are refused) and for CUDA inputs that require
    grad."""
    global ATTENTION_LAUNCHES
    _check(q, k, v)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v, scale)
    _refuse_grad("ops.attention", q, k, v)
    o = _launch("attn_forward", "attention kernel", q, k, v, scale)
    ATTENTION_LAUNCHES += 1
    return o


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """K10.  The same function for micro-shapes: with n, m <= 64 a CUDA call
    launches the kernel that gives each warp one head-batch; with a longer n
    or m it goes to ``attention`` (K9), where the JAX function takes its
    one-shot expression.  CPU tensors take the plain version.  Raises like
    ``attention``."""
    global PACKED_ATTENTION_LAUNCHES
    _check(q, k, v)
    if max(q.shape[1], k.shape[1]) > PACK_MAX:
        return attention(q, k, v, scale=scale)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v, scale)
    _refuse_grad("ops.packed_attention", q, k, v)
    o = _launch("attn_packed_forward", "packed attention kernel", q, k, v,
                scale)
    PACKED_ATTENTION_LAUNCHES += 1
    return o
