"""Streaming softmax attention for long sequences as hand-written CUDA
kernels, forward and backward (port of `ops/flash_attention.py`, kernels K5,
K6, K7).

``flash_attention(q, k, v)`` computes ``softmax(q k^T * scale) v`` for
q (bh, n, d) and k, v (bh, m, d) without ever holding the (n, m) scores in
device memory.  On CUDA tensors it launches ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (the backward), each built on
first use by ``ops.cuda_build``, or raises; on CPU tensors it runs the plain
versions below, the same arithmetic in PyTorch.  There is no fallback from
one to the other.

Which TPU kernel each replaces, what bounds it, what the design does:

* ``flash_forward`` -> ``fa_forward`` replaces ``_fwd_kernel``
  (`flash_attention.py:89`): the online-softmax sweep.  The TPU grid's
  innermost KV dimension, which carried the accumulator, the running max and
  the normaliser in VMEM scratch, is a loop inside one block per
  (bh, 64 query rows).  Its products run on the CUDA cores from float32
  tiles in shared memory.
* ``flash_backward`` -> ``fa_backward_dq`` replaces ``_dq_kernel`` (`:185`),
  one block per (bh, tile of query rows) sweeping KV tiles, and
  ``fa_backward_dkv`` replaces ``_dkv_kernel`` (`:220`), one block per
  (bh, tile of KV rows) sweeping query tiles.  Each output tile is written
  once by the block that owns it: no atomics, so dq, dk, dv are bitwise equal
  across calls.  ``di = rowsum(o * do)`` stays a torch expression in the
  wrapper, as `_bwd_pallas:273` computes it outside its kernels.  For
  bfloat16 inputs the five products of a tile run on the tensor cores on
  bf16 operands with float32 accumulation (``wgmma`` at d 64, ``mma.sync``
  at d 16, 32 and 128), the swept tiles arrive by ``cp.async`` into a ring
  of swizzled shared memory, and p and ds stay in registers between the
  products; float32 inputs keep CUDA-core kernels (TF32 would leave the 1e-4
  band).  The C entry points choose by dtype and head size.
* All three are bound by operations (4, 6 and 8 ``bh n m d`` flops against
  O(bh (n + m) d) bytes).  ``lse`` and ``di`` are (bh, n) float32: the TPU's
  128-lane broadcast of them is its tiling, not part of the function.

Rounding points.  Forward: q, k, v widened to float32, float32 scores and
probabilities into the p.v product, the output rounded once.  Backward,
bfloat16: s = q k^T and dp = do v^T are bf16 products summed in float32; p
and ds are computed in float32 and rounded to bf16 once, as operands of
dv = p^T do and of dq = ds k, dk = ds^T q, which again sum in float32; each
output is rounded once.  (The Pallas kernels do the same for bf16 inputs:
their dots run at default precision, one bf16 pass of the matrix unit.)
Backward, float32: float32 throughout.

``nn.attention.sdpa`` routes here when ``flash_takes`` says so, as the JAX
``packed_sdpa`` does: ``flash_enabled()`` (``MDT_FLASH``, default on),
``min(n, m) >= LONG_SEQ_THRESHOLD`` and both lengths multiples of 128.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import cuda_build
from .transformer_fusion import _DTYPES, _on_cpu, _raise_on, _stream

SOURCE = "flash_attention.cu"           # K5
BWD_SOURCE = "flash_attention_bwd.cu"   # K6, K7
# The length from which the JAX package streams attention (its TPU's measured
# crossover).  Kept so that both packages route alike.
LONG_SEQ_THRESHOLD = 2048
BLOCK = 128                 # n and m must be multiples of it, as in JAX
HEAD_DIMS = (16, 32, 64, 128)   # the head sizes the kernels are built for

# Kernel launches since import (or the last reset by the caller), one per
# kernel launched on CUDA tensors: K5, K6, K7.
FLASH_FWD_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None


def flash_enabled() -> bool:
    """The routing switch of ``nn.attention.sdpa``: on unless ``MDT_FLASH`` is
    0/false/off (A/B runs and numerics debugging).  ``flash_attention``
    itself stays callable either way."""
    return os.environ.get("MDT_FLASH", "1") not in ("0", "false", "off")


def flash_takes(n: int, m: int, d: int, dtype: torch.dtype) -> bool:
    """Shapes and types the kernels take: both lengths multiples of 128, a
    head size they are built for, float32 or bfloat16."""
    return (n >= BLOCK and m >= BLOCK and n % BLOCK == 0 and m % BLOCK == 0
            and d in HEAD_DIMS and dtype in _DTYPES)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o (bh, n, d) in q's dtype,
    lse (bh, n) float32).  One-shot softmax in float32, which the online
    rescaling equals algebraically."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mx = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / l
    return o.to(q.dtype), (mx + torch.log(l)).squeeze(-1)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) in the inputs'
    dtypes, from the saved output and logsumexp.  It repeats the kernels'
    arithmetic: for bfloat16 inputs p and ds are rounded to bfloat16 before
    the second products (then summed in float32, as a tensor core sums
    them); float32 inputs stay float32 throughout."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (dp - di) * p * scale
    if q.dtype == torch.bfloat16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


_TAIL = [_L, _I, _I, _I, _F, _I, _I, _P]   # bh n m d scale dtype device stream


def _library() -> ctypes.CDLL:
    """The forward's library (K5)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.fa_forward.argtypes = [_P] * 5 + _TAIL
        lib.fa_forward.restype = _I
        lib.fa_error_string.argtypes = [_I]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_library() -> ctypes.CDLL:
    """The backward's library (K6, K7)."""
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = cuda_build.load(BWD_SOURCE)
        lib.fa_backward_dq.argtypes = [_P] * 7 + _TAIL
        lib.fa_backward_dkv.argtypes = [_P] * 8 + _TAIL
        lib.fa_backward_dq.restype = lib.fa_backward_dkv.restype = _I
        lib.fa_bwd_error_string.argtypes = [_I]
        lib.fa_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **rows: torch.Tensor) -> None:
    """Raise unless q (bh, n, d), k and v (bh, m, d) are contiguous tensors
    of one type and device that the kernels take; ``rows`` are further
    tensors that must be like q (o, do) or (bh, n) float32 (lse)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"flash attention takes q (bh, n, d) and k, v "
                         f"(bh, m, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, d = q.shape
    if not flash_takes(n, k.shape[1], d, q.dtype):
        raise ValueError(
            f"flash attention kernels take n and m in multiples of {BLOCK}, "
            f"d in {HEAD_DIMS} and float32 or bfloat16, got n={n}, "
            f"m={k.shape[1]}, d={d}, {q.dtype}")
    like_q = {"q": q, **{name: t for name, t in rows.items()
                         if name != "lse"}}
    for name, t in {**like_q, "k": k, "v": v}.items():
        want = q.shape if name in like_q else k.shape
        if (t.shape != want or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {tuple(want)} {q.dtype} tensor "
                f"on {q.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device} contiguous={t.is_contiguous()}")
    lse = rows.get("lse")
    if lse is not None and (tuple(lse.shape) != (bh, n)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({bh}, {n}) float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")


def _tail(q: torch.Tensor, k: torch.Tensor, scale: float) -> tuple:
    bh, n, d = q.shape
    return (bh, n, k.shape[1], d, scale, _DTYPES[q.dtype], q.device.index,
            _stream(q))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, with_lse: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5.  (o, lse or None): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; raises for anything the kernel does not take
    (contiguous q (bh, n, d), k and v (bh, m, d); see ``flash_takes``)."""
    global FLASH_FWD_LAUNCHES
    if _on_cpu(q, k, v):
        o, lse = flash_attention_reference(q, k, v, scale)
        return o, (lse if with_lse else None)
    _check(q, k, v)
    lib = _library()
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), None if lse is None else lse.data_ptr(),
                         *_tail(q, k, scale))
    _raise_on(err, "flash attention forward kernel", lib, "fa_error_string")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 and K7.  (dq, dk, dv) from the forward's saved o and lse and the
    output's cotangent: the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors; raises for anything the kernels do not take."""
    global FLASH_DQ_LAUNCHES, FLASH_DKV_LAUNCHES
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    _check(q, k, v, o=o, do=do, lse=lse)
    lib = _bwd_library()
    # di = rowsum(o * do), float32: a torch expression, as the JAX package
    # computes it outside its kernels
    di = (o.float() * do.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), di.data_ptr())
    tail = _tail(q, k, scale)
    err = lib.fa_backward_dq(*ins, dq.data_ptr(), *tail)
    _raise_on(err, "flash attention dq kernel", lib, "fa_bwd_error_string")
    FLASH_DQ_LAUNCHES += 1
    err = lib.fa_backward_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_on(err, "flash attention dk/dv kernel", lib,
              "fa_bwd_error_string")
    FLASH_DKV_LAUNCHES += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Forward = K5 with lse, saving q, k, v, o, lse; backward = K6 and K7
    (the JAX ``_flash_core`` custom vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Streaming softmax attention: q (bh, n, d); k, v (bh, m, d) ->
    (bh, n, d) in q's dtype.  Differentiable: under autograd the forward
    keeps o and the logsumexp and the backward runs the dq and dk/dv
    kernels; without it (sampling) the forward runs without lse.  Inputs
    that are views (split heads) are made contiguous here."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]
