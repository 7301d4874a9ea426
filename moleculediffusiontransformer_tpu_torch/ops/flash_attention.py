"""Streaming softmax attention for long sequences as hand-written CUDA
kernels, forward and backward (port of `ops/flash_attention.py`, kernels K5,
K6, K7).

``flash_attention(q, k, v)`` computes ``softmax(q k^T * scale) v`` for
q (b, h, n, d) and k, v (b, h, m, d) -- or q (bh, n, d) and k, v (bh, m, d)
-- without ever holding the (n, m) scores in device memory.  On CUDA tensors
it launches ``csrc/flash_attention.cu`` (the forward) and
``csrc/flash_attention_bwd.cu`` (the backward), each built on first use by
``ops.cuda_build``, or raises; on CPU tensors it runs the plain versions
below, the same arithmetic in PyTorch.  There is no fallback from one to the
other.

Which TPU kernel each replaces, what bounds it, what the design does:

* ``flash_forward`` -> ``fa_forward`` replaces ``_fwd_kernel``
  (`flash_attention.py:89`): the online-softmax sweep.  The TPU grid's
  innermost KV dimension, which carried the accumulator, the running max and
  the normaliser in VMEM scratch, is a loop inside one block per
  (bh, 128 query rows).  For bfloat16 inputs both products run on the tensor
  cores (``wgmma`` at d 64 and 128, ``mma.sync`` at d 16 and 32) with p kept
  in registers between them, the KV tiles arrive by ``cp.async`` into a ring
  of swizzled shared memory, and the loop is skewed by one tile so that the
  exponentials of one tile run under the products of the previous one;
  float32 inputs keep a CUDA-core kernel (TF32 would leave the 1e-4 band).
* ``flash_backward`` -> ``fa_backward_dq`` replaces ``_dq_kernel`` (`:185`),
  one block per (bh, tile of query rows) sweeping KV tiles, and
  ``fa_backward_dkv`` replaces ``_dkv_kernel`` (`:220`), one block per
  (bh, tile of KV rows) sweeping query tiles.  Each output tile is written
  once by the block that owns it: no atomics, so dq, dk, dv are bitwise equal
  across calls.  ``di = rowsum(o * do)`` stays a torch expression in the
  wrapper, as `_bwd_pallas:273` computes it outside its kernels.  For
  bfloat16 inputs the five products of a tile run on the tensor cores on
  bf16 operands with float32 accumulation (``wgmma`` at d 64, ``mma.sync``
  at d 16, 32 and 128), with the same ring, and p and ds stay in registers
  between the products; float32 inputs keep CUDA-core kernels.  The C entry
  points choose by dtype and head size.
* All three are bound by operations (4, 6 and 8 ``bh n m d`` flops against
  O(bh (n + m) d) bytes), and each also takes ``bh n m`` exponentials on
  the SMs' special-function units, which the operations bound leaves out.
  ``lse`` and ``di`` are (bh, n) float32: the TPU's 128-lane broadcast of
  them is its tiling, not part of the function.

Split heads.  The kernels read q, k, v, do and write o, dq, dk, dv through a
batch, a head and a row stride each (``stride_problem`` says which layouts
they take), so ``nn.attention`` hands them its (b, h, n, d) views of the
(b, n, h d) projections uncopied, k and v being ``.chunk`` views of one
projection.  o and dq come back in (b, n, h, d) memory and dk, dv in
(b, m, h, d), each as its (b, h, rows, d) view, so that merging the heads
again is free.

Rounding points.  Forward, bfloat16: q k^T a bf16 product summed in
float32; the running max, the normaliser (summed from float32 p) and the
rescale float32; p rounded to bf16 once, as the operand of p v, which sums
in float32; the output rounded once.  Backward, bfloat16: s = q k^T and
dp = do v^T are bf16 products summed in float32; p and ds are computed in
float32 and rounded to bf16 once, as operands of dv = p^T do and of
dq = ds k, dk = ds^T q, which again sum in float32; each output is rounded
once.  (The Pallas kernels do the same for bf16 inputs: their dots run at
default precision, one bf16 pass of the matrix unit.)  float32: float32
throughout.

``nn.attention.sdpa`` routes here when ``flash_takes`` says so, as the JAX
``packed_sdpa`` does: ``flash_enabled()`` (``MDT_FLASH``, default on),
``min(n, m) >= LONG_SEQ_THRESHOLD`` and both lengths multiples of 128.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .transformer_fusion import _DTYPES, _on_cpu, _raise_on, _stream

SOURCE = "flash_attention.cu"           # K5
BWD_SOURCE = "flash_attention_bwd.cu"   # K6, K7
# The length from which ``sdpa`` streams attention: the card's crossover,
# the smallest length of ``chip_smoke.py``'s phase 16 (512 ... 8,192) at
# which streaming wins both the forward and the forward + backward over the
# one-shot product, in two runs on the H100 (PERF.md section 6).  The JAX
# package's constant (2,048) is its TPU's crossover.
LONG_SEQ_THRESHOLD = 512
# n and m must be multiples of it, as in JAX (its lane rule), and routing
# depends on it.  The kernels need less: a bf16 forward block owns 128 query
# rows and sweeps KV tiles of 64; the float32 kernels take multiples of 64.
BLOCK = 128
HEAD_DIMS = (16, 32, 64, 128)   # the head sizes the kernels are built for

# Kernel launches since import (or the last reset by the caller), one per
# kernel launched on CUDA tensors: K5, K6, K7.
FLASH_FWD_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None
# The layouts ``_check`` passed, and the arguments ``_args`` made for each
# but scale and stream: a model calls the kernels on a few layouts again and
# again, and checking and describing them anew each time cost as much host
# time as a short kernel takes.  Each holds at most _LAYOUTS_KEPT entries.
_CHECKED: Dict[tuple, bool] = {}
_ARGS: Dict[tuple, tuple] = {}
_LAYOUTS_KEPT = 256


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


def stride_problem(t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot address ``t``, or None if they can.  They take
    a contiguous (bh, rows, d) tensor, or a (b, h, rows, d) view whose last
    dimension is unit-stride and whose row, head and batch strides are
    multiples of 16 bytes (every load is 16 bytes wide), the row stride below
    2**31 elements: the transposed split-head view of a (b, rows, h, d)
    buffer is one.  Either way the base address is a multiple of 16 bytes.
    A dimension of size 1 has no stride that matters."""
    if t.dim() == 3:
        if not t.is_contiguous():
            return "a (bh, rows, d) tensor must be contiguous"
    elif t.dim() != 4:
        return f"takes 3 or 4 dimensions, not {t.dim()}"
    else:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            return (f"the last dimension must be unit-stride, not "
                    f"{t.stride(-1)}")
        size = t.element_size()
        for name, n, stride in zip(("batch", "head", "row"), t.shape[:3],
                                   t.stride()[:3]):
            if n > 1 and (stride < 0 or stride * size % 16):
                return (f"the {name} stride must be a multiple of 16 bytes, "
                        f"not {stride} x {size} bytes")
        if t.shape[2] > 1 and t.stride(2) >= 2 ** 31:
            return f"the row stride must be below 2**31, not {t.stride(2)}"
    if t.data_ptr() % 16:
        return "the base address must be a multiple of 16 bytes"
    return None


def _layout(tensors: Sequence[torch.Tensor]) -> tuple:
    """What the checks and the strides argument depend on, but the base
    addresses: each tensor's shape, strides, type and device."""
    return tuple((t.shape, t.stride(), t.dtype, t.device) for t in tensors)


def _remember(memo: dict, key: tuple, value):
    if len(memo) >= _LAYOUTS_KEPT:
        memo.clear()
    memo[key] = value
    return value


def _as4(t: torch.Tensor) -> torch.Tensor:
    """A (bh, rows, d) tensor as (bh, 1, rows, d); a 4-D one as it is."""
    return t.unsqueeze(1) if t.dim() == 3 else t


def _split_heads_like(t: torch.Tensor, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """An empty output shaped like ``t``: for a (b, h, rows, d) ``t`` in
    (b, rows, h, d) memory, returned as its (b, h, rows, d) view; for a
    (bh, rows, d) ``t`` contiguous."""
    dtype = t.dtype if dtype is None else dtype
    if t.dim() == 3:
        return torch.empty(t.shape, dtype=dtype, device=t.device)
    b, h, rows, d = t.shape
    return torch.empty((b, rows, h, d), dtype=dtype,
                       device=t.device).transpose(1, 2)


def _placed(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` in the memory layout the kernels give an output shaped like
    ``like`` (the plain versions' route returns the same layout)."""
    if like.dim() == 3:
        return value
    return _split_heads_like(like, value.dtype).copy_(value)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o like q, in q's dtype; lse
    (bh, n) float32).  One-shot softmax in float32, which the online
    rescaling equals algebraically.  For bfloat16 inputs p is rounded to
    bf16 before the product with v, as the tensor-core kernel feeds it to
    the matrix instruction; the normaliser stays the float32 sum.  (The
    kernel rounds p against its running max, this version against the row's
    final max: the two agree within the bf16 band, not bit for bit.)"""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mx = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    if q.dtype == torch.bfloat16:
        p = p.bfloat16().float()
    o = torch.matmul(p, vf) / l
    return o.to(q.dtype), (mx + torch.log(l)).reshape(-1, q.shape[-2])


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) in the inputs'
    dtypes, from the saved output and logsumexp (bh, n).  It repeats the
    kernels' arithmetic: for bfloat16 inputs p and ds are rounded to
    bfloat16 before the second products (then summed in float32, as a tensor
    core sums them); float32 inputs stay float32 throughout."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(s.shape[:-1]).unsqueeze(-1))
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
# strides, b h n m d scale dtype device stream
_TAIL = [ctypes.POINTER(ctypes.c_longlong), _L, _I, _I, _I, _I, _F, _I, _I,
         _P]


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
           **rows: torch.Tensor) -> tuple:
    """Raise unless q (b, h, n, d) or (bh, n, d) and k, v (b, h, m, d) or
    (bh, m, d) are tensors of one type and device, shape and layout that the
    kernels take (``flash_takes``, ``stride_problem``); ``rows`` are further
    tensors that must be like q (o, do) or (bh, n) float32 (lse).  Returns
    the layout's key for ``_args``.  A layout that passed once passes again
    without the checks, as long as every base address is still a multiple
    of 16 bytes."""
    tensors = (q, k, v, *rows.values())
    key = (tuple(rows), _layout(tensors))
    if key in _CHECKED and not any(t.data_ptr() % 16 for t in tensors):
        return key
    if (q.dim() not in (3, 4) or k.dim() != q.dim() or k.shape != v.shape
            or q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"flash attention takes q (b, h, n, d) and k, v "
                         f"(b, h, m, d), or q (bh, n, d) and k, v (bh, m, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, d = q.shape[-2:]
    if not flash_takes(n, k.shape[-2], d, q.dtype):
        raise ValueError(
            f"flash attention kernels take n and m in multiples of {BLOCK}, "
            f"d in {HEAD_DIMS} and float32 or bfloat16, got n={n}, "
            f"m={k.shape[-2]}, d={d}, {q.dtype}")
    like_q = {"q": q, **{name: t for name, t in rows.items()
                         if name != "lse"}}
    for name, t in {**like_q, "k": k, "v": v}.items():
        want = q.shape if name in like_q else k.shape
        if t.shape != want or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be a {tuple(want)} {q.dtype} tensor on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        problem = stride_problem(t)
        if problem:
            raise ValueError(f"flash attention cannot address {name} "
                             f"(strides {t.stride()}): {problem}")
    lse = rows.get("lse")
    bh = q.shape[:-2].numel()
    if lse is not None and (tuple(lse.shape) != (bh, n)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({bh}, {n}) float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    _remember(_CHECKED, key, True)
    return key


def _args(tensors: Sequence[torch.Tensor], q: torch.Tensor, k: torch.Tensor,
          scale: float, key: Optional[tuple] = None) -> tuple:
    """The arguments of an entry point after its pointers: the (batch, head,
    row) strides of ``tensors`` in elements (0 for a dimension of size 1),
    b, h, n, m, d, scale, dtype, device and stream.  Given ``_check``'s key,
    which fixes the outputs' layouts too (``_split_heads_like``), all but
    scale and stream are made once for it."""
    fixed = _ARGS.get(key)
    if fixed is None:
        flat = []
        for t in map(_as4, tensors):
            flat += [st if size > 1 else 0
                     for size, st in zip(t.shape[:3], t.stride()[:3])]
        b, h, n, d = _as4(q).shape
        fixed = ((ctypes.c_longlong * len(flat))(*flat), b, h, n,
                 k.shape[-2], d, _DTYPES[q.dtype], q.device.index)
        if key is not None:
            _remember(_ARGS, key, fixed)
    return (*fixed[:6], scale, *fixed[6:], _stream(q))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, with_lse: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5.  (o like q, lse (bh, n) or None): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; raises for anything the
    kernel does not take (see ``_check``).  A 4-D o is a (b, h, n, d) view
    of (b, n, h, d) memory."""
    global FLASH_FWD_LAUNCHES
    if _on_cpu(q, k, v):
        o, lse = flash_attention_reference(q, k, v, scale)
        return _placed(o, q), (lse if with_lse else None)
    key = _check(q, k, v)
    lib = _library()
    o = _split_heads_like(q)
    lse = (torch.empty((q.shape[:-2].numel(), q.shape[-2]),
                       dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), None if lse is None else lse.data_ptr(),
                         *_args((q, k, v, o), q, k, scale, key))
    _raise_on(err, "flash attention forward kernel", lib, "fa_error_string")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 and K7.  (dq, dk, dv), each like q, k, v, from the forward's saved
    o and lse and the output's cotangent: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors; raises for anything the kernels do
    not take."""
    global FLASH_DQ_LAUNCHES, FLASH_DKV_LAUNCHES
    if _on_cpu(q, k, v, o, lse, do):
        grads = flash_attention_backward_reference(q, k, v, o, lse, do, scale)
        return tuple(_placed(g, t) for g, t in zip(grads, (q, k, v)))
    key = _check(q, k, v, o=o, do=do, lse=lse)
    lib = _bwd_library()
    # di = rowsum(o * do), float32: a torch expression, as the JAX package
    # computes it outside its kernels
    di = (o.float() * do.float()).sum(dim=-1).reshape(lse.shape).contiguous()
    dq, dk, dv = (_split_heads_like(t) for t in (q, k, v))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), di.data_ptr())
    tail = _args((q, k, v, do, dq, dk, dv), q, k, scale, key)
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
        # the cotangent of the merged heads arrives as the same view as o;
        # only one the kernels cannot address (an expanded gradient, say) is
        # copied
        if do.device.type == "cuda" and stride_problem(do):
            do = do.contiguous()
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Streaming softmax attention: q (b, h, n, d); k, v (b, h, m, d) ->
    (b, h, n, d) in q's dtype, a view of (b, n, h, d) memory; or q
    (bh, n, d); k, v (bh, m, d) -> (bh, n, d).  Differentiable: under
    autograd the forward keeps o and the logsumexp and the backward runs the
    dq and dk/dv kernels; without it (sampling) the forward runs without
    lse.  Split-head views are taken as they are, uncopied (see
    ``stride_problem``)."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]
