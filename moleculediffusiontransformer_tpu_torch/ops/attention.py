"""Softmax attention with the whole K and V of a (batch, head) resident on
the SM, as hand-written CUDA kernels (port of `ops/attention.py`, kernels K9
and K10).

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
  becomes the route ``plan`` picks for the shape (below).
* ``packed_attention`` -> ``attn_packed_forward`` replaces
  ``_packed_attention_kernel`` (`attention.py:96`) for n, m <= 64.  The TPU
  kernel's block-diagonal mask exists to fill its matrix unit with several
  head-batches; masked entries contribute exact zeros, so the function is
  per-head-batch attention.  Its entry takes the same plan: the row route's
  blocks hold as many head-batches as keep ``TARGET_BLOCKS`` blocks in the
  grid, and at small bh a head-batch's rows are spread over teams.  For
  max(n, m) > 64 the JAX function takes its one-shot expression; the port's
  goes to ``attention`` (K9) instead, so that nothing on a CUDA tensor leaves
  the hand-written kernels.
* Both are bound by bytes: at these lengths each element moved takes part in
  a few hundred operations at most.  Every input is read once, every output
  written once, scores and probabilities stay on the SM.

Routes (``plan`` picks one and its block shape; ``csrc/attention.cu`` says
what each does): "row" for a few query rows, K and V read straight into
registers by a team of lanes; "tile" past them in bfloat16 at d >= 16, K
and V staged once a block in bfloat16 with both products on the tensor
cores; "cuda", the first design's CUDA-core tiles staged as float32, for
float32 and d 8 past the row route and for what the others do not hold.  A shape is taken when some route holds it in a block's 232,448
bytes of shared memory (``shared_bytes``); every shape the one-route design
took (4 (m (d + 1) + R (d + m)) bytes, R = min(16, n rounded up to 4)) the
"cuda" route still takes.  Beyond that both functions raise and name
``ops.flash_attention``, the streaming kernels.

Rounding points are the Pallas kernels': q and k widened to float32, scores
float32 and scaled after the product, p / sum rounded to v's dtype before
the product with v, float32 accumulation, one rounding to q's dtype.

Inputs that are not contiguous are refused, not copied: a copy would be one
more pass over tensors whose single pass is the whole cost.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_build
from .transformer_fusion import _DTYPES, _on_cpu, _raise_on, _stream

SOURCE = "attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)    # the head sizes the kernels are built for
PACK_MAX = 64                       # K10's longest n and m, as in JAX
SHARED_LIMIT = 232_448              # bytes of shared memory a block may use
ROUTES = ("row", "tile", "cuda")    # the kernels' route numbers 0, 1, 2
# Query rows up to which the row route is taken.  Measured by the crossover
# sweep of tools/check_torch_attention.py (NVIDIA H100 80GB HBM3, 700 W):
# the row route forced against the tile route (bf16) and the CUDA-core tiles
# (float32) at n = 1 ... 32 for (bh, m, d) = (8,192, 64, 64), (16,384, 65,
# 16) and (16,384, 13, 16), inputs cold.  Each query row costs a row-route
# team a full pass of shuffles while a tile's 16 rows cost about one, so the
# row route wins at n 1 in every case and past it only up to n 3 (float32 at
# m 64, bf16 at m 13), n 6 (bf16 at m 65) and, float32 at m 13, every n of
# the sweep.  The summed time of
# the 96 points a dtype is least at a boundary of 3 (bf16 6.353 ms against
# 6.416 at 1 and 6.467 at 6; float32 17.093 against 17.117 at 1).
ROW_ROUTE_MAX_ROWS = 3
ROW_CHUNKS = 8           # 16-byte chunks of K, and of V, a lane holds at most
ROW_GROUP_CHUNKS = 4     # the same where a team takes part of a warp
ROW_BLOCK_WARPS = 8      # warps a row-route block holds at most
TARGET_BLOCKS = 2 * 132  # blocks a grid should reach: two an SM of an H100
_TILE_ROWS, _TILE_WARPS = 16, 4     # tile route: 16 query rows a warp
_CUDA_ROWS, _CUDA_WARPS = 4, 4      # CUDA-core tiles: 4 query rows a warp

# Kernel launches since import (or the last reset by the caller), one per
# kernel launched on CUDA tensors: K9, K10.
ATTENTION_LAUNCHES = 0
PACKED_ATTENTION_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None


class Plan(NamedTuple):
    """How a call runs: ``route`` (one of ``ROUTES``), ``blocks`` in the
    grid, ``warps`` a block, ``rows`` (query rows a team in the row route,
    a block in the others), ``teams`` (the row route's teams a block: each
    owns one head-batch's rows; 1 elsewhere), ``team_warps`` (warps that
    share one team's K and V), ``lanes`` (lanes of each of them a team
    uses: a warp holds 32 / lanes teams), ``chunks`` (16-byte chunks of K
    and of V a lane holds, row route), ``shared`` bytes a block."""
    route: str
    blocks: int
    warps: int
    rows: int
    teams: int
    team_warps: int
    lanes: int
    chunks: int
    shared: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_plan(bh: int, n: int, m: int, d: int,
              dtype: torch.dtype) -> Optional[Plan]:
    chunk_lanes = d // (16 // (4 if dtype == torch.float32 else 2))
    # spread a head-batch's query rows over teams where bh alone cannot
    # fill TARGET_BLOCKS blocks
    groups = 1 if bh >= TARGET_BLOCKS else min(n, _cdiv(TARGET_BLOCKS, bh))
    rows = _cdiv(n, groups)
    items = bh * _cdiv(n, rows)
    # the fewest lanes whose lanes hold K and V in ROW_GROUP_CHUNKS chunks
    # each, as long as the grid keeps min(items, TARGET_BLOCKS) blocks
    lanes = chunk_lanes
    while lanes < 32 and (
            _cdiv(m, lanes // chunk_lanes) > ROW_GROUP_CHUNKS
            or _cdiv(items, 32 // lanes) < min(items, TARGET_BLOCKS)):
        lanes *= 2
    rows_a_load = lanes // chunk_lanes      # key rows a team-warp reads
    if lanes < 32:
        team_warps = 1
    else:
        team_warps = _cdiv(m, rows_a_load * ROW_CHUNKS)
        if team_warps > ROW_BLOCK_WARPS:
            return None
    chunks = _cdiv(m, rows_a_load * team_warps)
    if team_warps > 1:   # its warps meet at block barriers: the block
        return Plan("row", items, team_warps, rows, 1, team_warps, lanes,
                    chunks, 4 * team_warps * (2 + d))
    per_warp = 32 // lanes
    warps = max(1, min(ROW_BLOCK_WARPS,
                       items // (TARGET_BLOCKS * per_warp)))
    teams = warps * per_warp
    return Plan("row", _cdiv(items, teams), warps, rows, teams, 1, lanes,
                chunks, 0)


def _tile_kv_rows(m: int) -> int:
    """Key rows the tile route stages (``csrc/attention.cu::tile_kv_rows``)."""
    return 16 if m <= 16 else 32 if m <= 32 else _cdiv(m, 64) * 64


def _tile_plan(bh: int, n: int, m: int, d: int,
               dtype: torch.dtype) -> Optional[Plan]:
    if dtype != torch.bfloat16 or d < 16:
        return None
    warps = min(_TILE_WARPS, _cdiv(n, _TILE_ROWS))
    rows = warps * _TILE_ROWS
    return Plan("tile", bh * _cdiv(n, rows), warps, rows, 1, 1, 32, 0,
                2 * d * (rows + 2 * _tile_kv_rows(m)))


def _cuda_plan(bh: int, n: int, m: int, d: int,
               dtype: torch.dtype) -> Optional[Plan]:
    warps = min(_CUDA_WARPS, _cdiv(n, _CUDA_ROWS))
    rows = warps * _CUDA_ROWS
    return Plan("cuda", bh * _cdiv(n, rows), warps, rows, 1, 1, 32, 0,
                4 * (m * (d + 1) + rows * (d + m)))


_PLANS = {"row": _row_plan, "tile": _tile_plan, "cuda": _cuda_plan}


def plan(bh: int, n: int, m: int, d: int, dtype: torch.dtype,
         route: Optional[str] = None) -> Optional[Plan]:
    """The route and block shape of a call, or None where no route takes
    the shape.  The row route up to ``ROW_ROUTE_MAX_ROWS`` query
    rows, then the tile route, then the CUDA-core tiles, then the row route
    past its boundary: the first that fits.  ``route`` forces one route
    (None if it does not take the shape); the crossover sweep uses it."""
    if not (bh >= 1 and n >= 1 and m >= 1 and d in HEAD_DIMS
            and dtype in _DTYPES):
        return None
    if route is not None:
        order = (route,)
    elif n <= ROW_ROUTE_MAX_ROWS:
        order = ("row", "tile", "cuda")
    else:
        order = ("tile", "cuda", "row")
    for name in order:
        p = _PLANS[name](bh, n, m, d, dtype)
        if (p is not None and p.shared <= SHARED_LIMIT
                and p.blocks <= 0x7fffffff):
            return p
    return None


def shared_bytes(n: int, m: int, d: int,
                 dtype: torch.dtype = torch.float32) -> int:
    """Shared memory a block of the shape's plan needs (no route's depends
    on bh); where no route takes the shape, the least any route would
    need."""
    p = plan(1, n, m, d, dtype)
    if p is not None:
        return p.shared
    return min(q.shared for q in (f(1, n, m, d, dtype)
                                  for f in _PLANS.values()) if q is not None)


def attention_takes(n: int, m: int, d: int, dtype: torch.dtype) -> bool:
    """Shapes and types the kernels take: a head size they are built for,
    float32 or bfloat16, and a route whose block holds K and V."""
    return plan(1, n, m, d, dtype) is not None


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
            # q k v o, bh n m d scale dtype, route blocks warps rows
            # team_warps lanes chunks shared, device stream
            fn.argtypes = ([_P] * 4 + [_L, _I, _I, _I, _F, _I, _I, _L]
                           + [_I] * 7 + [_P])
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
    if plan(bh, n, m, d, q.dtype) is None:
        need = shared_bytes(n, m, d, q.dtype)
        raise ValueError(
            f"K and V of m={m} rows at d={d} do not fit a block of any route "
            f"({need} > {SHARED_LIMIT} bytes of shared memory): use "
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
            v: torch.Tensor, scale: float,
            p: Optional[Plan] = None) -> torch.Tensor:
    """Launch ``entry`` with the call's plan (``p``, when given, instead:
    the crossover sweep forces a route with it)."""
    lib = _library()
    o = torch.empty_like(q)
    bh, n, d = q.shape
    m = k.shape[1]
    p = plan(bh, n, m, d, q.dtype) if p is None else p
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, m, d,
        scale, _DTYPES[q.dtype], ROUTES.index(p.route), p.blocks, p.warps,
        p.rows, p.team_warps, p.lanes, p.chunks, p.shared, q.device.index,
        _stream(q))
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
    launches K10's entry with the call's plan; with a longer n or m it goes
    to ``attention`` (K9), where the JAX function takes its one-shot
    expression.  CPU tensors take the plain version.  Raises like
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
