"""The port's ``ops.attention`` / ``ops.packed_attention`` (kernels K9, K10)
on the CPU: their plain version against the JAX package's ``jnp`` route and
against the two Pallas kernels run in interpret mode (called from here with
plain full-array block specs, so nothing in the JAX package changes), the
functions on CPU tensors, and what they refuse; then ``plan``, the route and
block shape of a call, at every shape the card tests and ``chip_smoke.py``'s
phase 21 run, the range it takes, and the plan the wrapper hands the kernel.

Bands are ``tests/test_ops.py``'s own: 2e-5 in float32, 3e-2 in bfloat16."""
import functools
import importlib
import math

import chip_smoke as cs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_cuda_kernels as card
import torch
from jax.experimental import pallas as pl

from moleculediffusiontransformer_tpu import ops as jops
from moleculediffusiontransformer_tpu.ops.attention import (
    _attention_kernel, _packed_attention_kernel)
from moleculediffusiontransformer_tpu_torch import ops

at = importlib.import_module(
    "moleculediffusiontransformer_tpu_torch.ops.attention")

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (bh, n, m, d): the AR transformer's decode step, the shapes of
# tests/test_ops.py, a tiny head, lengths off the warp width, one past K10
CASES = [(16, 1, 65, 16), (128, 16, 12, 64), (8, 16, 24, 64), (6, 8, 8, 8),
         (4, 1, 13, 16), (3, 7, 33, 32), (2, 80, 100, 128)]


def _qkv(bh, n, m, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((bh, n, d), (bh, m, d), (bh, m, d))]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pallas_interpret(kernel, arrays, out_rows):
    """One program per leading index, whole blocks, interpret mode."""
    spec = lambda rows, d: pl.BlockSpec((1, rows, d), lambda i: (i, 0, 0))
    q, k, v = arrays
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((q.shape[0], out_rows, q.shape[2]),
                                       q.dtype),
        grid=(q.shape[0],),
        in_specs=[spec(q.shape[1], q.shape[2]), spec(k.shape[1], k.shape[2]),
                  spec(v.shape[1], v.shape[2])],
        out_specs=spec(out_rows, q.shape[2]), interpret=True)(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,n,m,d", CASES)
def test_plain_version_matches_jax(bh, n, m, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(bh, n, m, d, dtype, seed=n + m)
    scale = d ** -0.5
    got = at.attention_reference(tq, tk, tv, scale)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.attention(jq, jk, jv, force_jnp=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    packed = jops.packed_attention(jq, jk, jv)       # the jnp route off-TPU
    np.testing.assert_allclose(_np(got), _np(packed), atol=ATOL[dtype],
                               rtol=0)
    other = at.attention_reference(tq, tk, tv, 0.3)
    np.testing.assert_allclose(
        _np(other), _np(jops.attention(jq, jk, jv, scale=0.3,
                                       force_jnp=True)),
        atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,n,m,d", CASES)
def test_plain_version_matches_pallas_kernels_interpreted(bh, n, m, d, dtype):
    """K9's Pallas kernel at every shape; K10's where the JAX wrapper would
    pack (n, m <= 64 and G = gcd(128 // max(n, m), bh) > 1), with its own
    reshapes."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(bh, n, m, d, dtype, seed=n * m)
    scale = d ** -0.5
    exact = dtype == "float32"
    got = _np(at.attention_reference(tq, tk, tv, scale))
    k9 = _pallas_interpret(
        functools.partial(_attention_kernel, scale=scale, exact=exact),
        (jq, jk, jv), n)
    np.testing.assert_allclose(got, _np(k9), atol=ATOL[dtype], rtol=0)
    g = math.gcd(max(1, 128 // max(n, m)), bh)
    if max(n, m) > 64 or g <= 1:
        return
    packed = [a.reshape(bh // g, g * a.shape[1], d) for a in (jq, jk, jv)]
    k10 = _pallas_interpret(
        functools.partial(_packed_attention_kernel, scale=scale, g=g, n=n,
                          m=m, exact=exact), packed, g * n)
    np.testing.assert_allclose(got, _np(k10.reshape(bh, n, d)),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("bh,n,m,d", CASES)
def test_functions_on_cpu_tensors_take_the_plain_version(bh, n, m, d):
    _, (q, k, v) = _qkv(bh, n, m, d, "float32")
    want = at.attention_reference(q, k, v, d ** -0.5)
    before = (at.ATTENTION_LAUNCHES, at.PACKED_ATTENTION_LAUNCHES)
    assert torch.equal(ops.attention(q, k, v), want)
    assert torch.equal(ops.packed_attention(q, k, v), want)
    assert torch.equal(ops.attention(q, k, v, scale=0.5),
                       at.attention_reference(q, k, v, 0.5))
    # nothing was built, loaded or counted: a count is a launch on the card
    assert (at.ATTENTION_LAUNCHES, at.PACKED_ATTENTION_LAUNCHES) == before
    assert at._LIB is None
    # differentiable on the CPU, where the plain version runs
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.attention(*leaves).sum().backward()
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("fn", ["attention", "packed_attention"])
def test_functions_refuse_what_the_kernels_do_not_take(fn):
    fn = getattr(ops, fn)
    _, (q, k, v) = _qkv(4, 8, 12, 64, "float32")
    with pytest.raises(ValueError):
        fn(q[0], k[0], v[0])                             # not (bh, n, d)
    with pytest.raises(ValueError):
        fn(q, k, v[:, :8])                               # k and v differ
    with pytest.raises(ValueError):
        fn(q[:2], k, v)                                  # bh differs
    with pytest.raises(ValueError):
        fn(q[..., :24].contiguous(), k[..., :24].contiguous(),
           v[..., :24].contiguous())                     # no kernel for d 24
    with pytest.raises(ValueError):
        fn(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fn(q, k.bfloat16(), v)                           # mixed types
    with pytest.raises(ValueError):
        fn(q.transpose(0, 1), k, v)                      # a view
    with pytest.raises(ValueError):
        fn(q[:, :0], k, v)                               # no query rows
    big = torch.zeros(1, 1024, 128)
    with pytest.raises(ValueError, match="flash_attention"):
        fn(torch.zeros(1, 16, 128), big, big.clone())


def test_shared_memory_limit():
    """Every n, m <= 256 fits at every head size.  Each route has its own
    layout: the row route needs shared memory only where a team of several
    warps meets (their maxima, sums and p.v partials); the tile route stages
    Q, K and V in bfloat16; the CUDA-core tiles keep the float32 layout of
    K (then V) with a padded row plus the tile's rows and scores."""
    for d in at.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert at.attention_takes(256, 256, d, dtype)
            assert at.attention_takes(1, 1, d, dtype)
    # the AR decode step: float32 d 16 holds 64 keys a warp, so m 65 takes a
    # team of two warps; bf16 holds 128 and needs none
    assert at.shared_bytes(1, 65, 16) == 4 * 2 * (2 + 16)
    assert at.shared_bytes(1, 65, 16, torch.bfloat16) == 0
    assert at.shared_bytes(256, 256, 128) == 4 * (256 * 129 + 16 * 384)
    assert at.shared_bytes(256, 256, 128, torch.bfloat16) == 2 * 128 * (
        64 + 2 * 256)
    assert at.attention_takes(16, 386, 128, torch.float32)
    assert not at.attention_takes(16, 387, 128, torch.float32)
    assert at.attention_takes(16, 386, 128, torch.bfloat16)
    assert at.plan(1, 64, 384, 128, torch.bfloat16).route == "tile"
    assert at.plan(1, 64, 386, 128, torch.bfloat16).route == "cuda"
    assert at.attention_takes(16, 832, 64, torch.bfloat16)
    assert not at.attention_takes(16, 64, 48, torch.float32)
    assert not at.attention_takes(16, 64, 64, torch.float16)


# --------------------------------------------------------------- the plan

# the card tests' shapes (every route, its edges, m 1, m off a multiple of
# 8) and chip_smoke.py's phase 21 (its 11 and the fixed edges)
PLAN_CASES = sorted(set(card.ATTENTION_CASES) | set(cs.ATTENTION_SHAPES)
                    | set(cs.ATTENTION_EDGE_SHAPES)
                    | {c[:4] for c in card.ATTENTION_LIMIT_CASES})
DTYPES = [torch.float32, torch.bfloat16]
# lanes that hold one row of K (16 bytes a lane), by dtype and d
_CH = {(dt, d): d // (16 // (4 if dt == torch.float32 else 2))
       for dt in DTYPES for d in at.HEAD_DIMS}


def _old_takes(n, m, d):
    """The one-route design's range (every dtype): its float32 staging."""
    rows = min(16, -(-n // 4) * 4)
    return 4 * (m * (d + 1) + rows * (d + m)) <= at.SHARED_LIMIT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,m,d", PLAN_CASES)
def test_plan_covers_the_work(bh, n, m, d, dtype):
    """The route follows the measured boundary, the block fits, the grid
    covers every (head-batch, query row) once, and a K10 call's grid
    reaches min(bh, 264) blocks."""
    p = at.plan(bh, n, m, d, dtype)
    if p is None:
        assert not _old_takes(n, m, d)
        return
    assert p.route in at.ROUTES and p.shared <= at.SHARED_LIMIT
    assert at.shared_bytes(n, m, d, dtype) == p.shared
    row_fits = at.plan(bh, n, m, d, dtype, route="row") is not None
    if n <= at.ROW_ROUTE_MAX_ROWS and row_fits:
        assert p.route == "row"
    elif dtype == torch.bfloat16 and d >= 16 and p.route != "tile":
        assert at.plan(bh, n, m, d, dtype, route="tile") is None
    if p.route == "row":
        assert 1 <= p.chunks <= at.ROW_CHUNKS and p.warps <= 8
        assert _CH[dtype, d] <= p.lanes <= 32 and 32 % p.lanes == 0
        assert p.teams == p.warps // p.team_warps * (32 // p.lanes)
        if p.lanes < 32:
            assert p.chunks <= at.ROW_GROUP_CHUNKS and p.team_warps == 1
        # the team holds all m keys, and every warp of it holds some
        held = p.lanes // _CH[dtype, d] * p.chunks
        assert held * p.team_warps >= m > held * (p.team_warps - 1)
        items = bh * -(-n // p.rows)
        assert p.blocks * p.teams >= items > (p.blocks - 1) * p.teams
        assert p.shared == (4 * p.team_warps * (2 + d)
                            if p.team_warps > 1 else 0)
        assert p.team_warps == 1 or (p.teams, p.warps) == (1, p.team_warps)
    else:
        assert p.teams == p.team_warps == 1 and p.lanes == 32
        assert p.blocks == bh * -(-n // p.rows)
        assert p.rows == p.warps * (16 if p.route == "tile" else 4)
        assert p.warps == min(4, -(-n // (p.rows // p.warps)))
    if p.route == "tile":
        assert dtype == torch.bfloat16 and d >= 16
    if max(n, m) <= at.PACK_MAX:
        assert p.blocks >= min(bh, at.TARGET_BLOCKS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,m,d,route", [
    # the AR decode step (K9 at m 65, K10 at m 13), the 91M and 18M
    # presets' decode-like shapes at n 1 and 2, a wide head
    (16384, 1, 65, 16, "row"), (16384, 1, 13, 16, "row"),
    (8192, 1, 64, 64, "row"), (8192, 2, 12, 64, "row"),
    (4096, 1, 64, 128, "row"), (8192, 3, 64, 64, "row"),
    # past the boundary: both products on the tensor cores in bf16, the
    # CUDA-core tiles in float32
    (8192, 4, 64, 64, "tile"), (8192, 8, 8, 64, "tile"),
    (64, 256, 256, 64, "tile"), (128, 16, 12, 64, "tile"),
    (2, 100, 256, 128, "tile")])
def test_plan_routes(bh, n, m, d, route, dtype):
    p = at.plan(bh, n, m, d, dtype)
    want = route if route == "row" or dtype == torch.bfloat16 else "cuda"
    assert p.route == want


def test_plan_sizes_blocks_by_bh():
    """Few head-batches: a head-batch's query rows spread over teams, a
    team a warp; many: eight warps a block, still two blocks an SM and
    more; short K and V: several teams a warp."""
    small = at.plan(8, 4, 13, 16, torch.bfloat16, route="row")
    assert (small.rows, small.blocks, small.lanes) == (1, 32, 32)
    ar = at.plan(16384, 1, 65, 16, torch.bfloat16)
    assert (ar.route, ar.teams, ar.warps, ar.lanes, ar.chunks,
            ar.blocks) == ("row", 8, 8, 32, 5, 2048)
    # the AR cross-attention: 13 keys of 32 bytes, 8 lanes a team hold
    # them in 4 chunks, 4 teams a warp
    cross = at.plan(16384, 1, 13, 16, torch.bfloat16)
    assert (cross.lanes, cross.chunks, cross.teams, cross.blocks) == (
        8, 4, 32, 512)
    # bh 130: one query row a team; four rows in two groups of two
    assert at.plan(130, 1, 13, 16, torch.bfloat16).blocks == 130
    assert at.plan(130, 4, 13, 16, torch.bfloat16, route="row")[1:4] == (
        260, 1, 2)
    wide = at.plan(8192, 1, 64, 128, torch.bfloat16)
    assert (wide.team_warps, wide.chunks, wide.teams) == (4, 8, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_every_shape_taken_before_is_taken(d, dtype):
    """The range may grow, never shrink: every (n, m) the one-route design
    took (its corners: n, m <= 256 and the largest m at each n) is taken,
    and its plan fits a block."""
    for n in (1, 2, 3, 4, 5, 8, 9, 15, 16, 17, 31, 32, 63, 64, 65, 255, 256,
              1000, 4096):
        ms = [1, 2, 7, 8, 13, 64, 65, 255, 256]
        top = max(m for m in range(1, 5000) if _old_takes(n, m, d))
        ms += [top - 1, top]
        for m in ms:
            if _old_takes(n, m, d):
                p = at.plan(3, n, m, d, dtype)
                assert p is not None and p.shared <= at.SHARED_LIMIT, (
                    n, m, d, dtype)


def test_wrapper_passes_the_plan(monkeypatch):
    """``_launch`` hands the kernel entry the call's plan, route as its
    number, and raises on a non-zero return."""
    calls = []

    class Lib:
        def attn_forward(self, *args):
            calls.append(args)
            return 0

        def attn_packed_forward(self, *args):
            calls.append(args)
            return -3

        def attn_error_string(self, err):
            return b"the block plan does not fit the shape"

    monkeypatch.setattr(at, "_library", lambda: Lib())
    monkeypatch.setattr(at, "_stream", lambda t: 7)
    _, (q, k, v) = _qkv(16384, 1, 65, 16, "bfloat16")
    at._launch("attn_forward", "attention kernel", q, k, v, 0.25)
    p = at.plan(16384, 1, 65, 16, torch.bfloat16)
    args = calls[-1]
    assert args[4:10] == (16384, 1, 65, 16, 0.25, 1)
    assert args[10:18] == (0, p.blocks, p.warps, p.rows, p.team_warps,
                           p.lanes, p.chunks, p.shared)
    assert args[-1] == 7
    forced = at.plan(16384, 1, 65, 16, torch.bfloat16, route="tile")
    at._launch("attn_forward", "attention kernel", q, k, v, 0.25, forced)
    assert calls[-1][10:18] == (1, forced.blocks, forced.warps, forced.rows,
                                1, 32, 0, forced.shared)
    with pytest.raises(RuntimeError, match="block plan"):
        at._launch("attn_packed_forward", "packed attention kernel", q, k, v,
                   0.25)
