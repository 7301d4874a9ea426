"""The port's ``ops.attention`` / ``ops.packed_attention`` (kernels K9, K10)
on the CPU: their plain version against the JAX package's ``jnp`` route and
against the two Pallas kernels run in interpret mode (called from here with
plain full-array block specs, so nothing in the JAX package changes), the
functions on CPU tensors, and what they refuse.

Bands are ``tests/test_ops.py``'s own: 2e-5 in float32, 3e-2 in bfloat16."""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
    """Every n, m <= 256 fits at every head size; the limit is K (then V)
    with a padded row plus the tile's rows and scores in float32."""
    for d in at.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert at.attention_takes(256, 256, d, dtype)
            assert at.attention_takes(1, 1, d, dtype)
    assert at.shared_bytes(1, 65, 16) == 4 * (65 * 17 + 4 * (16 + 65))
    assert at.shared_bytes(256, 256, 128) == 4 * (256 * 129 + 16 * 384)
    assert at.attention_takes(16, 386, 128, torch.float32)
    assert not at.attention_takes(16, 387, 128, torch.float32)
    assert not at.attention_takes(16, 64, 48, torch.float32)
    assert not at.attention_takes(16, 64, 64, torch.float16)
