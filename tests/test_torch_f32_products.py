"""The arithmetic of the stack GEMM's float32 route on the CPU.

On the card every float32 product of K1-K4 (and K8) runs on the tensor
cores as three TF32 passes (``csrc/gemm_tc.cuh::gemm_tf32x3_kernel``): each
operand x is split into hi = rna(x) and lo = rna(x - hi), both TF32
(``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from zero),
and a product is lo.hi + hi.lo + hi.hi accumulated in float32.  Here that
arithmetic is emulated in PyTorch (rna written out on the int32 view) and
held against JAX's float32 product (``jnp.dot`` at HIGHEST precision) at the
layouts the kernels use -- nt (forward projections), nn (input grads), tn
(weight grads) -- at the 91M model's widths (K up to 2I = 1,024) on a few
hundred rows, within 1e-5 of the output's scale, the band in which
``tests/test_torch_cuda_kernels.py`` holds float32 GEMMs; a single TF32
pass of the same inputs falls outside 1e-4.  Then one stack layer's plain
backward (K2's) and the stash forward (K1's) with every product replaced by
the emulation are held against the Pallas kernels in interpret mode, at the
bands of ``tests/test_torch_stack_backward.py``.  Inputs from numpy with a
seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.ops import transformer_fusion as jtf
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf
from test_torch_stack_backward import (BANDS, HEAD_DIM, HEADS, LAYERS,
                                       _assert_close, _jax_grad_like, _jax_ws,
                                       _layer_inputs, _port_weights, _setup,
                                       _t)

ROWS = 384
# (layout, N, K) at the 91M model's widths: nt out (rows, N) = A (rows, K)
# W (N, K)^T; nn out (rows, K) = G (rows, N) W (N, K); tn dW (N, K) =
# G (rows, N)^T A (rows, K)
PRODUCTS = [("nt", 512, 256), ("nt", 1024, 512), ("nt", 512, 1024),
            ("nn", 256, 512), ("nn", 1024, 512), ("nn", 512, 1024),
            ("tn", 256, 512), ("tn", 1024, 256), ("tn", 512, 1024)]
THREE_PASS_BAND = 1e-5
ONE_PASS_BAND = 1e-4


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: half an
    ulp of the 10-bit mantissa (bit 12) added to the magnitude, the low 13
    bits dropped (finite values)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def three_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) . b (K, N) as the kernel computes it: lo.hi + hi.lo +
    hi.hi of the operands' TF32 splits, float32 sums."""
    a, b = a.float(), b.float()
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def one_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b))


def _operands(layout, n, k, seed=0):
    rng = np.random.default_rng(seed + 7 * n + 13 * k)
    shapes = {"nt": ((ROWS, k), (n, k)), "nn": ((ROWS, n), (n, k)),
              "tn": ((ROWS, n), (ROWS, k))}[layout]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _as_product(layout, x, y):
    """The (a, b) of out = a . b for ``layout``."""
    return {"nt": (x, y.T), "nn": (x, y), "tn": (x.T, y)}[layout]


def _jax_product(a, b):
    return np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_tf32_rounding_keeps_ten_bits():
    """rna keeps 10 mantissa bits, rounds half away from zero, and hi + lo
    gives back x to within 2^-22 of |x|."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    hi = tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    lo = tf32(x - hi)
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -22).all()
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("layout,n,k", PRODUCTS)
def test_three_tf32_passes_hold_the_float32_band(layout, n, k):
    x, y = _operands(layout, n, k)
    a, b = _as_product(layout, x, y)
    want = _jax_product(a, b)
    got = three_pass(torch.from_numpy(np.ascontiguousarray(a)),
                     torch.from_numpy(np.ascontiguousarray(b))).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= THREE_PASS_BAND


@pytest.mark.parametrize("layout,n,k", PRODUCTS[::3])
def test_one_tf32_pass_leaves_the_band(layout, n, k):
    """The same inputs through a single TF32 pass: outside 1e-4 of scale,
    which is why no product of the float32 route takes one."""
    x, y = _operands(layout, n, k)
    a, b = _as_product(layout, x, y)
    got = one_pass(torch.from_numpy(np.ascontiguousarray(a)),
                   torch.from_numpy(np.ascontiguousarray(b))).numpy()
    assert _rel(got, _jax_product(a, b)) > ONE_PASS_BAND


@pytest.fixture
def three_pass_products(monkeypatch):
    """The plain versions' products (``_mm``, ``_mm_nn``, ``_mm_tn``) as the
    float32 route computes them."""
    monkeypatch.setattr(tf, "_mm", lambda a, w: three_pass(a, w.float().t()))
    monkeypatch.setattr(tf, "_mm_nn", lambda g, w: three_pass(g, w))
    monkeypatch.setattr(tf, "_mm_tn", lambda g, a: three_pass(
        tf._rows(g).float().t(), tf._rows(a)))


@pytest.mark.parametrize("cross", [False, True])
def test_layer_backward_with_three_pass_products_matches_pallas(
        three_pass_products, cross):
    """K2's plain version, every product three TF32 passes, against the
    Pallas kernel in interpret mode: dy_prev, dcontext and every weight grad
    within the float32 bands."""
    params, dy, a, c, f, ctx, per_layer = _layer_inputs(cross, "grid1")
    lo = 4 + per_layer
    want_dy, want_dctx, want_flat = jtf._bwd_layer(
        jnp.asarray(dy), jnp.asarray(a), None if c is None else jnp.asarray(c),
        jnp.asarray(f), None if ctx is None else jnp.asarray(ctx),
        _jax_ws(params, cross)[lo:lo + per_layer], heads=HEADS,
        head_dim=HEAD_DIM, interpret=True)
    got_dy, got_dctx, got_flat = tf.bwd_layer_reference(
        _t(dy), _t(a), _t(c), _t(f), _t(ctx),
        _port_weights(params, cross)[lo:lo + per_layer], heads=HEADS,
        head_dim=HEAD_DIM)
    rtol, atol = BANDS["grid1"]
    _assert_close(got_dy, want_dy, rtol, atol, "dy_prev")
    if cross:
        _assert_close(got_dctx, want_dctx, rtol, atol, "dctx")
    names = tf._abi_names(LAYERS, cross)[lo:lo + per_layer]
    for name, g, w in zip(names, got_flat, want_flat):
        _assert_close(g, _jax_grad_like(g, w), rtol, atol, name)


@pytest.mark.parametrize("cross", [False, True])
def test_stash_forward_with_three_pass_products_matches_pallas(
        three_pass_products, cross):
    """K1's plain version with its stash, every product three TF32 passes,
    against the Pallas forward in interpret mode within 2e-5."""
    _, params, x, ctx, _ = _setup(cross, "grid1")
    want_out, want_stash = jtf._fused_forward(
        _jax_ws(params, cross), jnp.asarray(x),
        None if ctx is None else jnp.asarray(ctx), num_layers=LAYERS,
        heads=HEADS, head_dim=HEAD_DIM, multiplier=2, interpret=True,
        with_stash=True)
    out, stash = tf.transformer1d_reference(
        state_dict_from_jax_params(params), _t(x), _t(ctx),
        num_layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM, multiplier=2,
        with_stash=True)
    _assert_close(out, want_out, 0, 2e-5, "out")
    for i in range(stash.shape[0]):
        _assert_close(stash[i], want_stash[i], 0, 2e-5, f"slot {i}")
