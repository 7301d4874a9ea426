"""The plain version of the stack kernels' GEMM (``csrc/gemm_tc.cuh``, the
product of every K1 and K2 matrix multiply) against JAX, on the CPU.

``gemm_tc_reference`` is what the tensor-core GEMM and its CUDA-core
counterpart compute: the product of a layout (nt: x y^T; nn: x y; tn: x^T
y, the weight grad) summed in float32, then the epilogue in float32 and the
output in its type.  The JAX side is the product primitive the Pallas stack
kernels call, ``jnp.dot(..., preferred_element_type=float32)``, with the
same epilogue written in ``jnp``.  Inputs are made with numpy from a seed.
Bands: 1e-5 of the output's scale for float32 outputs (only the order of
float32 sums differs); one bf16 rounding step (2^-8 of the scale) for bf16
outputs, where the two sums may round to neighbouring bf16 values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.nn.attention import Transformer1d
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

# (layout, epilogue): every epilogue where K1 and K2 use it
CASES = [("nt", "none"), ("nt", "bias"), ("nt", "bias_res"),
         ("nt", "bias_gelu"), ("nn", "none"), ("nn", "res"), ("nn", "mul"),
         ("tn", "none")]
# (rows, n, k): rows are M of nt and nn and the summed K of tn
SHAPES = [(5, 24, 16), (33, 64, 40)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _operands(layout, rows, n, k, seed=0):
    rng = np.random.default_rng(seed + rows + n + k)
    shapes = {"nt": ((rows, k), (n, k)), "nn": ((rows, k), (k, n)),
              "tn": ((rows, n), (rows, k))}[layout]
    out = (n, k) if layout == "tn" else (rows, n)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes], out, rng


def _jax_gemm(x, y, layout, epi, extra, out_dtype):
    a, b = {"nt": (x, y.T), "nn": (x, y), "tn": (x.T, y)}[layout]
    v = jnp.dot(a, b, preferred_element_type=jnp.float32)
    if epi == "bias":
        v = v + extra["bias"]
    elif epi == "bias_res":
        v = (v + extra["bias"]).astype(out_dtype).astype(jnp.float32) + \
            extra["res"].astype(jnp.float32)
    elif epi == "bias_gelu":
        v = jax.nn.gelu(v + extra["bias"], approximate=False)
    elif epi == "res":
        v = v + extra["res"].astype(jnp.float32)
    elif epi == "mul":
        v = v * extra["mul"]
    return v.astype(out_dtype)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("rows,n,k", SHAPES)
@pytest.mark.parametrize("layout,epi", CASES)
def test_gemm_plain_version_matches_jax(layout, epi, rows, n, k, dname):
    tdt, jdt = DTYPES[dname]
    (x, y), out_shape, rng = _operands(layout, rows, n, k)
    # float32 outputs where K2 writes them (weight grads, the running dy),
    # the compute dtype elsewhere
    out_float = layout == "tn" or epi in ("res", "mul")
    extra = {}
    if epi in ("bias", "bias_res", "bias_gelu"):
        extra["bias"] = rng.standard_normal(out_shape[1]).astype(np.float32)
    if epi in ("bias_res", "res"):
        extra["res"] = rng.standard_normal(out_shape).astype(np.float32)
    if epi == "mul":
        extra["mul"] = rng.standard_normal(out_shape).astype(np.float32)
    odt_t = torch.float32 if out_float else tdt
    odt_j = jnp.float32 if out_float else jdt
    t_extra = {key: torch.from_numpy(v).to(odt_t if key == "res"
                                           else torch.float32)
               for key, v in extra.items()}
    j_extra = {key: jnp.asarray(v, odt_j if key == "res" else jnp.float32)
               for key, v in extra.items()}
    got, got_t = tf.gemm_tc_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt), layout,
        epi=epi, out_dtype=odt_t, want_out_t=epi == "mul", **t_extra)
    want = _jax_gemm(jnp.asarray(x, jdt), jnp.asarray(y, jdt), layout, epi,
                     j_extra, odt_j)
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == out_shape and got.dtype == odt_t
    scale = max(np.abs(want).max(), 1e-30)
    band = 1e-5 if odt_t == torch.float32 else 2.0 ** -8
    assert np.abs(got.float().numpy() - want).max() <= band * scale
    if epi == "mul":      # the second output: the same value in x's dtype
        assert got_t.dtype == tdt
        assert torch.equal(got_t, got.to(tdt))
    else:
        assert got_t is None


@pytest.mark.parametrize("dname", list(DTYPES))
def test_gemm_plain_version_is_the_stack_products(dname):
    """The GEMM's plain version computes the products of the stack's plain
    versions (``transformer1d_reference``, ``bwd_layer_reference``) bit for
    bit: x W^T, g W and the weight grad g^T x, in float32."""
    tdt, _ = DTYPES[dname]
    (x, w), _, rng = _operands("nt", 12, 32, 16)
    x, w = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    g = torch.from_numpy(rng.standard_normal((12, 32)).astype(
        np.float32)).to(tdt)
    f32 = dict(out_dtype=torch.float32)
    assert torch.equal(tf.gemm_tc_reference(x, w, "nt", **f32)[0],
                       tf._mm(x, w))
    assert torch.equal(tf.gemm_tc_reference(g, w, "nn", **f32)[0],
                       tf._mm_nn(g, w))
    assert torch.equal(tf.gemm_tc_reference(g, x, "tn", **f32)[0],
                       tf._mm_tn(g, x))


def test_gemm_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; strided views are read as they are."""
    (x, y), _, rng = _operands("nt", 9, 16, 24)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    before = tf.gemm_tc_launches()
    got = tf.gemm_tc(x, y, "nt", epi="bias", bias=bias)
    want = tf.gemm_tc_reference(x, y, "nt", epi="bias", bias=bias)
    assert torch.equal(got[0], want[0]) and got[1] is None
    xt = x.t().contiguous().t()          # the same matrix, column-major
    assert torch.equal(tf.gemm_tc(xt, y, "nt")[0],
                       tf.gemm_tc_reference(x, y, "nt")[0])
    assert tf.gemm_tc_launches() == before


@pytest.mark.parametrize("cross", [False, True])
def test_stack_products_counts_the_plain_versions_products(cross,
                                                           monkeypatch):
    """``stack_products``, the count of tensor-core launches the card checks
    K1 and K2 against, is the number of products (``_mm``, ``_mm_nn``,
    ``_mm_tn``, each one GEMM launch in the kernels) that the plain versions
    of the stack forward, with its stash, and of one layer's backward
    compute."""
    calls = []
    for name in ("_mm", "_mm_nn", "_mm_tn"):
        monkeypatch.setattr(tf, name, lambda *a, _fn=getattr(tf, name):
                            calls.append(1) or _fn(*a))
    layers, heads, head_dim = 2, 2, 8
    gen = torch.Generator().manual_seed(0)
    mod = Transformer1d(layers, 32, heads, head_dim, 2,
                        context_features=16 if cross else None)
    init_parameters(mod, gen)
    x = torch.randn(3, 4, 32, generator=gen)
    ctx = torch.randn(3, 5, 16, generator=gen) if cross else None
    kp = mod.kernel_params()
    out, stash = tf.transformer1d_reference(
        kp, x, ctx, num_layers=layers, heads=heads, head_dim=head_dim,
        multiplier=2, with_stash=True)
    assert len(calls) == tf.stack_products(layers, cross)
    del calls[:]
    per_layer, per_stash = (20, 3) if cross else (12, 2)
    w = tf._kernel_weights(kp, layers, cross, torch.float32)
    tf.bwd_layer_reference(torch.randn(out.shape, generator=gen), stash[0],
                           stash[1] if cross else None, stash[per_stash - 1],
                           ctx, w[4:4 + per_layer], heads=heads,
                           head_dim=head_dim)
    assert len(calls) == tf.stack_products(1, cross, backward=True)


@pytest.mark.parametrize("kernel", ["conv_out", "conv_in_gn"])
def test_conv_bwd_products_count_the_plain_versions_products(kernel,
                                                             monkeypatch):
    """``CONV_BWD_PRODUCTS``, the tensor-core launches the card checks each
    K3 and each K4 call against, is the number of products that the plain
    version of K3 (``bwd_conv_out_reference``) or of K4
    (``bwd_conv_in_gn_reference``) computes: a weight grad (``_mm_tn``) and
    an input grad (``_mm_nn``)."""
    calls = []
    for name in ("_mm", "_mm_nn", "_mm_tn"):
        monkeypatch.setattr(tf, name, lambda *a, _fn=getattr(tf, name),
                            _name=name: calls.append(_name) or _fn(*a))
    rng = np.random.default_rng(3)
    dy, x = (torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    if kernel == "conv_out":
        tf.bwd_conv_out_reference(dy, x, w)
    else:
        gs, gb = (torch.from_numpy(rng.standard_normal(64).astype(
            np.float32)) for _ in range(2))
        tf.bwd_conv_in_gn_reference(dy, x, w, gs, gb)
    assert len(calls) == tf.CONV_BWD_PRODUCTS
    assert sorted(calls) == ["_mm_nn", "_mm_tn"]


@pytest.mark.parametrize("args,match", [
    (((4, 8), (6, 9), "nt"), "inner sizes"),
    (((4, 8), (8, 6), "tt"), "layout"),
    (((4, 8, 1), (8, 6), "nn"), "two matrices"),
])
def test_gemm_refuses_shapes_it_does_not_take(args, match):
    xs, ys, layout = args
    with pytest.raises(ValueError, match=match):
        tf.gemm_tc(torch.zeros(xs), torch.zeros(ys), layout)


def test_gemm_refuses_an_unknown_epilogue():
    with pytest.raises(ValueError, match="epilogue"):
        tf.gemm_tc_reference(torch.zeros(4, 8), torch.zeros(6, 8), "nt",
                             epi="relu")
