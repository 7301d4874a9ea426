"""The PyTorch port's attention modules and Transformer1d stack against
their JAX twins, on the CPU (fp32 unless stated).

The stack is checked three ways: the port's plain kernel version
``transformer1d_reference`` against the JAX composition
(``disable_fusion=True``) and against the Pallas kernel itself in interpret
mode, and the port's module (both its dispatch and its own composition)
against the JAX composition; at L 2-16 and, past the whole-row attention
core's 64 rows, at L 65-200 with contexts of 12 and 80 rows.  The gate is
held to the JAX ``fusable``'s length rule at 512 and 513.  Tolerance: 2e-5
absolute, the primitive band of the JAX suite, unless stated at the
assert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import attention as ja
from moleculediffusiontransformer_tpu.ops import transformer_fusion as jtf
from moleculediffusiontransformer_tpu.ops.transformer_fusion import \
    transformer1d_fused
from moleculediffusiontransformer_tpu_torch.nn import attention as ta
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

from test_torch_modules import TOL, _compare, _inputs, _jax_params, _load, \
    _max_diff


HEADS, HEAD_DIM, CTX = 4, 16, (12, 32)


@pytest.mark.parametrize("cross", [False, True])
def test_attention(cross):
    x, c = _inputs(14, (3, 8, 64), (3, *CTX))
    jmod = ja.Attention(64, HEAD_DIM, HEADS,
                        context_features=CTX[1] if cross else None)
    port = ta.Attention(64, HEAD_DIM, HEADS,
                        context_features=CTX[1] if cross else None)
    _compare(jmod, port, [x, c] if cross else [x])


@pytest.mark.parametrize("cross", [False, True])
def test_transformer_block(cross):
    x, c = _inputs(15, (3, 8, 64), (3, *CTX))
    ctx_f = CTX[1] if cross else None
    _compare(ja.TransformerBlock(64, HEADS, HEAD_DIM, 2,
                                 context_features=ctx_f),
             ta.TransformerBlock(64, HEADS, HEAD_DIM, 2,
                                 context_features=ctx_f),
             [x, c] if cross else [x])


STACKS = [(length, cross) for length in (2, 8, 16) for cross in (False, True)]


def _stack(length, cross, seed=16, dtype=np.float32):
    x, c = _inputs(seed, (4, length, 64), (4, *CTX))
    ctx_f = CTX[1] if cross else None
    jmod = ja.Transformer1d(2, 64, HEADS, HEAD_DIM, 2, context_features=ctx_f,
                            disable_fusion=True)
    args = [x, c] if cross else [x]
    params = _jax_params(jmod, args)
    return jmod, params, x, (c if cross else None), ctx_f


def _port_reference(params, x, c, dtype=torch.float32):
    port = _load(ta.Transformer1d(2, 64, HEADS, HEAD_DIM, 2,
                                  context_features=None if c is None
                                  else CTX[1]), params)
    kp = {k: v.detach() for k, v in port.named_parameters()}
    return tf.transformer1d_reference(
        kp, torch.from_numpy(x).to(dtype),
        None if c is None else torch.from_numpy(c).to(dtype),
        num_layers=2, heads=HEADS, head_dim=HEAD_DIM, multiplier=2)


@pytest.mark.parametrize("length,cross", STACKS)
def test_stack_reference_vs_jax_composition(length, cross):
    jmod, params, x, c, _ = _stack(length, cross)
    args = [jnp.asarray(x)] + ([jnp.asarray(c)] if cross else [])
    want = jmod.apply({"params": params}, *args)
    assert _max_diff(_port_reference(params, x, c), want) <= TOL


@pytest.mark.parametrize("length,cross", STACKS)
def test_stack_reference_vs_pallas_kernel(length, cross):
    _, params, x, c, ctx_f = _stack(length, cross)
    want = transformer1d_fused(
        params, jnp.asarray(x), None if c is None else jnp.asarray(c),
        num_layers=2, heads=HEADS, head_dim=HEAD_DIM, multiplier=2,
        context_features=ctx_f, interpret=True)
    assert _max_diff(_port_reference(params, x, c), want) <= TOL


def test_stack_reference_vs_pallas_kernel_bf16():
    """In bf16 the plain version rounds where the Pallas kernel rounds; the
    two differ only in the order of float32 sums before each rounding, so a
    value may land one bf16 step apart and carry that into later layers.
    Bound: 2e-2 of the output's scale — the JAX fused-vs-composition bf16
    band (0.016 abs) was measured on unit-scale outputs; these perturbed
    weights give outputs up to ~5."""
    _, params, x, c, ctx_f = _stack(8, True)
    want = transformer1d_fused(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
        num_layers=2, heads=HEADS, head_dim=HEAD_DIM, multiplier=2,
        context_features=ctx_f, interpret=True)
    got = _port_reference(params, x, c, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert _max_diff(got.float(), want) <= 2e-2 * np.abs(want).max()


# Stacks past the whole-row attention core's 64 rows, which the tiled core
# takes up to the JAX gate's 512: self-attention and cross-attention on
# contexts of 12 and 80 rows, at C 64, 2 heads x 32, one layer.
LONG_HEADS, LONG_HEAD_DIM, LONG_CTX_C = 2, 32, 32
LONG_STACKS = [(length, m) for length in (65, 128, 200)
               for m in (None, 12, 80)]


def _long_stack(length, m, seed=17):
    x, c = _inputs(seed, (2, length, 64), (2, m or 1, LONG_CTX_C))
    ctx_f = LONG_CTX_C if m else None
    jmod = ja.Transformer1d(1, 64, LONG_HEADS, LONG_HEAD_DIM, 2,
                            context_features=ctx_f, disable_fusion=True)
    params = _jax_params(jmod, [x, c] if m else [x])
    port = _load(ta.Transformer1d(1, 64, LONG_HEADS, LONG_HEAD_DIM, 2,
                                  context_features=ctx_f), params)
    kp = {k: v.detach() for k, v in port.named_parameters()}
    return jmod, params, kp, x, (c if m else None), ctx_f


def _long_reference(kp, x, c, dtype=torch.float32):
    return tf.transformer1d_reference(
        kp, torch.from_numpy(x).to(dtype),
        None if c is None else torch.from_numpy(c).to(dtype), num_layers=1,
        heads=LONG_HEADS, head_dim=LONG_HEAD_DIM, multiplier=2)


@pytest.mark.parametrize("length,m", LONG_STACKS)
def test_long_stack_reference_vs_jax_composition(length, m):
    jmod, params, kp, x, c, _ = _long_stack(length, m)
    args = [jnp.asarray(x)] + ([jnp.asarray(c)] if m else [])
    want = jmod.apply({"params": params}, *args)
    assert _max_diff(_long_reference(kp, x, c), want) <= TOL


@pytest.mark.parametrize("length,m", LONG_STACKS)
def test_long_stack_reference_vs_pallas_kernel(length, m):
    _, params, kp, x, c, ctx_f = _long_stack(length, m)
    want = transformer1d_fused(
        params, jnp.asarray(x), None if c is None else jnp.asarray(c),
        num_layers=1, heads=LONG_HEADS, head_dim=LONG_HEAD_DIM, multiplier=2,
        context_features=ctx_f, interpret=True)
    assert _max_diff(_long_reference(kp, x, c), want) <= TOL


@pytest.mark.parametrize("length,m", [(128, None), (200, 80)])
def test_long_stack_reference_vs_pallas_kernel_bf16(length, m):
    """bf16 at the tiled lengths, within 2e-2 of the output's scale (see
    ``test_stack_reference_vs_pallas_kernel_bf16``)."""
    _, params, kp, x, c, ctx_f = _long_stack(length, m)
    want = transformer1d_fused(
        params, jnp.asarray(x, jnp.bfloat16),
        None if c is None else jnp.asarray(c, jnp.bfloat16), num_layers=1,
        heads=LONG_HEADS, head_dim=LONG_HEAD_DIM, multiplier=2,
        context_features=ctx_f, interpret=True)
    got = _long_reference(kp, x, c, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert _max_diff(got.float(), want) <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("length,m", [(128, None), (200, 80)])
def test_long_stack_module_takes_the_kernel_route(length, m, monkeypatch):
    """Past 64 rows the module takes the stack dispatch (on the CPU its plain
    version), not its composition, as the JAX gate fuses it; both match the
    JAX composition."""
    jmod, params, _, x, c, ctx_f = _long_stack(length, m)
    args = [jnp.asarray(x)] + ([jnp.asarray(c)] if m else [])
    want = jmod.apply({"params": params}, *args)
    port = _load(ta.Transformer1d(1, 64, LONG_HEADS, LONG_HEAD_DIM, 2,
                                  context_features=ctx_f), params)
    targs = [torch.from_numpy(x)] + ([torch.from_numpy(c)] if m else [])
    routed = []
    dispatch = tf.transformer1d
    monkeypatch.setattr(tf, "transformer1d", lambda *a, **k: (
        routed.append(a[2].shape[1]), dispatch(*a, **k))[1])
    with torch.no_grad():
        assert _max_diff(port(*targs), want) <= TOL
        assert routed == [length]
        port.disable_fusion = True
        assert _max_diff(port(*targs), want) <= TOL
    assert routed == [length]


@pytest.mark.parametrize("length,cross", STACKS)
def test_stack_module_dispatch(length, cross):
    """The port's Transformer1d on a CPU tensor takes the plain kernel
    version (no kernel launch counted); with ``disable_fusion`` it runs the
    module composition.  Both match the JAX composition."""
    jmod, params, x, c, ctx_f = _stack(length, cross)
    args = [jnp.asarray(x)] + ([jnp.asarray(c)] if cross else [])
    want = jmod.apply({"params": params}, *args)
    port = _load(ta.Transformer1d(2, 64, HEADS, HEAD_DIM, 2,
                                  context_features=ctx_f), params)
    targs = [torch.from_numpy(x)] + ([torch.from_numpy(c)] if cross else [])
    launches = tf.LAUNCHES
    with torch.no_grad():
        assert _max_diff(port(*targs), want) <= TOL
        port.disable_fusion = True
        assert _max_diff(port(*targs), want) <= TOL
    assert tf.LAUNCHES == launches


def test_stack_kernel_gate():
    x = torch.zeros(2, 8, 64)
    ctx = torch.zeros(2, 12, 32)

    def take(x, context, **kw):
        return tf.stack_kernel_takes(x, context, head_dim=HEAD_DIM, **kw)

    assert take(x, ctx, channels=64, dtype=torch.float32)
    assert take(x, None, channels=64, dtype=torch.float32)
    assert not take(x, None, channels=64, dtype=torch.bfloat16)
    assert not take(torch.zeros(2, 8, 48), None, channels=48,
                    dtype=torch.float32)
    assert not take(torch.zeros(2, tf.MAX_LENGTH + 1, 64), None, channels=64,
                    dtype=torch.float32)
    assert not take(x, torch.zeros(2, tf.MAX_CONTEXT + 1, 32), channels=64,
                    dtype=torch.float32)
    # a stack with relative position bias is the composition's, as the JAX
    # gate refuses it
    assert not take(x, ctx, channels=64, dtype=torch.float32,
                    use_rel_pos=True)


@pytest.mark.parametrize("length", [64, 65, 512, 513])
def test_stack_kernel_gate_length_matches_jax(length):
    """The port's gate takes x of L rows exactly where the JAX ``fusable``
    does (its rule: L <= 512), with and without a context."""
    jmod = ja.Transformer1d(1, 64, LONG_HEADS, LONG_HEAD_DIM, 2,
                            context_features=LONG_CTX_C)
    for m in (None, 12):
        jx = jnp.zeros((2, length, 64))
        jc = None if m is None else jnp.zeros((2, m, LONG_CTX_C))
        jax_takes = jtf.fusable(
            jx, jc, False, None if m is None else LONG_CTX_C,
            dtype=jnp.float32, num_layers=jmod.num_layers,
            heads=LONG_HEADS, head_dim=LONG_HEAD_DIM, multiplier=2)
        assert jax_takes is (length <= 512)
        port_takes = tf.stack_kernel_takes(
            torch.zeros(2, length, 64),
            None if m is None else torch.zeros(2, m, LONG_CTX_C),
            channels=64, dtype=torch.float32, head_dim=LONG_HEAD_DIM)
        assert port_takes is jax_takes


@pytest.mark.parametrize("m", [64, 65, 512, 513])
def test_stack_kernel_gate_context_length(m):
    """A context of m rows is the kernel's up to ``MAX_CONTEXT`` (512): the
    JAX gate's length rule held to the context.  (The JAX ``fusable`` has
    no rule of its own for m beyond its VMEM budget, which it meets here:
    past 512 the port's gate is the stricter.)"""
    assert tf.MAX_CONTEXT == 512
    x = torch.zeros(2, 128, 64)
    port_takes = tf.stack_kernel_takes(
        x, torch.zeros(2, m, LONG_CTX_C), channels=64, dtype=torch.float32,
        head_dim=LONG_HEAD_DIM)
    assert port_takes is (m <= 512)
    assert jtf.fusable(jnp.zeros((2, 128, 64)),
                       jnp.zeros((2, m, LONG_CTX_C)), False, LONG_CTX_C,
                       dtype=jnp.float32, num_layers=1, heads=LONG_HEADS,
                       head_dim=LONG_HEAD_DIM, multiplier=2)


def test_stack_kernel_gate_head_size():
    """A head size past ``MAX_HEAD_DIM`` is not the kernel's: the gate says
    so, and the module takes its composition instead of reaching a wrapper
    that would refuse the geometry on the card."""
    x = torch.zeros(2, 8, 64)
    for head_dim, takes in ((tf.MAX_HEAD_DIM, True), (256, False)):
        assert tf.stack_kernel_takes(x, None, channels=64,
                                     dtype=torch.float32,
                                     head_dim=head_dim) is takes


def test_stack_head_256_takes_the_composition(monkeypatch):
    gen = torch.Generator().manual_seed(21)
    port = ta.Transformer1d(1, 32, 2, 256, 2)
    x = torch.randn(2, 8, 32, generator=gen)

    def refuse(*args, **kwargs):
        raise AssertionError("head 256 reached the stack kernel's wrapper")

    monkeypatch.setattr(tf, "transformer1d", refuse)
    with torch.no_grad():
        got = port(x)
        port.disable_fusion = True
        want = port(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("disable_fusion", [False, True])
def test_cross_stack_without_context_raises(disable_fusion):
    """A stack built with ``context_features`` refuses a call without a
    context on both routes, as the JAX module and its ``fusable`` gate do;
    the kernel route used to run with the cross-attention skipped."""
    port = ta.Transformer1d(1, 32, 2, 16, 2, context_features=8,
                            disable_fusion=disable_fusion)
    with pytest.raises(AssertionError, match="You must provide a context"):
        port(torch.zeros(2, 8, 32), context=None)


def test_stack_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card never reaches
    the plain version: the wrapper raises."""
    port = ta.Transformer1d(1, 64, HEADS, HEAD_DIM, 2)
    x = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf.transformer1d_forward(dict(port.named_parameters()), x, None,
                                 num_layers=1, heads=HEADS, head_dim=HEAD_DIM,
                                 multiplier=2)


@pytest.mark.parametrize("length,m", [(200, None), (128, 80)])
def test_long_stack_exports_as_the_kernel_operator(length, m):
    """``torch.export`` of a stack past 64 rows records the K1 operator
    (``mdt_torch::t1d_forward``, whose fake takes any length) as one node,
    so that an artifact of such a model holds the kernel; the exported
    program gives the module's output.  (As ``design/export.py`` traces:
    the kernel parameters handed in, here the float32 parameters as they
    are.)"""
    _, params, _, x, c, ctx_f = _long_stack(length, m)
    port = _load(ta.Transformer1d(1, 64, LONG_HEADS, LONG_HEAD_DIM, 2,
                                  context_features=ctx_f), params).eval()
    port.requires_grad_(False)
    assert port.kernel_casts() == {}
    args = (torch.from_numpy(x),) + ((torch.from_numpy(c),) if m else ())
    port.given_kernel_params = {}
    try:
        program = torch.export.export(port, args)
    finally:
        port.given_kernel_params = None
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"]
    assert ops.count("mdt_torch.t1d_forward.default") == 1
    with torch.no_grad():
        assert torch.equal(program.module()(*args), port(*args))
