"""The PyTorch port's attention modules and Transformer1d stack against
their JAX twins, on the CPU (fp32 unless stated).

The stack is checked three ways: the port's plain kernel version
``transformer1d_reference`` against the JAX composition
(``disable_fusion=True``) and against the Pallas kernel itself in interpret
mode, and the port's module (both its dispatch and its own composition)
against the JAX composition.  Tolerance: 2e-5 absolute, the primitive band
of the JAX suite, unless stated at the assert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import attention as ja
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
