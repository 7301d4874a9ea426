"""The shared-KV CFG null half (K1 ``uniform_ctx``) in the PyTorch port
against the JAX package on the CPU, fp32: the plain version against
``transformer1d_fused(..., uniform_ctx=True, interpret=True)``; the
Transformer1d dispatch on a flagged doubled batch against the unflagged one
and the JAX composition; a null half that is not one repeated table, or a
context other than the flagged one, taking the exact per-row path; and the
gradients of the parameters, x and the table (the broadcast-summed
cotangent) against ``jax.grad`` (mirroring
``tests/test_transformer_fusion.py::test_cfg_null_half_shared_kv_exact``).

Bands: 2e-5 for outputs (the JAX suite's), rtol 1e-4 / atol 1e-5 for
gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import attention as ja
from moleculediffusiontransformer_tpu.ops import transformer_fusion as jtf
from moleculediffusiontransformer_tpu_torch.nn import attention as ta
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

TOL = 2e-5
GEOM = dict(num_layers=2, heads=4, head_dim=16, multiplier=2)
B, L, C, M = 8, 16, 64, 12


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    ctx_cond = rng.standard_normal((B // 2, M, C)).astype(np.float32)
    null_row = rng.standard_normal((1, M, C)).astype(np.float32)
    ctx = np.concatenate([ctx_cond, np.broadcast_to(null_row, (B // 2, M, C))])
    jmod = ja.Transformer1d(2, C, 4, 16, 2, context_features=C,
                            disable_fusion=True)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                              jnp.asarray(ctx))["params"])
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(ctx)))
    return jmod, params, x, ctx_cond, null_row, ref


@pytest.fixture
def sharedkv():
    tf.enable_sharedkv(True)
    yield
    tf._SHAREDKV = None


def _port(params):
    port = ta.Transformer1d(2, C, 4, 16, 2, context_features=C)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return port


def _spy(monkeypatch):
    """Record ``uniform_ctx`` of every stack-forward call."""
    calls = []
    real = tf.transformer1d_forward

    def spy(*a, **k):
        calls.append(k.get("uniform_ctx", False))
        return real(*a, **k)

    monkeypatch.setattr(tf, "transformer1d_forward", spy)
    return calls


def _diff(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float64) - b).max())


def test_uniform_plain_version_matches_pallas(case):
    _, params, x, _, null_row, ref = case
    want = np.asarray(jtf.transformer1d_fused(
        params, jnp.asarray(x[B // 2:]), jnp.asarray(null_row),
        context_features=C, interpret=True, uniform_ctx=True, **GEOM))
    sd = state_dict_from_jax_params(params)
    got = tf.transformer1d_reference(sd, torch.from_numpy(x[B // 2:]),
                                     torch.from_numpy(null_row),
                                     uniform_ctx=True, **GEOM)
    assert _diff(got, want) <= TOL
    assert _diff(got, ref[B // 2:]) <= TOL
    # the CPU wrapper is the plain version
    got = tf.transformer1d_forward(sd, torch.from_numpy(x[B // 2:]),
                                   torch.from_numpy(null_row),
                                   uniform_ctx=True, **GEOM)
    assert _diff(got, want) <= TOL
    with pytest.raises(ValueError, match="uniform_ctx"):
        tf.transformer1d_reference(sd, torch.from_numpy(x),
                                   torch.from_numpy(x[:, :M]),
                                   uniform_ctx=True, **GEOM)


def _doubled(ctx_cond, null_half):
    return torch.cat([torch.from_numpy(ctx_cond), null_half])


def test_flagged_dispatch_equals_unflagged(case, sharedkv, monkeypatch):
    _, params, x, ctx_cond, null_row, ref = case
    port = _port(params)
    null_half = torch.from_numpy(null_row).expand(B // 2, M, C)
    ctx = _doubled(ctx_cond, null_half)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        plain = port(torch.from_numpy(x), ctx)
        assert calls == [False]
        with tf.cfg_uniform_null_half(ctx, null_half):
            assert tf.cfg_null_half_active()
            flagged = port(torch.from_numpy(x), ctx)
    # the conditioned half, then the null half against the one table
    assert calls == [False, False, True]
    assert _diff(flagged, plain.numpy()) <= TOL
    assert _diff(flagged, ref) <= TOL


def test_null_half_that_is_not_one_table_gets_the_exact_result(
        case, sharedkv, monkeypatch):
    jmod, params, x, ctx_cond, _, _ = case
    port = _port(params)
    rng = np.random.default_rng(9)
    bad = torch.from_numpy(
        rng.standard_normal((B // 2, M, C)).astype(np.float32))
    ctx_bad = _doubled(ctx_cond, bad)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(ctx_bad.numpy())))
    calls = _spy(monkeypatch)
    with torch.no_grad(), tf.cfg_uniform_null_half(ctx_bad, bad):
        assert tf.null_half_table(ctx_bad) is None
        got = port(torch.from_numpy(x), ctx_bad)
        # a context other than the flagged tensor, even with equal values
        assert tf.null_half_table(ctx_bad.clone()) is None
    assert calls == [False]
    assert _diff(got, want) <= TOL


def test_switch_off_by_default(case, monkeypatch):
    _, _, _, ctx_cond, null_row, _ = case
    null_half = torch.from_numpy(null_row).expand(B // 2, M, C)
    ctx = _doubled(ctx_cond, null_half)
    monkeypatch.delenv("MDT_CFG_SHAREDKV", raising=False)
    assert tf._SHAREDKV is None
    with tf.cfg_uniform_null_half(ctx, null_half):
        assert not tf.cfg_null_half_active()
        assert tf.null_half_table(ctx) is None
        monkeypatch.setenv("MDT_CFG_SHAREDKV", "1")
        assert tf.null_half_table(ctx).shape == (1, M, C)
    assert not tf.cfg_null_half_active()


def test_gradients_match_jax_grad(case, sharedkv):
    """Grads of the null half's loss through the flagged dispatch (the
    uniform kernel forward, autograd of the module composition backward)
    against ``jax.grad`` of the uniform Pallas path: every parameter, x and
    the shared table, whose grad is the broadcast-summed cotangent."""
    _, params, x, ctx_cond, null_row, _ = case
    x_n = jnp.asarray(x[B // 2:])

    def loss_u(p, xx, cc):
        o = jtf.transformer1d_fused(p, xx, cc, context_features=C,
                                    interpret=True, uniform_ctx=True, **GEOM)
        return jnp.sum(o ** 2)

    gp, gx, gc = jax.grad(loss_u, argnums=(0, 1, 2))(
        params, x_n, jnp.asarray(null_row))
    port = _port(params)
    xt = torch.from_numpy(x).requires_grad_()
    table = torch.from_numpy(null_row).requires_grad_()
    null_half = table.expand(B // 2, M, C)
    ctx = _doubled(ctx_cond, null_half)
    with tf.cfg_uniform_null_half(ctx, null_half):
        out = port(xt, ctx)
    (out[B // 2:] ** 2).sum().backward()
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad[B // 2:].numpy(), np.asarray(gx),
                               **close)
    assert not xt.grad[:B // 2].any()
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(gc), **close)
    want = state_dict_from_jax_params(gp)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **close)
