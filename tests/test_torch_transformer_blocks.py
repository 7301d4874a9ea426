"""The port's ``nn/transformer_blocks.py`` against the JAX package on the CPU
in float32, with JAX's parameters and JAX's draws: the gamma-only LayerNorm,
top-k filtering, Gumbel-max sampling and the CFG keep-mask on injected
uniforms, and multi-query attention (self and cross with a context mask, the
cached ``step`` over several positions, ``cross_step``).  Band: 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import transformer_blocks as jtb
from moleculediffusiontransformer_tpu_torch.nn import transformer_blocks as tb
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params

ATOL = 2e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_ln_gamma_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    gamma = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    want = jtb.LNGamma().apply({"params": {"gamma": jnp.asarray(gamma)}},
                               jnp.asarray(x))
    mod = tb.LNGamma(32)
    mod.load_state_dict({"gamma": torch.from_numpy(gamma)}, strict=True)
    _close(mod(torch.from_numpy(x)), want)
    half = tb.LNGamma(32, dtype=torch.bfloat16)
    assert half(torch.from_numpy(x)).dtype == torch.bfloat16


@pytest.mark.parametrize("thres", [0.9, 0.5, 0.0, 0.99])
def test_top_k_filter_matches_jax(thres):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 24)).astype(np.float32)
    want = np.asarray(jtb.top_k_filter(jnp.asarray(logits), thres))
    got = tb.top_k_filter(torch.from_numpy(logits), thres).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(tb.NEG_INF) == float(jtb.NEG_INF)


def test_gumbel_sample_on_jax_uniforms():
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 24)).astype(np.float32)
    uniforms = np.array(jax.random.uniform(key, logits.shape))
    for temperature in (1.0, 0.7):
        want = np.asarray(jtb.gumbel_sample(key, jnp.asarray(logits),
                                            temperature))
        got = tb.gumbel_sample(torch.from_numpy(logits), temperature,
                               uniforms=torch.from_numpy(uniforms))
        np.testing.assert_array_equal(got.numpy(), want)
    _close(tb.gumbel_noise(torch.from_numpy(uniforms)),
           jtb.gumbel_noise(key, logits.shape), atol=1e-5)
    # drawn from a generator: same seed, same ids; ids within the vocabulary
    a = tb.gumbel_sample(torch.from_numpy(logits),
                         generator=torch.Generator().manual_seed(3))
    b = tb.gumbel_sample(torch.from_numpy(logits),
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (16,)
    assert 0 <= int(a.min()) and int(a.max()) < 24


def test_prob_mask_like():
    key = jax.random.PRNGKey(4)
    uniforms = np.array(jax.random.uniform(key, (64,)))
    want = np.asarray(jtb.prob_mask_like(key, (64,), 0.75))
    got = tb.prob_mask_like((64,), 0.75, uniforms=torch.from_numpy(uniforms))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tb.prob_mask_like((5,), 1).all()
    assert not tb.prob_mask_like((5,), 0).any()
    drawn = tb.prob_mask_like((4000,), 0.75,
                              generator=torch.Generator().manual_seed(0))
    assert abs(drawn.float().mean().item() - 0.75) < 0.03


def _attention_pair(causal, context_dim=None, norm_context=False, seed=0):
    kw = dict(dim=32, dim_head=8, heads=4, causal=causal,
              norm_context=norm_context)
    jm = jtb.MQAttention(context_dim=context_dim, **kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 6, 32)).astype(np.float32)
    ctx = (None if context_dim is None else
           rng.standard_normal((3, 5, context_dim)).astype(np.float32))
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     None if ctx is None else jnp.asarray(ctx))["params"]
    # gammas off their initial 1 so that they count
    params = jax.tree_util.tree_map(
        lambda a: a * (1 + 0.1 * np.arange(a.size).reshape(a.shape)
                       / a.size), params)
    tm = tb.MQAttention(context_dim=context_dim, **kw)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm, x, ctx


def test_mq_attention_causal_self_matches_jax():
    jm, params, tm, x, _ = _attention_pair(causal=True)
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("norm_context", [False, True])
def test_mq_attention_cross_with_context_mask_matches_jax(norm_context):
    jm, params, tm, x, ctx = _attention_pair(causal=False, context_dim=16,
                                             norm_context=norm_context,
                                             seed=1)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                    bool)
    for cm in (mask, None):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx),
                        None if cm is None else jnp.asarray(cm))
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx),
                 None if cm is None else torch.from_numpy(cm))
        _close(got, want)


def test_mq_attention_step_matches_jax_and_the_full_forward():
    """The cached decode step, position by position: JAX's ``step`` and the
    row of the causal forward at that position."""
    jm, params, tm, x, _ = _attention_pair(causal=True, seed=2)
    total = x.shape[1] + 2                       # a cache longer than needed
    full = tm(torch.from_numpy(x))
    jcache = jnp.zeros((3, total, 8))
    cache = torch.zeros(3, total, 8)
    with torch.no_grad():
        for pos in range(x.shape[1]):
            x_t = x[:, pos:pos + 1]
            want, jcache = jm.apply({"params": params}, jnp.asarray(x_t),
                                    jcache, jnp.asarray(pos),
                                    method=jtb.MQAttention.step)
            got, cache = tm.step(torch.from_numpy(x_t), cache, pos)
            _close(got, want)
            _close(cache, jcache)
            _close(got[:, 0], full[:, pos].detach().numpy())


def test_mq_attention_cross_step_matches_jax():
    jm, params, tm, x, ctx = _attention_pair(causal=False, context_dim=16,
                                             seed=3)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                    bool)
    jkv = jm.apply({"params": params}, jnp.asarray(ctx),
                   method=jtb.MQAttention.kv)
    kv = tm.kv(torch.from_numpy(ctx))
    assert kv.shape == (3, 6, 8)
    _close(kv, jkv)
    for cm in (mask, None):
        want = jm.apply({"params": params}, jnp.asarray(x[:, :1]), jkv,
                        None if cm is None else jnp.asarray(cm),
                        method=jtb.MQAttention.cross_step)
        got = tm.cross_step(torch.from_numpy(x[:, :1]), kv,
                            None if cm is None else torch.from_numpy(cm))
        _close(got, want)
    # the cross step is the cross forward's first row
    full = tm(torch.from_numpy(x), torch.from_numpy(ctx),
              torch.from_numpy(mask))
    _close(tm.cross_step(torch.from_numpy(x[:, :1]), kv,
                         torch.from_numpy(mask))[:, 0],
           full[:, 0].detach().numpy())
