"""The port's forward property transformer (``TorchMHA``,
``MoleculeTransformerSequenceEncoder``, ``from_encoder_config``,
``make_encoder_train_step``) and ``TorchLayerNorm`` against the JAX package
on the CPU in float32, at the recipes' tiny encoder (dim 32, depth 2, 4
heads) with JAX's parameters.

Bands: logits, hidden states and the loss 1e-4; grads rtol 1e-4 / atol
1e-5 (the JAX suite's gradient band); the optimizer within 1e-6 of optax
given equal grads."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import \
    forward_transformer_qm9
from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu.nn import transformer_blocks as jtb
from moleculediffusiontransformer_tpu.nn.torch_import import \
    params_to_state_dict
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn import transformer_blocks as ttb
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer

E = forward_transformer_qm9()
TINY = dict(dim=32, depth=2, heads=4, ff_mult=E.ff_mult,
            logits_dim=E.logits_dim, logits_dim_length=E.logits_dim_length,
            max_length=E.max_length, max_tokens=E.max_tokens,
            embed_dim=E.embed_dim)
BATCH, TOL = 5, 1e-4


def _ids(seed=0):
    """(5, 64) ids: a full row, three padded to lengths 40, 9 and 1, and a
    row of padding only."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, E.max_tokens, (BATCH, E.max_length))
    for row, length in ((1, 40), (2, 9), (3, 1), (4, 0)):
        ids[row, length:] = 0
    return ids


@pytest.fixture(scope="module")
def pair():
    jm = jt.MoleculeTransformerSequenceEncoder(**TINY)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)(key, jnp.asarray(_ids()))["params"]
    # norms off their initial gamma of 1 and biases off 0, so that each
    # counts
    params = jax.tree_util.tree_map(
        lambda a: a * (1 + 0.1 * np.arange(a.size).reshape(a.shape) / a.size)
        + 0.01 * (a.ndim == 1) if a.ndim == 1 else a, params)
    tm = tt.MoleculeTransformerSequenceEncoder(device="cpu", **TINY)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def test_jax_params_load_strict(pair):
    """Every key, shape and value equals ``params_to_state_dict``'s, the
    fused in-projection in torch's (3d, d) layout."""
    _, params, tm = pair
    sd = state_dict_from_jax_params(params)
    ref = params_to_state_dict(params)
    assert set(sd) == set(ref) == set(tm.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    w = sd["layers.0.0.in_proj_weight"]
    assert tuple(w.shape) == (3 * 32, 32)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["layers_0_0"]["in_proj_weight"]).T)


@pytest.mark.parametrize("padded", [True, False])
def test_logits_match_jax(pair, padded):
    """With the key-padding mask (a row of padding only attends uniformly,
    as in JAX) and with no padding token in the ids."""
    jm, params, tm = pair
    ids = _ids(1)
    if not padded:
        ids[ids == 0] = 3
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(_t(ids))
    assert got.shape == (BATCH, 1, 12) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_return_hidden_and_explicit_mask_match_jax(pair):
    jm, params, tm = pair
    ids = _ids(2)
    mask = np.zeros(ids.shape, bool)
    mask[:, 50:] = True
    for kw in ({"return_hidden": True}, {"text_mask": mask}):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                                   **{k: (jnp.asarray(v) if k == "text_mask"
                                          else v) for k, v in kw.items()}))
        with torch.no_grad():
            got = tm(_t(ids), **{k: (_t(v) if k == "text_mask" else v)
                                 for k, v in kw.items()})
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_torch_mha_matches_jax(causal):
    """The attention alone, with the causal mask and a key-padding mask."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    mask = np.zeros((3, 7), bool)
    mask[1, 4:] = True
    mask[2, :] = True
    jmod = jt.TorchMHA(16, 4, causal=causal)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(4),
                                jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.02, params)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(mask)))
    mod = tt.TorchMHA(16, 4, causal=causal)
    mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = mod(_t(x), key_padding_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_torch_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = 3 * rng.standard_normal((2, 5, 24)).astype(np.float32) + 1
    jmod = jtb.TorchLayerNorm()
    params = {"scale": rng.standard_normal(24).astype(np.float32),
              "bias": rng.standard_normal(24).astype(np.float32)}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = ttb.TorchLayerNorm(24)
    mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = mod(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_train_step_matches_jax_and_optax(pair):
    """One ``make_encoder_train_step`` step: the loss and every grad are
    those of the JAX step, and the update is optax's clip + Adam given the
    port's own grads."""
    jm, params, _ = pair
    tm = tt.MoleculeTransformerSequenceEncoder(device="cpu", **TINY)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    ids = _ids(6)
    targets = np.random.default_rng(7).uniform(-1, 1, (BATCH, 12)).astype(
        np.float32)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids))
        return jnp.mean(jnp.square(logits.reshape(BATCH, -1)[:, :12]
                                   - jnp.asarray(targets)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = state_dict_from_jax_params(want_grads)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    jstate = jtrainer.TrainState.create(params, tx)
    _, jstep_loss = jtrainer.make_encoder_train_step(jm, tx, donate=False)(
        jstate, jnp.asarray(ids), jnp.asarray(targets))
    assert abs(float(jstep_loss) - float(want_loss)) <= 1e-6

    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(tm, opt)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    loss = trainer.make_encoder_train_step(tm, opt)(state, _t(ids),
                                                    _t(targets))
    assert state.step == 1 and loss.dtype == torch.float32
    assert abs(loss.item() - float(want_loss)) <= TOL
    named = dict(tm.named_parameters())
    assert set(named) == set(want_grads)
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    names = list(before)
    grads = [jnp.asarray(named[n].grad.numpy()) for n in names]
    old = [jnp.asarray(before[n].numpy()) for n in names]

    @jax.jit
    def optax_step(grads, old):
        return optax.apply_updates(old, tx.update(grads, tx.init(old), old)[0])

    for n, w in zip(names, optax_step(grads, old)):
        np.testing.assert_allclose(named[n].detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6, err_msg=n)


def test_from_encoder_config_builds_the_preset():
    """The notebook preset: 3,162,496 parameters, (b, 1, 12) out; a
    ``vocab_size`` replaces ``max_tokens``."""
    with torch.device("meta"):
        m = tt.from_encoder_config(E, device="meta")
        assert sum(p.numel() for p in m.parameters()) == 3_162_496
        m = tt.from_encoder_config(E, vocab_size=30, device="meta")
        assert tuple(m.token_embed.weight.shape) == (30, E.embed_dim)
    tiny = dataclasses.replace(E, dim=32, depth=2, heads=4)
    small = tt.from_encoder_config(tiny, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    again = tt.from_encoder_config(tiny, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    for a, b in zip(small.parameters(), again.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        out = small(torch.from_numpy(_ids(8)))
    assert out.shape == (BATCH, 1, 12) and torch.isfinite(out).all()
