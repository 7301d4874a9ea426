"""The port's inverse AR transformer (``models/transformers.py``) against the
JAX package on the CPU in float32, with JAX's parameters and JAX's draws
(torch cannot reproduce threefry): logits, the loss under conditioning
dropout, every gradient, the cached decode against the full forward,
``generate_sequence`` token for token, and one training step.

Bands: logits and loss 1e-4; grads rtol 1e-4 / atol 1e-5 (the JAX suite's
gradient band); the optimizer within 1e-6 of optax given equal grads."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import (
    inverse_transformer_qm9)
from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer

SMALL = dict(dim=32, depth=2, heads=4, dim_head=8, logits_dim=24,
             text_embed_dim=16, max_text_len=12)
BATCH, LENGTH = 4, 9


@pytest.fixture(scope="module")
def pair():
    jm = jt.MoleculeTransformerSequence(**SMALL)
    rng = np.random.default_rng(0)
    props = rng.uniform(-1, 1, (BATCH, 12)).astype(np.float32)
    ids = rng.integers(0, 24, (BATCH, LENGTH))
    key = jax.random.PRNGKey(0)
    params = jm.init({"params": key}, jnp.asarray(props), jnp.asarray(ids),
                     key=key)["params"]
    # norms off their initial gamma of 1, so that every gamma counts
    params = jax.tree_util.tree_map(
        lambda a: a * (1 + 0.1 * np.arange(a.size).reshape(a.shape) / a.size)
        if a.ndim == 1 else a, params)
    tm = tt.MoleculeTransformerSequence(device="cpu", **SMALL)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm, props, ids


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_keep(key, batch, cond_drop_prob=0.25):
    """The keep mask ``_text_mask`` draws from ``key``."""
    return np.array(jax.random.uniform(key, (batch,)) < 1 - cond_drop_prob)


def test_jax_params_load_strict(pair):
    _, params, tm, _, _ = pair
    sd = state_dict_from_jax_params(params)
    assert ({k: tuple(v.shape) for k, v in sd.items()}
            == {k: tuple(v.shape) for k, v in tm.state_dict().items()})
    assert "layers.1.0.to_q.1.weight" in sd and "start_token" in sd
    assert "layers.0.2.3.gamma" in sd and "layers.0.1.null_kv" in sd


def test_preset_parameter_count():
    cfg = inverse_transformer_qm9()
    with torch.device("meta"):
        model = tt.MoleculeTransformerSequence(
            device="meta", dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
            dim_head=cfg.dim_head, logits_dim=cfg.logits_dim,
            text_embed_dim=cfg.text_embed_dim, max_text_len=cfg.max_text_len)
    assert sum(p.numel() for p in model.parameters()) == 2_407_712


def test_logits_match_jax(pair):
    jm, params, tm, props, ids = pair
    want = jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(ids),
                    cond_drop_prob=0.0)
    got = tm(_t(props), _t(ids), cond_drop_prob=0.0)
    assert got.shape == (BATCH, LENGTH, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    mask = np.ones((BATCH, 12), bool)
    mask[1, 5:] = False
    mask[2] = False
    want = jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(ids),
                    cond_drop_prob=0.0, text_mask=jnp.asarray(mask))
    got = tm(_t(props), _t(ids), cond_drop_prob=0.0, text_mask=_t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("cond_scale", [3.0, 1.0])
def test_forward_with_cond_scale_matches_jax(pair, cond_scale):
    jm, params, tm, props, ids = pair
    want = jt.forward_with_cond_scale(jm, {"params": params},
                                      jnp.asarray(props), jnp.asarray(ids),
                                      cond_scale=cond_scale)
    with torch.no_grad():
        got = tt.forward_with_cond_scale(tm, _t(props), _t(ids),
                                         cond_scale=cond_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_loss_and_grads_match_jax(pair):
    """The loss with the model's conditioning dropout (0.25), fed the keep
    mask JAX draws from its key, and every parameter's gradient."""
    jm, params, tm, props, ids = pair
    key = jax.random.PRNGKey(4)
    keep = _jax_keep(key, BATCH)
    assert 0 < keep.sum() < BATCH            # the mask drops and keeps rows
    loss, grads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jnp.asarray(props),
                           jnp.asarray(ids), return_loss=True, key=key))(
                               params)
    want = state_dict_from_jax_params(grads)
    tm.zero_grad()
    got = tm(_t(props), _t(ids), return_loss=True, keep=_t(keep))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - float(loss)) <= 1e-4
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        # the start token takes no part in this model's forward
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert named["start_token"].grad is None
    with pytest.raises(ValueError, match="generator"):
        tm(_t(props), _t(ids), return_loss=True)
    a = tm(_t(props), _t(ids), return_loss=True,
           generator=torch.Generator().manual_seed(1))
    b = tm(_t(props), _t(ids), return_loss=True,
           generator=torch.Generator().manual_seed(1))
    assert a.item() == b.item()


def test_cross_entropy_mean_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 24)).astype(np.float32)
    labels = rng.integers(0, 24, (3, 7))
    for ignore in (None, int(labels[0, 0])):
        want = float(jt.cross_entropy_mean(jnp.asarray(logits),
                                           jnp.asarray(labels), ignore))
        got = tt.cross_entropy_mean(_t(logits), _t(labels), ignore).item()
        assert abs(got - want) <= 1e-6


def test_cached_decode_matches_full_forward(pair):
    """The KV-cached decode gives the full forward's logits at every
    position, for the conditioned and for the null half."""
    _, _, tm, props, ids = pair
    props_t, ids_t = _t(props[:2]), _t(ids[:2])
    with torch.no_grad():
        cond = tm.embed_conditioning(props_t)[:, :tm.max_text_len]
        cross_kvs = tm.cross_kv(cond)
        x = tm.embed_tokens(ids_t)
        for keep in (True, False):
            text_mask = torch.full(cond.shape[:2], keep)
            full = tm(props_t, ids_t, cond_drop_prob=0.0,
                      text_mask=text_mask)
            caches = tm.init_cache(2, LENGTH)
            assert caches[0].shape == (2, LENGTH, SMALL["dim_head"])
            for pos in range(LENGTH):
                logits, caches = tm.decode_step(
                    x[:, pos:pos + 1], pos, cross_kvs, caches, text_mask)
                np.testing.assert_allclose(logits.numpy(),
                                           full[:, pos].numpy(), atol=2e-5,
                                           rtol=0, err_msg=f"{keep} {pos}")


def _jax_step_uniforms(key, steps, batch, vocab):
    """The uniforms ``generate_sequence``'s scan draws: the key is split
    once a step, and ``gumbel_noise`` draws (batch, vocab) from the second
    half."""
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k1, (batch, vocab))))
    return np.stack(out)


@pytest.mark.parametrize("prompt", [1, 3])
def test_generate_sequence_gives_jax_token_ids(pair, prompt):
    """Fed the uniforms JAX draws, the port generates JAX's tokens; the
    prompt is kept; each step's blended logits equal JAX's uncached CFG
    logits at that position."""
    jm, params, tm, props, ids = pair
    key = jax.random.PRNGKey(5)
    new = 10
    start = ids[:, :prompt]
    want = np.asarray(jt.generate_sequence(
        jm, {"params": params}, jnp.asarray(props), jnp.asarray(start), key,
        tokens_to_generate=new, cond_scale=3.0, filter_thres=0.9))
    total = prompt + new
    uniforms = _jax_step_uniforms(key, total - 1, BATCH, 24)
    got, logits = tt.generate_sequence(
        tm, _t(props), _t(start), uniforms=_t(uniforms),
        tokens_to_generate=new, cond_scale=3.0, filter_thres=0.9,
        return_logits=True)
    assert got.shape == (BATCH, total) and logits.shape == (total - 1, BATCH,
                                                            24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :prompt].numpy(), start)
    assert len(np.unique(want[:, prompt:])) > 1
    cfg = np.asarray(jt.forward_with_cond_scale(
        jm, {"params": params}, jnp.asarray(props), jnp.asarray(want),
        cond_scale=3.0))
    for pos in range(total - 1):
        np.testing.assert_allclose(logits[pos].numpy(), cfg[:, pos],
                                   atol=1e-4, rtol=0, err_msg=str(pos))
    # a callable of the step serves as well as the stacked tensor
    again = tt.generate_sequence(
        tm, _t(props), _t(start), uniforms=lambda pos: _t(uniforms[pos]),
        tokens_to_generate=new)
    assert torch.equal(again, got)


def test_generate_sequence_draws_from_a_generator(pair):
    """``start_ids=None`` draws the start token; the same seed gives the
    same sequence, another seed another; ids stay within the vocabulary."""
    _, _, tm, props, _ = pair

    def run(seed):
        return tt.generate_sequence(
            tm, _t(props), None, torch.Generator().manual_seed(seed),
            tokens_to_generate=12, filter_thres=0.5)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (BATCH, 13) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < 24


def test_train_step_matches_jax_and_optax(pair):
    """One ``make_transformer_train_step`` step: the loss and grads are
    those of the JAX step (whose key is folded with the step count), and the
    update is optax's clip + Adam given the port's own grads."""
    jm, params, _, props, ids = pair
    tm = tt.MoleculeTransformerSequence(device="cpu", **SMALL)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    key = jax.random.PRNGKey(9)
    step_key = jax.random.fold_in(key, 0)
    keep = _jax_keep(step_key, BATCH)
    assert 0 < keep.sum() < BATCH
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    jstate = jtrainer.TrainState.create(params, tx)
    jstate, jloss = jtrainer.make_transformer_train_step(
        jm, tx, donate=False)(jstate, jnp.asarray(props), jnp.asarray(ids),
                              key)

    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(tm, opt)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    loss = trainer.make_transformer_train_step(tm, opt)(
        state, _t(props), _t(ids), keep=_t(keep))
    assert state.step == 1 and state.opt_state.count == 1
    assert abs(loss.item() - float(jloss)) <= 1e-4

    names = list(before)
    grads = [jnp.asarray(dict(tm.named_parameters())[n].grad.numpy())
             for n in names]
    old = [jnp.asarray(before[n].numpy()) for n in names]
    updates, _ = tx.update(grads, tx.init(old), old)
    want = optax.apply_updates(old, updates)
    moved = 0.0
    for n, w in zip(names, want):
        p = dict(tm.named_parameters())[n].detach().numpy()
        np.testing.assert_allclose(p, np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=n)
        moved = max(moved, float(np.abs(p - before[n].numpy()).max()))
    assert moved > 1e-4
    # and the JAX step's own parameters, within Adam's first-step noise: a
    # grad near zero may flip a parameter by up to 2 lr
    jafter = state_dict_from_jax_params(jstate.params)
    for n in names:
        p = dict(tm.named_parameters())[n].detach().numpy()
        assert np.abs(p - jafter[n].numpy()).max() <= 2 * 2e-4 + 1e-6, n
