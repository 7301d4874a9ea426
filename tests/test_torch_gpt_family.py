"""The port's ``MoleculeTransformerGPT`` against the JAX package on the
CPU in float32, with JAX's parameters (loaded ``strict=True``) and JAX's
draws: the variants' logits and losses, the BERT mask, ``generate_gpt``
and two ``make_gpt_train_step`` steps.

Bands: logits and losses 1e-4; generated ids equal wherever the two largest
perturbed logits are more than 1e-3 apart; trained parameters rtol 1e-4 /
atol 1e-5 (the band of the encoder's step)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer
from test_torch_gpt_blocks import (BATCH, LENGTH, MODEL_TOL, _check_ids,
                                   _close, _init, _jax_gpt_uniforms, _load,
                                   _perturb, _rng, _t)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GPT = dict(dim=32, depth=2, heads=4, dim_head=8, max_tokens=24,
           logits_dim=24, embed_dim=16, text_embed_dim=16)
GPT_VARIANTS = {
    "dense": {},
    "concat_pos": dict(concat_pos_encoding=True, pos_fourier_graph_dim=12),
    "ffcnn_glu": dict(ff_conv_kernel=3, ff_inner_conv_kernel=2, ff_glu=True),
    "gnn": dict(gnn_layers=2, use_null_kv=False, gnn_att_threshold_min=0.05,
                gnn_att_threshold_max=0.9),
    "moe": dict(ff_num_experts=4, ff_expert_top_k=2,
                ff_expert_capacity_factor=0.5),
    "multi_kv_heads": dict(one_kv_head=False),
}


# ---------------------------------------------------------------- decoders --

@pytest.fixture(scope="module")
def gpt_pairs():
    pairs = {}
    ids = _rng(13).integers(0, 24, (BATCH, LENGTH))
    ids[1, 7:] = 0
    for name, kw in GPT_VARIANTS.items():
        jm = jt.MoleculeTransformerGPT(**GPT, **kw)
        params = _perturb(_init(jm, jax.random.PRNGKey(14),
                                jnp.asarray(ids)))
        tm = _load(tt.MoleculeTransformerGPT(device="cpu", **GPT, **kw),
                   params)
        pairs[name] = (jm, params, tm)
    return pairs, ids


def test_gpt_params_load_strict(gpt_pairs):
    pairs, _ = gpt_pairs
    _, params, tm = pairs["moe"]
    sd = state_dict_from_jax_params(params)
    assert "layers.0.1.moe.w_in" in sd and "layers.1.1.0.gamma" in sd
    assert "fc1.weight" in sd and "layers.0.0.null_k" in sd
    _, params, _ = pairs["gnn"]
    assert "layers.0.0.GNN_net.layers.1.projection.weight" in \
        state_dict_from_jax_params(params)


@pytest.mark.parametrize("name", sorted(GPT_VARIANTS))
def test_gpt_logits_and_loss_match_jax(gpt_pairs, name):
    pairs, ids = gpt_pairs
    jm, params, tm = pairs[name]
    want = jm.apply({"params": params}, jnp.asarray(ids))
    _close(tm(_t(ids)), want, MODEL_TOL, name)
    for ignore in (False, True):
        want = jm.apply({"params": params}, jnp.asarray(ids),
                        return_loss=True, ignore_padding_zeros=ignore)
        got = tm(_t(ids), return_loss=True, ignore_padding_zeros=ignore)
        assert got.dim() == 0 and abs(got.item() - float(want)) <= MODEL_TOL


@pytest.mark.parametrize("name", ["dense", "gnn"])
def test_gpt_mask_prob_matches_jax(gpt_pairs, name):
    """BERT-style masking fed JAX's normals; and from a generator."""
    pairs, ids = gpt_pairs
    jm, params, tm = pairs[name]
    key = jax.random.PRNGKey(15)
    want = jm.apply({"params": params}, jnp.asarray(ids), return_loss=True,
                    mask_prob=0.3, key=key)
    normals = np.array(jax.random.normal(key, ids.shape))
    got = tm(_t(ids), return_loss=True, mask_prob=0.3,
             mask_normals=_t(normals))
    assert abs(got.item() - float(want)) <= MODEL_TOL
    plain = tm(_t(ids), return_loss=True)
    assert abs(got.item() - plain.item()) > 1e-6
    a, b = (tm(_t(ids), mask_prob=0.3,
               generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        tm(_t(ids), mask_prob=0.3)


def _jax_decode_logits(jm, params, ids):
    """JAX's cached decode logits at every position of ``ids`` (the
    FF-CNN's causal convs see one position a step there, as in the port, so
    these are not the full forward's)."""
    b, total = ids.shape
    caches = jm.apply({"params": params}, b, total,
                      method=jt.MoleculeTransformerGPT.init_cache)
    out = []
    for pos in range(total - 1):
        logits, caches = jm.apply(
            {"params": params}, jnp.asarray(ids[:, pos]), pos, caches,
            method=jt.MoleculeTransformerGPT.decode_step)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name", ["dense", "concat_pos", "ffcnn_glu"])
def test_generate_gpt_matches_jax(gpt_pairs, name):
    pairs, _ = gpt_pairs
    jm, params, tm = pairs[name]
    start = np.array([[1, 5], [1, 2], [1, 9]])
    tokens = 7
    key = jax.random.PRNGKey(16)
    want = np.asarray(jt.generate_gpt(jm, {"params": params},
                                      jnp.asarray(start), key,
                                      tokens_to_generate=tokens))
    total = start.shape[1] + tokens
    uniforms = _jax_gpt_uniforms(key, total - 1, 3, 24)
    got, logits = tt.generate_gpt(tm, _t(start), uniforms=_t(uniforms),
                                  tokens_to_generate=tokens,
                                  return_logits=True)
    got = got.numpy()
    assert got.shape == (3, total)
    np.testing.assert_array_equal(got[:, :2], start)
    jlogits = _jax_decode_logits(jm, params, want)
    agree = (got == want).all(axis=1)
    assert agree.any()
    for pos in range(total - 1):
        _close(logits[pos][agree], jlogits[agree, pos], MODEL_TOL,
               f"{name} pos {pos}")
    if name != "ffcnn_glu":
        # without convs over the sequence, the decode is the full forward
        full = np.asarray(jm.apply({"params": params}, jnp.asarray(want)))
        _close(jlogits, full[:, :-1], MODEL_TOL)
    _check_ids(got, want, jlogits, uniforms,
               [(p, p) for p in range(1, total - 1)])
    argmax = tt.generate_gpt(tm, _t(start), tokens_to_generate=3,
                             use_gumbel_sample=False)
    jargmax = jt.generate_gpt(jm, {"params": params}, jnp.asarray(start),
                              key, tokens_to_generate=3,
                              use_gumbel_sample=False)
    np.testing.assert_array_equal(argmax.numpy(), np.asarray(jargmax))


# ------------------------------------------------------------- training --

@pytest.mark.parametrize("name,aux_weight", [("dense", 0.0),
                                             ("moe", 1e-2)])
def test_gpt_train_steps_match_jax(gpt_pairs, name, aux_weight):
    """Two ``make_gpt_train_step`` steps against JAX's: the losses 1e-4, the
    parameters after them rtol 1e-4 / atol 1e-5."""
    pairs, ids = gpt_pairs
    jm, params, _ = pairs[name]
    tm = _load(tt.MoleculeTransformerGPT(device="cpu", **GPT,
                                         **GPT_VARIANTS[name]), params)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    jstate = jtrainer.TrainState.create(params, tx)
    jstep = jtrainer.make_gpt_train_step(jm, tx, donate=False,
                                         aux_loss_weight=aux_weight,
                                         ignore_padding_zeros=True)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(tm, opt)
    step = trainer.make_gpt_train_step(tm, opt, aux_loss_weight=aux_weight,
                                       ignore_padding_zeros=True)
    for i in range(2):
        batch = _rng(27 + i).integers(0, 24, ids.shape)
        jstate, jloss = jstep(jstate, jnp.asarray(batch),
                              jax.random.PRNGKey(i))
        loss = step(state, _t(batch))
        assert abs(loss.item() - float(jloss)) <= MODEL_TOL
    assert state.step == 2
    if aux_weight:
        assert len(tm.moe_aux_losses()) == GPT["depth"]
        plain = tm(_t(batch), return_loss=True, ignore_padding_zeros=True)
        assert abs(loss.item() - plain.item()) > 0
    want = state_dict_from_jax_params(jstate.params)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD_TOL)
