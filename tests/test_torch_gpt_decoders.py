"""The port's other transformer decoders against the JAX package on the CPU
in float32, with JAX's parameters (loaded ``strict=True``) and JAX's draws:
the MHA GPT with ``generate_gpt_mha``, the Internaldim decoder with
``generate_sequence``, and the continuous decoder with
``generate_vectors``.

Bands: logits and losses 1e-4; generated ids equal wherever the two largest
perturbed logits are more than 1e-3 apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from test_torch_gpt_blocks import (BATCH, LENGTH, MODEL_TOL, _check_ids,
                                   _close, _init, _jax_gpt_uniforms, _load,
                                   _perturb, _rng, _t, _x)

SEQ = dict(dim=32, depth=2, heads=4, dim_head=8, logits_dim=24,
           text_embed_dim=16, max_text_len=12)


# --------------------------------------------------- the MHA GPT (torch) --

@pytest.mark.parametrize("kw", [dict(), dict(causal=False),
                                dict(concat_pos_encoding=True,
                                     pos_fourier_graph_dim=8)])
def test_gpt_pytorch_and_generate_gpt_mha_match_jax(kw):
    cfg = dict(dim=32, depth=2, heads=4, max_tokens=24, logits_dim=24,
               embed_dim=16, **kw)
    ids = _rng(17).integers(0, 24, (BATCH, LENGTH))
    jm = jt.MoleculeTransformerGPTPyTorch(**cfg)
    params = _perturb(_init(jm, jax.random.PRNGKey(18), jnp.asarray(ids)))
    tm = _load(tt.MoleculeTransformerGPTPyTorch(device="cpu", **cfg), params)
    _close(tm(_t(ids)), jm.apply({"params": params}, jnp.asarray(ids)),
           MODEL_TOL)
    want = jm.apply({"params": params}, jnp.asarray(ids), return_loss=True)
    assert abs(tm(_t(ids), return_loss=True).item() - float(want)) \
        <= MODEL_TOL
    start = np.array([[1, 4], [1, 7], [1, 3]])
    tokens = 5
    key = jax.random.PRNGKey(19)
    jids = np.asarray(jt.generate_gpt_mha(jm, {"params": params},
                                          jnp.asarray(start), key,
                                          tokens_to_generate=tokens))
    keys = jax.random.split(key, tokens)
    uniforms = np.stack([np.array(jax.random.uniform(k, (3, 24)))
                         for k in keys])
    got = tt.generate_gpt_mha(tm, _t(start), uniforms=_t(uniforms),
                              tokens_to_generate=tokens).numpy()
    np.testing.assert_array_equal(got[:, :2], start)
    # the logits each step sees: the forward of the buffer as it stood
    for step, pos in enumerate(range(1, 1 + tokens)):
        buf = np.zeros_like(jids)
        buf[:, :pos + 1] = jids[:, :pos + 1]
        full = np.asarray(jm.apply({"params": params}, jnp.asarray(buf)))
        _check_ids(got, jids, full, uniforms, [(step, pos)])


# ------------------------------------- Internaldim and continuous decoders --

def _props(seed=20):
    return _rng(seed).uniform(-1, 1, (BATCH, 12)).astype(np.float32)


@pytest.mark.parametrize("one_kv_head", [True, False])
def test_internaldim_matches_jax(one_kv_head):
    ids = _rng(21).integers(0, 24, (BATCH, LENGTH))
    props = _props()
    cfg = dict(SEQ, max_tokens=24, embed_dim=12, one_kv_head=one_kv_head)
    jm = jt.MoleculeTransformerSequenceInternaldim(**cfg)
    key = jax.random.PRNGKey(22)
    params = _perturb(_init(jm, {"params": key}, jnp.asarray(props),
                            jnp.asarray(ids), key=key))
    tm = _load(tt.MoleculeTransformerSequenceInternaldim(device="cpu", **cfg),
               params)
    _close(tm(_t(props), _t(ids), cond_drop_prob=0.0),
           jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(ids),
                    cond_drop_prob=0.0), MODEL_TOL)
    keep = np.array(jax.random.uniform(key, (BATCH,)) < 0.75)
    want = jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(ids),
                    return_loss=True, key=key)
    got = tm(_t(props), _t(ids), return_loss=True, keep=_t(keep))
    assert abs(got.item() - float(want)) <= MODEL_TOL
    if not one_kv_head:
        return
    start = np.ones((BATCH, 1), np.int64)
    tokens = 6
    gkey = jax.random.PRNGKey(23)
    jids = np.asarray(jt.generate_sequence(
        jm, {"params": params}, jnp.asarray(props), jnp.asarray(start), gkey,
        tokens_to_generate=tokens))
    uniforms = _jax_gpt_uniforms(gkey, tokens, BATCH, 24)
    got, logits = tt.generate_sequence(
        tm, _t(props), _t(start), uniforms=_t(uniforms),
        tokens_to_generate=tokens, return_logits=True)
    got = got.numpy()
    full_c = np.asarray(jt.forward_with_cond_scale(
        jm, {"params": params}, jnp.asarray(props), jnp.asarray(jids),
        cond_scale=3.0))
    agree = (got == jids).all(axis=1)
    assert agree.any()
    for pos in range(tokens):
        _close(logits[pos][agree], full_c[agree, pos], MODEL_TOL)
    _check_ids(got, jids, full_c, uniforms, [(p, p) for p in range(tokens)])


def test_continuous_transformer_and_generate_vectors_match_jax():
    props = _props(24)
    out = _x(25, BATCH, 7, 24)
    cfg = dict(SEQ, pos_fourier_graph_dim=10)
    jm = jt.MoleculeTransformer(**cfg)
    key = jax.random.PRNGKey(26)
    params = _perturb(_init(jm, {"params": key}, jnp.asarray(props),
                            jnp.asarray(out), key=key))
    tm = _load(tt.MoleculeTransformer(device="cpu", **cfg), params)
    _close(tm(_t(props), _t(out), cond_drop_prob=0.0),
           jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(out),
                    cond_drop_prob=0.0), MODEL_TOL)
    keep = np.array(jax.random.uniform(key, (BATCH,)) < 0.75)
    want = jm.apply({"params": params}, jnp.asarray(props), jnp.asarray(out),
                    return_loss=True, key=key)
    got = tm(_t(props), _t(out), return_loss=True, keep=_t(keep))
    assert abs(got.item() - float(want)) <= MODEL_TOL
    for scale in (3.0, 1.5):
        want = jt.generate_vectors(jm, {"params": params}, jnp.asarray(props),
                                   tokens_to_generate=6, cond_scale=scale)
        got = tt.generate_vectors(tm, _t(props), tokens_to_generate=6,
                                  cond_scale=scale)
        assert got.shape == (BATCH, 6, 24) and got.dtype == torch.float32
        _close(got, want, MODEL_TOL)
