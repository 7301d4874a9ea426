"""The port's inverse-design pipeline (``diffusion.samplers.inpaint_adpm2``,
``models.qm_diffusion.inpaint``, ``design.inverse_design`` and
``train.eval``) against the JAX package on the CPU in float32.

The same weights in both packages (the small QM model of
``tests/test_torch_import.py`` at the tokenizer's vocabulary, a small
forward diffusion model, the tiny encoder and a small AR transformer) and
JAX's draws, made here by the key splits of the JAX samplers: torch cannot
reproduce threefry.  Bands: samples 1e-4 absolute (the JAX suite's full-UNet
band at L >= 32), properties 1e-4 of the scaler's range, R² and MAE 1e-4;
SMILES strings and validity / novelty counts equal."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu import design as jdesign
from moleculediffusiontransformer_tpu.data import qm9 as jqm9
from moleculediffusiontransformer_tpu.diffusion import samplers as jsamp
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu.nn.torch_import import \
    state_dict_to_params
from moleculediffusiontransformer_tpu.train import eval as jeval
from moleculediffusiontransformer_tpu_torch import design as tdesign
from moleculediffusiontransformer_tpu_torch.data import qm9 as tqm9
from moleculediffusiontransformer_tpu_torch.diffusion import samplers
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.train import eval as teval

TOL = 1e-4
STEPS = 8                 # the diffusion models' sampling steps here
PREDICT_STEPS = 100       # rescore_generated's, fixed in both packages
BATCH = 4
AR_TOKENS = 16
# tests/test_torch_import.py's SMALL at the inverse tokenizer's vocabulary
SMALL = dict(max_length=32, channels=32, text_embed_dim=16,
             embed_dim_position=16, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=16,
             pre_transformer=1)
FORWARD = dict(max_length=64, channels=16, pred_dim=1, text_embed_dim=16,
               embed_dim_position=16, context_embedding_max_length=64,
               multipliers=(1, 2), factors=(4,), num_blocks=(1,),
               attentions=(1,), attention_heads=2, attention_features=8)
ENCODER = dict(dim=32, depth=2, heads=4, ff_mult=2, logits_dim=1,
               logits_dim_length=12, max_length=64, embed_dim=16)
AR = dict(dim=32, depth=2, heads=4, dim_head=8, text_embed_dim=16,
          max_text_len=12)


def _pair(jmodel, port, *example, seed, **kw):
    """JAX params carrying the port model's seeded weights (the template
    from ``eval_shape``: nothing is compiled), and the port model."""
    init_parameters(port, torch.Generator().manual_seed(seed))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(partial(jmodel.init, **kw), key,
                            *example)["params"]
    return {"params": state_dict_to_params(port.state_dict(), shapes)}, \
        port.eval()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The models here are small: torch's thread pool costs more than it
    gives (3 s against 6 s for a 100-step prediction)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    smiles, props = jqm9.synthetic_qm9(96, seed=2, chemically_valid=True)
    data = {mode: (jqm9.prepare_qm9(smiles, props, mode=mode),
                   tqm9.prepare_qm9(smiles, props, mode=mode))
            for mode in ("inverse_diffusion", "forward_diffusion",
                         "transformer")}
    vocab = data["inverse_diffusion"][0].vocab_size
    tvocab = data["transformer"][0].vocab_size
    key = jax.random.PRNGKey(0)
    inv = jqm.QMDiffusion(**SMALL, pred_dim=vocab)
    inv_vars, inv_port = _pair(
        inv, tqm.QMDiffusion(**SMALL, pred_dim=vocab), jnp.zeros((2, 12)),
        jnp.zeros((2, 32, vocab)), key, seed=1)
    fwd = jqm.QMDiffusionForward(**FORWARD)
    fwd_vars, fwd_port = _pair(
        fwd, tqm.QMDiffusionForward(**FORWARD), jnp.zeros((2, 64)),
        jnp.zeros((2, 64, 1)), key, seed=2)
    enc = jt.MoleculeTransformerSequenceEncoder(**ENCODER, max_tokens=tvocab)
    enc_vars, enc_port = _pair(
        enc, tt.MoleculeTransformerSequenceEncoder(
            **ENCODER, max_tokens=tvocab, device="cpu"),
        jnp.zeros((2, 64), jnp.int32), seed=3)
    ar = jt.MoleculeTransformerSequence(**AR, logits_dim=tvocab)
    ar_vars, ar_port = _pair(
        ar, tt.MoleculeTransformerSequence(**AR, logits_dim=tvocab,
                                           device="cpu"),
        jnp.zeros((2, 12)), jnp.zeros((2, 4), jnp.int32), seed=4, key=key)
    return dict(data=data, smiles=smiles, inv=(inv, inv_vars, inv_port),
                fwd=(fwd, fwd_vars, fwd_port), enc=(enc, enc_vars, enc_port),
                ar=(ar, ar_vars, ar_port))


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _sample_draws(key, num_steps, shape):
    """The draws ``models.qm_diffusion.sample`` makes from ``key``."""
    k_noise, k_samp = jax.random.split(key)
    steps = [_normal(k, shape)
             for k in jax.random.split(k_samp, num_steps - 1)]
    return dict(noise=_t(_normal(k_noise, shape)), step_noise=_t(steps))


def _inpaint_draws(key, num_steps, resamples, shape):
    """The draws ``diffusion.samplers.inpaint_adpm2`` makes from ``key``:
    the start, then a step key each, split into the source's noise and a
    key folded with each resample, split into the step's and the renoise
    draw."""
    key, k0 = jax.random.split(key)
    source_noise, step_noise, renoise = [], [], []
    for k in jax.random.split(key, num_steps - 1):
        k_src, k_steps = jax.random.split(k)
        source_noise.append(_normal(k_src, shape))
        pairs = [jax.random.split(jax.random.fold_in(k_steps, r))
                 for r in range(resamples)]
        step_noise.append([_normal(a, shape) for a, _ in pairs])
        renoise.append([_normal(b, shape) for _, b in pairs])
    return dict(noise=_t(_normal(k0, shape)), source_noise=_t(source_noise),
                step_noise=_t(step_noise), renoise=_t(renoise))


def _same_report(got, want):
    for k in ("smiles", "num_samples", "num_valid", "num_novel",
              "validity_fraction", "novelty_fraction", "valid_smiles",
              "novel_smiles"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("resamples", [1, 2])
def test_inpaint_adpm2_matches_jax(resamples):
    """The sampler alone on a closed-form denoiser."""
    rng = np.random.default_rng(0)
    shape = (3, 8, 5)
    source = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.4
    sigmas = jnp.asarray(tqm.karras_schedule(STEPS))
    key = jax.random.PRNGKey(1)
    want = np.asarray(jsamp.inpaint_adpm2(
        lambda x, s: jnp.tanh(x) / (1 + s[:, None, None]),
        jnp.asarray(source), jnp.asarray(mask), sigmas, key, STEPS,
        resamples))
    got = samplers.inpaint_adpm2(
        lambda x, s: torch.tanh(x) / (1 + s[:, None, None]), _t(source),
        _t(mask), np.asarray(sigmas), STEPS, resamples,
        **_inpaint_draws(key, STEPS, resamples, shape))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.numpy()[mask], source[mask])
    with pytest.raises(ValueError, match="generator"):
        samplers.inpaint_adpm2(lambda x, s: x, _t(source), _t(mask),
                               np.asarray(sigmas), STEPS, resamples)


@pytest.mark.parametrize("resamples", [1, 2])
def test_inpaint_and_inpaint_from_draft_match_jax(setup, resamples):
    """``qm_diffusion.inpaint`` within 1e-4 of JAX's, and
    ``inpaint_from_draft_and_conditioning`` the same SMILES and counts; the
    fixed positions decode to the draft's tokens."""
    jdata, tdata = setup["data"]["inverse_diffusion"]
    jm, jvars, port = setup["inv"]
    draft, fixed = setup["smiles"][5], [0, 1, 2]
    props = jdata.scaler.inverse_transform(jdata.y_test[:1])[0]
    key = jax.random.PRNGKey(10 + resamples)
    kw = dict(scaler=jdata.scaler, num_resamples=resamples, timesteps=STEPS,
              num_candidates=BATCH, training_smiles=setup["smiles"])
    want = jdesign.inpaint_from_draft_and_conditioning(
        jm, jvars, draft, props, fixed, jdata.tokenizer, key, **kw)
    draws = _inpaint_draws(key, STEPS, resamples, (BATCH, 32, jm.pred_dim))
    kw["scaler"] = tdata.scaler
    got = tdesign.inpaint_from_draft_and_conditioning(
        port, draft, props, fixed, tdata.tokenizer, **kw, **draws)
    _same_report(got, want)
    for s in got["smiles"]:
        assert s[:len(fixed)] == draft[:len(fixed)]
    # the raw samples under the same conditioning, source and mask
    cond = jdata.scaler.transform(props[None].astype(np.float32)).astype(
        np.float32).repeat(BATCH, 0)
    source = jqm9.one_hot_signed(jqm9.pad_sequences(
        jdata.tokenizer.texts_to_sequences([draft]), 32),
        jm.pred_dim).repeat(BATCH, 0)
    mask = np.zeros(source.shape, bool)
    mask[:, fixed] = True
    raw = np.asarray(jqm.inpaint(
        jm, jvars, jnp.asarray(cond), jnp.asarray(source), jnp.asarray(mask),
        key, num_steps=STEPS, num_resamples=resamples, cond_scale=7.5))
    out = tqm.inpaint(port, _t(cond), _t(source), _t(mask), num_steps=STEPS,
                      num_resamples=resamples, **draws)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), raw, atol=TOL, rtol=0)


def test_generate_and_eval_inverse_diffusion_match_jax(setup):
    jdata, tdata = setup["data"]["inverse_diffusion"]
    jm, jvars, port = setup["inv"]
    props = jdata.scaler.inverse_transform(jdata.y_test[:BATCH])
    key = jax.random.PRNGKey(20)
    want = jdesign.generate_from_conditioning(
        jm, jvars, props, jdata.tokenizer, key, scaler=jdata.scaler,
        training_smiles=setup["smiles"], timesteps=STEPS)
    draws = _sample_draws(key, STEPS, (BATCH, 32, jm.pred_dim))
    got = tdesign.generate_from_conditioning(
        port, props, tdata.tokenizer, scaler=tdata.scaler,
        training_smiles=setup["smiles"], timesteps=STEPS, **draws)
    np.testing.assert_allclose(got["raw_samples"], want["raw_samples"],
                               atol=TOL, rtol=0)
    _same_report(got, want)
    kw = dict(num_samples=BATCH, timesteps=STEPS, cond_scale=7.5)
    want = jeval.eval_inverse_diffusion(jm, jvars, jdata.y_test,
                                        jdata.tokenizer, setup["smiles"],
                                        key, **kw)
    got = teval.eval_inverse_diffusion(port, tdata.y_test, tdata.tokenizer,
                                       setup["smiles"], **kw, **draws)
    assert got == want


def _close_properties(got, want, scaler):
    """Physical-unit properties within 1e-4 of the scaled range."""
    np.testing.assert_allclose(scaler.transform(got), scaler.transform(want),
                               atol=TOL, rtol=0)


def _close_scores(got, want):
    _close_properties(got["predicted_properties"],
                      want["predicted_properties"], _close_scores.scaler)
    np.testing.assert_allclose(got["per_molecule_r2"],
                               want["per_molecule_r2"], atol=TOL, rtol=0)
    assert abs(got["overall_r2"] - want["overall_r2"]) <= TOL
    assert abs(got["mae"] - want["mae"]) <= TOL * max(1.0, want["mae"])


def test_forward_diffusion_predict_rescore_and_eval_match_jax(setup):
    """``predict_properties_from_smiles``, ``rescore_generated`` with the
    forward diffusion model (at its fixed 100 steps) and
    ``eval_forward_diffusion``."""
    jdata, tdata = setup["data"]["forward_diffusion"]
    jinv, tinv = setup["data"]["inverse_diffusion"]
    jm, jvars, port = setup["fwd"]
    smiles = setup["smiles"][10:10 + BATCH]
    key = jax.random.PRNGKey(30)
    draws = _sample_draws(key, STEPS, (BATCH, 64, 1))
    want = jdesign.predict_properties_from_smiles(
        jm, jvars, smiles, jinv.tokenizer, jinv.scaler, key, timesteps=STEPS)
    got = tdesign.predict_properties_from_smiles(
        port, smiles, tinv.tokenizer, tinv.scaler, timesteps=STEPS, **draws)
    assert got.shape == (BATCH, 12)
    _close_properties(got, want, jinv.scaler)
    kw = dict(num_samples=BATCH, timesteps=STEPS)
    want = jeval.eval_forward_diffusion(jm, jvars, jdata.X_test,
                                        jdata.y_test, key, **kw)
    got = teval.eval_forward_diffusion(port, tdata.X_test, tdata.y_test,
                                       **kw, **draws)
    assert set(got) == set(want) == {"r2", "mae"}
    for k in got:
        assert abs(got[k] - want[k]) <= TOL, k
    targets = jinv.scaler.inverse_transform(jinv.y_test[:BATCH])
    want = jdesign.rescore_generated(jm, jvars, smiles, targets,
                                     jinv.tokenizer, jinv.scaler, key)
    got = tdesign.rescore_generated(
        port, smiles, targets, tinv.tokenizer, tinv.scaler,
        **_sample_draws(key, PREDICT_STEPS, (BATCH, 64, 1)))
    _close_scores.scaler = jinv.scaler
    _close_scores(got, want)


def test_forward_transformer_predict_rescore_and_eval_match_jax(setup):
    """``predict_properties_from_smiles_transformer``, ``rescore_generated``
    with the encoder, and ``eval_forward_transformer``."""
    jdata, tdata = setup["data"]["transformer"]
    jm, jvars, port = setup["enc"]
    smiles = setup["smiles"][20:20 + BATCH] + [""]
    want = jdesign.predict_properties_from_smiles_transformer(
        jm, jvars, smiles, jdata.tokenizer, jdata.scaler)
    got = tdesign.predict_properties_from_smiles_transformer(
        port, smiles, tdata.tokenizer, tdata.scaler)
    assert got.shape == (BATCH + 1, 12)
    _close_properties(got, want, jdata.scaler)
    targets = jdata.scaler.inverse_transform(jdata.y_test[:BATCH + 1])
    want = jdesign.rescore_generated(
        None, None, smiles, targets, jdata.tokenizer, jdata.scaler, None,
        transformer_encoder=jm, variables_encoder=jvars)
    got = tdesign.rescore_generated(None, smiles, targets, tdata.tokenizer,
                                    tdata.scaler, transformer_encoder=port)
    _close_scores.scaler = jdata.scaler
    _close_scores(got, want)
    want = jeval.eval_forward_transformer(jm, jvars, jdata.X_test,
                                          jdata.y_test, num_samples=BATCH)
    got = teval.eval_forward_transformer(port, tdata.X_test, tdata.y_test,
                                         num_samples=BATCH)
    for k in ("r2", "mae"):
        assert abs(got[k] - want[k]) <= TOL, k


def _ar_uniforms(key, steps, batch, vocab):
    """The uniforms ``generate_sequence``'s scan draws from ``key``."""
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k1, (batch, vocab))))
    return _t(np.stack(out))


def test_generate_transformer_and_eval_inverse_transformer_match_jax(setup):
    jdata, tdata = setup["data"]["transformer"]
    jm, jvars, port = setup["ar"]
    key = jax.random.PRNGKey(40)
    uniforms = _ar_uniforms(key, AR_TOKENS, BATCH, jm.logits_dim)
    props = jdata.scaler.inverse_transform(jdata.y_test[:BATCH])
    kw = dict(tokens_to_generate=AR_TOKENS, training_smiles=setup["smiles"])
    want = jdesign.generate_from_conditioning_transformer(
        jm, jvars, props, jdata.tokenizer, key, scaler=jdata.scaler, **kw)
    got = tdesign.generate_from_conditioning_transformer(
        port, props, tdata.tokenizer, scaler=tdata.scaler,
        uniforms=uniforms, **kw)
    _same_report(got, want)
    assert len(set(got["smiles"])) > 1
    kw = dict(num_samples=BATCH, tokens_to_generate=AR_TOKENS)
    want = jeval.eval_inverse_transformer(jm, jvars, jdata.y_test,
                                          jdata.tokenizer, setup["smiles"],
                                          key, **kw)
    got = teval.eval_inverse_transformer(port, tdata.y_test, tdata.tokenizer,
                                         setup["smiles"], uniforms=uniforms,
                                         **kw)
    assert got == want


def test_validity_and_decode_match_jax(setup):
    """``smiles_is_valid``, ``canonicalize``, ``decode_one_hot`` (an array
    or a tensor) and ``evaluate_generated`` give the JAX package's
    answers."""
    jdata, tdata = setup["data"]["inverse_diffusion"]
    strings = setup["smiles"][:40] + ["C(C", "C=1", "FF", "", "CC1CC1N"]
    for s in strings:
        assert tdesign.smiles_is_valid(s) == jdesign.smiles_is_valid(s), s
        assert tdesign.canonicalize(s) == jdesign.canonicalize(s), s
    assert tdesign.HAS_RDKIT == jdesign.HAS_RDKIT
    x = np.random.default_rng(4).standard_normal(
        (6, 32, jdata.vocab_size)).astype(np.float32)
    want = jdesign.decode_one_hot(x, jdata.tokenizer)
    assert tdesign.decode_one_hot(x, tdata.tokenizer) == want
    assert tdesign.decode_one_hot(_t(x), tdata.tokenizer) == want
    assert (tdesign.evaluate_generated(strings, setup["smiles"][:20])
            == jdesign.evaluate_generated(strings, setup["smiles"][:20]))
