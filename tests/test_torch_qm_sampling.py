"""The port's serving path against the JAX package on the CPU in fp32: one
CFG denoise evaluation of a small ``QMDiffusion`` and a full 8-step ADPM2
``sample`` fed the JAX package's own noise draws (torch cannot reproduce
threefry).  Tolerance: 1e-4 absolute, the JAX suite's full-UNet band at
L >= 32, unless stated at the assert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import objectives as jobj
from moleculediffusiontransformer_tpu.diffusion import samplers as jsamp
from moleculediffusiontransformer_tpu.diffusion.schedules import \
    karras_schedule as jax_karras
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu_torch.diffusion import objectives
from moleculediffusiontransformer_tpu_torch.diffusion import samplers
from moleculediffusiontransformer_tpu_torch.diffusion.schedules import \
    karras_schedule
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params

TOL = 1e-4
SMALL = dict(max_length=32, channels=32, pred_dim=8, text_embed_dim=16,
             embed_dim_position=16, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=16,
             pre_transformer=1)
BATCH = 3


@pytest.fixture(scope="module")
def models():
    jm = jqm.QMDiffusion(**SMALL)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(key, jnp.zeros((2, 12)),
                                 jnp.zeros((2, 32, 8)), key)
    port = tqm.QMDiffusion(**SMALL)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    rng = np.random.default_rng(0)
    props = rng.uniform(-1, 1, (BATCH, 12)).astype(np.float32)
    return jm, variables, port.eval(), props


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_denoise_matches_jax(models, cond_scale):
    jm, variables, port, props = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 32, 8)).astype(np.float32)
    sigmas = np.array([0.5, 2.0, 0.05], np.float32)

    @jax.jit
    def jax_denoise(v, x, s, seq):
        emb = jm.apply(v, seq, method=jqm.QMDiffusionBase.embed_conditioning)
        return jm.apply(v, x, s, emb, cond_scale,
                        method=jqm.QMDiffusionBase.denoise)

    want = np.asarray(jax_denoise(variables, jnp.asarray(x),
                                  jnp.asarray(sigmas), jnp.asarray(props)))
    with torch.no_grad():
        emb = port.embed_conditioning(torch.from_numpy(props))
        got = port.denoise(torch.from_numpy(x), torch.from_numpy(sigmas), emb,
                           cond_scale).numpy()
    assert np.abs(got - want).max() <= TOL


def _jax_draws(key, num_steps, shape):
    """The draws ``models.qm_diffusion.sample`` makes from ``key``."""
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(k_samp, num_steps - 1)]
    return torch.tensor(noise), torch.from_numpy(np.stack(steps))


def test_sample_matches_jax(models):
    jm, variables, port, props = models
    key, steps = jax.random.PRNGKey(7), 8
    want = np.asarray(jqm.sample(jm, variables, jnp.asarray(props), key,
                                 num_steps=steps, cond_scale=2.0))
    noise, step_noise = _jax_draws(key, steps, (BATCH, 32, 8))
    got = tqm.sample(port, torch.from_numpy(props), num_steps=steps,
                     cond_scale=2.0, noise=noise, step_noise=step_noise)
    assert got.shape == (BATCH, 32, 8) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL


def test_sample_from_generator(models):
    """Without explicit noise the draws come from the generator: the same
    seed gives the same molecules, another seed others."""
    _, _, port, props = models
    seq = torch.from_numpy(props)

    def run(seed):
        return tqm.sample(port, seq, torch.Generator().manual_seed(seed),
                          num_steps=3, cond_scale=2.0)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (BATCH, 32, 8) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        tqm.sample(port, seq, num_steps=3)


@pytest.mark.parametrize("num_steps", [8, 64])
def test_karras_schedule_matches_jax(num_steps):
    got = karras_schedule(num_steps)
    assert got.dtype == np.float32 and len(got) == num_steps + 1
    assert got[-1] == 0.0
    np.testing.assert_array_equal(got, jax_karras(num_steps))


def test_adpm2_sigmas_match_jax():
    sig = karras_schedule(64)
    for s, sn in zip(sig[:63], sig[1:64]):
        got = samplers.adpm2_sigmas(s, sn)
        want = jsamp.adpm2_sigmas(jnp.float32(s), jnp.float32(sn))
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, float(w))
    # sigma_down is exactly 0 where sigma_up == sigma_next (FMA-safe form)
    assert samplers._sqrt_sq_diff(np.float32(0.3), np.float32(0.3)) == 0.0


@pytest.mark.parametrize("threshold", [0.0, 0.9])
def test_clip_matches_jax(threshold):
    x = 3 * np.random.default_rng(2).standard_normal((4, 16, 8)).astype(
        np.float32)
    want = np.asarray(jobj.clip(jnp.asarray(x), threshold))
    got = objectives.clip(torch.from_numpy(x), threshold).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_base_unet_with_context_channels_and_features():
    """The UNet paths the CFG slice does not take: XUNet1d "base" with
    per-layer context channels and a feature mapping, against JAX."""
    from moleculediffusiontransformer_tpu.nn.unet import XUNet1d as JXUNet1d
    from moleculediffusiontransformer_tpu_torch.nn.unet import XUNet1d

    kw = dict(in_channels=4, channels=32, multipliers=(1, 2), factors=(2,),
              num_blocks=(1,), attentions=(1,), attention_heads=2,
              attention_features=16, attention_multiplier=2,
              context_channels=(2, 8), context_features=8)
    rng = np.random.default_rng(3)
    x, c0, c1, feats = (rng.standard_normal(s).astype(np.float32) for s in
                        [(2, 16, 4), (2, 16, 2), (2, 8, 8), (2, 8)])
    t = np.array([0.3, -0.7], np.float32)
    jmod = JXUNet1d("base", **kw)
    jargs = dict(features=jnp.asarray(feats),
                 channels_list=[jnp.asarray(c0), jnp.asarray(c1)])
    variables = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x),
                          jnp.asarray(t), **jargs)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(t),
                                 **jargs))
    port = XUNet1d("base", **kw)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   features=torch.from_numpy(feats),
                   channels_list=[torch.from_numpy(c0),
                                  torch.from_numpy(c1)]).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= TOL
