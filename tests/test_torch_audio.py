"""The port's ``Model1d`` family (``models/audio.py``), its v-diffusion
objective, linear schedule and v-sampler against the JAX package, on the CPU
in fp32.  Inputs, parameters (JAX's, loaded ``strict=True``), sigmas and
noise are the same numbers in both packages.

Bands: schedule, objective and sampler on a stub network within 2e-5; a tiny
model's denoise and 4-step sample within 1e-4 (the JAX suite's UNet band);
its loss within 1e-4 and every gradient rtol 1e-4 / atol 1e-5 (the gradient
band of ``test_torch_training.py``); through the streaming-attention route
(Pallas interpret on the JAX side) gradients atol 5e-5 / rtol 1e-4, JAX's
own band for that backward.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import \
    UniformDistribution as JUniform
from moleculediffusiontransformer_tpu.diffusion import objectives as jobj
from moleculediffusiontransformer_tpu.diffusion import samplers as jsamplers
from moleculediffusiontransformer_tpu.diffusion import schedules as jsched
from moleculediffusiontransformer_tpu.models import audio as jaudio
from moleculediffusiontransformer_tpu_torch.diffusion import objectives
from moleculediffusiontransformer_tpu_torch.diffusion import samplers
from moleculediffusiontransformer_tpu_torch.diffusion import schedules
from moleculediffusiontransformer_tpu_torch.models import audio
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import flash_attention as tfa
from moleculediffusiontransformer_tpu_torch.train import trainer

jfa = importlib.import_module(
    "moleculediffusiontransformer_tpu.ops.flash_attention")

# the tiny configuration of examples/audio_diffusion.py
TINY = dict(channels=16, patch_size=2, multipliers=(1, 2), factors=(2,),
            num_blocks=(1,), attentions=(0, 1), attention_heads=2,
            attention_features=8, attention_multiplier=2,
            diffusion_type="v", resnet_groups=4)
LENGTH = 256
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(seed=0, length=LENGTH, batch=2, in_channels=2, **overrides):
    """(JAX model, its params, the port's model with them loaded, x)."""
    kw = {**TINY, **overrides}
    jmodel = jaudio.Model1d(in_channels=in_channels,
                            diffusion_sigma_distribution=JUniform(), **kw)
    x = np.random.default_rng(seed).standard_normal(
        (batch, length, in_channels)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    emb = None
    if kw.get("unet_type") == "cfg":
        emb = np.random.default_rng(seed + 1).standard_normal(
            (batch, kw["context_embedding_max_length"],
             kw["context_embedding_features"])).astype(np.float32)
        params = jmodel.init(key, jnp.asarray(x), key,
                             embedding=jnp.asarray(emb))["params"]
    else:
        params = jmodel.init(key, jnp.asarray(x), key)["params"]
    tmodel = audio.build_model1d(device="cpu", in_channels=in_channels, **kw)
    tmodel.load_state_dict(state_dict_from_jax_params(params), strict=True)
    n_jax = sum(p.size for p in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax
    return jmodel, params, tmodel, x, emb


def _jax_draws(key, shape):
    """The sigmas and noise that ``loss_from_key`` draws from ``key``."""
    ks, kn = jax.random.split(key)
    return (np.asarray(JUniform()(ks, shape[0])),
            np.asarray(jax.random.normal(kn, shape, jnp.float32)))


@pytest.mark.parametrize("steps", [1, 4, 50])
def test_linear_schedule(steps):
    np.testing.assert_array_equal(schedules.linear_schedule(steps),
                                  jsched.linear_schedule(steps))
    np.testing.assert_array_equal(
        schedules.make_schedule("linear", steps),
        jsched.make_schedule("linear", steps))
    np.testing.assert_array_equal(
        schedules.make_schedule("karras", max(steps, 2), rho=2.0),
        jsched.make_schedule("karras", max(steps, 2), rho=2.0))
    with pytest.raises(ValueError):
        schedules.make_schedule("cosine", steps)


def test_make_objective():
    assert isinstance(objectives.make_objective("v"), objectives.VDiffusion)
    k = objectives.make_objective("k", sigma_data=0.3, dynamic_threshold=0.9)
    assert (k.alias, k.sigma_data, k.dynamic_threshold) == ("k", 0.3, 0.9)
    assert objectives.make_objective("v").alias == "v"
    assert isinstance(objectives.make_objective("vk"),
                      objectives.VKDiffusion)
    with pytest.raises(ValueError):
        objectives.make_objective("x")


def test_v_objective_matches_jax():
    rng = np.random.default_rng(1)
    x, noise, w = (rng.standard_normal((3, 16, 2)).astype(np.float32)
                   for _ in range(3))
    sigmas = rng.uniform(size=3).astype(np.float32)
    jnet = lambda xn, t: jnp.tanh(xn * jnp.asarray(w)) + t.reshape(-1, 1, 1)
    tnet = lambda xn, t: torch.tanh(xn * torch.tensor(w)) + t.reshape(
        -1, 1, 1)
    want = jobj.VDiffusion().loss(jnet, jnp.asarray(x), jnp.asarray(sigmas),
                                  jnp.asarray(noise))
    v = objectives.VDiffusion()
    got = v.loss(tnet, torch.tensor(x), torch.tensor(sigmas),
                 torch.tensor(noise))
    assert abs(got.item() - float(want)) <= 2e-5
    drawn = v.loss_from_draws(tnet, torch.tensor(x), None,
                              sigmas=torch.tensor(sigmas),
                              noise=torch.tensor(noise))
    assert drawn.item() == got.item()
    from moleculediffusiontransformer_tpu_torch.diffusion.distributions \
        import UniformDistribution
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(v.loss_from_draws(tnet, torch.tensor(x),
                                            UniformDistribution(), gen))
    for a, b in zip(v.get_alpha_beta(torch.tensor(sigmas)),
                    jobj.VDiffusion.get_alpha_beta(jnp.asarray(sigmas))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


@pytest.mark.parametrize("steps", [2, 5, 12])
def test_v_sampler_matches_jax(steps):
    rng = np.random.default_rng(2)
    noise, w = (rng.standard_normal((2, 16, 2)).astype(np.float32)
                for _ in range(2))
    jden = lambda x, s: jnp.tanh(x * jnp.asarray(w)) * s.reshape(-1, 1, 1)
    tden = lambda x, s: torch.tanh(x * torch.tensor(w)) * s.reshape(-1, 1, 1)
    sig = schedules.linear_schedule(steps)
    key = jax.random.PRNGKey(0)
    want = jsamplers.sample(jden, jnp.asarray(noise), sig, key, steps,
                            sampler="v", clamp=False, objective_alias="v")
    got = samplers.sample(tden, torch.tensor(noise), sig, steps,
                          sampler="v", clamp=False, objective_alias="v")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert samplers.SAMPLER_COMPAT == jsamplers.SAMPLER_COMPAT
    with pytest.raises(AssertionError):
        samplers.sample(tden, torch.tensor(noise), sig, steps, sampler="v",
                        objective_alias="k")
    with pytest.raises(ValueError, match="step_noise or a generator"):
        samplers.sample(tden, torch.tensor(noise), sig, steps,
                        sampler="karras")
    with pytest.raises(ValueError, match="Unknown sampler"):
        samplers.sample(tden, torch.tensor(noise), sig, steps, sampler="x")


def test_tiny_model1d_denoise_and_sample():
    jmodel, params, tmodel, x, _ = _pair(3)
    sig = np.random.default_rng(4).uniform(size=2).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(sig),
                        method=jaudio.Model1d.denoise)
    with torch.no_grad():
        got = tmodel.denoise(torch.tensor(x), torch.tensor(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    want = jaudio.sample_model1d(jmodel, {"params": params}, jnp.asarray(x),
                                 jax.random.PRNGKey(0), num_steps=4)
    got = audio.sample_model1d(tmodel, torch.tensor(x), num_steps=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert got.abs().max() <= 1.0
    drawn = audio.sample_model1d(tmodel, shape=(1, LENGTH, 2),
                                 generator=torch.Generator().manual_seed(0),
                                 num_steps=2)
    assert drawn.shape == (1, LENGTH, 2) and torch.isfinite(drawn).all()
    with pytest.raises(ValueError):
        audio.sample_model1d(tmodel, num_steps=2)


def _loss_and_grads(jmodel, params, x, key, **kw):
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(x), key, **kw))(
            params)
    return float(loss), state_dict_from_jax_params(grads)


def _assert_grads(tmodel, want, tol):
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_tiny_model1d_loss_and_grads(micro_batches):
    """The training loss with JAX's own draws, and every gradient, through
    ``make_model1d_train_step``; with two micro-batches against the mean of
    JAX's two half-batch gradients."""
    jmodel, params, tmodel, x, _ = _pair(5, batch=4)
    key = jax.random.PRNGKey(7)
    sigmas, noise = _jax_draws(key, x.shape)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(tmodel, opt)
    step = trainer.make_model1d_train_step(tmodel, opt, micro_batches)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    loss = step(state, torch.tensor(x), sigmas=torch.tensor(sigmas),
                noise=torch.tensor(noise))
    assert state.step == 1 and state.opt_state.count == 1
    assert any(not torch.equal(p, before[n])
               for n, p in tmodel.named_parameters())

    if micro_batches == 1:
        want_loss, want = _loss_and_grads(jmodel, params, x, key)
    else:
        # JAX's loss on each half with that half's draws
        def half(p, rows):
            net = lambda xn, t: jmodel.apply({"params": p}, xn, t,
                                             method=lambda m, a, b: m.unet(
                                                 a, b))
            return jobj.VDiffusion().loss(
                net, jnp.asarray(x[rows]), jnp.asarray(sigmas[rows]),
                jnp.asarray(noise[rows]))
        parts = [jax.value_and_grad(lambda p: half(p, rows))(params)
                 for rows in (slice(0, 2), slice(2, 4))]
        want_loss = float(sum(l for l, _ in parts) / 2)
        want = state_dict_from_jax_params(jax.tree_util.tree_map(
            lambda a, b: (a + b) / 2, parts[0][1], parts[1][1]))
    assert abs(loss.item() - want_loss) <= 1e-4
    _assert_grads(tmodel, want, GRAD_TOL)


def test_model1d_forward_draws_from_a_generator():
    _, _, tmodel, x, _ = _pair(6)
    a = tmodel(torch.tensor(x), torch.Generator().manual_seed(1))
    b = tmodel(torch.tensor(x), torch.Generator().manual_seed(1))
    c = tmodel(torch.tensor(x), torch.Generator().manual_seed(2))
    assert torch.isfinite(a) and a.item() == b.item() != c.item()
    with pytest.raises(ValueError):
        trainer.make_model1d_train_step(tmodel, trainer.make_optimizer(
            trainer.OptimizerConfig()), 0)


def test_model1d_through_the_flash_route(monkeypatch):
    """A ``Model1d`` whose attention runs at 512 tokens, the threshold
    patched to 512 in both packages: JAX through its Pallas kernels in
    interpret mode, the port through ``flash_attention``."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 512)
    monkeypatch.setattr(tfa, "LONG_SEQ_THRESHOLD", 512)
    monkeypatch.setenv("MDT_FLASH_INTERPRET", "1")
    monkeypatch.delenv("MDT_FLASH", raising=False)
    jmodel, params, tmodel, x, _ = _pair(8, length=2048, batch=1,
                                         attention_features=16)
    calls = []
    inner = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda q, k, v, **kw: (
        calls.append(tuple(q.shape)), inner(q, k, v, **kw))[1])

    key = jax.random.PRNGKey(9)
    sigmas, noise = _jax_draws(key, x.shape)
    want_loss, want = _loss_and_grads(jmodel, params, x, key)
    loss = tmodel(torch.tensor(x), sigmas=torch.tensor(sigmas),
                  noise=torch.tensor(noise))
    loss.backward()
    # one attention layer: batch 1, 2 heads, handed over as split heads
    assert calls == [(1, 2, 512, 16)]
    assert abs(loss.item() - want_loss) <= 1e-4
    _assert_grads(tmodel, want, dict(rtol=1e-4, atol=5e-5))

    sig = np.full((1,), 0.7, np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(sig),
                        method=jaudio.Model1d.denoise)
    with torch.no_grad():
        got = tmodel.denoise(torch.tensor(x), torch.tensor(sig))
    assert len(calls) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_conditional_preset_denoise_at_scale_5():
    """``AudioDiffusionConditional`` ("cfg") cut to the tiny widths: a
    classifier-free-guided denoise at the reference's embedding scale, and
    the training loss with the embedding split over micro-batches."""
    cfg = dict(unet_type="cfg", context_embedding_features=16,
               context_embedding_max_length=8)
    jmodel, params, tmodel, x, emb = _pair(10, batch=2, **cfg)
    preset = audio.AudioDiffusionConditional(16, 8, device="cpu",
                                             in_channels=2, **TINY)
    assert ({k: v.shape for k, v in preset.state_dict().items()}
            == {k: v.shape for k, v in tmodel.state_dict().items()})
    sig = np.random.default_rng(11).uniform(size=2).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(sig),
                        method=jaudio.Model1d.denoise,
                        embedding=jnp.asarray(emb), embedding_scale=5.0)
    with torch.no_grad():
        got = tmodel.denoise(torch.tensor(x), torch.tensor(sig),
                             embedding=torch.tensor(emb),
                             embedding_scale=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    key = jax.random.PRNGKey(12)
    sigmas, noise = _jax_draws(key, x.shape)
    want_loss, _ = _loss_and_grads(jmodel, params, x, key,
                                   embedding=jnp.asarray(emb))
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    loss = trainer.make_model1d_train_step(tmodel, opt, 1)(
        trainer.TrainState.create(tmodel, opt), torch.tensor(x),
        sigmas=torch.tensor(sigmas), noise=torch.tensor(noise),
        embedding=torch.tensor(emb))
    assert abs(loss.item() - want_loss) <= 1e-4


def test_default_presets():
    assert audio.get_default_sampling_kwargs() == \
        jaudio.get_default_sampling_kwargs()
    ours, theirs = (audio.get_default_model_kwargs(),
                    jaudio.get_default_model_kwargs())
    assert set(ours) == set(theirs)
    for k in ours:
        if k != "diffusion_sigma_distribution":
            assert ours[k] == theirs[k], k
    with torch.device("meta"):
        model = audio.AudioDiffusionModel(device="meta", in_channels=2)
    # attention at lengths 32 ... 4 on a 2**15-sample waveform: 4 stacks in
    # the down path, the bottleneck, 3 in the up path
    assert sum(p.numel() for p in model.parameters()) > 1e8
    assert model.diffusion_type == "v"
