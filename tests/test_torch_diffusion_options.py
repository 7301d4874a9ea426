"""The port's diffusion options beyond the production path against the JAX
package, on the CPU in float32: the vk objective, ``make_distribution``, the
ancestral Euler and Karras samplers (whole trajectories fed JAX's own step
draws), span-by-span outpainting and the sampler/objective compatibility.

Bands: objectives and distributions 2e-5 (primitives); sampler trajectories
on a stub network 1e-4 (the JAX suite's band for whole trajectories);
``span_by_span_compose`` on a fake inpainter exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.diffusion import objectives as jobj
from moleculediffusiontransformer_tpu.diffusion import samplers as jsamplers
from moleculediffusiontransformer_tpu.diffusion.schedules import \
    karras_schedule
from moleculediffusiontransformer_tpu_torch.diffusion import distributions
from moleculediffusiontransformer_tpu_torch.diffusion import objectives
from moleculediffusiontransformer_tpu_torch.diffusion import samplers

TOL = 2e-5
SHAPE = (2, 16, 4)


def _stub_nets(seed=0):
    """The same small nonlinear network in both packages:
    ``tanh(x * w) + t``."""
    w = np.random.default_rng(seed).standard_normal(SHAPE[1:]).astype(
        np.float32)

    def jnet(x, t):
        return jnp.tanh(x * jnp.asarray(w)) + t.reshape(-1, 1, 1)

    def tnet(x, t):
        return torch.tanh(x * torch.from_numpy(w)) + t.reshape(-1, 1, 1)
    return jnet, tnet


def _draws(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]


def test_pad_dims_and_to_batch():
    x = torch.arange(3.0)
    assert objectives.pad_dims(x, 2).shape == (3, 1, 1)
    np.testing.assert_array_equal(
        objectives.to_batch(4, sigma=0.5).numpy(),
        np.asarray(jobj.to_batch(4, sigma=0.5)))
    assert objectives.to_batch(3, sigmas=x) is x
    with pytest.raises(ValueError):
        objectives.to_batch(3)


def test_vk_objective_matches_jax():
    """The scale weights, sigma <-> t, denoise and the loss."""
    jnet, tnet = _stub_nets(1)
    x, noise, x_noisy = _draws(2)
    sigmas = np.array([0.05, 3.0], np.float32)
    vk, jvk = objectives.make_objective("vk"), jobj.VKDiffusion()
    assert isinstance(vk, objectives.VKDiffusion) and vk.alias == "vk"
    for a, b in zip(vk.get_scale_weights(torch.from_numpy(sigmas)),
                    jvk.get_scale_weights(jnp.asarray(sigmas))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    t = vk.sigma_to_t(torch.from_numpy(sigmas))
    np.testing.assert_allclose(t.numpy(),
                               np.asarray(jvk.sigma_to_t(sigmas)), atol=TOL)
    np.testing.assert_allclose(vk.t_to_sigma(t).numpy(), sigmas, rtol=1e-5)
    got = vk.denoise(tnet, torch.from_numpy(x_noisy),
                     torch.from_numpy(sigmas))
    want = jvk.denoise(jnet, jnp.asarray(x_noisy), jnp.asarray(sigmas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    got = vk.loss(tnet, torch.from_numpy(x), torch.from_numpy(sigmas),
                  torch.from_numpy(noise))
    want = jvk.loss(jnet, jnp.asarray(x), jnp.asarray(sigmas),
                    jnp.asarray(noise))
    assert abs(got.item() - float(want)) <= TOL * max(1.0, abs(float(want)))
    drawn = vk.loss_from_draws(tnet, torch.from_numpy(x), None,
                               sigmas=torch.from_numpy(sigmas),
                               noise=torch.from_numpy(noise))
    assert drawn.item() == got.item()


@pytest.mark.parametrize("name", ["lognormal", "uniform", "vk"])
def test_make_distribution_matches_jax(name):
    """Each distribution maps JAX's own draw of its variable (a normal for
    the lognormal and for vk, whose CDF variable the reference draws with
    ``randn``; a uniform for uniform) as JAX does."""
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdist.make_distribution(name)(key, 6))
    dist = distributions.make_distribution(name)
    assert type(dist).__name__ == type(
        jdist.make_distribution(name)).__name__
    if name == "uniform":
        got = dist(6, uniforms=torch.from_numpy(
            np.array(jax.random.uniform(key, (6,)))))
    else:
        got = dist(6, normals=torch.from_numpy(
            np.array(jax.random.normal(key, (6,)))))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    drawn = dist(6, torch.Generator().manual_seed(0))
    assert drawn.shape == (6,) and drawn.dtype == torch.float32
    with pytest.raises(ValueError):
        distributions.make_distribution("x")


def _scan_step_noises(key, num_steps):
    """The per-step normals the JAX samplers' scans draw from ``key``."""
    keys = jax.random.split(key, num_steps - 1)
    return np.stack([np.asarray(jax.random.normal(k, SHAPE, jnp.float32))
                     for k in keys])


@pytest.mark.parametrize("objective", ["k", "vk"])
@pytest.mark.parametrize("num_steps,s_max", [(4, 9.0), (9, 3.0)])
def test_aeuler_matches_jax(objective, num_steps, s_max):
    jnet, tnet = _stub_nets(3)
    start = _draws(4, 1)[0]
    sigmas = karras_schedule(num_steps, 1e-3, s_max, 3.0)
    key = jax.random.PRNGKey(num_steps)
    jo, to = jobj.make_objective(objective), objectives.make_objective(
        objective)
    want = jsamplers.sample_aeuler(
        lambda x, s: jo.denoise(jnet, x, s), jnp.asarray(start),
        jnp.asarray(sigmas), key, num_steps)
    got = samplers.sample_aeuler(
        lambda x, s: to.denoise(tnet, x, s), torch.from_numpy(start),
        sigmas, num_steps,
        step_noise=torch.from_numpy(_scan_step_noises(key, num_steps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# (num_steps, s_churn, s_noise, s_tmin, s_tmax): without churn, with churn
# everywhere, and with churn gated by s_tmin / s_tmax -- the cases of the
# JAX suite's Karras sweep
KARRAS_CASES = [(4, 0.0, 1.0, 0.0, float("inf")),
                (9, 2.0, 1.0, 0.0, float("inf")),
                (16, 10.0, 0.9, 0.05, 2.0),
                (9, 0.5, 0.9, 0.0, 2.0)]


@pytest.mark.parametrize("objective", ["k", "vk"])
@pytest.mark.parametrize("case", KARRAS_CASES)
def test_karras_matches_jax(objective, case):
    num_steps, s_churn, s_noise, s_tmin, s_tmax = case
    jnet, tnet = _stub_nets(5)
    start = _draws(6, 1)[0]
    sigmas = karras_schedule(num_steps, 1e-3, 9.0, 3.0)
    key = jax.random.PRNGKey(100 + num_steps)
    kw = dict(s_churn=s_churn, s_noise=s_noise, s_tmin=s_tmin, s_tmax=s_tmax)
    jo, to = jobj.make_objective(objective), objectives.make_objective(
        objective)
    want = jsamplers.sample_karras(
        lambda x, s: jo.denoise(jnet, x, s), jnp.asarray(start),
        jnp.asarray(sigmas), key, num_steps, **kw)
    calls = []

    def tden(x, s):
        calls.append(float(s[0]))
        return to.denoise(tnet, x, s)

    got = samplers.sample(
        tden, torch.from_numpy(start), sigmas, num_steps, sampler="karras",
        clamp=False, objective_alias=objective,
        step_noise=torch.from_numpy(_scan_step_noises(key, num_steps)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # two evaluations a step: sigma_next is never 0 inside the schedule
    assert len(calls) == 2 * (num_steps - 1)


def test_karras_skips_the_correction_at_sigma_zero():
    """Where sigma_next is 0 the Euler step is the result, as the JAX
    sampler's mask makes it, and its second evaluation is not made."""
    jnet, tnet = _stub_nets(7)
    start = _draws(8, 1)[0]
    sigmas = np.array([2.0, 0.5, 0.0], np.float32)
    key = jax.random.PRNGKey(3)
    ko = jobj.KDiffusion()
    want = jsamplers.sample_karras(
        lambda x, s: ko.denoise(jnet, x, s), jnp.asarray(start),
        jnp.asarray(sigmas), key, 3, s_churn=1.0)
    calls = []

    def tden(x, s):
        calls.append(float(s[0]))
        return objectives.KDiffusion().denoise(tnet, x, s)

    got = samplers.sample_karras(
        tden, torch.from_numpy(start), sigmas, 3, s_churn=1.0,
        step_noise=torch.from_numpy(_scan_step_noises(key, 3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert len(calls) == 3 and calls[-1] != 0.0


@pytest.mark.parametrize("sampler", ["aeuler", "karras"])
def test_samplers_draw_from_a_generator(sampler):
    _, tnet = _stub_nets(9)
    ko = objectives.KDiffusion()
    start = torch.from_numpy(_draws(10, 1)[0])
    sigmas = karras_schedule(5, 1e-3, 9.0, 3.0)
    runs = [samplers.sample(lambda x, s: ko.denoise(tnet, x, s), start,
                            sigmas, 5, sampler=sampler,
                            generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[0]).all()
    with pytest.raises(ValueError, match="steps"):
        samplers.sample(lambda x, s: ko.denoise(tnet, x, s), start, sigmas,
                        5, sampler=sampler,
                        step_noise=torch.zeros(3, *SHAPE))


@pytest.mark.parametrize("sampler,objective", [
    ("aeuler", "v"), ("karras", "v"), ("adpm2", "v"), ("v", "k"),
    ("v", "vk")])
def test_incompatible_pairs_raise_as_in_jax(sampler, objective):
    assert samplers.SAMPLER_COMPAT == jsamplers.SAMPLER_COMPAT
    noise = torch.zeros(SHAPE)
    sigmas = karras_schedule(3, 1e-3, 9.0, 3.0)
    with pytest.raises(AssertionError):
        jsamplers.sample(lambda x, s: x, jnp.zeros(SHAPE), sigmas,
                         jax.random.PRNGKey(0), 3, sampler=sampler,
                         objective_alias=objective)
    with pytest.raises(AssertionError, match="incompatible"):
        samplers.sample(lambda x, s: x, noise, sigmas, 3, sampler=sampler,
                        objective_alias=objective,
                        generator=torch.Generator())


@pytest.mark.parametrize("keep_start", [True, False])
def test_span_by_span_compose_matches_jax(keep_start):
    """The same fake inpainter in both packages (next span = previous span
    + 1): the chaining and the masks, exactly."""
    half = 4
    start = np.arange(2 * 2 * half * 3, dtype=np.float32).reshape(
        2, 2 * half, 3)

    def jfake(source, mask):
        first = source[:, :half]
        return jnp.where(mask, source,
                         jnp.concatenate([first, first + 1.0], axis=1))

    def tfake(source, mask):
        first = source[:, :half]
        return torch.where(mask, source, torch.cat([first, first + 1.0], 1))

    want = jsamplers.span_by_span_compose(jfake, jnp.asarray(start), 3,
                                          keep_start=keep_start)
    got = samplers.span_by_span_compose(tfake, torch.from_numpy(start), 3,
                                        keep_start=keep_start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = samplers.sequential_mask(torch.from_numpy(start), half)
    np.testing.assert_array_equal(
        mask.numpy(),
        np.asarray(jsamplers.sequential_mask(jnp.asarray(start), half)))


def test_span_by_span_over_inpaint_adpm2():
    """Outpainting through the real inpainter: each span's kept half is the
    previous span's new half, and every value finite."""
    _, tnet = _stub_nets(11)
    ko = objectives.KDiffusion()
    gen = torch.Generator().manual_seed(2)
    sigmas = karras_schedule(4, 1e-3, 9.0, 3.0)
    seen = []

    def inpaint(source, mask):
        seen.append(source.clone())
        return samplers.inpaint_adpm2(
            lambda x, s: ko.denoise(tnet, x, s), source, mask, sigmas, 4, 2,
            generator=gen)

    start = torch.from_numpy(_draws(12, 1)[0])
    out = samplers.span_by_span_compose(inpaint, start, 2)
    assert out.shape == (2, 16, 4) and torch.isfinite(out).all()
    assert torch.equal(seen[1][:, :8], out[:, :8])
    assert torch.equal(seen[0][:, :8], start[:, 8:])
