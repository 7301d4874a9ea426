"""The default audio preset's structure at the lengths where its stacks pass
the whole-row attention core's 64 rows: a ``Model1d`` with the preset's
patch 16, factors (4, 4, 4, 2, 2, 2) and attention levels, at narrow
channels, on a waveform of 2**18 samples, so that its seven Transformer1d
stacks run at L 128, 64, 32, 32, 32, 64 and 128.  Every stack takes the
stack dispatch (on the CPU its plain versions; on the card K1, and in
training the stash, K3, K2 and K4), as the JAX gate fuses every stack up
to L 512.  JAX's params are loaded ``strict=True``; the JAX model runs its
composition on the CPU.  A denoise evaluation, the training loss with
JAX's draws and every gradient agree within 1e-4 in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import \
    UniformDistribution as JUniform
from moleculediffusiontransformer_tpu.models import audio as jaudio
from moleculediffusiontransformer_tpu_torch.models import audio
from moleculediffusiontransformer_tpu_torch.nn.attention import Transformer1d
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import \
    transformer_fusion as tf

from test_torch_audio import _jax_draws

SAMPLES = 2 ** 18
# the preset's structure (get_default_model_kwargs) at narrow widths: 16
# channels (64 at the attention levels), 2 heads of 32, one block a level
NARROW = dict(channels=16, patch_size=16,
              multipliers=(1, 2, 4, 4, 4, 4, 4), factors=(4, 4, 4, 2, 2, 2),
              num_blocks=(1, 1, 1, 1, 1, 1), attentions=(0, 0, 0, 1, 1, 1, 1),
              attention_heads=2, attention_features=32,
              attention_multiplier=2, diffusion_type="v")
STACK_LENGTHS = [128, 64, 32, 32, 32, 64, 128]


@pytest.fixture(autouse=True)
def one_thread():
    """One thread, as ``test_torch_tools_quality.py`` runs: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jmodel = jaudio.Model1d(in_channels=1,
                            diffusion_sigma_distribution=JUniform(), **NARROW)
    x = np.random.default_rng(0).uniform(
        -1, 1, (1, SAMPLES, 1)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    # the parameters do not depend on the length: initialised on the
    # shortest waveform the net takes (16 x 4 x 4 x 4 x 2 x 2 x 2)
    params = jax.jit(jmodel.init)(key, jnp.zeros((1, 8192, 1)), key)[
        "params"]
    tmodel = audio.build_model1d(device="cpu", in_channels=1, **NARROW)
    tmodel.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel, x


def _routed(monkeypatch):
    """The lengths of the stacks that reach the stack dispatch."""
    routed = []
    dispatch = tf.transformer1d
    monkeypatch.setattr(tf, "transformer1d", lambda *a, **k: (
        routed.append(a[2].shape[1]), dispatch(*a, **k))[1])
    return routed


def test_every_stack_takes_the_kernel_route(pair):
    _, _, tmodel, _ = pair
    stacks = [m for m in tmodel.modules() if isinstance(m, Transformer1d)]
    assert len(stacks) == 7 and all(m.num_layers == 1 for m in stacks)
    assert all(tf.stack_kernel_takes(
        torch.zeros(1, length, m.channels), None, channels=m.channels,
        dtype=torch.float32, head_dim=m.head_features)
        for m, length in zip(stacks, STACK_LENGTHS))


def test_denoise_matches_jax(pair, monkeypatch):
    jmodel, params, tmodel, x = pair
    routed = _routed(monkeypatch)
    sig = np.full((1,), 0.6, np.float32)
    want = jax.jit(lambda p, xx, s: jmodel.apply(
        {"params": p}, xx, s, method=jaudio.Model1d.denoise))(
            params, jnp.asarray(x), jnp.asarray(sig))
    with torch.no_grad():
        got = tmodel.denoise(torch.tensor(x), torch.tensor(sig))
    assert sorted(routed) == sorted(STACK_LENGTHS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_loss_and_grads_match_jax(pair, monkeypatch):
    """The loss with JAX's draws, and every parameter's gradient, through
    the stacks' autograd function (the stash forward and the K3, K2, K4
    plain versions), against ``jax.value_and_grad``."""
    jmodel, params, tmodel, x = pair
    key = jax.random.PRNGKey(3)
    sigmas, noise = _jax_draws(key, x.shape)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(x), key)))(params)
    want = state_dict_from_jax_params(want)
    routed = _routed(monkeypatch)
    tmodel.zero_grad()
    loss = tmodel(torch.tensor(x), sigmas=torch.tensor(sigmas),
                  noise=torch.tensor(noise))
    loss.backward()
    assert sorted(routed) == sorted(STACK_LENGTHS)
    assert abs(loss.item() - float(want_loss)) <= 1e-4
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
