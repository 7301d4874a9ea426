"""The port's forward QM9 model (``QMDiffusionForward``: SMILES token ids
divided by the vocabulary size condition a diffusion over a (b, 64, 1)
property track) against the JAX package on the CPU in fp32, at a narrow
config (channels 32, patch 4, max_length 64, a 64-token context): the
preset's parameter count, JAX params loading with ``strict=True``, one
denoise evaluation at cond scale 1 and 2 (also with the resnet-run kernel
and the shared-KV null half switched on), a short sample and the training
loss with every gradient, fed the JAX package's own draws.  Tolerance: 1e-4
absolute for outputs and the loss (the JAX suite's full-UNet band at
L >= 32), rtol 1e-4 / atol 1e-5 for gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import forward_diffusion_qm9
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

TOL = 1e-4
VOCAB = 22
NARROW = dict(max_length=64, channels=32, pred_dim=1, text_embed_dim=16,
              embed_dim_position=16, context_embedding_max_length=64,
              num_blocks=(2, 2), attention_heads=2, attention_features=16)
BATCH = 3


@pytest.fixture(scope="module")
def models():
    jm = jqm.QMDiffusionForward(**NARROW)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(key, jnp.zeros((2, 64)),
                                 jnp.zeros((2, 64, 1)), key)
    port = tqm.QMDiffusionForward(**NARROW)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (BATCH, 64))
    cond = (ids / VOCAB).astype(np.float32)    # inverse_design.py:146-151
    return jm, variables, port.eval(), cond


def test_preset_has_18m_parameters():
    with torch.device("meta"):
        model = tqm.from_config(tqm.QMDiffusionForward,
                                forward_diffusion_qm9(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 18_322_684
    assert (model.unet.to_in.patch_size, model.max_length,
            model.pred_dim) == (4, 64, 1)


@pytest.fixture
def switches():
    rf.enable_resnet_fusion(True)
    tf.enable_sharedkv(True)
    yield
    rf.enable_resnet_fusion(False)
    tf._SHAREDKV = None


def _jax_denoise(jm, variables, x, sigmas, cond, cond_scale):
    @jax.jit
    def run(v, x, s, seq):
        emb = jm.apply(v, seq, method=jqm.QMDiffusionBase.embed_conditioning)
        return jm.apply(v, x, s, emb, cond_scale,
                        method=jqm.QMDiffusionBase.denoise)

    return np.asarray(run(variables, jnp.asarray(x), jnp.asarray(sigmas),
                          jnp.asarray(cond)))


def _denoise_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 64, 1)).astype(np.float32)
    return x, np.array([0.5, 2.0, 0.05], np.float32)


def _port_denoise(port, x, sigmas, cond, cond_scale):
    with torch.no_grad():
        emb = port.embed_conditioning(torch.from_numpy(cond))
        return port.denoise(torch.from_numpy(x), torch.from_numpy(sigmas),
                            emb, cond_scale).numpy()


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_denoise_matches_jax(models, cond_scale):
    jm, variables, port, cond = models
    x, sigmas = _denoise_inputs()
    want = _jax_denoise(jm, variables, x, sigmas, cond, cond_scale)
    got = _port_denoise(port, x, sigmas, cond, cond_scale)
    assert got.shape == (BATCH, 64, 1)
    assert np.abs(got - want).max() <= TOL


def test_denoise_with_both_switches_on(models, switches, monkeypatch):
    """Cond scale 2 with the resnet-run kernel and the shared-KV null half
    on: four resnet runs (two down, two up) and five null-half stacks (two
    down, the bottleneck's, two up; context 64) an evaluation, the same
    result."""
    jm, variables, port, cond = models
    x, sigmas = _denoise_inputs()
    want = _jax_denoise(jm, variables, x, sigmas, cond, 2.0)
    uniform, runs = [], []
    stack, run = tf.transformer1d_forward, rf.resnet_stack_forward
    monkeypatch.setattr(tf, "transformer1d_forward", lambda *a, **k: (
        uniform.append(k.get("uniform_ctx", False)), stack(*a, **k))[1])
    monkeypatch.setattr(rf, "resnet_stack_forward", lambda *a, **k: (
        runs.append(1), run(*a, **k))[1])
    got = _port_denoise(port, x, sigmas, cond, 2.0)
    assert sum(uniform) == 5 and len(runs) == 4
    assert np.abs(got - want).max() <= TOL


def _jax_draws(key, num_steps, shape):
    """The draws ``models.qm_diffusion.sample`` makes from ``key``."""
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(k_samp, num_steps - 1)]
    return torch.tensor(noise), torch.from_numpy(np.stack(steps))


def test_sample_matches_jax(models):
    """The predict path's sampler (cond scale 1.0), a few steps."""
    jm, variables, port, cond = models
    key, steps = jax.random.PRNGKey(7), 4
    want = np.asarray(jqm.sample(jm, variables, jnp.asarray(cond), key,
                                 num_steps=steps, cond_scale=1.0))
    noise, step_noise = _jax_draws(key, steps, (BATCH, 64, 1))
    got = tqm.sample(port, torch.from_numpy(cond), num_steps=steps,
                     cond_scale=1.0, noise=noise, step_noise=step_noise)
    assert got.shape == (BATCH, 64, 1) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("resnet_kernel", [False, True])
def test_loss_and_grads_match_jax(models, resnet_kernel):
    """The training loss and every parameter's gradient with JAX's draws,
    through the module composition and through the resnet-run kernel's
    autograd function."""
    jm, variables, _, cond = models
    rng = np.random.default_rng(2)
    target = rng.uniform(-1, 1, (BATCH, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jnp.asarray(cond),
                           jnp.asarray(target), key)))(variables["params"])
    ks, kn = jax.random.split(key)
    sigmas = np.array(jdist.LogNormalDistribution(-1.2, 1.2)(ks, BATCH))
    noise = np.array(jax.random.normal(kn, target.shape, jnp.float32))

    port = tqm.QMDiffusionForward(**NARROW)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    rf.enable_resnet_fusion(resnet_kernel)
    try:
        got = port(torch.from_numpy(cond), torch.from_numpy(target),
                   sigmas=torch.from_numpy(sigmas),
                   noise=torch.from_numpy(noise))
        got.backward()
    finally:
        rf.enable_resnet_fusion(False)
    assert abs(got.item() - float(loss)) <= TOL
    want = state_dict_from_jax_params(grads)
    for name, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
