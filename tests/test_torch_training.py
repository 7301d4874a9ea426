"""The port's training path against the JAX package on the CPU in fp32: the
LogNormal sigma distribution and the K-diffusion loss on injected draws, the
``QMDiffusion`` training loss and every parameter's gradient through
``make_diffusion_train_step`` (A = 1 and A = 2) fed the JAX package's own
draws (torch cannot reproduce threefry), and the optimizer alone against
optax.

Bands: loss within 1e-4; grads rtol 1e-4 / atol 1e-5 (the JAX suite's
gradient band); the optimizer within 1e-6 over 3 steps.  The optimizer is
held alone because Adam's first step is about lr * sign(g): after a whole
train step, a grad near zero that differs in its last bits could flip a
parameter by a full learning rate."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import TrainConfig
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.diffusion import objectives as jobj
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.diffusion import distributions
from moleculediffusiontransformer_tpu_torch.diffusion import objectives
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_length=32, channels=32, pred_dim=8, text_embed_dim=16,
             embed_dim_position=16, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=16,
             pre_transformer=1)
MICRO = 2


def test_lognormal_on_injected_normals():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdist.LogNormalDistribution(-1.2, 1.2)(key, 64))
    normals = torch.from_numpy(np.array(jax.random.normal(key, (64,))))
    got = distributions.LogNormalDistribution()(64, normals=normals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    drawn = distributions.LogNormalDistribution()(
        1000, torch.Generator().manual_seed(0))
    assert drawn.shape == (1000,) and (drawn > 0).all()
    assert abs(drawn.log().mean().item() + 1.2) < 0.15


def test_vk_and_uniform_distributions_on_injected_draws():
    key = jax.random.PRNGKey(4)
    vk = jdist.VKDistribution(min_value=0.1, max_value=10.0, sigma_data=0.5)
    want = np.asarray(vk(key, 32))
    normals = torch.from_numpy(np.array(jax.random.normal(key, (32,))))
    got = distributions.VKDistribution(0.1, 10.0, 0.5)(32, normals=normals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    u = torch.rand(8)
    assert torch.equal(distributions.UniformDistribution()(8, uniforms=u), u)


def test_k_loss_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 16, 8)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    sigmas = np.array([0.05, 0.3, 1.0, 6.0], np.float32)
    w = rng.standard_normal((8, 8)).astype(np.float32) * 0.5

    def jnet(xn, t):
        return jnp.tanh(xn @ w + t[:, None, None])

    def tnet(xn, t):
        return torch.tanh(xn @ torch.from_numpy(w) + t[:, None, None])

    want = float(jobj.KDiffusion(sigma_data=0.1).loss(
        jnet, jnp.asarray(x), jnp.asarray(sigmas), jnp.asarray(noise)))
    k = objectives.KDiffusion(sigma_data=0.1)
    got = k.loss(tnet, torch.from_numpy(x), torch.from_numpy(sigmas),
                 torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want))
    np.testing.assert_allclose(
        k.loss_weight(torch.from_numpy(sigmas)).numpy(),
        np.asarray(jobj.KDiffusion(sigma_data=0.1).loss_weight(
            jnp.asarray(sigmas))), rtol=1e-6)
    drawn = k.loss_from_draws(
        tnet, torch.from_numpy(x), distributions.LogNormalDistribution(),
        sigmas=torch.from_numpy(sigmas), noise=torch.from_numpy(noise))
    assert drawn.item() == got.item()


@pytest.fixture(scope="module")
def qm():
    jm = jqm.QMDiffusion(**SMALL)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)(key, jnp.zeros((2, 12)), jnp.zeros((2, 32, 8)),
                              key)["params"]
    rng = np.random.default_rng(1)
    cond = rng.uniform(-1, 1, (2 * MICRO, 12)).astype(np.float32)
    tokens = rng.integers(0, 8, (2 * MICRO, 32))
    target = np.eye(8, dtype=np.float32)[tokens]

    @jax.jit
    def value_and_grad(p, c, t, k):
        return jax.value_and_grad(
            lambda pp: jm.apply({"params": pp}, c, t, k))(p)

    return jm, params, cond, target, value_and_grad


def _jax_draws(key, batch):
    """The draws ``Objective.loss_from_key`` makes from ``key``."""
    ks, kn = jax.random.split(key)
    sigmas = jdist.LogNormalDistribution(-1.2, 1.2)(ks, batch)
    noise = jax.random.normal(kn, (batch, 32, 8), jnp.float32)
    return np.asarray(sigmas), np.asarray(noise)


@pytest.mark.parametrize("accumulation", [1, 2])
def test_train_step_loss_and_grads_match_jax(qm, accumulation):
    """The JAX train step's keys: fold_in(key, step), then split into A
    micro-batch keys (A > 1), each split again by ``loss_from_key``."""
    _, params, cond, target, value_and_grad = qm
    A = accumulation
    batch = A * MICRO
    cond, target = cond[:batch], target[:batch]
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    keys = [key] if A == 1 else list(jax.random.split(key, A))
    losses, grads, sigmas, noise = [], [], [], []
    for i, k in enumerate(keys):
        part = slice(i * MICRO, (i + 1) * MICRO)
        loss, g = value_and_grad(params, jnp.asarray(cond[part]),
                                 jnp.asarray(target[part]), k)
        losses.append(float(loss))
        grads.append(g)
        s, n = _jax_draws(k, MICRO)
        sigmas.append(s)
        noise.append(n)
    want_loss = sum(losses) / A
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda *g: sum(g) / A, *grads))

    port = tqm.QMDiffusion(**SMALL)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(port, opt)
    step = trainer.make_diffusion_train_step(port, opt, accumulation_steps=A)
    loss = step(state, torch.from_numpy(cond), torch.from_numpy(target),
                sigmas=torch.from_numpy(np.concatenate(sigmas)),
                noise=torch.from_numpy(np.concatenate(noise)))
    assert state.step == 1 and state.opt_state.count == 1
    assert abs(loss.item() - want_loss) <= 1e-4
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_train_step_with_generator_draws(qm):
    """Without injected draws each micro-batch draws from the generator:
    the same seed gives the same step."""
    _, params, cond, target, _ = qm

    def run(seed):
        port = tqm.QMDiffusion(**SMALL)
        port.load_state_dict(state_dict_from_jax_params(params), strict=True)
        opt = trainer.make_optimizer(trainer.OptimizerConfig(
            learning_rate=1e-3))
        state = trainer.TrainState.create(port, opt)
        step = trainer.make_diffusion_train_step(port, opt, 2)
        gen = torch.Generator().manual_seed(seed)
        return [step(state, torch.from_numpy(cond), torch.from_numpy(target),
                     gen).item()]

    a, b = run(0), run(0)
    assert a == b and np.isfinite(a).all()
    with pytest.raises(ValueError, match="micro-batches"):
        port = tqm.QMDiffusion(**SMALL)
        opt = trainer.make_optimizer(trainer.OptimizerConfig())
        trainer.make_diffusion_train_step(port, opt, 3)(
            trainer.TrainState.create(port, opt), torch.from_numpy(cond),
            torch.from_numpy(target))


def _optimizer_grads():
    rng = np.random.default_rng(2)
    shapes = [(16, 8), (8,), (3, 4, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # step 1 and 3 above the clip norm 0.5, step 2 below it
    grads = []
    for scale in (1.0, 0.01, 3.0):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in g))
        grads.append([x * (scale / norm) * (0.4 if scale < 0.5 else 1.0)
                      for x in g])
    return params, grads


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax(schedule):
    config = TrainConfig(learning_rate=2e-4, grad_clip_norm=0.5,
                         lr_schedule=schedule, lr_warmup_steps=2,
                         lr_decay_steps=10, lr_min_ratio=0.1)
    tx = jtrainer.make_optimizer(config)
    if schedule == "constant":
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    params, grads = _optimizer_grads()
    want = [jnp.asarray(p) for p in params]
    opt_state = tx.init(want)
    opt = trainer.make_optimizer(config)
    got = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(got)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, want)
        want = optax.apply_updates(want, updates)
        opt.update(got, [torch.from_numpy(x) for x in g], state)
    assert state.count == 3
    for p, w in zip(got, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    moved = max(float(np.abs(np.asarray(w) - p0).max())
                for w, p0 in zip(want, params))
    assert moved > 1e-4     # the three steps really moved the parameters


def test_cosine_schedule_matches_optax():
    sched = trainer.warmup_cosine_schedule(0.0, 1e-3, 5, 40, 1e-5)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 40, 1e-5)
    for count in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        assert abs(sched(count) - float(ref(count))) <= 1e-9


def test_optimizer_config_defaults_match_train_config():
    port, jax_cfg = trainer.OptimizerConfig(), TrainConfig()
    for name in ("learning_rate", "grad_clip_norm", "lr_schedule",
                 "lr_warmup_steps", "lr_decay_steps", "lr_min_ratio"):
        assert getattr(port, name) == getattr(jax_cfg, name), name
    with pytest.raises(ValueError):
        trainer.make_optimizer(TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError):
        trainer.make_optimizer(TrainConfig(lr_schedule="step"))


def test_training_modules_import_no_jax():
    code = ("import sys\n"
            "import moleculediffusiontransformer_tpu_torch.train.trainer\n"
            "import moleculediffusiontransformer_tpu_torch.diffusion."
            "distributions\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', "
            "'moleculediffusiontransformer_tpu'))\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
