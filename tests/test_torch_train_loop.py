"""The port's training loop (``train/trainer.py::train_diffusion``) on the
CPU: against the JAX package's ``train_diffusion`` from JAX's initial
params, on JAX's batches (the same ``batch_iterator`` order) and JAX's
per-step draws (``fold_in(PRNGKey(seed + 1), step)``, split over the A
micro-batches, then as ``loss_from_key`` splits each), at A = 1 and 2:
every logged loss within 1e-4 relative, the final params within rtol 1e-4
/ atol 1e-5 (the JAX suite's gradient band).  Then, without JAX: ``remat``
gives the same step bit for bit, the eval and checkpoint cadences, a
preflight that leaves the state untouched, the loaders yield the plain
iterator's batches, and what the port refuses (mesh, FSDP, Orbax)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from moleculediffusiontransformer_tpu.data.qm9 import \
    batch_iterator as jax_batch_iterator
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.parallel.mesh import make_mesh
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
    all_checkpoint_steps
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.data.prefetch import (
    ThreadedLoader, prefetch_to_device)
from moleculediffusiontransformer_tpu_torch.data.qm9 import (batch_iterator,
                                                             prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer

SEED, BATCH, ROWS = 5, 4, 12


@pytest.fixture(scope="module")
def data():
    d = prepare_qm9(*synthetic_qm9(ROWS + 2, seed=4, chemically_valid=True),
                    mode="inverse_diffusion")
    assert len(d.X_train) >= ROWS
    return d


def _small(vocab):
    return dict(max_length=32, channels=16, pred_dim=vocab, text_embed_dim=8,
                embed_dim_position=8, context_embedding_max_length=12,
                multipliers=(1, 2), factors=(2,), num_blocks=(1,),
                attentions=(0,), attention_heads=2, attention_features=8,
                pre_transformer=0)


def _epoch(data, seed, iterate=batch_iterator):
    return lambda: iterate(data.X_train[:ROWS], data.y_train[:ROWS], BATCH,
                           rng=np.random.RandomState(seed))


def _jax_draws(A, shape):
    """Step N's draws as the JAX step makes them from its data key."""
    mb = BATCH // A

    def draws(step):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), step)
        keys = [key] if A == 1 else list(jax.random.split(key, A))
        sigmas, noise = [], []
        for k in keys:
            ks, kn = jax.random.split(k)
            sigmas.append(np.asarray(
                jdist.LogNormalDistribution(-1.2, 1.2)(ks, mb)))
            noise.append(np.asarray(
                jax.random.normal(kn, (mb,) + shape, jnp.float32)))
        return (torch.from_numpy(np.concatenate(sigmas)),
                torch.from_numpy(np.concatenate(noise)))

    return draws


@pytest.mark.parametrize("accumulation", [1, 2])
def test_train_diffusion_matches_jax(data, accumulation):
    A = accumulation
    small = _small(data.vocab_size)
    fields = dict(learning_rate=2e-4, batch_size=BATCH, epochs=2,
                  print_loss_every=1, seed=SEED, accumulation_steps=A,
                  prefetch=0, preflight_memory_check=False)
    jm = jqm.QMDiffusion(**small)
    j_state, j_log = jtrainer.train_diffusion(
        jm, _epoch(data, SEED, jax_batch_iterator), JaxTrainConfig(**fields),
        init_conditioning=data.y_train[:2], init_target=data.X_train[:2],
        mesh=make_mesh(1, backend="cpu"))
    rng = jax.random.PRNGKey(SEED)     # JAX's train_diffusion init
    init = jm.init(rng, jnp.asarray(data.y_train[:2]),
                   jnp.asarray(data.X_train[:2]), rng)["params"]

    port = tqm.QMDiffusion(**small)
    port.load_state_dict(state_dict_from_jax_params(init), strict=True)
    shape = (small["max_length"], small["pred_dim"])
    state, log = trainer.train_diffusion(
        port, _epoch(data, SEED), TrainConfig(**fields),
        draws=_jax_draws(A, shape))

    want = [(r["step"], r["epoch"], r["loss"]) for r in j_log.history]
    got = [(r["step"], r["epoch"], r["loss"]) for r in log.history]
    assert len(got) == len(want) == 2 * ROWS // BATCH
    for (gs, ge, gl), (ws, we, wl) in zip(got, want):
        assert (gs, ge) == (ws, we)
        assert abs(gl - wl) <= 1e-4 * abs(wl), (gs, gl, wl)
    assert state.step == int(j_state.step) == len(want)
    final = state_dict_from_jax_params(jax.device_get(j_state.params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _tiny(vocab, seed=0):
    model = tqm.QMDiffusion(**_small(vocab))
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def test_remat_gives_the_same_step(data):
    cond = torch.from_numpy(data.y_train[:BATCH])
    target = torch.from_numpy(data.X_train[:BATCH])
    results = []
    for remat in (False, True):
        model = _tiny(data.vocab_size)
        opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
        state = trainer.TrainState.create(model, opt)
        step = trainer.make_diffusion_train_step(model, opt, 2, remat=remat)
        losses = [step(state, cond, target,
                       trainer.step_generator(0, i, "cpu")).item()
                  for i in range(2)]
        results.append((losses, [p.detach().clone()
                                 for p in model.parameters()]))
    (loss_a, params_a), (loss_b, params_b) = results
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_eval_and_checkpoint_cadence(tmp_path, data):
    """``eval_every_steps`` evals and saves inside the epoch (reference
    `generative.py:1139-1172`), ``eval_fn`` runs after every epoch, and
    ``checkpoint_every_epochs`` saves every Nth epoch and after the last;
    the loop runs with cuDNN's deterministic algorithms and restores the
    flag after."""
    model = _tiny(data.vocab_size)
    evals = []

    def eval_fn(state):
        evals.append(state.step)
        assert torch.backends.cudnn.deterministic      # inside the loop
        return {"eval_loss": 0.0}

    config = TrainConfig(learning_rate=1e-3, batch_size=BATCH, epochs=1,
                         print_loss_every=100, eval_every_steps=2,
                         prefetch=0, preflight_memory_check=False)
    _, log = trainer.train_diffusion(model, _epoch(data, 0), config,
                                     eval_fn=eval_fn,
                                     checkpoint_dir=str(tmp_path / "a"))
    # 3 steps an epoch, cadence 2: in-epoch eval + save at step 2, then
    # the end-of-epoch eval and save at step 3
    assert evals == [2, 3]
    assert [r["step"] for r in log.history if r.get("in_epoch")] == [2]
    assert not any("loss" in r for r in log.history)   # print_loss_every
    assert sorted(all_checkpoint_steps(str(tmp_path / "a"))) == [2, 3]

    config = dataclasses.replace(config, epochs=3, eval_every_steps=None,
                                 checkpoint_every_epochs=2)
    evals.clear()
    trainer.train_diffusion(model, _epoch(data, 0), config, eval_fn=eval_fn,
                            checkpoint_dir=str(tmp_path / "b"))
    assert evals == [3, 6, 9]                          # after every epoch
    assert not torch.backends.cudnn.deterministic      # restored
    # every second epoch (step 6) and the last (step 9)
    assert sorted(all_checkpoint_steps(str(tmp_path / "b"))) == [6, 9]


def test_preflight_leaves_the_state_untouched(data):
    model = _tiny(data.vocab_size)
    opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
    state = trainer.TrainState.create(model, opt)
    cond = torch.from_numpy(data.y_train[:BATCH])
    target = torch.from_numpy(data.X_train[:BATCH])
    gen = torch.Generator().manual_seed(1)
    trainer.make_diffusion_train_step(model, opt, 2)(state, cond, target,
                                                     gen)
    before = ([p.detach().clone() for p in model.parameters()],
              [p.grad.clone() for p in model.parameters()],
              [t.clone() for t in state.opt_state.mu + state.opt_state.nu],
              state.opt_state.count, state.step, gen.get_state())
    info = trainer.preflight_memory_check(model, state, cond, target, 2)
    assert info == {"ok": True}         # the CPU only reports
    after = ([p.detach() for p in model.parameters()],
             [p.grad for p in model.parameters()],
             state.opt_state.mu + state.opt_state.nu,
             state.opt_state.count, state.step, gen.get_state())
    for a, b in zip(before[:3], after[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert before[3:5] == after[3:5]
    assert torch.equal(before[5], after[5])


def test_loaders_yield_the_plain_batches(data):
    plain = list(_epoch(data, 7)())
    loader = ThreadedLoader(_epoch(data, 7), queue_depth=1)
    for _ in range(2):                        # a fresh worker each epoch
        threaded = list(loader.epoch())
        assert len(threaded) == len(plain)
        for (x, y), (a, b) in zip(threaded, plain):
            np.testing.assert_array_equal(x, a)
            np.testing.assert_array_equal(y, b)
    assert loader._thread is None
    for size in (1, 2, 5):
        moved = list(prefetch_to_device(_epoch(data, 7)(), "cpu", size=size))
        assert len(moved) == len(plain)
        for (x, y), (a, b) in zip(moved, plain):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), a)
            np.testing.assert_array_equal(y.numpy(), b)


@pytest.mark.parametrize("change, match", [
    ({"param_sharding": "fsdp"}, "process group"),
    ({"checkpoint_backend": "orbax"}, "Orbax is JAX-only"),
    ({"param_sharding": "zero3"}, "unknown param_sharding")])
def test_refuses_mesh_fsdp_and_orbax(data, change, match):
    """What the loop still refuses: FSDP with no process group (no mesh to
    shard over), the JAX-only Orbax tier, a sharding it does not know.
    Training over a mesh is ``tests/test_torch_parallel.py``'s."""
    config = dataclasses.replace(TrainConfig(), **change)
    with pytest.raises(ValueError, match=match):
        trainer.train_diffusion(_tiny(data.vocab_size), _epoch(data, 0),
                                config)


def test_profiling_hooks(tmp_path):
    """``train/profiling.py``: a Chrome trace written, anomaly mode that
    raises on a NaN backward (and is left off after), the finite check,
    the step timer."""
    from moleculediffusiontransformer_tpu_torch.train import profiling
    x = torch.ones(3, requires_grad=True)
    with profiling.trace(str(tmp_path / "trace")):
        (x * 2).sum().backward()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with pytest.raises(RuntimeError, match="nan"), \
            pytest.warns(UserWarning, match="SqrtBackward0"):
        with profiling.debug_nans():
            torch.sqrt(torch.tensor([-1.0], requires_grad=True)).backward()
    assert not torch.is_anomaly_enabled()
    assert profiling.check_finite(torch.tensor(2.0)).item() == 2.0
    with pytest.raises(FloatingPointError):
        profiling.check_finite(torch.tensor(float("nan")))
    timer = profiling.StepTimer()
    timer.update(4, n_steps=2)
    assert (timer.steps, timer.samples) == (2, 8)
    assert timer.samples_per_sec > 0
    assert profiling.StepTimer.sync(torch.ones(3)) == 3.0


def _list_update(opt, params, grads, state):
    """``ClipAdam.update`` as it was written before its moments were
    updated in place: every moment, denominator and update a new list."""
    B1, B2, EPS = trainer.B1, trainer.B2, trainer.EPS
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    if not bool(norm < opt.max_norm):
        grads = [(g / norm) * opt.max_norm for g in grads]
    step_size = -opt.lr(state.count)
    count = state.count + 1
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
    mu = torch._foreach_mul(grads, 1 - B1)
    torch._foreach_add_(mu, torch._foreach_mul(state.mu, B1))
    nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2)
    torch._foreach_add_(nu, torch._foreach_mul(state.nu, B2))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_mul_(updates, step_size)
    torch._foreach_add_(params, updates)
    state.mu, state.nu, state.count = mu, nu, count


@pytest.mark.parametrize("chunk", [7, 2 ** 24])
def test_in_place_update_is_bitwise_the_list_update(monkeypatch, chunk):
    """Three steps of ``ClipAdam.update`` (moments in place, in chunks of
    ``chunk`` elements) against the same steps written with new lists, on
    the same params and grads: the params and both moments equal bit for
    bit, the grads left as they were, the clip taken in steps 1 and 3 and
    not in step 2; ``scratch_bytes`` is three copies of the largest
    chunk."""
    monkeypatch.setattr(trainer, "UPDATE_CHUNK", chunk)
    gen = torch.Generator().manual_seed(11)
    shapes = [(3, 4), (5,), (2, 3, 2), (1,), (6, 2)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    opt = trainer.ClipAdam(learning_rate=trainer.warmup_cosine_schedule(
        0.0, 1e-2, 1, 10), max_norm=1.0)
    ref_params = [p.clone() for p in params]
    state, ref_state = opt.init(params), opt.init(ref_params)
    for scale in (3.0, 0.01, 5.0):
        grads = [torch.randn(s, generator=gen) * scale for s in shapes]
        kept = [g.clone() for g in grads]
        opt.update(params, grads, state)
        _list_update(opt, ref_params, [g.clone() for g in grads], ref_state)
        for a, b in zip([*params, *state.mu, *state.nu],
                        [*ref_params, *ref_state.mu, *ref_state.nu]):
            assert torch.equal(a, b)
        assert all(torch.equal(g, k) for g, k in zip(grads, kept))
    assert state.count == ref_state.count == 3
    largest = 12 if chunk == 7 else sum(map(np.prod, shapes))
    assert trainer.ClipAdam.scratch_bytes(params) == 3 * 4 * largest
