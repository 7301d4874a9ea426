"""The port's Orbax checkpoint tier (``core/checkpoint_orbax.py``, on
``torch.distributed.checkpoint``) on the CPU, at the small preset of
``tests/test_torch_train_loop.py``: the JAX package's four tests of its
tier (the async round trip with retention, a restore into another target,
``train_diffusion`` committing and resuming, a relative directory); the
tier's one-epoch-plus-resume run against JAX's on JAX's parameters and
draws (losses within 1e-4, parameters within rtol 1e-4 / atol 1e-5, as
``test_train_diffusion_matches_jax`` holds them); a save that in-place
steps overrun while it is written, restored bit for bit; an interrupted
save that no reader sees; a failed background save raised at the next
call; the two tiers' resumed runs and the straight run equal bit for bit;
which tier each task's recipe writes.  Two gloo ranks under FSDP:
``tests/test_torch_parallel.py``."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from moleculediffusiontransformer_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from moleculediffusiontransformer_tpu.data.qm9 import \
    batch_iterator as jax_batch_iterator
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.parallel.mesh import make_mesh
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.core import checkpoint_orbax
from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
    all_checkpoint_steps, latest_checkpoint, load_checkpoint)
from moleculediffusiontransformer_tpu_torch.core.checkpoint_orbax import (
    OrbaxCheckpointer, restore_train_state, shard_restore_target)
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.data.qm9 import (batch_iterator,
                                                             prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.train import recipes, trainer

from test_torch_train_loop import _small

SEED, BATCH, ROWS = 5, 4, 16          # 4 steps an epoch, as JAX's tests


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models: torch's thread pool costs more than it gives under the
    suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    d = prepare_qm9(*synthetic_qm9(ROWS + 4, seed=4, chemically_valid=True),
                    mode="inverse_diffusion")
    assert len(d.X_train) >= ROWS
    return d


def _epoch(data, seed=SEED, iterate=batch_iterator):
    return lambda: iterate(data.X_train[:ROWS], data.y_train[:ROWS], BATCH,
                           rng=np.random.RandomState(seed))


def _model(vocab, seed=0):
    model = tqm.QMDiffusion(**_small(vocab))
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _fresh(vocab, seed=1):
    """A model and a train state other than any saved one."""
    model = _model(vocab, seed)
    return model, trainer.TrainState.create(
        model, trainer.make_optimizer(TrainConfig()))


def _snapshot(model, state):
    return {"model": {k: v.clone() for k, v in model.state_dict().items()},
            "mu": [t.clone() for t in state.opt_state.mu],
            "nu": [t.clone() for t in state.opt_state.nu],
            "counts": (state.opt_state.count, state.step, state.epoch)}


def _assert_bitwise(got, want):
    assert got["counts"] == want["counts"]
    assert set(got["model"]) == set(want["model"])
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    for m in ("mu", "nu"):
        assert all(map(torch.equal, got[m], want[m])), m


def _stepper(data):
    """A model, its train state and ``step()``: one Adam step of the first
    batch with step-seeded draws."""
    model = _model(data.vocab_size)
    opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
    state = trainer.TrainState.create(model, opt)
    train_step = trainer.make_diffusion_train_step(model, opt)
    cond = torch.from_numpy(data.y_train[:BATCH])
    target = torch.from_numpy(data.X_train[:BATCH])

    def step():
        train_step(state, cond, target,
                   trainer.step_generator(0, state.step, "cpu"))

    return model, state, step


# ------------------------------------------- the JAX package's tests --

def test_async_roundtrip_keeps_the_newest(tmp_path, data):
    """Async saves commit by ``wait_until_finished``, ``keep=2`` prunes
    steps 1 and 2, and steps 4 and 3 restore bit for bit."""
    model, state, step = _stepper(data)
    saved = {}
    with OrbaxCheckpointer(str(tmp_path / "orbax"), keep=2,
                           async_save=True) as ck:
        for _ in range(4):
            step()
            saved[state.step] = _snapshot(model, state)
            assert ck.save(state.step, shard_restore_target(model, state))
        ck.wait_until_finished()
        assert ck.all_steps() == [3, 4]
        assert [r["step"] for r in ck.saves] == [1, 2, 3, 4]
        for want, asked in ((4, None), (3, 3)):
            fresh, fstate = _fresh(data.vocab_size)
            got, _ = restore_train_state(ck, fresh, fstate, asked)
            assert got == want
            _assert_bitwise(_snapshot(fresh, fstate), saved[want])


def test_restore_into_a_target(tmp_path, data):
    """A checkpoint restores into another model's and state's tensors, in
    place: the target's own storage holds the saved values."""
    model, state, step = _stepper(data)
    step()
    want = _snapshot(model, state)
    with OrbaxCheckpointer(str(tmp_path / "ck"), async_save=False) as ck:
        assert ck.save(7, shard_restore_target(model, state))
        fresh, fstate = _fresh(data.vocab_size)
        storage = [p.data_ptr() for p in fresh.parameters()]
        target = shard_restore_target(fresh, fstate, mesh=None)
        assert ck.restore(target) is target
    assert target["step"] == want["counts"][1] == 1
    assert [p.data_ptr() for p in fresh.parameters()] == storage
    for k, v in want["model"].items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert all(map(torch.equal, fstate.opt_state.mu, want["mu"]))


def test_train_diffusion_orbax_backend_resume(tmp_path, data):
    """``checkpoint_backend="orbax"``: the epoch's last step (4) has
    committed when ``train_diffusion`` returns, and a resumed run goes on
    from it to step 8."""
    config = TrainConfig(learning_rate=1e-3, batch_size=BATCH, epochs=1,
                         print_loss_every=100, checkpoint_backend="orbax",
                         prefetch=0, preflight_memory_check=False)
    directory = str(tmp_path / "orbax_ck")
    trainer.train_diffusion(_model(data.vocab_size), _epoch(data), config,
                            checkpoint_dir=directory)
    with OrbaxCheckpointer(directory) as ck:
        assert ck.latest_step() == 4
    state, _ = trainer.train_diffusion(_model(data.vocab_size),
                                       _epoch(data), config,
                                       checkpoint_dir=directory, resume=True)
    assert state.step == 8 and state.epoch == 2
    assert OrbaxCheckpointer(directory).all_steps() == [4, 8]
    assert not all_checkpoint_steps(directory)       # no single-file tier


def test_accepts_a_relative_directory(tmp_path, data, monkeypatch):
    model, state, _ = _stepper(data)
    want = _snapshot(model, state)
    monkeypatch.chdir(tmp_path)
    with OrbaxCheckpointer("rel_ckpts", async_save=False) as ck:
        assert ck.directory == os.path.join(str(tmp_path), "rel_ckpts")
        ck.save(0, shard_restore_target(model, state))
        assert ck.latest_step() == 0
        fresh, fstate = _fresh(data.vocab_size)
        restore_train_state(ck, fresh, fstate)
    _assert_bitwise(_snapshot(fresh, fstate), want)


# ------------------------------------------------------ against JAX --

def _jax_draws(shape):
    """Step N's draws as the JAX step makes them from its data key."""
    def draws(step):
        ks, kn = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(SEED + 1), step))
        return (torch.from_numpy(np.asarray(
                    jdist.LogNormalDistribution(-1.2, 1.2)(ks, BATCH))),
                torch.from_numpy(np.asarray(jax.random.normal(
                    kn, (BATCH,) + shape, jnp.float32))))

    return draws


def test_orbax_tier_matches_jax(tmp_path, data):
    """One epoch, then one more resumed from the Orbax tier, in JAX and in
    the port from the same parameters and draws: the same steps, each loss
    within 1e-4, the final parameters within the training band.  JAX's
    resumed run counts its epochs from 0 again; the port's goes on from
    the epochs completed (``TrainState.epoch``)."""
    small = _small(data.vocab_size)
    fields = dict(learning_rate=2e-4, batch_size=BATCH, epochs=1,
                  print_loss_every=1, seed=SEED, prefetch=0,
                  preflight_memory_check=False, checkpoint_backend="orbax")
    jm = jqm.QMDiffusion(**small)
    mesh = make_mesh(1, backend="cpu")
    want, j_state = [], None
    for resume in (False, True):
        j_state, j_log = jtrainer.train_diffusion(
            jm, _epoch(data, SEED, jax_batch_iterator),
            JaxTrainConfig(**fields), init_conditioning=data.y_train[:2],
            init_target=data.X_train[:2], mesh=mesh,
            checkpoint_dir=str(tmp_path / "jax"), resume=resume)
        want += [(r["step"], r["epoch"] + resume, r["loss"])
                 for r in j_log.history]
    rng = jax.random.PRNGKey(SEED)     # JAX's train_diffusion init
    init = state_dict_from_jax_params(jm.init(
        rng, jnp.asarray(data.y_train[:2]), jnp.asarray(data.X_train[:2]),
        rng)["params"])
    got = []
    draws = _jax_draws((small["max_length"], small["pred_dim"]))
    for resume in (False, True):
        port = tqm.QMDiffusion(**small)
        port.load_state_dict(init, strict=True)
        state, log = trainer.train_diffusion(
            port, _epoch(data), TrainConfig(**fields), draws=draws,
            checkpoint_dir=str(tmp_path / "port"), resume=resume)
        got += [(r["step"], r["epoch"], r["loss"]) for r in log.history]
    assert len(got) == len(want) == 2 * ROWS // BATCH
    for (gs, ge, gl), (ws, we, wl) in zip(got, want):
        assert (gs, ge) == (ws, we)
        assert abs(gl - wl) <= 1e-4 * abs(wl), (gs, gl, wl)
    assert state.step == int(j_state.step) == 8
    final = state_dict_from_jax_params(jax.device_get(j_state.params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------ async, commit, failures --

def test_async_save_is_staged_before_it_returns(tmp_path, data,
                                                monkeypatch):
    """The write is held back until two in-place steps have run (the
    moments and parameters change under it); the checkpoint is the state
    at its step, bit for bit."""
    model, state, step = _stepper(data)
    step()
    want = _snapshot(model, state)
    gate, write = threading.Event(), dcp.save

    def held_save(*args, **kwargs):
        assert gate.wait(60)
        return write(*args, **kwargs)

    monkeypatch.setattr(dcp, "save", held_save)
    with OrbaxCheckpointer(str(tmp_path / "ck"), async_save=True) as ck:
        try:
            assert ck.save(state.step, shard_restore_target(model, state))
            step()
            step()
            assert ck.latest_step() is None        # still being written
            assert not all(map(torch.equal, state.opt_state.mu, want["mu"]))
        finally:
            gate.set()
        ck.wait_until_finished()
        assert ck.latest_step() == 1
        fresh, fstate = _fresh(data.vocab_size)
        restore_train_state(ck, fresh, fstate)
    _assert_bitwise(_snapshot(fresh, fstate), want)


def _fail_commit_of(monkeypatch, step: int) -> None:
    """Make the rename that commits ``step`` raise, as a kill between the
    write and the commit would leave it."""
    rename = os.rename

    def interrupted(src, dst):
        if os.path.basename(src) == f"{step}.tmp":
            raise OSError(f"interrupted before committing step {step}")
        return rename(src, dst)

    monkeypatch.setattr(checkpoint_orbax.os, "rename", interrupted)


def test_an_interrupted_save_is_invisible(tmp_path, data, monkeypatch):
    """A save that never committed leaves ``<step>.tmp``, which neither
    ``latest_step`` nor ``restore`` sees; a later save of the step
    replaces it."""
    model, state, step = _stepper(data)
    directory = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(directory).restore(
            shard_restore_target(model, state))
    step()
    want = _snapshot(model, state)
    ck = OrbaxCheckpointer(directory, async_save=True)
    assert ck.save(1, shard_restore_target(model, state))
    step()
    _fail_commit_of(monkeypatch, 2)
    assert ck.save(2, shard_restore_target(model, state))
    with pytest.raises(OSError, match="interrupted"):
        ck.close()
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(directory, "2.tmp"))
    ck = OrbaxCheckpointer(directory, async_save=True)
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    fresh, fstate = _fresh(data.vocab_size)
    assert restore_train_state(ck, fresh, fstate)[0] == 1
    _assert_bitwise(_snapshot(fresh, fstate), want)
    with pytest.raises(FileNotFoundError):
        ck.restore(shard_restore_target(fresh, fstate), step=2)
    assert ck.save(2, shard_restore_target(model, state))
    ck.close()
    assert ck.all_steps() == [1, 2]
    assert sorted(os.listdir(directory)) == ["1", "2"]


@pytest.mark.parametrize("next_call", ["save", "wait_until_finished",
                                       "close"])
def test_a_failed_save_raises_at_the_next_call(tmp_path, data, monkeypatch,
                                               next_call):
    """The background save's exception is raised by the next call that
    waits for it, once, and nothing else is written in its place."""
    model, state, step = _stepper(data)
    step()
    _fail_commit_of(monkeypatch, 1)
    ck = OrbaxCheckpointer(str(tmp_path / "ck"), async_save=True)
    assert ck.save(1, shard_restore_target(model, state))
    call = {"save": lambda: ck.save(5, shard_restore_target(model, state)),
            "wait_until_finished": ck.wait_until_finished,
            "close": ck.close}[next_call]
    with pytest.raises(OSError, match="interrupted"):
        call()
    ck.close()
    assert ck.all_steps() == []
    assert sorted(os.listdir(tmp_path / "ck")) == ["1.tmp"]


def test_interval_and_repeated_steps(tmp_path, data):
    """A step off ``save_interval_steps``, or not past the last saved one,
    is skipped unless ``force``, as Orbax's manager does."""
    model, state, _ = _stepper(data)
    with OrbaxCheckpointer(str(tmp_path / "ck"), async_save=False,
                           save_interval_steps=2) as ck:
        target = shard_restore_target(model, state)
        assert [ck.save(s, target) for s in (1, 2, 3, 2)] == [
            False, True, False, False]
        assert ck.save(3, target, force=True)
        assert ck.save(3, target, force=True)
        assert ck.all_steps() == [2, 3]


# ---------------------------------------------------- the two tiers --

def _run(data, directory, epochs, backend, resume=False):
    model = _model(data.vocab_size)
    config = TrainConfig(learning_rate=1e-3, batch_size=BATCH, epochs=epochs,
                         print_loss_every=1, checkpoint_backend=backend,
                         prefetch=0, preflight_memory_check=False)
    state, log = trainer.train_diffusion(model, _epoch(data), config,
                                         checkpoint_dir=directory,
                                         resume=resume)
    return _snapshot(model, state), [r["loss"] for r in log.history]


def test_the_tiers_resume_alike(tmp_path, data):
    """Two epochs straight (single-file tier), and one plus one resumed on
    each tier: the three final states equal bit for bit, the losses the
    same, and each tier's last checkpoint holds the same state."""
    straight, losses = _run(data, str(tmp_path / "straight"), 2, "msgpack")
    for backend in ("msgpack", "orbax"):
        directory = str(tmp_path / backend)
        _, first = _run(data, directory, 1, backend)
        resumed, second = _run(data, directory, 1, backend, resume=True)
        _assert_bitwise(resumed, straight)
        assert first + second == losses
    ckpt = load_checkpoint(latest_checkpoint(str(tmp_path / "msgpack")))
    fresh, fstate = _fresh(data.vocab_size)
    restore_train_state(OrbaxCheckpointer(str(tmp_path / "orbax")), fresh,
                        fstate)
    assert (ckpt["adam"]["count"], ckpt["step"], ckpt["epoch"]) == (
        fstate.opt_state.count, fstate.step, fstate.epoch)
    names = [n for n, _ in fresh.named_parameters()]
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    for m in ("mu", "nu"):
        for name, t in zip(names, getattr(fstate.opt_state, m)):
            assert torch.equal(t, ckpt["adam"][m][name]), (m, name)


@pytest.mark.parametrize("task", recipes.TASKS)
def test_recipes_write_the_tasks_tier(tmp_path, task):
    """With ``checkpoint_backend="orbax"`` the diffusion tasks write the
    Orbax tier through ``train_diffusion``; the transformer tasks write
    the single-file tier, as the JAX package's do."""
    data = prepare_qm9(*synthetic_qm9(40, seed=2, chemically_valid=True),
                       mode=recipes.data_mode(task))
    model = recipes.build_model(task, data.vocab_size, "tiny", device="cpu")
    config = TrainConfig(batch_size=16, epochs=1, print_loss_every=100,
                         checkpoint_backend="orbax", prefetch=0,
                         preflight_memory_check=False)
    state, _ = recipes.train_task(task, model, data, config,
                                  checkpoint_dir=str(tmp_path))
    orbax_steps = OrbaxCheckpointer(str(tmp_path)).all_steps()
    single = all_checkpoint_steps(str(tmp_path))
    if task.endswith("diffusion"):
        assert orbax_steps == [state.step] and not single
    else:
        assert single == [state.step] and not orbax_steps

