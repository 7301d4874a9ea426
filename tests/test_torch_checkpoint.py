"""The port's checkpoints (``core/checkpoint.py``) and exact resume on the CPU:
save, restore and ``keep`` pruning; ``train_diffusion`` at the tiny inverse
preset run two epochs straight against one epoch, a resume and one more
epoch (parameters, Adam state, step, epochs and every logged loss
**bitwise** equal); the lr schedule's position across a save and restore,
as the JAX package's ``test_lr_schedule_position_survives_checkpoint_resume``
checks it.  No tolerance anywhere: the same CPU arithmetic runs on both
sides."""
import os

import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.core import checkpoint as ck
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.data.qm9 import (batch_iterator,
                                                             prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.train import recipes, trainer


@pytest.fixture(scope="module")
def data():
    return prepare_qm9(*synthetic_qm9(72, seed=2, chemically_valid=True),
                       mode="inverse_diffusion")


def _model(data, seed=0):
    return recipes.build_model("inverse_diffusion", data.vocab_size, "tiny",
                               device="cpu", seed=seed)


def _same_state(a_model, a_state, b_model, b_state):
    for (n, p), (m, q) in zip(a_model.state_dict().items(),
                              b_model.state_dict().items()):
        assert n == m and torch.equal(p, q), n
    for x, y in zip(a_state.opt_state.mu + a_state.opt_state.nu,
                    b_state.opt_state.mu + b_state.opt_state.nu):
        assert torch.equal(x, y)
    assert a_state.opt_state.count == b_state.opt_state.count
    assert (a_state.step, a_state.epoch) == (b_state.step, b_state.epoch)


def test_save_restore_keep_and_latest(tmp_path, data):
    model = _model(data)
    opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt)
    cond = torch.from_numpy(data.y_train[:4])
    target = torch.from_numpy(data.X_train[:4])
    gen = torch.Generator().manual_seed(0)
    directory = str(tmp_path / "ckpts")
    assert ck.latest_checkpoint(directory) is None
    for _ in range(5):
        step(state, cond, target, gen)
        state.epoch += 1
        path = ck.save_step_checkpoint(
            directory, ck.checkpoint_state(model, state), state.step, keep=3)
    assert sorted(ck.all_checkpoint_steps(directory)) == [3, 4, 5]
    assert ck.latest_checkpoint(directory) == path
    assert path.endswith("step_5.pt")
    assert not [f for f in os.listdir(directory) if f.endswith(".tmp")]

    # the moments are keyed by parameter name: a file whose dicts list the
    # names in another order restores the same state
    saved = torch.load(path, weights_only=True)
    for k in ("mu", "nu"):
        saved["adam"][k] = dict(reversed(list(saved["adam"][k].items())))
    shuffled = ck.save_checkpoint(str(tmp_path / "shuffled.pt"), saved)
    for source in (path, shuffled):
        fresh = _model(data, seed=1)
        fresh_state = trainer.TrainState.create(fresh, opt)
        ck.restore_checkpoint(source, fresh, fresh_state)
        _same_state(model, state, fresh, fresh_state)
        assert fresh_state.opt_state.mu[0].device.type == "cpu"

    # a model-only checkpoint loads weights and refuses to resume
    only = ck.save_checkpoint(str(tmp_path / "model.pt"),
                              ck.checkpoint_state(model))
    fresh = _model(data, seed=1)
    ck.restore_checkpoint(only, fresh)
    assert all(torch.equal(p, q) for p, q in
               zip(fresh.parameters(), model.parameters()))
    with pytest.raises(ValueError, match="no optimizer state"):
        ck.restore_checkpoint(only, fresh,
                              trainer.TrainState.create(fresh, opt))
    torch.save({"w": torch.zeros(2)}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not a checkpoint"):
        ck.restore_checkpoint(str(tmp_path / "other.pt"), fresh)


def test_resume_equals_uninterrupted_run(tmp_path, data):
    """Two epochs straight against one epoch, then ``resume`` and one more:
    the draws of step N come from (seed, N), each epoch takes the batches
    in the order of a fresh RandomState(seed), and the checkpoint carries
    the Adam state, the step and the epochs, so the two runs are equal bit
    for bit (the threaded loader and the preflight pass run in both)."""
    config = TrainConfig(learning_rate=1e-3, batch_size=16, epochs=2,
                         print_loss_every=1, seed=3)

    def batches():
        return batch_iterator(data.X_train, data.y_train, config.batch_size,
                              rng=np.random.RandomState(config.seed))

    straight = _model(data)
    s_state, s_log = trainer.train_diffusion(straight, batches, config)

    directory = str(tmp_path / "resumed")
    resumed = _model(data)
    one = TrainConfig(**{**config.__dict__, "epochs": 1})
    _, log1 = trainer.train_diffusion(resumed, batches, one,
                                      checkpoint_dir=directory)
    steps_per_epoch = len(data.X_train) // config.batch_size
    assert ck.all_checkpoint_steps(directory) == [steps_per_epoch]
    again = _model(data, seed=9)           # other weights: all restored
    r_state, log2 = trainer.train_diffusion(again, batches, one,
                                            checkpoint_dir=directory,
                                            resume=True)
    _same_state(straight, s_state, again, r_state)
    assert r_state.step == 2 * steps_per_epoch and r_state.epoch == 2

    def curve(*logs):
        return [(r["step"], r["epoch"], r["loss"]) for log in logs
                for r in log.history]

    assert curve(s_log) == curve(log1, log2)


def test_lr_schedule_position_survives_checkpoint_resume(tmp_path):
    """The cosine schedule is indexed by the optimizer state's own count,
    so save -> restore -> step gives EXACTLY the update a never-interrupted
    run gives at that step."""
    cfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine",
                      lr_warmup_steps=2, lr_decay_steps=12, lr_min_ratio=0.0)
    opt = trainer.make_optimizer(cfg)

    def run(model, state, n):
        updates = []
        for _ in range(n):
            before = model.weight.detach().clone()
            model.weight.grad = torch.full((4, 1), 0.5)
            opt.update([model.weight], [model.weight.grad], state.opt_state)
            state.step += 1
            updates.append(model.weight.detach() - before)
        return updates

    def fresh():
        model = torch.nn.Linear(1, 4, bias=False)
        with torch.no_grad():
            model.weight.fill_(1.0)
        return model, trainer.TrainState.create(model, opt)

    model, state = fresh()
    oracle = run(model, state, 6)
    model, state = fresh()
    run(model, state, 3)
    path = ck.save_step_checkpoint(str(tmp_path),
                                   ck.checkpoint_state(model, state), 3)
    model2, state2 = fresh()
    ck.restore_checkpoint(path, model2, state2)
    assert state2.opt_state.count == 3
    for i, got in enumerate(run(model2, state2, 3), start=3):
        assert torch.equal(got, oracle[i]), i
    assert not torch.equal(oracle[3], oracle[5])     # the schedule moved
