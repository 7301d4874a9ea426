"""The training loop's card-only paths: ``preflight_memory_check`` against
the card's memory (it raises above its margin and leaves the state as it
was; its estimate is at least the first step's peak and within 20% of
it), a checkpoint saved on the CPU restored onto the card, a resumed
``train_diffusion`` equal bit for bit to an uninterrupted one with the stack
kernels and cuDNN's deterministic algorithms, and ``prefetch_to_device``'s
side-stream copies equal to the host batches.  Marked ``cuda_hw``: every
test skips without a CUDA card (decided inside the fixture).  Run on the
card with ``python -m pytest tests/test_torch_train_loop_card.py -q``."""
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.core import checkpoint as ck
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.data.prefetch import \
    prefetch_to_device
from moleculediffusiontransformer_tpu_torch.data.qm9 import (batch_iterator,
                                                             prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf
from moleculediffusiontransformer_tpu_torch.train import recipes, trainer

pytestmark = pytest.mark.cuda_hw


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@pytest.fixture(scope="module")
def data():
    return prepare_qm9(*synthetic_qm9(160, seed=2, chemically_valid=True),
                       mode="inverse_diffusion")


def _model(data, device, seed=0):
    return recipes.build_model("inverse_diffusion", data.vocab_size, "tiny",
                               device=device, seed=seed)


def test_preflight_on_the_card(cuda, data):
    model = _model(data, cuda)
    opt = trainer.make_optimizer(TrainConfig())
    state = trainer.TrainState.create(model, opt)
    cond = torch.as_tensor(data.y_train[:32], device=cuda)
    target = torch.as_tensor(data.X_train[:32], device=cuda)
    before = [p.detach().clone() for p in model.parameters()]
    info = trainer.preflight_memory_check(model, state, cond, target, 2)
    assert info["ok"] and info["bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert info["estimated_bytes"] == max(
        info["peak_bytes"] + info["grad_bytes"],
        info["held_bytes"] + info["update_bytes"])
    with pytest.raises(RuntimeError, match="preflight"):
        trainer.preflight_memory_check(model, state, cond, target,
                                       margin=-1.0)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    assert all(p.grad is None for p in model.parameters())
    assert state.step == 0 and state.opt_state.count == 0


@pytest.mark.parametrize("micro", [1, 4])
def test_preflight_estimate_holds_the_first_step(cuda, data, micro):
    """The 91M inverse preset in float32 at 1 x 512 and 4 x 128: the
    preflight's estimate is at least the first step's measured peak
    (``torch.cuda.max_memory_allocated``) and within 20% of it."""
    batch = 512
    model = recipes.build_model("inverse_diffusion", data.vocab_size,
                                "notebook", device=cuda, seed=0)
    opt = trainer.make_optimizer(TrainConfig())
    state = trainer.TrainState.create(model, opt)
    gen = torch.Generator(device=cuda).manual_seed(4)
    cond = torch.rand(batch, 12, generator=gen, device=cuda) * 2 - 1
    ids = torch.randint(0, data.vocab_size, (batch, 32), generator=gen,
                        device=cuda)
    target = torch.nn.functional.one_hot(ids, data.vocab_size).float()
    info = trainer.preflight_memory_check(model, state, cond, target, micro)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.make_diffusion_train_step(model, opt, micro)(state, cond, target,
                                                         gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert peak <= info["estimated_bytes"] <= 1.2 * peak, (peak, info)


def test_restore_lands_on_the_models_device(cuda, tmp_path, data):
    cpu_model = _model(data, "cpu")
    opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
    state = trainer.TrainState.create(cpu_model, opt)
    trainer.make_diffusion_train_step(cpu_model, opt)(
        state, torch.as_tensor(data.y_train[:8]),
        torch.as_tensor(data.X_train[:8]), torch.Generator().manual_seed(0))
    path = ck.save_step_checkpoint(str(tmp_path),
                                   ck.checkpoint_state(cpu_model, state), 1)
    card_model = _model(data, cuda, seed=1)
    card_state = trainer.TrainState.create(card_model, opt)
    ck.restore_checkpoint(path, card_model, card_state)
    for p, q in zip(card_model.parameters(), cpu_model.parameters()):
        assert p.device.type == "cuda" and torch.equal(p.cpu(), q)
    for a, b in zip(card_state.opt_state.mu + card_state.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert (card_state.step, card_state.opt_state.count) == (1, 1)


def test_resume_is_bitwise_on_the_card(cuda, tmp_path, data):
    config = TrainConfig(learning_rate=1e-3, batch_size=32, epochs=2,
                         print_loss_every=1, seed=3)

    def batches():
        return batch_iterator(data.X_train, data.y_train, config.batch_size,
                              rng=np.random.RandomState(config.seed))

    tf.STASH_LAUNCHES = 0
    straight = _model(data, cuda)
    s_state, s_log = trainer.train_diffusion(straight, batches, config)
    assert tf.STASH_LAUNCHES > 0          # the stack kernels trained it
    one = TrainConfig(**{**config.__dict__, "epochs": 1})
    trainer.train_diffusion(_model(data, cuda), batches, one,
                            checkpoint_dir=str(tmp_path))
    again = _model(data, cuda, seed=9)
    r_state, r_log = trainer.train_diffusion(again, batches, one,
                                             checkpoint_dir=str(tmp_path),
                                             resume=True)
    for p, q in zip(straight.parameters(), again.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(s_state.opt_state.mu + s_state.opt_state.nu,
                    r_state.opt_state.mu + r_state.opt_state.nu):
        assert torch.equal(a, b)
    assert (s_state.step, s_state.epoch) == (r_state.step, r_state.epoch)
    half = len(s_log.history) // 2
    assert [r["loss"] for r in s_log.history[half:]] == \
        [r["loss"] for r in r_log.history]


def test_prefetch_to_the_card(cuda, data):
    def batches():
        return batch_iterator(data.X_train, data.y_train, 16,
                              rng=np.random.RandomState(5))

    plain = list(batches())
    for size in (1, 2, 4):
        moved = list(prefetch_to_device(batches(), cuda, size=size))
        assert len(moved) == len(plain)
        for (x, y), (a, b) in zip(moved, plain):
            assert x.device.type == "cuda" and y.device.type == "cuda"
            np.testing.assert_array_equal(x.cpu().numpy(), a)
            np.testing.assert_array_equal(y.cpu().numpy(), b)
