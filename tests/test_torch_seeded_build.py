"""One initialisation of a seeded model, not two (``nn/primitives.py::
seeded_build``): each factory that seeds the model it builds gives the
weights it gave when every primitive first drew its default init from
torch's global RNG and the seeding then overwrote it, bit for bit, and no
longer draws from the global RNG."""
import contextlib

import pytest
import torch

from moleculediffusiontransformer_tpu_torch.models import audio, graph
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as qm
from moleculediffusiontransformer_tpu_torch.nn import primitives
from moleculediffusiontransformer_tpu_torch.train import recipes


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twice(*_):
    """``seeded_build`` as it was before: the default draw kept."""
    return contextlib.nullcontext()


def _graph():
    return graph.build_graph_model(
        graph.AnalogDiffusionFull, device="cpu",
        generator=torch.Generator().manual_seed(3), max_length=16,
        channels=16, pred_dim=3 + 16, text_embed_dim=16,
        embed_dim_position=8, context_embedding_max_length=12,
        multipliers=(1, 2), factors=(2,), num_blocks=(1,), attentions=(1,),
        attention_heads=2, attention_features=8, patch_size=1,
        max_neighbors=4)


BUILDS = {
    "qm_tiny_inverse": lambda: recipes.build_model(
        "inverse_diffusion", 22, "tiny", device="cpu", seed=2),
    "qm_tiny_forward": lambda: recipes.build_model(
        "forward_diffusion", None, "tiny", device="cpu", seed=2),
    "qm_18M_from_config": lambda: recipes.build_model(
        "forward_diffusion", None, "notebook", device="cpu", seed=2),
    "model1d": lambda: audio.build_model1d(
        device="cpu", generator=torch.Generator().manual_seed(4),
        in_channels=1, channels=32, patch_size=2, multipliers=(1, 2),
        factors=(2,), num_blocks=(1,), attentions=(0, 1),
        attention_heads=2, attention_features=8, attention_multiplier=2,
        resnet_groups=4),
    "graph_full": _graph,
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_seeded_factories_initialise_once(monkeypatch, name):
    torch.manual_seed(0)
    state = torch.get_rng_state()
    once = BUILDS[name]().state_dict()
    assert torch.equal(torch.get_rng_state(), state)    # no default draw
    for module in (primitives, qm, audio, graph):
        monkeypatch.setattr(module, "seeded_build", _twice)
    twice = BUILDS[name]().state_dict()
    assert not torch.equal(torch.get_rng_state(), state)
    assert list(once) == list(twice)
    for k in once:
        assert torch.equal(once[k], twice[k]), k


def test_unseeded_builds_keep_the_default_draw():
    """Without a generator the default draw stays the model's init, inside
    the block or not, and the block nests."""
    with primitives.seeded_build(None):
        torch.manual_seed(1)
        a = primitives.Dense(4, 3).weight
    torch.manual_seed(1)
    b = primitives.Dense(4, 3).weight
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    with primitives.seeded_build(g):
        with primitives.seeded_build(None):
            state = torch.get_rng_state()
            primitives.Dense(4, 3)
            assert torch.equal(torch.get_rng_state(), state)
    state = torch.get_rng_state()
    primitives.Dense(4, 3)
    assert not torch.equal(torch.get_rng_state(), state)


@pytest.mark.parametrize("task", ["inverse_diffusion", "forward_diffusion"])
def test_build_without_init_then_a_checkpoint(task):
    """``build_model(init=False)`` (the CLI's build when a checkpoint is
    loaded next) draws no weights, neither from the seed nor from torch's
    global RNG; loading a model's state dict with ``strict=True`` then
    gives that model bit for bit, every parameter and buffer."""
    kw = dict(vocab_size=22, preset="notebook", device="cpu")
    want = recipes.build_model(task, seed=5, **kw)
    state = torch.random.get_rng_state()
    bare = recipes.build_model(task, seed=0, init=False, **kw)
    assert torch.equal(torch.random.get_rng_state(), state)
    bare.load_state_dict(want.state_dict(), strict=True)
    got, ref = bare.state_dict(), want.state_dict()
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert all(torch.equal(a, b) for a, b in zip(bare.buffers(),
                                                  want.buffers()))
