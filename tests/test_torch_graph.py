"""The port's graph-analog diffusion models (``models/graph.py``) against the
JAX package on the CPU in float32, at the tiny widths of
``tests/test_audio_graph.py``: JAX's params loaded with ``strict=True``,
numpy-seeded inputs, and the sigmas and noise JAX draws from its key handed
to the port.  Bands: each loss (through the model and through
``make_diffusion_train_step``) and a 4-step ``qm_diffusion.sample`` under CFG
within 1e-4, the JAX suite's UNet band."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.models import graph as jgraph
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.models import graph
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import trainer

TOL = 1e-4
SMALL = dict(max_length=16, channels=16, text_embed_dim=16,
             embed_dim_position=8, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=8,
             patch_size=1, max_neighbors=4)
# (name, pred_dim, predict_neighbors, packed length)
CASES = [("AnalogDiffusionSparse", 3, False, 10),
         ("AnalogDiffusionSparse", 3 + 4, True, 20),
         ("AnalogDiffusionFull", 3 + 16, True, 16)]
BATCH = 3


def _params(jmodel, *args):
    """Random params of ``jmodel``'s shapes (traced, not run): a kernel
    N(0, 1 / fan-in), a norm's scale 1 + N(0, 0.01), any other vector
    N(0, 0.01), an embedding N(0, 1)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *args)["params"]
    rng = np.random.default_rng(1)

    def draw(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2 and name != "embedding":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if len(s.shape) == 1:
            return (1.0 if name == "scale" else 0.0) + 0.1 * x
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(case):
    name, pred_dim, neighbors, length = case
    kw = dict(SMALL, pred_dim=pred_dim, predict_neighbors=neighbors)
    jm = getattr(jgraph, name)(**kw)
    rng = np.random.default_rng(length)
    seq = rng.uniform(-1, 1, (BATCH, 12)).astype(np.float32)
    packed = rng.standard_normal((BATCH, length, 4 + 16)).astype(np.float32)
    key = jax.random.PRNGKey(length)
    jp = _params(jm, jnp.asarray(seq), jnp.asarray(packed), key)
    tm = graph.build_graph_model(getattr(graph, name), "cpu", **kw)
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    return jm, jp, tm.eval(), seq, packed, key


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_loss_and_train_step_match_jax(case):
    jm, jp, tm, seq, packed, key = _pair(case)
    want = float(jax.jit(lambda p, s, o, k: jm.apply({"params": p}, s, o, k))(
        jp, jnp.asarray(seq), jnp.asarray(packed), key))
    target = tm.pack_target(torch.from_numpy(packed))
    np.testing.assert_array_equal(
        target.numpy(), np.asarray(jm.pack_target(jnp.asarray(packed))))
    ks, kn = jax.random.split(key)
    sigmas = torch.tensor(np.asarray(jm.sigma_distribution(ks, BATCH)))
    noise = torch.tensor(np.asarray(jax.random.normal(kn, target.shape)))
    got = tm(torch.from_numpy(seq), torch.from_numpy(packed), sigmas=sigmas,
             noise=noise)
    assert abs(got.item() - want) <= TOL * max(1.0, abs(want))
    # the same loss as the first step of make_diffusion_train_step
    tm.train()
    opt = trainer.make_optimizer(TrainConfig(learning_rate=1e-3))
    state = trainer.TrainState.create(tm, opt)
    step = trainer.make_diffusion_train_step(tm, opt)
    loss = step(state, torch.from_numpy(seq), torch.from_numpy(packed),
                sigmas=sigmas, noise=noise)
    assert abs(loss.item() - got.item()) <= 1e-6 * max(1.0, abs(want))
    assert state.step == 1
    assert all(torch.isfinite(p).all() for p in tm.parameters())


def _jax_draws(key, num_steps, shape):
    """The draws ``models.qm_diffusion.sample`` makes from ``key``."""
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(k_samp, num_steps - 1)]
    return torch.tensor(noise), torch.from_numpy(np.stack(steps))


@pytest.mark.parametrize("case", [CASES[0], CASES[2]],
                         ids=lambda c: c[0])
def test_sample_matches_jax(case):
    jm, jp, tm, seq, _, _ = _pair(case)
    key, steps = jax.random.PRNGKey(3), 4
    want = np.asarray(jqm.sample(jm, {"params": jp}, jnp.asarray(seq), key,
                                 num_steps=steps, cond_scale=2.0))
    shape = (BATCH, SMALL["max_length"], case[1])
    noise, step_noise = _jax_draws(key, steps, shape)
    got = tqm.sample(tm, torch.from_numpy(seq), num_steps=steps,
                     cond_scale=2.0, noise=noise, step_noise=step_noise)
    assert tuple(got.shape) == want.shape == shape
    assert np.abs(got.numpy() - want).max() <= TOL


def test_sparse_pads_and_truncates_the_length():
    m = graph.AnalogDiffusionSparse(
        **dict(SMALL, pred_dim=7, predict_neighbors=True))
    for length in (5, 16, 23):
        packed = torch.randn(2, length, 4 + 16)
        target = m.pack_target(packed)
        n = min(length, 16)
        assert tuple(target.shape) == (2, 16, 7)
        assert torch.equal(target[:, :n, :3], packed[:, :n, 1:4])
        assert torch.equal(target[:, :n, 3:], packed[:, :n, 4:8])
        assert not target[:, n:].any()
    full = graph.AnalogDiffusionFull(**dict(SMALL, pred_dim=19))
    assert tuple(full.pack_target(torch.randn(2, 10, 20)).shape) == (2, 10,
                                                                     19)


@pytest.mark.parametrize("name,pred_dim", [("AnalogDiffusionSparse", 3),
                                           ("AnalogDiffusionFull", 1027)])
def test_class_defaults_are_jaxs(name, pred_dim):
    """At the class defaults (channels 128, max_length 1,024, a 1,024-wide
    conditioning of 12 scalars) the port has the JAX model's parameters,
    by key and shape, and ``build_graph_model`` defaults to the card."""
    jm = getattr(jgraph, name)(pred_dim=pred_dim)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.init, key, jnp.zeros((1, 12)),
                            jnp.zeros((1, 1024, 4 + 1024)), key)["params"]
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)).items()}
    with torch.device("meta"):
        port = graph.build_graph_model(getattr(graph, name), "meta",
                                       pred_dim=pred_dim)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            graph.build_graph_model(getattr(graph, name), pred_dim=pred_dim)


def test_plots_write_files(tmp_path):
    """``design/plots.py`` on the Agg backend: the loss curve and the bar
    chart (from a tensor too) are written as files; without RDKit
    ``draw_and_save`` reports validity as ``smiles_is_valid`` does."""
    pytest.importorskip("matplotlib")
    from moleculediffusiontransformer_tpu_torch.design import (
        HAS_RDKIT, draw_and_save, plot_loss_curve, plot_results_as_barchart,
        smiles_is_valid)
    curve = plot_loss_curve(torch.linspace(1, 0, 20),
                            str(tmp_path / "loss.png"))
    bars = plot_results_as_barchart(np.arange(3.0), torch.ones(3),
                                    ["a", "b", "c"],
                                    str(tmp_path / "bars.png"))
    for path in (curve, bars):
        assert (tmp_path / path.split("/")[-1]).stat().st_size > 0
    if not HAS_RDKIT:
        for smiles in ("CCO", "C1CC"):
            assert draw_and_save(smiles) == smiles_is_valid(smiles)
