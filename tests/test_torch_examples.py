"""The port's examples (``examples/*_torch.py``) on the CPU against the JAX
package's (``examples/*.py``).

Each example runs end to end in this process at ``--tiny --device cpu``
and prints its ``final:`` report; the tour runs its seven families; the
serving example serves a sampler, a generator and an encoder exported
here.  Architecture: each example's notebook-size model has the JAX
docstring's parameter count (built on the meta device), and its tiny model
the state-dict keys and shapes that ``nn/jax_import.py`` maps the JAX
example's tiny model to (traced with ``jax.eval_shape``).  The Quickstart
flow against JAX: one train step (the loss, and every updated parameter
whose clipped grad reaches Adam's eps, within 1e-5), an 8-step CFG sample
(within 1e-4) and the decoded SMILES (equal), on JAX's init params and
JAX's draws.  The forward example's padded track
against the JAX example's ``pad_props``; the inverse example resuming from
the quality tool's checkpoint, and its ``best.pt`` served."""
import ast
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import (
    TrainConfig as JaxTrainConfig, forward_transformer_qm9)
from moleculediffusiontransformer_tpu.data import qm9 as jqm9
from moleculediffusiontransformer_tpu.design import \
    decode_one_hot as jax_decode_one_hot
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.models import transformers as jtf
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
    latest_checkpoint, load_checkpoint)
from moleculediffusiontransformer_tpu_torch.data.qm9 import (prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.design import \
    decode_one_hot
from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import recipes, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
CPU = torch.device("cpu")
SMOKE = ["--tiny", "--epochs", "1", "--rows", "64", "--batch-size", "32",
         "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models: torch's thread pool costs more than it gives, and under
    the suite's six workers its threads starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    return importlib.import_module(name + "_torch")


# ------------------------------------------------------------ end to end --

@pytest.mark.parametrize("name,needle", [
    ("inverse_diffusion", "validity_fraction"),
    ("forward_diffusion", "r2"),
    ("inverse_transformer", "validity_fraction"),
    ("forward_transformer", "r2"),
])
def test_example_runs_end_to_end(name, needle, capsys):
    """``tests/test_examples.py``'s smoke run of each task example, in this
    process: it trains, evaluates and prints its ``final:`` report with the
    task's metric."""
    final = _example(name).main(SMOKE)
    out = capsys.readouterr().out
    assert "final:" in out and needle in out, out[-2000:]
    assert np.isfinite(final[needle]) and final["step"] == 1


def test_simple_models_tour_runs_every_family():
    """Every family constructed, differentiated (loss and grads finite)
    and sampled at the JAX demos' shapes."""
    records = _example("simple_models").main(["--device", "cpu"])
    shapes = {name: None if r["out"] is None else tuple(r["out"].shape)
              for name, r in records.items()}
    assert shapes == {
        "demo_qm_diffusion": (4, 16, 16),
        "demo_continuous_transformer": (4, 16, 32),
        "demo_sequence_transformer": (4, 17),
        "demo_encoder": (4, 1, 12),
        "demo_gpt": (4, 16),
        "demo_audio_model1d": (2, 64, 2),
        "demo_graph_analog": None}
    assert all(np.isfinite(r["loss"]) for r in records.values())
    assert all(torch.isfinite(r["out"].float()).all()
               for r in records.values() if r["out"] is not None)


def _export(tmp_path, kind, vocab, **kw):
    task = {"sampler": "inverse_diffusion",
            "inpainter": "inverse_diffusion",
            "generator": "inverse_transformer",
            "encoder": "forward_transformer"}[kind]
    model = recipes.build_model(task, vocab, "tiny", device=CPU).eval()
    export = {"sampler": dx.export_sampler, "inpainter": dx.export_inpainter,
              "generator": dx.export_generator,
              "encoder": dx.export_encoder}[kind]
    path = str(tmp_path / f"{kind}.pt2")
    dx.save_artifact(export(model, device=CPU, **kw), path)
    return path


@pytest.mark.parametrize("kind,vocab,kw", [
    ("sampler", 10, dict(batch=4, num_steps=3, cond_scale=2.0)),
    ("generator", 12, dict(batch=4, tokens_to_generate=6)),
    ("encoder", 12, dict(batch=4, max_length=64)),
])
def test_serve_artifact_serves_each_kind(tmp_path, kind, vocab, kw):
    """A sampler, a generator and an encoder exported on the CPU, each
    served with placeholder weights from a synthetic corpus of matching
    vocabulary: decoded SMILES (of the padded rows too) or properties in
    physical units."""
    path = _export(tmp_path, kind, vocab, **kw)
    report = _example("serve_artifact").main(
        [path, "--rows", "64", "--device", "cpu"])
    assert report["server"].kind == kind
    if kind == "encoder":
        assert report["properties"].shape == (4, 12)
        assert np.isfinite(report["properties"]).all()
    else:
        assert len(report["smiles"]) == 4
        assert 0.0 <= report["validity_fraction"] <= 1.0


def test_serve_artifact_refuses_the_inpainter(tmp_path):
    path = _export(tmp_path, "inpainter", 10, batch=2, num_steps=2)
    with pytest.raises(SystemExit, match="inpainter artifacts need "
                                         "source/mask inputs"):
        _example("serve_artifact").main([path, "--device", "cpu"])


# ---------------------------------------------------------- architecture --

@pytest.mark.parametrize("name,args,want", [
    ("inverse_diffusion", (22, False), 90_965_554),
    ("forward_diffusion", (False,), 18_322_684),
    ("inverse_transformer", (24, False), 2_407_712),
    ("forward_transformer", (24, False), 3_162_496),
])
def test_notebook_size_parameter_count(name, args, want):
    """The JAX example's docstring count of each notebook-size model."""
    with torch.device("meta"):
        model = _example(name).build_model(*args, "meta")
    assert sum(p.numel() for p in model.parameters()) == want


def _jax_tiny(name, vocab):
    """The JAX example's tiny model and its init arguments, with the
    kwargs of ``examples/{name}.py``."""
    key = jax.random.PRNGKey(0)
    # examples/inverse_diffusion.py:29-35
    if name == "inverse_diffusion":
        model = jqm.QMDiffusion(
            max_length=32, channels=32, pred_dim=vocab, text_embed_dim=32,
            embed_dim_position=16, context_embedding_max_length=12,
            multipliers=(1, 2), factors=(4,), num_blocks=(2,),
            attentions=(1,), attention_heads=4, attention_features=32,
            pre_transformer=1, patch_size=1)
        return model, (key, jnp.zeros((2, 12)), jnp.zeros((2, 32, vocab)),
                       key), {}
    # examples/forward_diffusion.py:29-36
    if name == "forward_diffusion":
        model = jqm.QMDiffusionForward(
            max_length=64, channels=32, pred_dim=1, text_embed_dim=32,
            embed_dim_position=16, context_embedding_max_length=64,
            multipliers=(1, 2), factors=(4,), num_blocks=(2,),
            attentions=(1,), attention_heads=4, attention_features=32,
            patch_size=4)
        return model, (key, jnp.zeros((2, 64)), jnp.zeros((2, 64, 1)),
                       key), {}
    ids = jnp.zeros((2, 64), jnp.int32)
    # examples/inverse_transformer.py:32-35
    if name == "inverse_transformer":
        model = jtf.MoleculeTransformerSequence(
            dim=32, depth=2, logits_dim=vocab, dim_head=16, heads=8,
            text_embed_dim=16, max_text_len=12)
        return model, ({"params": key}, jnp.zeros((2, 12)), ids), \
            {"key": key}
    # examples/forward_transformer.py:32-38
    preset = forward_transformer_qm9()
    model = jtf.MoleculeTransformerSequenceEncoder(
        dim=32, depth=2, heads=4, ff_mult=preset.ff_mult,
        logits_dim=preset.logits_dim,
        logits_dim_length=preset.logits_dim_length,
        max_length=preset.max_length, max_tokens=vocab,
        embed_dim=preset.embed_dim)
    return model, (key, ids), {}


@pytest.mark.parametrize("name,vocab", [
    ("inverse_diffusion", 10), ("forward_diffusion", None),
    ("inverse_transformer", 12), ("forward_transformer", 12)])
def test_tiny_model_is_the_jax_examples(name, vocab):
    """The port example's ``--tiny`` model has the keys and shapes of the
    JAX example's tiny model's params, mapped by ``nn/jax_import.py``
    (traced with ``jax.eval_shape``: nothing compiles)."""
    model, args, kw = _jax_tiny(name, vocab)
    shapes = jax.eval_shape(lambda *a: model.init(*a, **kw), *args)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes["params"])
    want = {k: tuple(v.shape)
            for k, v in state_dict_from_jax_params(params).items()}
    args = (True,) if vocab is None else (vocab, True)
    port = _example(name).build_model(*args, CPU)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want


# ------------------------------------------------- the slice against JAX --

QUICKSTART = dict(max_length=16, channels=16, text_embed_dim=16,
                  embed_dim_position=8, context_embedding_max_length=12,
                  multipliers=(1, 2), factors=(2,), num_blocks=(1,),
                  attentions=(1,), attention_heads=2, attention_features=8,
                  pre_transformer=1, patch_size=1)
LR = 1e-3                     # the Quickstart's learning rate


def test_quickstart_flow_matches_jax():
    """The Quickstart's flow at its toy size: the JAX model's init params
    carried into the port, one train step of ClipAdam (1e-3, clip 0.5) on
    JAX's draws, then an 8-step CFG (2.0) sample on JAX's draws (within
    1e-4) and its decoded SMILES (equal).  The JAX side runs its plain path
    on the CPU.

    The step's loss is held within 1e-5, and so is every updated parameter
    whose clipped grad reaches Adam's eps (1e-8; at least 99% of them).
    Below eps Adam's step lr * g / (|g| + eps) follows the grad's last
    bits: there, grads of order 1e-8 before the clip are float32
    cancellation noise that differs between the two, and so may their
    steps; they are held within one learning rate."""
    data = prepare_qm9(*synthetic_qm9(512, seed=1, chemically_valid=True),
                       mode="inverse_diffusion", max_length=16)
    vocab = data.vocab_size
    X, y = data.X_train[:32], data.y_train[:32]
    jm = jqm.QMDiffusion(pred_dim=vocab, **QUICKSTART)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(key, jnp.asarray(y), jnp.asarray(X), key)
    tx = jtrainer.make_optimizer(JaxTrainConfig(learning_rate=LR))
    jstate = jtrainer.TrainState.create(variables["params"], tx)
    jstate, jloss = jtrainer.make_diffusion_train_step(jm, tx, donate=False)(
        jstate, jnp.asarray(y), jnp.asarray(X), key)

    port = tqm.QMDiffusion(pred_dim=vocab, **QUICKSTART)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    opt = trainer.make_optimizer(trainer.OptimizerConfig(learning_rate=LR))
    state = trainer.TrainState.create(port, opt)
    ks, kn = jax.random.split(jax.random.fold_in(key, 0))
    sigmas = np.array(jdist.LogNormalDistribution(-1.2, 1.2)(ks, 32))
    noise = np.array(jax.random.normal(kn, X.shape, jnp.float32))
    loss = trainer.make_diffusion_train_step(port, opt)(
        state, torch.from_numpy(y), torch.from_numpy(X),
        sigmas=torch.from_numpy(sigmas), noise=torch.from_numpy(noise))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    before = state_dict_from_jax_params(variables["params"])
    want = state_dict_from_jax_params(jstate.params)
    held = total = 0
    for name, p in port.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        # Adam's first step is lr * g / (|g| + eps) of the clipped grad g:
        # a step of at least lr / 2 means |g| >= eps, where the step is
        # the grad's sign and magnitude, not its last bits
        strict = np.abs(w - before[name].numpy()) >= LR / 2
        np.testing.assert_allclose(got[strict], w[strict], rtol=0,
                                   atol=1e-5, err_msg=name)
        assert np.abs(got - w).max() <= LR, name
        held, total = held + strict.sum(), total + strict.size
    assert held >= 0.99 * total, (held, total)

    steps, props = 8, y[:8]
    jout = np.asarray(jqm.sample(jm, {"params": jstate.params},
                                 jnp.asarray(props), key, num_steps=steps,
                                 cond_scale=2.0))
    k_noise, k_samp = jax.random.split(key)
    shape = (8, 16, vocab)
    start = torch.from_numpy(np.asarray(jax.random.normal(k_noise, shape)))
    step_noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(k, shape, jnp.float32))
        for k in jax.random.split(k_samp, steps - 1)]))
    out = tqm.sample(port.eval(), torch.from_numpy(props), num_steps=steps,
                     cond_scale=2.0, noise=start, step_noise=step_noise)
    assert np.abs(out.numpy() - jout).max() <= 1e-4
    assert decode_one_hot(out, data.tokenizer) == jax_decode_one_hot(
        jout, data.tokenizer)


# ------------------------------------------------------ the example data --

def _jax_pad_props():
    """``pad_props`` as ``examples/forward_diffusion.py`` defines it (a
    function inside its ``main``), compiled from that file's source."""
    path = os.path.join(ROOT, "examples", "forward_diffusion.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "pad_props")
    scope = {"np": np, "max_length": 64}
    exec(compile(ast.Module([node], []), path, "exec"), scope)
    return scope["pad_props"]


def test_forward_example_batches_are_the_jax_examples(monkeypatch):
    """The forward example hands ``train_diffusion`` (with ``swap_xy``) the
    batches the JAX example makes: the same ids as conditioning and the
    properties padded onto a (b, 64, 1) track by the JAX ``pad_props``."""
    example = _example("forward_diffusion")
    seen = {}

    def fake_train(model, data_iter_fn, config, **kw):
        seen.update(batches=list(data_iter_fn()), **kw)
        return None, trainer.MetricsLogger()

    monkeypatch.setattr(trainer, "train_diffusion", fake_train)
    example.main(["--tiny", "--rows", "96", "--batch-size", "16",
                  "--seed", "3", "--device", "cpu"])
    assert seen["swap_xy"] is True
    jdata = jqm9.prepare_qm9(*jqm9.synthetic_qm9(
        96, seed=3, chemically_valid=True), mode="forward_diffusion",
        max_length=64)
    pad = _jax_pad_props()
    want = [(X, pad(y)) for X, y in jqm9.batch_iterator(
        jdata.X_train, jdata.y_train, 16, rng=np.random.RandomState(3))]
    assert len(seen["batches"]) == len(want) == 5
    for (X, track), (wX, wtrack) in zip(seen["batches"], want):
        np.testing.assert_array_equal(X, wX)
        np.testing.assert_array_equal(track, wtrack)
        assert track.shape == (16, 64, 1) and track.dtype == np.float32
    y = jdata.y_train[:7]
    np.testing.assert_array_equal(example.pad_props(y), pad(y))


# ------------------------------------------------ resume across the tools --

def test_inverse_example_resumes_from_the_quality_tool(tmp_path):
    """``tools/quality_convergence_torch.py --preset tiny`` writes a step
    checkpoint and ``best.pt``; the inverse example resumes from the step
    checkpoint (its steps and epochs continue), and the serving example
    serves ``best.pt``."""
    import quality_convergence_torch as qc
    out = tmp_path / "q"
    qc.main(["--device", "cpu", "--preset", "tiny", "--rows", "300",
             "--tasks", "inverse_diffusion", "--chunk-epochs", "1",
             "--max-epochs", "1", "--timesteps", "2", "--num-generate", "2",
             "--num-rescore", "2", "--out", str(out)])
    ckpts = out / "ckpts" / "inverse_diffusion"
    first = load_checkpoint(latest_checkpoint(str(ckpts)))
    assert (first["step"], first["epoch"]) == (2, 1)   # 270 rows at 128
    final = _example("inverse_diffusion").main(
        ["--tiny", "--rows", "300", "--batch-size", "128", "--epochs", "1",
         "--checkpoint-dir", str(ckpts), "--resume", "--device", "cpu"])
    assert (final["step"], final["epoch"]) == (4, 1)
    resumed = load_checkpoint(latest_checkpoint(str(ckpts)))
    assert (resumed["step"], resumed["epoch"]) == (4, 2)

    best = str(ckpts / "best.pt")
    sampler = _export(tmp_path, "sampler", 10, batch=4, num_steps=2,
                      cond_scale=2.0)
    report = _example("serve_artifact").main(
        [sampler, "--checkpoint", best, "--rows", "300", "--device", "cpu"])
    assert report["server"].restored_from == best
    assert len(report["smiles"]) == 4
