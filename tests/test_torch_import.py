"""Loading JAX params into the PyTorch port, and the port's import hygiene.

``state_dict_from_jax_params`` must give exactly the keys, shapes and values
of the JAX package's ``params_to_state_dict`` and load into the port with
``strict=True``; the port must import neither jax nor flax (nor the JAX
package), and must import with no CUDA toolchain present."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import (
    forward_diffusion_qm9, forward_transformer_qm9, inverse_diffusion_qm9)
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.nn.torch_import import (
    _flatten, flax_path_to_torch_key, params_to_state_dict)
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import (
    state_dict_from_jax_params, torch_key)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_length=32, channels=32, pred_dim=8, text_embed_dim=16,
             embed_dim_position=16, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=16,
             pre_transformer=1)
PORT_MODULES = [
    "moleculediffusiontransformer_tpu_torch",
    "moleculediffusiontransformer_tpu_torch.nn.primitives",
    "moleculediffusiontransformer_tpu_torch.nn.embeddings",
    "moleculediffusiontransformer_tpu_torch.nn.blocks",
    "moleculediffusiontransformer_tpu_torch.nn.attention",
    "moleculediffusiontransformer_tpu_torch.nn.unet",
    "moleculediffusiontransformer_tpu_torch.nn.transformer_blocks",
    "moleculediffusiontransformer_tpu_torch.nn.moe",
    "moleculediffusiontransformer_tpu_torch.nn.jax_import",
    "moleculediffusiontransformer_tpu_torch.ops.cuda_build",
    "moleculediffusiontransformer_tpu_torch.ops.transformer_fusion",
    "moleculediffusiontransformer_tpu_torch.ops.resnet_fusion",
    "moleculediffusiontransformer_tpu_torch.ops.flash_attention",
    "moleculediffusiontransformer_tpu_torch.ops.attention",
    "moleculediffusiontransformer_tpu_torch.diffusion.schedules",
    "moleculediffusiontransformer_tpu_torch.diffusion.objectives",
    "moleculediffusiontransformer_tpu_torch.diffusion.samplers",
    "moleculediffusiontransformer_tpu_torch.diffusion.distributions",
    "moleculediffusiontransformer_tpu_torch.models.qm_diffusion",
    "moleculediffusiontransformer_tpu_torch.models.audio",
    "moleculediffusiontransformer_tpu_torch.models.transformers",
    "moleculediffusiontransformer_tpu_torch.train.trainer",
    "moleculediffusiontransformer_tpu_torch.train.eval",
    "moleculediffusiontransformer_tpu_torch.data",
    "moleculediffusiontransformer_tpu_torch.data.tokenizer",
    "moleculediffusiontransformer_tpu_torch.data.preprocess",
    "moleculediffusiontransformer_tpu_torch.data.qm9",
    "moleculediffusiontransformer_tpu_torch.design",
    "moleculediffusiontransformer_tpu_torch.design.valence",
    "moleculediffusiontransformer_tpu_torch.design.inverse_design",
    "moleculediffusiontransformer_tpu_torch.design.export",
    "moleculediffusiontransformer_tpu_torch.design.serve",
    "moleculediffusiontransformer_tpu_torch.design.http_serve",
    "moleculediffusiontransformer_tpu_torch.core",
    "moleculediffusiontransformer_tpu_torch.core.config",
    "moleculediffusiontransformer_tpu_torch.core.utils",
    "moleculediffusiontransformer_tpu_torch.core.checkpoint",
    "moleculediffusiontransformer_tpu_torch.data.prefetch",
    "moleculediffusiontransformer_tpu_torch.train.profiling",
    "moleculediffusiontransformer_tpu_torch.train.recipes",
    "moleculediffusiontransformer_tpu_torch.cli",
    "moleculediffusiontransformer_tpu_torch.__main__",
    "moleculediffusiontransformer_tpu_torch.nn",
    "moleculediffusiontransformer_tpu_torch.nn.dsp",
    "moleculediffusiontransformer_tpu_torch.nn.stft",
    "moleculediffusiontransformer_tpu_torch.nn.autoencoder",
    "moleculediffusiontransformer_tpu_torch.nn.text",
    "moleculediffusiontransformer_tpu_torch.models",
    "moleculediffusiontransformer_tpu_torch.models.graph",
    "moleculediffusiontransformer_tpu_torch.design.plots",
    "moleculediffusiontransformer_tpu_torch.parallel",
    "moleculediffusiontransformer_tpu_torch.parallel.mesh",
    "moleculediffusiontransformer_tpu_torch.parallel.multihost",
    "moleculediffusiontransformer_tpu_torch.parallel.fsdp",
    "moleculediffusiontransformer_tpu_torch.parallel.collectives",
    "moleculediffusiontransformer_tpu_torch.parallel.tp",
    "moleculediffusiontransformer_tpu_torch.parallel.sp",
    "moleculediffusiontransformer_tpu_torch.parallel.pp",
    "moleculediffusiontransformer_tpu_torch.parallel.ep",
]
# entry points outside the package, and the ranks' module of the parallel
# tests (each rank a fresh interpreter), imported by path
PORT_SCRIPTS = ["examples/audio_diffusion_torch.py",
                "tests/torch_parallel_workers.py",
                "tests/torch_parallel_axes_workers.py",
                "tools/check_torch_parallel_ab.py",
                "tools/quality_convergence_torch.py",
                "tools/eval_converged_torch.py",
                "tools/reproduce_baseline_torch.py",
                "tools/import_torch_checkpoint_torch.py",
                "tools/export_serving_artifact_torch.py",
                "tools/bench_serving_torch.py",
                "tools/check_torch_trace_reading.py"]


@pytest.fixture(scope="module")
def jax_params():
    model = jqm.QMDiffusion(**SMALL)
    key = jax.random.PRNGKey(3)
    variables = jax.jit(model.init)(key, jnp.zeros((2, 12)),
                                    jnp.zeros((2, 32, 8)), key)
    return variables["params"]


def test_keys_and_shapes_match_port(jax_params):
    sd = state_dict_from_jax_params(jax_params)
    port = tqm.QMDiffusion(**SMALL)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    port.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k])


def test_values_match_params_to_state_dict(jax_params):
    """The QM model's params, then the forward encoder's, whose fused
    attention in-projection ``in_proj_weight`` JAX stores as (d, 3d) and
    torch as (3d, d)."""
    from moleculediffusiontransformer_tpu.models.transformers import \
        MoleculeTransformerSequenceEncoder
    encoder = MoleculeTransformerSequenceEncoder(
        dim=16, depth=1, heads=2, ff_mult=2, logits_dim=1,
        logits_dim_length=12, max_length=8, max_tokens=10)
    shapes = jax.eval_shape(encoder.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    encoder_params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    assert encoder_params["layers_0_0"]["in_proj_weight"].shape == (16, 48)
    for params in (jax_params, encoder_params):
        sd = state_dict_from_jax_params(params)
        ref = params_to_state_dict(params)
        assert set(sd) == set(ref)
        for k, v in ref.items():
            assert sd[k].dtype == torch.float32
            np.testing.assert_array_equal(sd[k].numpy(), v)
    assert tuple(sd["layers.0.0.in_proj_weight"].shape) == (48, 16)


def test_torch_key_matches_jax_package(jax_params):
    for path in _flatten(jax_params):
        assert torch_key(path) == flax_path_to_torch_key(path)
    assert torch_key(("layers_0_2_1", "to_in_0", "block1")) == \
        "layers.0.2.1.to_in.0.block1"


def _meta_model(**kw):
    with torch.device("meta"):
        return kw.pop("build")(**kw)


def test_flagship_parameter_count():
    model = _meta_model(build=tqm.from_config, cls=tqm.QMDiffusion,
                        config=inverse_diffusion_qm9(22), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 90_965_554


def test_entry_points_default_to_the_card():
    """``from_config``, the ``Model1d`` factories (the "all"/vk and "ncca"
    types too), the AR transformer, the forward encoder,
    ``from_encoder_config``, both GPTs, the continuous decoder and the
    Internaldim decoder, the audio assemblies' presets (and
    ``build_model1d`` of the AR model), ``build_graph_model`` and the models
    of ``examples/audio_diffusion_torch.py`` put the model on the card
    unless the caller names a device: with no device
    argument they ask for "cuda" (which raises on a host without one), never
    the CPU.  So do the serving entry points: ``export_*`` and
    ``ArtifactServer`` export and serve on the card unless ``device``
    names another, as do the ``export``, ``export-torch``, ``inspect`` and
    ``serve`` subcommands, and the parallel layer: ``make_mesh``, the 2-D
    meshes of its other axes (``make_mesh_2d``, ``make_mesh_sp``,
    ``make_mesh_ep``, ``make_mesh_pp``) and ``distributed_init`` (NCCL,
    each rank bound to its card) unless ``device="cpu"`` asks for gloo on
    the CPU."""
    from moleculediffusiontransformer_tpu_torch.models import (audio, graph,
                                                               transformers)

    tiny = dict(in_channels=2, channels=16, patch_size=2, multipliers=(1, 2),
                factors=(2,), num_blocks=(1,), attentions=(0, 1),
                attention_heads=2, attention_features=8,
                attention_multiplier=2, resnet_groups=4)
    tiny_1 = {k: v for k, v in tiny.items() if k != "in_channels"}
    builds = [lambda **kw: tqm.from_config(
                  tqm.QMDiffusionForward, forward_diffusion_qm9(), **kw),
              lambda **kw: audio.AudioDiffusionModel(**tiny, **kw),
              lambda **kw: transformers.MoleculeTransformerSequence(
                  dim=16, depth=1, heads=2, dim_head=8, logits_dim=24,
                  text_embed_dim=16, max_text_len=12, **kw),
              lambda **kw: transformers.MoleculeTransformerSequenceEncoder(
                  dim=16, depth=1, heads=2, logits_dim=1,
                  logits_dim_length=12, max_length=8, **kw),
              lambda **kw: transformers.from_encoder_config(
                  forward_transformer_qm9(), **kw),
              lambda **kw: audio.AudioDiffusionConditional(
                  8, 6, unet_type="all", diffusion_type="vk", **tiny, **kw),
              lambda **kw: audio.AudioDiffusionModel(
                  **dict(tiny, in_channels=1), unet_type="ncca",
                  context_channels=(1,), context_features=8, **kw),
              lambda **kw: transformers.MoleculeTransformerGPT(
                  dim=16, depth=1, heads=2, dim_head=8, ff_num_experts=2,
                  **kw),
              lambda **kw: transformers.MoleculeTransformerGPTPyTorch(
                  dim=16, depth=1, heads=2, **kw),
              lambda **kw: transformers.MoleculeTransformer(
                  dim=16, depth=1, heads=2, dim_head=8, logits_dim=8,
                  text_embed_dim=16, **kw),
              lambda **kw: transformers.MoleculeTransformerSequenceInternaldim(
                  dim=16, depth=1, heads=2, dim_head=8, logits_dim=24,
                  text_embed_dim=16, **kw),
              lambda **kw: audio.AudioDiffusionUpsampler(1, **tiny_1, **kw),
              lambda **kw: audio.AudioDiffusionAE(
                  1, **tiny_1, encoder_channels=8, encoder_patch_size=2,
                  encoder_multipliers=(1, 2), encoder_factors=(2,),
                  encoder_num_blocks=(1,), encoder_out_channels=8,
                  context_channels=(0, 8), **kw),
              lambda **kw: audio.AudioDiffusionVocoder(1, **tiny_1, **kw),
              lambda **kw: audio.AudioDiffusionUpphaser(1, **tiny_1, **kw),
              lambda **kw: audio.build_model1d(
                  cls=audio.DiffusionAR1d, chunk_length=8, in_channels=1,
                  context_channels=(1,), **tiny_1, **kw),
              lambda **kw: graph.build_graph_model(
                  graph.AnalogDiffusionSparse, max_length=16, channels=16,
                  pred_dim=3, text_embed_dim=8, embed_dim_position=8,
                  multipliers=(1, 2), factors=(2,), num_blocks=(1,),
                  attention_heads=2, attention_features=8, **kw),
              lambda **kw: graph.build_graph_model(
                  graph.AnalogDiffusionFull, max_length=16, channels=16,
                  pred_dim=19, text_embed_dim=8, embed_dim_position=8,
                  multipliers=(1, 2), factors=(2,), num_blocks=(1,),
                  attention_heads=2, attention_features=8, **kw)]
    example = _example()
    builds += [lambda b=b, **kw: b(False, **kw)[0]
               for b in example.BUILDERS.values()]
    for build in builds:
        if torch.cuda.is_available():
            assert next(build().parameters()).device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
        assert next(build(device="cpu").parameters()).device.type == "cpu"

    import inspect

    from moleculediffusiontransformer_tpu_torch import cli
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    from moleculediffusiontransformer_tpu_torch.design.serve import \
        ArtifactServer
    from moleculediffusiontransformer_tpu_torch import parallel
    exports = (dx.export_sampler, dx.export_inpainter, dx.export_generator,
               dx.export_encoder)
    meshes_2d = (parallel.make_mesh_2d, parallel.make_mesh_sp,
                 parallel.make_mesh_ep, parallel.make_mesh_pp)
    for entry in (*exports, ArtifactServer, parallel.make_mesh,
                  parallel.distributed_init, *meshes_2d):
        assert inspect.signature(entry).parameters["device"].default == \
            "cuda", entry
    parser = cli.build_parser()
    for argv in (["export", "--out", "a.pt2"],
                 ["export-torch", "--checkpoint", "a.pt", "--out", "b.pt"],
                 ["inspect", "a.pt2"], ["serve", "a.pt2"]):
        assert parser.parse_args(argv).device == "cuda", argv
    if not torch.cuda.is_available():
        encoder = builds[3](device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA"):
            dx.export_encoder(encoder, batch=1, max_length=8)
        with pytest.raises(RuntimeError, match="no CUDA"):
            ArtifactServer("no-such-artifact.pt2")
        for entry in (parallel.make_mesh, parallel.distributed_init):
            with pytest.raises(RuntimeError, match="no CUDA"):
                entry()
        for entry in meshes_2d:
            with pytest.raises(RuntimeError, match="no CUDA"):
                entry(1, 1)


def _example():
    spec = importlib.util.spec_from_file_location(
        "audio_diffusion_torch",
        os.path.join(ROOT, "examples", "audio_diffusion_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _same_architecture(a, b) -> bool:
    return ({k: v.shape for k, v in a.state_dict().items()}
            == {k: v.shape for k, v in b.state_dict().items()})


def test_chip_smoke_builds_the_flagship():
    """``chip_smoke.py`` spells the 91M preset out (it may not import the
    JAX package's config); it must be the same architecture."""
    a = _meta_model(build=tqm.QMDiffusion, **_smoke().FLAGSHIP)
    b = _meta_model(build=tqm.from_config, cls=tqm.QMDiffusion,
                    config=inverse_diffusion_qm9(22), device="meta")
    assert _same_architecture(a, b)


def test_chip_smoke_builds_the_forward_preset():
    """The same for the 18M forward preset."""
    a = _meta_model(build=tqm.QMDiffusionForward, **_smoke().FORWARD)
    b = _meta_model(build=tqm.from_config, cls=tqm.QMDiffusionForward,
                    config=forward_diffusion_qm9(), device="meta")
    assert _same_architecture(a, b)


def test_chip_smoke_builds_the_ar_preset():
    """The same for the inverse AR transformer's preset."""
    from moleculediffusiontransformer_tpu.core.config import \
        inverse_transformer_qm9
    from moleculediffusiontransformer_tpu_torch.models import transformers
    cfg = inverse_transformer_qm9()
    a = _meta_model(build=transformers.MoleculeTransformerSequence,
                    device="meta", **_smoke().AR_PRESET)
    b = _meta_model(build=transformers.MoleculeTransformerSequence,
                    device="meta", dim=cfg.dim, depth=cfg.depth,
                    heads=cfg.heads, dim_head=cfg.dim_head,
                    logits_dim=cfg.logits_dim,
                    text_embed_dim=cfg.text_embed_dim,
                    max_text_len=cfg.max_text_len, ff_mult=cfg.ff_mult,
                    cond_drop_prob=cfg.cond_drop_prob)
    assert _same_architecture(a, b)
    assert (a.cond_drop_prob, a.max_text_len) == (b.cond_drop_prob,
                                                  b.max_text_len)
    assert sum(p.numel() for p in a.parameters()) == 2_407_712


def test_chip_smoke_builds_the_encoder_preset():
    """The same for the forward encoder's preset, against
    ``from_encoder_config(forward_transformer_qm9())``."""
    from moleculediffusiontransformer_tpu_torch.models import transformers
    a = _meta_model(build=transformers.MoleculeTransformerSequenceEncoder,
                    device="meta", **_smoke().ENCODER_PRESET)
    b = _meta_model(build=transformers.from_encoder_config,
                    config=forward_transformer_qm9(), device="meta")
    assert _same_architecture(a, b)
    assert (a.max_length, a.logits_dim_length, a.padding_token,
            a.layers[0][0].heads) == (b.max_length, b.logits_dim_length,
                                      b.padding_token, b.layers[0][0].heads)
    assert sum(p.numel() for p in a.parameters()) == 3_162_496


def test_chip_smoke_builds_the_gpt_preset():
    """Phase 29's GPT is ``MoleculeTransformerGPT`` at the JAX class's
    defaults, its MoE and GNN variants the JAX package's: equal parameter
    counts."""
    from moleculediffusiontransformer_tpu.models.transformers import \
        MoleculeTransformerGPT as JGPT
    from moleculediffusiontransformer_tpu_torch.models import transformers
    smoke = _smoke()
    ids = jnp.zeros((1, 32), jnp.int32)
    for kw in ({}, smoke.GPT_MOE, smoke.GPT_GNN):
        a = _meta_model(build=transformers.MoleculeTransformerGPT,
                        device="meta", **smoke.GPT_PRESET, **kw)
        shapes = jax.eval_shape(JGPT(**kw).init, jax.random.PRNGKey(0),
                                ids)["params"]
        assert sum(p.numel() for p in a.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_chip_smoke_builds_the_audio_all_preset():
    """Phase 28's "all"/vk model is the JAX package's
    ``AudioDiffusionConditional`` at the same arguments: the same
    parameters, by key and shape."""
    from moleculediffusiontransformer_tpu.diffusion import \
        distributions as jdist
    from moleculediffusiontransformer_tpu.models import audio as jaudio
    from moleculediffusiontransformer_tpu_torch.models import audio
    smoke = _smoke()
    a = _meta_model(build=audio.AudioDiffusionConditional, device="meta",
                    **smoke.AUDIO_ALL)
    kw = dict(smoke.AUDIO_ALL)
    kw["diffusion_sigma_distribution"] = jdist.make_distribution("vk")
    j = jaudio.AudioDiffusionConditional(**kw)
    length = 16 * 4 * 4 * 4 * 2 * 2 * 2
    shapes = jax.eval_shape(
        j.init, {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, length, kw["in_channels"])), jax.random.PRNGKey(0),
        embedding=jnp.zeros((1, kw["embedding_max_length"],
                             kw["embedding_features"])))["params"]
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == want


def test_chip_smoke_builds_the_serving_programs(tmp_path, monkeypatch):
    """Phase 30's export code (``serve_export`` over
    ``serve_artifact_args``, through the CLI) builds the sampler, inpainter,
    generator and encoder programs; here at the recipes' tiny preset on the
    CPU, with a few steps and small batches."""
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    smoke.SERVE_PRESET, smoke.NUM_STEPS, smoke.AR_TOKENS = "tiny", 2, 3
    smoke.SERVE_BATCH = smoke.SERVE_INPAINT_BATCH = 2
    smoke.SERVE_AR_BATCH = smoke.SERVE_ENCODER_BATCH = 2
    exports = smoke.serve_artifact_args(22, 24)
    want = {"sampler": "sampler", "inpainter": "inpainter",
            "generator": "generator", "encoder": "encoder"}
    for name, kind in want.items():
        task, args = exports[name]
        path = smoke.serve_export(torch.device("cpu"), str(tmp_path), name,
                                  task, *args)
        program, header = dx.load_bundle(path)
        assert (header["kind"], header["device"], header["task"]) == (
            kind, "cpu", task)
        assert header["inputs"][0]["shape"][0] == 2
        ops = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
        assert ("mdt_torch.t1d_forward.default" in ops) == (
            kind in ("sampler", "inpainter"))
    assert exports["sampler_fp32"][1][-2:] == ("--dtype", "float32")


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    """Every port module, every name the port's ``nn`` exports (imported on
    first use) and the port's example scripts import none of jax, flax or
    the JAX package."""
    code = ("import sys, importlib.util\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "import moleculediffusiontransformer_tpu_torch.nn as n\n"
              "[getattr(n, name) for name in n.__all__]\n"
            + "".join(
                f"spec = importlib.util.spec_from_file_location('s{i}', "
                f"{os.path.join(ROOT, path)!r})\n"
                f"spec.loader.exec_module("
                f"importlib.util.module_from_spec(spec))\n"
                for i, path in enumerate(PORT_SCRIPTS))
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msgpack', "
              "'moleculediffusiontransformer_tpu'))\n"
              "print(bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_port_imports_without_cuda_toolchain(tmp_path):
    """No nvcc, no CUDA, no triton: importing builds and loads nothing."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    code = ("import sys, moleculediffusiontransformer_tpu_torch.ops."
            "transformer_fusion as tf, moleculediffusiontransformer_tpu_torch."
            "models.qm_diffusion, moleculediffusiontransformer_tpu_torch."
            "models.audio, moleculediffusiontransformer_tpu_torch.models."
            "transformers\n"
            "from moleculediffusiontransformer_tpu_torch.ops import "
            "cuda_build, resnet_fusion as rf, flash_attention as fa\n"
            "from moleculediffusiontransformer_tpu_torch.ops.attention import "
            "_LIB as attention_lib\n"
            "assert tf._LIB is None and rf._LIB is None and fa._LIB is None\n"
            "assert fa._BWD_LIB is None\n"
            "assert attention_lib is None\n"
            "assert not cuda_build._LOADED\n"
            "assert 'triton' not in sys.modules\n"
            "print(cuda_build.library_path(tf.SOURCE).name)\n")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("libtransformer1d_fwd_")


def test_chip_smoke_runs_the_assemblies_phase(monkeypatch):
    """Phase 31's code (``audio_assemblies``) on the CPU, with its seven
    models at tiny widths in float32: every step, request, K1 comparison and
    card-against-CPU pair runs, and each launch count is held against the
    expected one (on the CPU no kernel launches, so the held counts are
    recorded rather than compared)."""
    from moleculediffusiontransformer_tpu_torch.models import audio, graph
    smoke = _smoke()
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    held = []
    monkeypatch.setattr(smoke, "check_launches",
                        lambda what, got, want: held.append((what, want)))
    smoke.ASM_SAMPLES, smoke.ASM_BATCH, smoke.ASM_AR_CHUNK = 256, 2, 64
    smoke.GRAPH_BATCH, smoke.GRAPH_LENGTH = 2, 16
    tiny = dict(channels=16, patch_size=2, multipliers=(1, 2), factors=(2,),
                num_blocks=(1,), attentions=(0, 1), attention_heads=2,
                attention_features=8, attention_multiplier=2,
                resnet_groups=4, dtype=torch.float32)
    g = dict(max_length=16, channels=16, text_embed_dim=8,
             embed_dim_position=8, multipliers=(1, 2), factors=(2,),
             num_blocks=(1,), attention_heads=2, attention_features=8,
             dtype=torch.float32)

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    def build(cls, seed, **kw):
        kw = {"in_channels": 1, **kw}
        return lambda dev, dtype: audio.build_model1d(dev, seeded(seed), cls,
                                                      **tiny, **kw)

    cases = {
        "upsampler": (build(audio.DiffusionUpsampler1d, 1, factor=(2,),
                            context_channels=(1,)), "upsampler"),
        "autoencoder": (build(
            audio.DiffusionAE1d, 2, encoder_channels=8, encoder_patch_size=2,
            encoder_multipliers=(1, 2), encoder_factors=(2,),
            encoder_num_blocks=(1,), encoder_out_channels=8,
            context_channels=(0, 8)), "autoencoder"),
        "vocoder": (build(audio.DiffusionVocoder1d, 3, in_channels=16,
                          context_channels=(16,), stft_num_fft=31,
                          stft_hop_length=8), "vocoder"),
        "upphaser": (build(audio.DiffusionUpphaser1d, 4, factor=(1,),
                           context_channels=(1,), stft_num_fft=15,
                           stft_hop_length=4), "upphaser"),
        "ar": (build(audio.DiffusionAR1d, 5, chunk_length=64,
                     context_channels=(1,)), "ar"),
        "graph_sparse": (lambda dev, dtype: graph.build_graph_model(
            graph.AnalogDiffusionSparse, dev, seeded(6), pred_dim=3, **g),
            "graph"),
        "graph_full": (lambda dev, dtype: graph.build_graph_model(
            graph.AnalogDiffusionFull, dev, seeded(7), pred_dim=19, **g),
            "graph")}
    monkeypatch.setattr(smoke, "assembly_cases", lambda: cases)
    served, trained = smoke.audio_assemblies(torch.device("cpu"))
    assert len(held) == 3 * len(cases)
    want = {what: w for what, w in held}
    # one stack a tiny waveform UNet, three a graph one; 3 steps each;
    # the AR request samples 4 chunks of 7 evaluations
    assert want["upsampler training"]["STASH_LAUNCHES"] == 3
    assert want["graph_full training"]["LAYER_BWD_LAUNCHES"] == 9
    assert want["ar request"]["LAUNCHES"] == 4 * (smoke.ASM_STEPS - 1)
    assert want["graph_sparse request"]["LAUNCHES"] == \
        3 * 2 * (smoke.ASM_STEPS - 1)
    assert want["vocoder fp32"]["LAUNCHES"] == 2
    assert not any(served.values()) and not any(trained.values())


def test_chip_smoke_runs_the_parallel_phase(monkeypatch, tmp_path):
    """Phase 32's code (``parallel_layer``) on the CPU through gloo at tiny
    widths in float32: two spawned ranks train, are held across ranks and
    against one process, serve live and from the mesh artifact; the CLI
    runs under ``torchrun`` against an in-process run of the same
    arguments; FSDP runs over a group of one.  On the CPU no kernel
    launches, so the held counts are recorded rather than compared."""
    import sys as _sys
    smoke = _smoke()
    # a spawned rank unpickles its function by module name
    monkeypatch.setitem(_sys.modules, "chip_smoke", smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    held = []
    monkeypatch.setattr(smoke, "check_launches",
                        lambda what, got, want: held.append((what, want)))
    monkeypatch.setattr(smoke, "FLAGSHIP", dict(
        SMALL, pred_dim=22, context_embedding_max_length=12))
    for name, value in (("DP_BATCH", 8), ("PARALLEL_FP32_BATCH", 4),
                        ("PARALLEL_SERVE_BATCH", 4), ("NUM_STEPS", 4),
                        ("PARALLEL_FP32_SERVE_STEPS", 3), ("FSDP_BATCH", 4),
                        ("DESIGN_SMILES", 64), ("PARALLEL_TIMEOUT", 120),
                        ("PARALLEL_DTYPE", "float32")):
        monkeypatch.setattr(smoke, name, value)
    inv, _ = smoke.design_data()
    argv = ["train", "--task", "inverse_diffusion", "--preset", "tiny",
            "--device", "cpu", "--rows", "64", "--batch-size", "16",
            "--epochs", "1", "--print-loss-every", "1", "--timesteps", "2",
            "--num-eval", "2", "--checkpoint-dir", str(tmp_path / "ref")]
    out, _, launched, _ = smoke.cli_run(argv)
    reference = {"argv": argv[:-2], "losses": out["losses"],
                 "launches": launched}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # the CLI's child runs beside it
    try:
        got = smoke.parallel_layer(torch.device("cpu"), inv, reference)
    finally:
        torch.set_num_threads(threads)
    want = dict(held)
    stacks, layers, _ = smoke.preset_stacks(smoke.FLAGSHIP)
    assert want["DP training (rank 0)"]["STASH_LAUNCHES"] == stacks * 3
    assert want["DP training (rank 1)"]["LAYER_BWD_LAUNCHES"] == layers * 3
    assert want["mesh request (rank 0)"]["LAUNCHES"] == stacks * 2 * 3
    assert want["FSDP training"]["CONV_IN_GN_BWD_LAUNCHES"] == stacks * 3
    assert want["FSDP training (rank 1)"]["STASH_LAUNCHES"] == stacks * 3
    assert "torchrun train" in want
    assert not any(got["train"].values()) and not any(got["serve"].values())
