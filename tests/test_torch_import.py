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
]


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
    """``from_config``, the ``Model1d`` factories, the AR transformer, the
    forward encoder and ``from_encoder_config`` put the model on the card
    unless the caller names a device: with no device
    argument they ask for "cuda" (which raises on a host without one), never
    the CPU."""
    from moleculediffusiontransformer_tpu_torch.models import (audio,
                                                               transformers)

    tiny = dict(in_channels=2, channels=16, patch_size=2, multipliers=(1, 2),
                factors=(2,), num_blocks=(1,), attentions=(0, 1),
                attention_heads=2, attention_features=8,
                attention_multiplier=2, resnet_groups=4)
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
                  forward_transformer_qm9(), **kw)]
    for build in builds:
        if torch.cuda.is_available():
            assert next(build().parameters()).device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
        assert next(build(device="cpu").parameters()).device.type == "cpu"


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


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', "
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
