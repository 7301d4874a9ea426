"""The port's UNet options against the JAX package on the CPU in float32,
with JAX's parameters (loaded ``strict=True``) and JAX's own draws (read
back from ``jax.random`` while the JAX module runs): relative position bias
in ``Attention`` and ``Transformer1d`` (self and cross) and the stack gate
that refuses it, ``UNetNCCA1d``, ``UNetAll1d``, the CFG dropout
``embedding_mask_proba``, a ``Model1d(unet_type="all", diffusion_type="vk")``
loss and Karras sample, and the embedding helpers.

Bands: primitives and one Transformer1d 2e-5; a whole UNet, loss or sample
1e-4 (the JAX suite's full-UNet band)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import \
    distributions as jdist
from moleculediffusiontransformer_tpu.models import audio as jaudio
from moleculediffusiontransformer_tpu.nn import attention as jattn
from moleculediffusiontransformer_tpu.nn import blocks as jblocks
from moleculediffusiontransformer_tpu.nn import embeddings as jemb
from moleculediffusiontransformer_tpu.nn import unet as junet
from moleculediffusiontransformer_tpu_torch.diffusion import distributions
from moleculediffusiontransformer_tpu_torch.models import audio
from moleculediffusiontransformer_tpu_torch.nn import attention as tattn
from moleculediffusiontransformer_tpu_torch.nn import blocks as tblocks
from moleculediffusiontransformer_tpu_torch.nn import embeddings as temb
from moleculediffusiontransformer_tpu_torch.nn import unet as tunet
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import \
    transformer_fusion as tf

PRIM_TOL, UNET_TOL = 2e-5, 1e-4
REL = dict(use_rel_pos=True, rel_pos_num_buckets=8, rel_pos_max_distance=16)
# the NCCA configuration of the JAX suite's reference parity test
NCCA = dict(in_channels=4, channels=16, multipliers=(1, 2), factors=(2,),
            num_blocks=(1,), attentions=(0,), patch_size=2, resnet_groups=8,
            context_features=8, context_channels=(4,))
# a tiny conditional UNet with a stack: attention at length 16, 2 heads
CFG = dict(in_channels=2, channels=32, multipliers=(1, 1), factors=(2,),
           num_blocks=(1,), attentions=(0, 1), patch_size=2, resnet_groups=8,
           attention_heads=2, attention_features=16, attention_multiplier=2,
           context_embedding_features=24, context_embedding_max_length=12)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return module


def _init(module, rngs, *arrays, **kwargs):
    """``module.init(...)["params"]`` under ``jax.jit``: eagerly, Flax
    compiles every op apart, several times slower.  Keyword arguments that
    are not arrays stay static."""
    traced = {k: v for k, v in kwargs.items() if _arrays(v)}
    static = {k: v for k, v in kwargs.items() if k not in traced}
    return jax.jit(lambda r, a, kw: module.init(r, *a, **kw, **static))(
        rngs, arrays, traced)["params"]


def _apply(module, params, *arrays, rngs=None, **kwargs):
    """``module.apply`` under ``jax.jit``, as ``_init``."""
    traced = {k: v for k, v in kwargs.items() if _arrays(v)}
    static = {k: v for k, v in kwargs.items() if k not in traced}
    out = jax.jit(lambda p, a, kw, r: module.apply(
        {"params": p}, *a, **kw, rngs=r, **static))(
        params, arrays, traced, rngs)
    jax.block_until_ready(out)
    jax.effects_barrier()           # every recording callback has run
    return out


def _arrays(v):
    leaves = jax.tree_util.tree_leaves(v)
    return bool(leaves) and all(isinstance(a, jax.Array) for a in leaves)


def _recording(monkeypatch, name):
    """Record every array ``jax.random.<name>`` returns while patched, also
    under ``jax.jit`` (as a debug callback when the program runs)."""
    seen = []
    original = getattr(jax.random, name)

    def record(*args, **kwargs):
        out = original(*args, **kwargs)
        jax.debug.callback(lambda v: seen.append(np.array(v)), out)
        return out

    monkeypatch.setattr(jax.random, name, record)
    return seen


# -------------------------------------------------------- embeddings etc --

def test_embedding_helpers_match_jax():
    x = jnp.asarray([0, 3, 17, 250])
    _close(temb.sinusoidal_embedding(_t(x), 10),
           jemb.sinusoidal_embedding(x, 10), PRIM_TOL)
    for args in ((5, 7, 12), (3, 4, 5), (2, 2, 1)):
        _close(temb.positional_encoding_2d(*args),
               jemb.positional_encoding_2d(*args), PRIM_TOL, str(args))
    for args in ((3, 4, 5, 12), (2, 3, 4, 7), (4, 2, 3, 18)):
        _close(temb.positional_encoding_3d(*args),
               jemb.positional_encoding_3d(*args), PRIM_TOL, str(args))
    for args in ((9, 16), (5, 7)):
        _close(temb.positional_encoding_1d(*args),
               jemb.positional_encoding_1d(*args), PRIM_TOL)


def test_number_embedder_matches_jax():
    x = _x(0, 3, 2)
    jm = jemb.NumberEmbedder(features=12, dim=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = _load(temb.NumberEmbedder(12, dim=16), params)
    got = port(_t(x))
    assert got.shape == (3, 2, 12)
    _close(got, jm.apply({"params": params}, jnp.asarray(x)), PRIM_TOL)


def test_conditioned_sequential_matches_jax():
    x, mapping = _x(1, 2, 8, 8), _x(2, 2, 16)
    jm = jblocks.ConditionedSequential(modules_list=(
        jblocks.ResnetBlock1d(8, num_groups=4, use_mapping=True),
        jblocks.ResnetBlock1d(8, num_groups=4, use_mapping=True)))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                     jnp.asarray(mapping))["params"]
    port = _load(tblocks.ConditionedSequential(
        tblocks.ResnetBlock1d(8, 8, num_groups=4,
                              context_mapping_features=16),
        tblocks.ResnetBlock1d(8, 8, num_groups=4,
                              context_mapping_features=16)), params)
    _close(port(_t(x), _t(mapping)),
           jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mapping)),
           PRIM_TOL)


# --------------------------------------------------- relative position ----

@pytest.mark.parametrize("n,m", [(8, 8), (5, 12), (1, 40)])
def test_relative_position_bias_matches_jax(n, m):
    buckets = tattn.relative_position_bucket(
        np.arange(-40, 41)[None], 8, 16)
    np.testing.assert_array_equal(
        buckets, jattn.relative_position_bucket(np.arange(-40, 41)[None], 8,
                                                16))
    jm = jattn.RelativePositionBias(8, 16, 3)
    params = jm.init(jax.random.PRNGKey(2), n, m)["params"]
    port = _load(tattn.RelativePositionBias(8, 16, 3), params)
    got = port(n, m)
    assert got.shape == (1, 3, n, m) and got.dtype == torch.float32
    _close(got, jm.apply({"params": params}, n, m), PRIM_TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_rel_pos_attention_matches_jax(cross):
    """The bias joins the float32 scores before the scale, in self- and in
    cross-attention (queries at the last positions of the keys)."""
    x = _x(3, 2, 10, 32)
    ctx = _x(4, 2, 14, 24) if cross else None
    kw = dict(context_features=24) if cross else {}
    jm = jattn.Attention(32, head_features=8, num_heads=4, **kw, **REL)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    params = jm.init(jax.random.PRNGKey(3), *args)["params"]
    port = _load(tattn.Attention(32, 8, 4, **kw, **REL), params)
    targs = (_t(x),) + ((_t(ctx),) if cross else ())
    _close(port(*targs), jm.apply({"params": params}, *args), PRIM_TOL)


@pytest.fixture(scope="module")
def rel_stack():
    x, ctx = _x(5, 2, 32, 32), _x(6, 2, 12, 24)
    jm = jattn.Transformer1d(2, 32, num_heads=2, head_features=16,
                             multiplier=2, context_features=24, **REL)
    params = _init(jm, jax.random.PRNGKey(5), jnp.asarray(x),
                   jnp.asarray(ctx))
    port = _load(tattn.Transformer1d(2, 32, 2, 16, 2, context_features=24,
                                     **REL), params)
    return jm, params, port, x, ctx


def test_rel_pos_transformer1d_matches_jax(rel_stack):
    jm, params, port, x, ctx = rel_stack
    assert ("blocks.1.cross_attention.attention.rel_pos."
            "relative_attention_bias.weight") in dict(port.named_parameters())
    _close(port(_t(x), _t(ctx)),
           _apply(jm, params, jnp.asarray(x), jnp.asarray(ctx)), PRIM_TOL)


def test_rel_pos_stack_never_reaches_the_kernel(rel_stack, monkeypatch):
    """The gate refuses a rel-pos stack (the kernel has no bias term), so
    the module runs its composition and never the stack dispatch; the same
    stack without the bias would be the kernel's."""
    _, _, port, x, ctx = rel_stack
    x, ctx = _t(x), _t(ctx)
    assert not tf.stack_kernel_takes(x, ctx, channels=32,
                                     dtype=torch.float32, head_dim=16,
                                     use_rel_pos=True)
    assert tf.stack_kernel_takes(x, ctx, channels=32, dtype=torch.float32,
                                 head_dim=16)

    def refuse(*args, **kwargs):
        raise AssertionError("a rel-pos stack reached the stack dispatch")

    monkeypatch.setattr(tf, "transformer1d", refuse)
    out = port(x, ctx)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_unet_with_rel_pos_matches_jax():
    """The UNet's attention_rel_pos_* arguments reach every stack."""
    kw = dict(CFG, attention_use_rel_pos=True,
              attention_rel_pos_num_buckets=8,
              attention_rel_pos_max_distance=16)
    x, t, emb = _x(7, 2, 32, 2), np.array([0.3, 0.8], np.float32), \
        _x(8, 2, 12, 24)
    jm = junet.XUNet1d(type="cfg", **kw)
    params = _init(jm, jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(t),
                   embedding=jnp.asarray(emb))
    port = _load(tunet.XUNet1d(type="cfg", **kw), params)
    want = _apply(jm, params, jnp.asarray(x), jnp.asarray(t),
                  embedding=jnp.asarray(emb), embedding_scale=2.0)
    _close(port(_t(x), _t(t), embedding=_t(emb), embedding_scale=2.0), want,
           UNET_TOL)


# --------------------------------------------------------------- NCCA ----

@pytest.mark.parametrize("augmentation", [True, False, (True,)])
def test_unet_ncca_matches_jax(augmentation, monkeypatch):
    """Fed JAX's own noise draws; the raw scale is embedded even where the
    augmentation gates it off."""
    x, chan = _x(9, 2, 16, 4), _x(10, 2, 16, 4)
    t = np.array([0.3, 0.8], np.float32)
    jm = junet.XUNet1d(type="ncca", **NCCA)
    params = _init(jm, {"params": jax.random.PRNGKey(9),
                        "ncca": jax.random.PRNGKey(10)}, jnp.asarray(x),
                   jnp.asarray(t), channels_list=[jnp.asarray(chan)],
                   channels_scale=0.4)
    port = _load(tunet.XUNet1d(type="ncca", **NCCA), params)
    assert isinstance(port, tunet.UNetNCCA1d)
    draws = _recording(monkeypatch, "normal")
    want = _apply(jm, params, jnp.asarray(x), jnp.asarray(t),
                  channels_list=[jnp.asarray(chan)],
                  channels_augmentation=augmentation, channels_scale=0.4,
                  rngs={"ncca": jax.random.PRNGKey(11)})
    assert len(draws) == 1 and draws[0].shape == chan.shape
    got = port(_t(x), _t(t), channels_list=[_t(chan)],
               channels_augmentation=augmentation, channels_scale=0.4,
               channels_noise=[_t(draws[0])])
    _close(got, want, UNET_TOL)
    with pytest.raises(ValueError, match="generator"):
        port(_t(x), _t(t), channels_list=[_t(chan)], channels_scale=0.4)
    a, b = (port(_t(x), _t(t), channels_list=[_t(chan)],
                 channels_augmentation=True, channels_scale=0.4,
                 generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)


# ------------------------------------------------------- CFG dropout, All --

def _cfg_pair(kind, **extra):
    kw = dict(CFG, **extra)
    x, t, emb = _x(12, 2, 32, 2), np.array([0.2, 0.9], np.float32), \
        _x(13, 2, 12, 24)
    jm = junet.XUNet1d(type=kind, **kw)
    jkw = dict(embedding=jnp.asarray(emb))
    if extra.get("context_features"):
        jkw["features"] = jnp.ones((2, extra["context_features"]))
    params = _init(jm, jax.random.PRNGKey(12), jnp.asarray(x), jnp.asarray(t),
                   **jkw)
    port = _load(tunet.XUNet1d(type=kind, **kw), params)
    return jm, params, port, x, t, emb


@pytest.mark.parametrize("kind", ["cfg", "all"])
def test_embedding_mask_proba_matches_jax(kind, monkeypatch):
    """The dropout fed JAX's own bernoulli draw as the keep mask, at
    embedding scale 1 and 3; and proba 1 equals the null table."""
    jm, params, port, x, t, emb = _cfg_pair(kind)
    masks = _recording(monkeypatch, "bernoulli")
    for scale in (1.0, 3.0):
        masks.clear()
        want = _apply(jm, params, jnp.asarray(x), jnp.asarray(t),
                      embedding=jnp.asarray(emb), embedding_scale=scale,
                      embedding_mask_proba=0.5,
                      rngs={"cfg": jax.random.PRNGKey(int(scale))})
        (mask,) = masks
        got = port(_t(x), _t(t), embedding=_t(emb), embedding_scale=scale,
                   embedding_mask_proba=0.5, embedding_keep=_t(~mask))
        _close(got, want, UNET_TOL, f"scale {scale}")
    null = port(_t(x), _t(t), embedding=_t(emb), embedding_scale=0.0)
    dropped = port(_t(x), _t(t), embedding=_t(emb), embedding_mask_proba=1.0,
                   generator=torch.Generator().manual_seed(0))
    _close(dropped, null.detach().numpy(), 1e-6)
    with pytest.raises(ValueError, match="generator"):
        port(_t(x), _t(t), embedding=_t(emb), embedding_mask_proba=0.1)


def test_unet_all_owns_the_ncca_embedder():
    """With context_features the All UNet holds the NCCA NumberEmbedder's
    parameters (checkpoint parity) and runs the CFG forward with them
    unused."""
    jm, params, port, x, t, emb = _cfg_pair("all", context_features=6)
    assert isinstance(port, tunet.UNetAll1d)
    assert "embedder.embedding.1.weight" in dict(port.named_parameters())
    feats = np.ones((2, 6), np.float32)
    _close(port(_t(x), _t(t), embedding=_t(emb), features=_t(feats),
                embedding_scale=2.5),
           _apply(jm, params, jnp.asarray(x), jnp.asarray(t),
                  embedding=jnp.asarray(emb), features=jnp.asarray(feats),
                  embedding_scale=2.5),
           UNET_TOL)
    with pytest.raises(ValueError):
        tunet.XUNet1d(type="x", **CFG)


# ------------------------------------------------ Model1d "all" with vk --

TINY_ALL = dict(channels=16, patch_size=2, multipliers=(1, 2), factors=(2,),
                num_blocks=(1,), attentions=(0, 1), attention_heads=2,
                attention_features=8, attention_multiplier=2,
                resnet_groups=4, unet_type="all", diffusion_type="vk",
                context_embedding_features=8, context_embedding_max_length=6)


@pytest.fixture(scope="module")
def all_vk_pair():
    x = _x(14, 2, 64, 2)
    emb = _x(15, 2, 6, 8)
    jm = jaudio.Model1d(in_channels=2, diffusion_sigma_distribution=(
        jdist.make_distribution("vk")), **TINY_ALL)
    key = jax.random.PRNGKey(14)
    params = _init(jm, {"params": key, "cfg": key}, jnp.asarray(x), key,
                   embedding=jnp.asarray(emb))
    tm = _load(audio.build_model1d(
        device="cpu", in_channels=2,
        diffusion_sigma_distribution=distributions.make_distribution("vk"),
        **TINY_ALL), params)
    return jm, params, tm, x, emb


def test_all_vk_model1d_loss_matches_jax(all_vk_pair, monkeypatch):
    """The training loss with the documented dropout (0.1, here 0.5 so that
    the mask keeps and drops), fed JAX's sigmas, noise and mask."""
    jm, params, tm, x, emb = all_vk_pair
    key = jax.random.PRNGKey(16)
    ks, kn = jax.random.split(key)
    sigmas = np.array(jdist.make_distribution("vk")(ks, 2))
    noise = np.array(jax.random.normal(kn, x.shape))
    masks = _recording(monkeypatch, "bernoulli")
    want = _apply(jm, params, jnp.asarray(x), key,
                  embedding=jnp.asarray(emb), embedding_mask_proba=0.5,
                  rngs={"cfg": jax.random.PRNGKey(4)})
    (mask,) = masks
    got = tm(_t(x), sigmas=_t(sigmas), noise=_t(noise), embedding=_t(emb),
             embedding_mask_proba=0.5, embedding_keep=_t(~mask))
    assert abs(got.item() - float(want)) <= UNET_TOL * max(1.0,
                                                           abs(float(want)))
    drawn = [tm(_t(x), torch.Generator().manual_seed(5), embedding=_t(emb),
                embedding_mask_proba=0.1) for _ in range(2)]
    assert drawn[0].item() == drawn[1].item()


def test_all_vk_model1d_karras_sample_matches_jax(all_vk_pair):
    jm, params, tm, x, emb = all_vk_pair
    noise = _x(17, 2, 64, 2)
    key = jax.random.PRNGKey(17)
    want = jaudio.sample_model1d(jm, {"params": params}, jnp.asarray(noise),
                                 key, num_steps=4, sampler="karras",
                                 schedule="karras",
                                 embedding=jnp.asarray(emb),
                                 embedding_scale=2.0)
    keys = jax.random.split(key, 3)
    step_noise = np.stack([np.array(jax.random.normal(k, noise.shape))
                           for k in keys])
    got = audio.sample_model1d(tm, _t(noise), num_steps=4, sampler="karras",
                               schedule="karras", step_noise=_t(step_noise),
                               embedding=_t(emb), embedding_scale=2.0)
    _close(got, want, UNET_TOL)
    churned = audio.sample_model1d(
        tm, _t(noise), torch.Generator().manual_seed(0), num_steps=4,
        sampler="karras", schedule="karras", sampler_kwargs={"s_churn": 1.0},
        embedding=_t(emb), embedding_scale=2.0)
    assert torch.isfinite(churned).all()
    assert not torch.equal(churned, got)
