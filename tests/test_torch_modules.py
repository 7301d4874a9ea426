"""The PyTorch port's primitives, embeddings and blocks against their JAX
twins, on the CPU in fp32 (attention and the Transformer1d stack:
``test_torch_transformer1d.py``).

Each case builds the JAX module, perturbs its init params (so norm scales,
biases and tables are not trivial), loads them into the port module through
``state_dict_from_jax_params`` with ``strict=True``, feeds both the same
numpy inputs (``np.random.default_rng``) and compares.  Tolerance: 2e-5
absolute, the primitive band of the JAX suite, unless stated at the assert.
"""
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from moleculediffusiontransformer_tpu.nn import blocks as jb
from moleculediffusiontransformer_tpu.nn import embeddings as je
from moleculediffusiontransformer_tpu.nn import primitives as jp
from moleculediffusiontransformer_tpu_torch.nn import blocks as tb
from moleculediffusiontransformer_tpu_torch.nn import embeddings as te
from moleculediffusiontransformer_tpu_torch.nn import primitives as tp
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params

TOL = 2e-5


class JFn(fnn.Module):
    """Runs a JAX function that creates named submodules (``downsample1d``
    & co) inside a module of its own."""
    fn: Any

    @fnn.compact
    def __call__(self, *args):
        return self.fn(*args)


def _named(name: str, module: torch.nn.Module) -> torch.nn.Module:
    """Hold ``module`` under ``name``, as the JAX function names its child."""
    holder = torch.nn.Module()
    holder.add_module(name, module)
    return holder


def _inputs(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_params(module, args, seed: int = 0, **kw):
    variables = module.init(jax.random.PRNGKey(seed),
                            *[jnp.asarray(a) for a in args], **kw)
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                   ).astype(np.float32), dict(variables["params"]))


def _load(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return module


def _max_diff(a, b) -> float:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def _compare(jax_mod, torch_mod, args, torch_call=None, tol=TOL, **kw):
    params = _jax_params(jax_mod, args, **kw)
    want = jax_mod.apply({"params": params},
                         *[jnp.asarray(a) for a in args], **kw)
    _load(torch_mod, params)
    with torch.no_grad():
        targs = [torch.from_numpy(a) for a in args]
        got = (torch_call or torch_mod)(*targs, **kw)
    assert _max_diff(got, want) <= tol


# ------------------------------------------------------------ primitives ---

@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    _compare(jp.Dense(20, use_bias=bias), tp.Dense(12, 20, bias=bias),
             _inputs(0, (3, 5, 12)))


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (5, 2, 2), (1, 1, 0),
                                          (9, 4, 4)])
def test_conv1d(k, stride, pad):
    _compare(jp.Conv1d(24, kernel_size=k, stride=stride, padding=pad),
             tp.Conv1d(16, 24, kernel_size=k, stride=stride, padding=pad),
             _inputs(1, (2, 16, 16)))


@pytest.mark.parametrize("groups,eps", [(8, 1e-5), (1, 1e-5), (32, 1e-6)])
def test_group_norm(groups, eps):
    _compare(jp.GroupNorm(groups, eps=eps), tp.GroupNorm(groups, 64, eps=eps),
             _inputs(2, (3, 16, 64)))


def test_layer_norm():
    _compare(jp.LayerNorm(), tp.LayerNorm(48), _inputs(3, (3, 7, 48)))


def test_embed():
    ids = np.array([[0, 3, 5], [7, 7, 1]])
    params = _jax_params(jp.Embed(8, 16), [ids])
    want = jp.Embed(8, 16).apply({"params": params}, jnp.asarray(ids))
    got = _load(tp.Embed(8, 16), params)(torch.from_numpy(ids))
    assert _max_diff(got, want) == 0.0     # a gather: exact


@pytest.mark.parametrize("fn", ["gelu", "silu"])
def test_activations(fn):
    (x,) = _inputs(4, (1000,))
    x = x * 4
    want = getattr(jp, fn)(jnp.asarray(x))
    got = getattr(tp, fn)(torch.from_numpy(x))
    assert _max_diff(got, want) <= TOL


@pytest.mark.parametrize("p", [1, 2, 4])
def test_patchify_roundtrip(p):
    (x,) = _inputs(5, (2, 16, 6))
    want = jp.patchify(jnp.asarray(x), p)
    got = tp.patchify(torch.from_numpy(x), p)
    assert _max_diff(got, want) == 0.0     # a permutation: exact
    assert _max_diff(tp.unpatchify(got, p),
                     jp.unpatchify(want, p)) == 0.0


# ------------------------------------------------------------ embeddings ---

def test_learned_positional_embedding():
    t = np.array([-1.2, 0.0, 0.3, 2.5], np.float32)
    _compare(je.LearnedPositionalEmbedding(16),
             te.LearnedPositionalEmbedding(16), [t])


def test_time_positional_embedding():
    t = np.array([-1.2, 0.0, 0.3, 2.5], np.float32)
    port = _named("emb", te.time_positional_embedding(16, 40))
    _compare(je.TimePositionalEmbedding(16, 40), port, [t],
             torch_call=port.emb)


def test_fixed_embedding():
    (e,) = _inputs(6, (3, 12, 24))
    _compare(je.FixedEmbedding(12, 24), te.FixedEmbedding(12, 24), [e])


@pytest.mark.parametrize("length,channels", [(12, 64), (12, 16), (5, 7)])
def test_positional_encoding_1d(length, channels):
    want = je.positional_encoding_1d(length, channels)
    got = te.positional_encoding_1d(length, channels)
    assert _max_diff(got, want) == 0.0     # the same numpy code: exact


# ---------------------------------------------------------------- blocks ---

@pytest.mark.parametrize("factor", [2, 4])
def test_downsample1d(factor):
    port = _named("downsample", tb.downsample1d(16, 32, factor))
    _compare(JFn(lambda x: jb.downsample1d(x, 32, factor)), port,
             _inputs(7, (2, 16, 16)), torch_call=port.downsample)


@pytest.mark.parametrize("factor,nearest", [(2, False), (3, False),
                                            (4, False), (2, True), (1, False)])
def test_upsample1d(factor, nearest):
    port = _named("upsample", tb.upsample1d(32, 16, factor, nearest))
    _compare(JFn(lambda x: jb.upsample1d(x, 16, factor, nearest)), port,
             _inputs(8, (2, 8, 32)), torch_call=port.upsample)


@pytest.mark.parametrize("film", [False, True])
def test_conv_block(film):
    x, scale, shift = _inputs(9, (2, 16, 32), (2, 1, 32), (2, 1, 32))
    params = _jax_params(jb.ConvBlock1d(24), [x])
    want = jb.ConvBlock1d(24).apply(
        {"params": params}, jnp.asarray(x),
        (jnp.asarray(scale), jnp.asarray(shift)) if film else None)
    port = _load(tb.ConvBlock1d(32, 24), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   (torch.from_numpy(scale), torch.from_numpy(shift))
                   if film else None)
    assert _max_diff(got, want) <= TOL


def test_mapping_to_scale_shift():
    (m,) = _inputs(10, (3, 40))
    params = _jax_params(jb.MappingToScaleShift(24), [m])
    want = jb.MappingToScaleShift(24).apply({"params": params}, jnp.asarray(m))
    port = _load(tb.MappingToScaleShift(40, 24), params)
    got = port(torch.from_numpy(m))
    for g, w in zip(got, want):
        assert _max_diff(g, w) <= TOL


@pytest.mark.parametrize("cin,cout,mapping", [(16, 32, True), (32, 32, False),
                                              (32, 16, False)])
def test_resnet_block(cin, cout, mapping):
    x, m = _inputs(11, (2, 16, cin), (2, 40))
    jmod = jb.ResnetBlock1d(cout, use_mapping=mapping)
    args = [x, m] if mapping else [x]
    port = tb.ResnetBlock1d(cin, cout,
                            context_mapping_features=40 if mapping else None)
    _compare(jmod, port, args)


@pytest.mark.parametrize("p", [1, 2])
def test_patcher_unpatcher(p):
    x, m = _inputs(12, (2, 16, 6), (2, 40))
    _compare(jb.Patcher(32, p, use_mapping=True),
             tb.Patcher(6, 32, p, context_mapping_features=40), [x, m])
    (h,) = _inputs(13, (2, 16 // p, 32))
    _compare(jb.Unpatcher(6, p, use_mapping=True),
             tb.Unpatcher(32, 6, p, context_mapping_features=40), [h, m])
