"""The port's blocks of the GPT family against the JAX package on the CPU
in float32, with JAX's parameters (loaded ``strict=True``) and JAX's draws:
parti's and the FF-CNN feed-forward, GLU, the causal depthwise conv, the
2-D relative bias, the GCN layers, ``AttentionQKV`` and its cached step,
and the MoE feed-forward with its load-balance loss.

Bands: blocks 2e-5 (primitives); the MoE 1e-5.  The helpers here (JAX's
parameters carried into the port, comparisons, seeded inputs, the
generators' draws and the ids check) serve ``test_torch_gpt_family.py``
and ``test_torch_gpt_decoders.py`` too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from moleculediffusiontransformer_tpu.nn import moe as jmoe
from moleculediffusiontransformer_tpu.nn import transformer_blocks as jtb
from moleculediffusiontransformer_tpu_torch.nn import moe as tmoe
from moleculediffusiontransformer_tpu_torch.nn import transformer_blocks as ttb
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params

BLOCK_TOL, MODEL_TOL, GAP = 2e-5, 1e-4, 1e-3
BATCH, LENGTH = 3, 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(params):
    """Norm gammas off their initial 1, so that each one counts."""
    return jax.tree_util.tree_map(
        lambda a: a * (1 + 0.1 * np.arange(a.size).reshape(a.shape) / a.size)
        if a.ndim == 1 else a, params)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return module


def _init(module, rngs, *arrays, **kwargs):
    """``module.init(...)["params"]`` under ``jax.jit``: eagerly, Flax
    compiles every op apart, several times slower.  Keyword arguments that
    are not arrays stay static."""
    static = {k: v for k, v in kwargs.items() if not isinstance(v, jax.Array)}
    traced = {k: v for k, v in kwargs.items() if k not in static}
    return jax.jit(lambda r, a, kw: module.init(r, *a, **kw, **static))(
        rngs, arrays, traced)["params"]


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _rng(seed):
    return np.random.default_rng(seed)


def _x(seed, *shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _jax_gpt_uniforms(key, steps, b, vocab):
    """The uniforms ``generate_gpt``'s scan draws: one key split a step."""
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k1, (b, vocab))))
    return np.stack(out)


def _check_ids(got, want, logits, uniforms, positions, filter_thres=0.9):
    """ids equal wherever the two largest perturbed logits (JAX's logits at
    that position, top-k filtered, plus the step's Gumbel noise) are more
    than GAP apart."""
    for step, pos in positions:
        lg = np.asarray(jtb.top_k_filter(jnp.asarray(logits[:, pos]),
                                         filter_thres))
        pert = lg + np.asarray(-np.log(-np.log(uniforms[step] + 1e-20)
                                       + 1e-20))
        top2 = np.sort(pert, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > GAP
        np.testing.assert_array_equal(got[clear, pos + 1],
                                      want[clear, pos + 1])


# ----------------------------------------------------------------- blocks --

class _JParti(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jtb.feed_forward_parti(x, 16, 4, name="ff")


def test_feed_forward_parti_and_relu_squared():
    x = _x(0, 2, 5, 16)
    params = _perturb(_JParti().init(jax.random.PRNGKey(0),
                                     jnp.asarray(x))["params"])
    port = torch.nn.Module()
    port.ff = ttb.feed_forward_parti(16, 4)
    _load(port, params)
    _close(port.ff(_t(x)), _JParti().apply({"params": params},
                                           jnp.asarray(x)), BLOCK_TOL)
    _close(ttb.relu_squared(_t(x)), jtb.relu_squared(jnp.asarray(x)),
           BLOCK_TOL)


@pytest.mark.parametrize("name,jmod,tmod,shape", [
    ("glu", lambda: jtb.GLU(12), lambda: ttb.GLU(16, 12), (2, 5, 16)),
    ("ds_conv", lambda: jtb.CausalDSConv(3, dilation=2),
     lambda: ttb.CausalDSConv(16, 3, dilation=2), (2, 9, 16)),
    ("ffcnn", lambda: jtb.FeedForwardCNN(16, mult=2, conv_kernel_ff=3,
                                         ff_inner_conv=2),
     lambda: ttb.FeedForwardCNN(16, mult=2, conv_kernel_ff=3,
                                ff_inner_conv=2), (2, 7, 16)),
    ("ffcnn_glu_relu2", lambda: jtb.FeedForwardCNN(
        16, dim_out=8, glu=True, use_relu_squared=True, conv_kernel_ff=2),
     lambda: ttb.FeedForwardCNN(16, dim_out=8, glu=True,
                                use_relu_squared=True, conv_kernel_ff=2),
     (2, 7, 16)),
    ("ffcnn_swish", lambda: jtb.FeedForwardCNN(16, swish=True),
     lambda: ttb.FeedForwardCNN(16, swish=True), (2, 7, 16)),
])
def test_feed_forward_blocks_match_jax(name, jmod, tmod, shape):
    x = _x(1, *shape)
    jm = jmod()
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    port = _load(tmod(), params)
    _close(port(_t(x)), jm.apply({"params": params}, jnp.asarray(x)),
           BLOCK_TOL, name)


def test_depthwise_kernel_layout():
    """JAX's (k, 1, c) depthwise kernel arrives as torch's (c, 1, k)."""
    jm = jtb.CausalDSConv(3)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 6)))["params"]
    sd = state_dict_from_jax_params(params)
    np.testing.assert_array_equal(
        sd["ds_conv.weight"].numpy(),
        np.transpose(np.asarray(params["ds_conv"]["kernel"]), (2, 1, 0)))


def test_rel_pos_bias_2d_matches_jax():
    jm = jtb.RelPosBias2d(size=4, heads=3)
    params = jm.init(jax.random.PRNGKey(3), 16, 17)["params"]
    port = _load(ttb.RelPosBias2d(4, 3), params)
    for i, j in ((16, 17), (5, 9), (1, 2)):
        _close(port(i, j), jm.apply({"params": params}, i, j), BLOCK_TOL)


def test_gcn_layers_match_jax():
    """A GCN layer, then the stack with and without its skip, and the stack
    with its train-time dropout fed JAX's own keep mask (read back from the
    dropout's output)."""
    x = _x(4, 6, 5, 8)
    adj = np.abs(_x(5, 6, 5, 5))
    jl = jtb.GCNLayer(8)
    params = jl.init(jax.random.PRNGKey(4), jnp.asarray(x),
                     jnp.asarray(adj))["params"]
    port = _load(ttb.GCNLayer(8, 8), params)
    _close(port(_t(x), _t(adj)),
           jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(adj)),
           BLOCK_TOL)
    for skip in (True, False):
        jg = jtb.GraphConvLayers(8, 6, depth=2, have_skip=skip)
        params = jg.init(jax.random.PRNGKey(5), jnp.asarray(x),
                         jnp.asarray(adj))["params"]
        port = _load(ttb.GraphConvLayers(8, 8, 6, 2, have_skip=skip),
                     params)
        _close(port(_t(x), _t(adj)),
               jg.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(adj)), BLOCK_TOL)
    out, state = jg.apply({"params": params}, jnp.asarray(x),
                          jnp.asarray(adj), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(6)},
                          capture_intermediates=True)
    dropped = np.asarray(state["intermediates"]["Dropout_0"]["__call__"][0])
    keep = dropped != 0
    assert 0 < (~keep).sum() < keep.size
    got = port(_t(x), _t(adj), deterministic=False,
               dropout_keep=_t(keep))
    _close(got, out, BLOCK_TOL)
    with pytest.raises(ValueError, match="generator"):
        port(_t(x), _t(adj), deterministic=False)


QKV_CASES = {
    "self_one_kv": dict(causal=True),
    "self_multi_kv": dict(causal=True, one_kv_head=False),
    "cross_masked": dict(context_dim=12, norm_context=True),
    "no_null": dict(causal=True, use_null_kv=False),
    "gnn": dict(causal=True, use_null_kv=False, gnn_layers=2,
                gnn_att_threshold_min=0.05, gnn_att_threshold_max=0.9),
    "gnn_no_clamp": dict(causal=True, use_null_kv=False, gnn_layers=1,
                         gnn_clamp_att_after_identity=False,
                         gnn_have_skip=False),
}


@pytest.mark.parametrize("case", sorted(QKV_CASES))
def test_attention_qkv_matches_jax(case):
    kw = QKV_CASES[case]
    x = _x(7, 2, 6, 16)
    ctx = _x(8, 2, 5, 12) if "context_dim" in kw else None
    mask = np.ones((2, 5 if ctx is not None else 6), bool)
    mask[1, 3:] = False
    jkw = {k: v for k, v in kw.items() if k != "context_dim"}
    jm = jtb.AttentionQKV(16, dim_head=8, heads=4, **jkw)
    args = (jnp.asarray(x),) + (() if ctx is None else (jnp.asarray(ctx),))
    params = _perturb(jm.init(jax.random.PRNGKey(9), *args)["params"])
    port = _load(ttb.AttentionQKV(16, dim_head=8, heads=4, **kw), params)
    targs = (_t(x),) + (() if ctx is None else (_t(ctx),))
    _close(port(*targs), jm.apply({"params": params}, *args), BLOCK_TOL,
           case)
    _close(port(*targs, context_mask=_t(mask)),
           jm.apply({"params": params}, *args,
                    context_mask=jnp.asarray(mask)), BLOCK_TOL, case)


@pytest.mark.parametrize("case", ["self_one_kv", "no_null", "gnn"])
def test_attention_qkv_step_matches_jax(case):
    """The cached step position by position against JAX's step; without
    GCN layers it also equals the full causal forward row by row."""
    kw = QKV_CASES[case]
    x = _x(10, 2, 6, 16)
    jm = jtb.AttentionQKV(16, dim_head=8, heads=4, **kw)
    params = _perturb(jm.init(jax.random.PRNGKey(11),
                              jnp.asarray(x))["params"])
    port = _load(ttb.AttentionQKV(16, dim_head=8, heads=4, **kw), params)
    full = port(_t(x))
    kc, vc = torch.zeros(2, 6, 8), torch.zeros(2, 6, 8)
    jkc, jvc = jnp.zeros((2, 6, 8)), jnp.zeros((2, 6, 8))
    for pos in range(6):
        out, (kc, vc) = port.step(_t(x[:, pos:pos + 1]), (kc, vc), pos)
        want, jkc, jvc = jm.apply({"params": params},
                                  jnp.asarray(x[:, pos:pos + 1]), jkc, jvc,
                                  pos, method=jtb.AttentionQKV.step)
        _close(out, want, BLOCK_TOL, f"{case} pos {pos}")
        if not kw.get("gnn_layers"):
            _close(out, full[:, pos:pos + 1].detach().numpy(), BLOCK_TOL)
    with pytest.raises(ValueError, match="one-KV-head"):
        ttb.AttentionQKV(16, dim_head=8, heads=4, one_kv_head=False).step(
            _t(x[:, :1]), (kc, vc), 0)


# -------------------------------------------------------------------- MoE --

@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (2, 0.5),
                                          (1, 0.3)])
def test_moe_matches_jax(top_k, factor):
    """Output and load-balance loss; the small capacity factors drop
    tokens."""
    x = _x(12, 4, 8, 16)
    jm = jmoe.MoEFeedForward(dim=16, num_experts=4, mult=2, top_k=top_k,
                             capacity_factor=factor)
    params = jm.init(jax.random.PRNGKey(12), jnp.asarray(x))["params"]
    want, state = jm.apply({"params": params}, jnp.asarray(x),
                           mutable=["aux_loss"])
    port = _load(tmoe.MoEFeedForward(16, 4, mult=2, top_k=top_k,
                                     capacity_factor=factor), params)
    got = port(_t(x))
    _close(got, want, 1e-5)
    aux = float(state["aux_loss"]["load_balance"][0])
    assert abs(port.aux_loss.item() - aux) <= 1e-5
    assert port.capacity(32) == jmoe.moe_capacity(32, 4, top_k, factor)
    # the stacked experts and the router keep JAX's layout
    assert tuple(port.w_in.shape) == tuple(params["w_in"].shape) == (4, 16,
                                                                     32)
    assert tuple(port.router.shape) == (16, 4)
    # torch.topk picks JAX's experts on these draws
    probs = torch.softmax(_t(x).reshape(-1, 16) @ port.router, -1)
    np.testing.assert_array_equal(
        torch.topk(probs, top_k).indices.numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(probs.detach().numpy()),
                                 top_k)[1]))


def test_moe_drops_tokens_past_capacity():
    """With capacity 1 a token past it contributes exactly zero."""
    port = tmoe.MoEFeedForward(8, 2, top_k=1, capacity_factor=0.25)
    x = torch.randn(1, 8, 8, generator=torch.Generator().manual_seed(0))
    assert port.capacity(8) == 1
    out = port(x)
    assert int((out.abs().sum(-1) == 0).sum()) >= 8 - 2
