"""The Transformer1d stack's training path in the PyTorch port against the JAX
package, on the CPU (fp32 unless stated): the stash forward, the three
backward segment kernels' plain versions (K3 conv out, K2 one layer, K4
GroupNorm + conv in) against the Pallas kernels run with ``interpret=True``,
and the whole stack's gradients through the port's dispatch; at L 16 and 64
and, past the whole-row attention core's 64 rows, at L 128 with a context
of 80 rows.

Weights come from the JAX module's ``init`` through
``state_dict_from_jax_params``; JAX grads are mapped the same way, which
puts matrices in torch's (out, in) layout.  Bands are the JAX suite's own
(``tests/test_transformer_fusion.py``): 2e-5 for the forward, rtol 1e-4 /
atol 1e-5 for gradients, and rtol 5e-4 / atol 5e-5 where the Pallas grid has
more than one program (its sequential partial sums reorder float32 adds).
bf16: within 2e-2 of each tensor's largest magnitude (one rounding step of
the compute dtype, carried through a few products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import attention as ja
from moleculediffusiontransformer_tpu.ops import transformer_fusion as jtf
from moleculediffusiontransformer_tpu_torch.nn import attention as ta
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

HEADS, HEAD_DIM, LAYERS = 4, 16, 2
# (B, L, C, m): the JAX suite's gradient geometry (one Pallas program), its
# grid > 1 geometry, and a stack past the whole-row attention core's 64 rows
# (the tiled core's) with a context of 80 rows
GEOMS = {"grid1": (8, 16, 64, 12), "grid4": (16, 64, 64, 12),
         "L128": (2, 128, 64, 80)}
BANDS = {"grid1": (1e-4, 1e-5), "grid4": (5e-4, 5e-5), "L128": (5e-4, 5e-5)}
BF16_BAND = 2e-2


def _setup(cross, geom="grid1", seed=0):
    B, L, C, M = GEOMS[geom]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    ctx = (rng.standard_normal((B, M, C)).astype(np.float32) if cross
           else None)
    jmod = ja.Transformer1d(num_layers=LAYERS, channels=C, num_heads=HEADS,
                            head_features=HEAD_DIM, multiplier=2,
                            context_features=C if cross else None,
                            disable_fusion=True)
    args = [jnp.asarray(x)] + ([jnp.asarray(ctx)] if cross else [])
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), *args)["params"])
    return jmod, params, x, ctx, rng


def _jax_ws(params, cross, dtype=jnp.float32):
    return [jnp.asarray(w, dtype if w.shape[0] > 1 else jnp.float32)
            for w in jtf.flatten_params(params, LAYERS, cross)]


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32)
                                                   ).to(dtype)


def _jax_grad_like(port_grad: torch.Tensor, jax_grad) -> np.ndarray:
    """A JAX kernel grad in the port's layout: (in, out) matrices
    transposed, (1, n) vectors flattened."""
    g = np.asarray(jax_grad, np.float32)
    return g.T if port_grad.dim() == 2 else g.reshape(-1)


def _assert_close(got, want, rtol, atol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _assert_bf16(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= BF16_BAND * scale, what


# ------------------------------------------------------------------ stash ---

def _stash_forward_matches_pallas(cross, geom):
    _, params, x, ctx, _ = _setup(cross, geom)
    want_out, want_stash = jtf._fused_forward(
        _jax_ws(params, cross), jnp.asarray(x),
        None if ctx is None else jnp.asarray(ctx), num_layers=LAYERS,
        heads=HEADS, head_dim=HEAD_DIM, multiplier=2, interpret=True,
        with_stash=True)
    out, stash = tf.transformer1d_reference(
        state_dict_from_jax_params(params), _t(x), _t(ctx),
        num_layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM, multiplier=2,
        with_stash=True)
    assert stash.shape[0] == jtf.n_stash_slots(LAYERS, cross)
    _assert_close(out, want_out, 0, 2e-5, "out")
    for i in range(stash.shape[0]):
        _assert_close(stash[i], want_stash[i], 0, 2e-5, f"slot {i}")


@pytest.mark.parametrize("cross", [False, True])
def test_stash_forward_matches_pallas(cross):
    _stash_forward_matches_pallas(cross, "grid1")


@pytest.mark.parametrize("cross", [False, True])
def test_stash_forward_past_64_rows_matches_pallas(cross):
    """The stash forward at L 128 (context 80 rows): the tiled core's
    lengths."""
    _stash_forward_matches_pallas(cross, "L128")


# ------------------------------------------------- K3, K2, K4 one by one ---

def _port_weights(params, cross, dtype=torch.float32):
    return tf._kernel_weights(state_dict_from_jax_params(params), LAYERS,
                              cross, dtype)


@pytest.mark.parametrize("geom", ["grid1", "grid4", "L128"])
def test_conv_out_backward_matches_pallas(geom):
    _, params, _, _, rng = _setup(False, geom)
    B, L, C, _ = GEOMS[geom]
    g, y = (rng.standard_normal((B, L, C)).astype(np.float32)
            for _ in range(2))
    want = jtf._bwd_conv_out(jnp.asarray(g), jnp.asarray(y),
                             _jax_ws(params, False)[-2], interpret=True)
    got = tf.bwd_conv_out(_t(g), _t(y), _port_weights(params, False)[-2])
    rtol, atol = BANDS[geom]
    _assert_close(got[0], want[0], rtol, atol, "dy")
    _assert_close(got[1], np.asarray(want[1]).T, rtol, atol, "dW")
    _assert_close(got[2], np.asarray(want[2]).reshape(-1), rtol, atol, "db")


@pytest.mark.parametrize("geom", ["grid1", "grid4"])
def test_conv_out_backward_with_a_workspace_on_cpu_is_the_plain_version(geom):
    """On CPU tensors a workspace changes nothing: the wrapper runs the plain
    version, launches nothing, and agrees with the Pallas kernel."""
    _, params, _, _, rng = _setup(False, geom)
    B, L, C, _ = GEOMS[geom]
    g, y = (_t(rng.standard_normal((B, L, C))) for _ in range(2))
    w = _port_weights(params, False)[-2]
    before = tf.CONV_OUT_BWD_LAUNCHES
    got = tf.bwd_conv_out(g, y, w, workspace=torch.empty(64, dtype=torch.uint8))
    assert tf.CONV_OUT_BWD_LAUNCHES == before
    for a, b in zip(got, tf.bwd_conv_out_reference(g, y, w)):
        assert torch.equal(a, b)
    want = jtf._bwd_conv_out(jnp.asarray(g.numpy()), jnp.asarray(y.numpy()),
                             _jax_ws(params, False)[-2], interpret=True)
    rtol, atol = BANDS[geom]
    _assert_close(got[0], want[0], rtol, atol, "dy")
    _assert_close(got[1], np.asarray(want[1]).T, rtol, atol, "dW")
    _assert_close(got[2], np.asarray(want[2]).reshape(-1), rtol, atol, "db")


def _split_colsum(a: torch.Tensor, splits: int, lanes: int = 32) -> torch.Tensor:
    """The order in which K3's and K4's row-split column sums add (float32):
    the rows cut into ``splits`` chunks of ceil(rows / splits); in a chunk,
    lane l sums rows l, l + lanes, ... in order and the lanes are added in
    order; then the chunks' partials in chunk order."""
    rows, cols = a.shape
    chunk = -(-rows // splits)
    total = torch.zeros(cols)
    for r0 in range(0, rows, chunk):
        part = a[r0:r0 + chunk]
        pad = -part.shape[0] % lanes      # + 0.0 leaves a float32 sum as is
        steps = torch.cat([part, torch.zeros(pad, cols)]).reshape(
            -1, lanes, cols)
        acc = torch.zeros(lanes, cols)
        for step in steps:
            acc = acc + step
        part_sum = torch.zeros(cols)
        for lane in acc:
            part_sum = part_sum + lane
        total = total + part_sum
    return total


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rows,splits", [
    (1, 1), (24, 1), (97, 3), (2048, 32), (4096, 17), (4109, 17),
    (1024, 9), (1000, 7)])
def test_row_split_column_sum_is_the_column_sum(rows, splits, weighted):
    """The row-split column sum of K3 (db) and K4 (db, dbeta, and dgamma:
    the sum weighted by xhat), modelled in float32 in the kernels' order,
    equals ``_colsum`` and JAX's column sum within float32 rounding: two
    orders of n additions differ by at most 2 (n - 1) 2^-24 sum |a|."""
    rng = np.random.default_rng(rows * 31 + splits)
    a = rng.standard_normal((rows, 64)).astype(np.float32)
    if weighted:
        a = a * rng.standard_normal((rows, 64)).astype(np.float32)
    got = _split_colsum(_t(a), splits)
    want = tf._colsum(_t(a))
    band = 2 * max(rows - 1, 1) * 2.0 ** -24 * np.abs(a).sum(axis=0)
    assert np.all(np.abs(got.numpy() - want.numpy()) <= band)
    jax_sum = np.asarray(jnp.sum(jnp.asarray(a), axis=0))
    assert np.all(np.abs(got.numpy() - jax_sum) <= band)


def test_backward_chain_hands_one_workspace_to_every_stage():
    """``_backward_chain`` gives its one workspace to K3, to every layer's K2
    and to K4 (recorders in their place, running the plain versions), and
    returns what the plain chain returns."""
    _, params, x, ctx, rng = _setup(True)
    sd = state_dict_from_jax_params(params)
    kw = dict(num_layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM)
    _, stash = tf.transformer1d_reference(sd, _t(x), _t(ctx), multiplier=2,
                                          with_stash=True, **kw)
    g = _t(rng.standard_normal(x.shape))
    workspace = torch.empty(16, dtype=torch.uint8)
    seen = []

    def recorder(name, plain):
        def stage(*args, workspace=None, **kwargs):
            seen.append((name, workspace))
            return plain(*args, **kwargs)
        return stage

    got = tf._backward_chain(
        recorder("K3", tf.bwd_conv_out_reference),
        recorder("K2", tf.bwd_layer_reference),
        recorder("K4", tf.bwd_conv_in_gn_reference), sd, _t(x), _t(ctx),
        stash, g, LAYERS, HEADS, HEAD_DIM, workspace)
    assert [name for name, _ in seen] == ["K3"] + ["K2"] * LAYERS + ["K4"]
    assert all(ws is workspace for _, ws in seen)
    want = tf.transformer1d_backward_reference(sd, _t(x), _t(ctx), stash, g,
                                               **kw)
    assert set(got[0]) == set(want[0])
    assert all(torch.equal(got[0][n], want[0][n]) for n in want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _layer_inputs(cross, geom, dtype=np.float32):
    jmod, params, _, ctx, rng = _setup(cross, geom)
    B, L, C, _ = GEOMS[geom]
    dy, a, c, f = (rng.standard_normal((B, L, C)).astype(np.float32)
                   for _ in range(4))
    per_layer = (16 if cross else 8) + 4
    return params, dy, a, (c if cross else None), f, ctx, per_layer


@pytest.mark.parametrize("geom", ["grid1", "grid4", "L128"])
@pytest.mark.parametrize("cross", [False, True])
def test_layer_backward_matches_pallas(cross, geom):
    params, dy, a, c, f, ctx, per_layer = _layer_inputs(cross, geom)
    layer = 1
    lo = 4 + layer * per_layer
    jw = _jax_ws(params, cross)[lo:lo + per_layer]
    want_dy, want_dctx, want_flat = jtf._bwd_layer(
        jnp.asarray(dy), jnp.asarray(a), None if c is None else jnp.asarray(c),
        jnp.asarray(f), None if ctx is None else jnp.asarray(ctx), jw,
        heads=HEADS, head_dim=HEAD_DIM, interpret=True)
    pw = _port_weights(params, cross)[lo:lo + per_layer]
    got_dy, got_dctx, got_flat = tf.bwd_layer(
        _t(dy), _t(a), _t(c), _t(f), _t(ctx), pw, heads=HEADS,
        head_dim=HEAD_DIM)
    rtol, atol = BANDS[geom]
    _assert_close(got_dy, want_dy, rtol, atol, "dy_prev")
    if cross:
        _assert_close(got_dctx, want_dctx, rtol, atol, "dctx")
    else:
        assert got_dctx is None
    assert len(got_flat) == len(want_flat) == per_layer
    names = tf._abi_names(LAYERS, cross)[lo:lo + per_layer]
    for name, g, w in zip(names, got_flat, want_flat):
        _assert_close(g, _jax_grad_like(g, w), rtol, atol, name)


def test_layer_backward_sums_dcontext_across_layers():
    """dcontext of a layer is added to the later layers' sum."""
    params, dy, a, c, f, ctx, per_layer = _layer_inputs(True, "grid1")
    pw = _port_weights(params, True)[4:4 + per_layer]
    args = (_t(dy), _t(a), _t(c), _t(f), _t(ctx), pw)
    _, alone, _ = tf.bwd_layer(*args, heads=HEADS, head_dim=HEAD_DIM)
    prior = torch.ones_like(alone)
    _, summed, _ = tf.bwd_layer(*args, heads=HEADS, head_dim=HEAD_DIM,
                                dctx_sum=prior)
    assert torch.equal(summed, prior + alone)


@pytest.mark.parametrize("geom", ["grid1", "grid4", "L128"])
def test_conv_in_gn_backward_matches_pallas(geom):
    _, params, x, _, rng = _setup(False, geom)
    B, L, C, _ = GEOMS[geom]
    dy0 = rng.standard_normal((B, L, C)).astype(np.float32)
    jw = _jax_ws(params, False)
    want = jtf._bwd_conv_in_gn(jnp.asarray(dy0), jnp.asarray(x), jw[2], jw[0],
                               jw[1], interpret=True)
    pw = _port_weights(params, False)
    got = tf.bwd_conv_in_gn(_t(dy0), _t(x), pw[2], pw[0], pw[1])
    rtol, atol = BANDS[geom]
    for name, g, w in zip(["dx", "dW", "db", "dgamma", "dbeta"], got, want):
        w = np.asarray(w) if name == "dx" else _jax_grad_like(g, w)
        _assert_close(g, w, rtol, atol, name)


def test_backward_kernels_bf16():
    """Each backward segment in bf16 against the Pallas kernel in bf16."""
    _backward_kernels_bf16("grid1")


def test_backward_kernels_past_64_rows_bf16():
    """The same at L 128 with a context of 80 rows."""
    _backward_kernels_bf16("L128")


def _backward_kernels_bf16(geom):
    params, dy, a, c, f, ctx, per_layer = _layer_inputs(True, geom)
    bf = jnp.bfloat16
    jw = _jax_ws(params, True, bf)
    pw = _port_weights(params, True, torch.bfloat16)
    J = {k: jnp.asarray(v, bf) for k, v in
         dict(dy=dy, a=a, c=c, f=f, ctx=ctx).items()}
    T = {k: _t(v, torch.bfloat16) for k, v in
         dict(dy=dy, a=a, c=c, f=f, ctx=ctx).items()}

    want = jtf._bwd_conv_out(J["dy"], J["a"], jw[-2], interpret=True)
    got = tf.bwd_conv_out(T["dy"], T["a"], pw[-2])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, g, w in zip(["dy", "dW", "db"], got, want):
        _assert_bf16(g, w if name == "dy" else _jax_grad_like(g, w),
                     f"K3 {name}")

    lo = 4
    want = jtf._bwd_layer(J["dy"], J["a"], J["c"], J["f"], J["ctx"],
                          jw[lo:lo + per_layer], heads=HEADS,
                          head_dim=HEAD_DIM, interpret=True)
    got = tf.bwd_layer(T["dy"], T["a"], T["c"], T["f"], T["ctx"],
                       pw[lo:lo + per_layer], heads=HEADS, head_dim=HEAD_DIM)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _assert_bf16(got[0], want[0], "K2 dy_prev")
    _assert_bf16(got[1], want[1], "K2 dctx")
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        assert g.dtype == torch.float32
        _assert_bf16(g, _jax_grad_like(g, w), f"K2 grad {i}")

    want = jtf._bwd_conv_in_gn(J["dy"], J["f"], jw[2], jw[0], jw[1],
                               interpret=True)
    got = tf.bwd_conv_in_gn(T["dy"], T["f"], pw[2], pw[0], pw[1])
    for name, g, w in zip(["dx", "dW", "db", "dgamma", "dbeta"], got, want):
        _assert_bf16(g, w if name == "dx" else _jax_grad_like(g, w),
                     f"K4 {name}")


# ------------------------------------------------------- the whole stack ---

def _port_stack(params, cross, C, **kw):
    port = ta.Transformer1d(LAYERS, C, HEADS, HEAD_DIM, 2,
                            context_features=C if cross else None, **kw)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return port


def _port_grads(port, x, ctx, r):
    """Grads of sum(out * r) for every parameter, x and the context."""
    xt = _t(x).requires_grad_()
    ct = None if ctx is None else _t(ctx).requires_grad_()
    (port(xt, ct) * _t(r)).sum().backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    grads["x"], grads["context"] = xt.grad, None if ct is None else ct.grad
    return grads


def _jax_grads(loss, params, x, ctx):
    argn = (0, 1, 2) if ctx is not None else (0, 1)
    g = jax.grad(loss, argnums=argn)(
        params, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    out = dict(state_dict_from_jax_params(g[0]))
    out["x"] = np.asarray(g[1])
    out["context"] = np.asarray(g[2]) if ctx is not None else None
    return out


def _compare_grads(got, want, rtol, atol):
    assert set(got) == set(want)
    for name, g in got.items():
        if want[name] is None:
            assert g is None, name
            continue
        assert g is not None, f"{name} got no gradient"
        _assert_close(g, want[name], rtol, atol, name)


@pytest.mark.parametrize("cross", [False, True])
def test_stack_dispatch_gives_gradients(cross):
    """Through the port's stack dispatch every stack parameter, x and the
    context get gradients (they used to get none: the dispatch handed the
    stack detached parameter copies), equal to the module composition's
    and to the JAX module's ``jax.grad`` (slow path)."""
    jmod, params, x, ctx, rng = _setup(cross)
    C = x.shape[-1]
    r = rng.standard_normal(x.shape).astype(np.float32)
    got = _port_grads(_port_stack(params, cross, C), x, ctx, r)
    missing = [n for n, g in got.items()
               if g is None and (cross or n != "context")]
    assert not missing, f"no gradient for {missing}"
    composed = _port_grads(_port_stack(params, cross, C,
                                       disable_fusion=True), x, ctx, r)
    _compare_grads(got, composed, 1e-4, 1e-5)

    def loss(p, xx, cc):
        args = (xx, cc) if cross else (xx,)
        return jnp.sum(jmod.apply({"params": p}, *args) * r)

    _compare_grads(got, _jax_grads(loss, params, x, ctx), 1e-4, 1e-5)


@pytest.mark.parametrize("geom", ["grid1", "grid4", "L128"])
@pytest.mark.parametrize("cross", [False, True])
def test_stack_gradients_match_pallas_backward(cross, geom):
    """The port's stack grads against ``transformer1d_fused`` with the
    Pallas backward chain (``fused_backward(True)``) in interpret mode."""
    _, params, x, ctx, rng = _setup(cross, geom)
    C = x.shape[-1]
    r = rng.standard_normal(x.shape).astype(np.float32)
    got = _port_grads(_port_stack(params, cross, C), x, ctx, r)

    def loss(p, xx, cc):
        with jtf.fused_backward(True):
            out = jtf.transformer1d_fused(
                p, xx, cc, num_layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM,
                multiplier=2, context_features=C if cross else None,
                interpret=True)
        return jnp.sum(out * r)

    _compare_grads(got, _jax_grads(loss, params, x, ctx), *BANDS[geom])


def test_stack_dispatch_without_grad_keeps_the_serving_path():
    """Without autograd (sampling) the dispatch is the plain forward: no
    stash, no graph; with it, the output carries the stack's backward."""
    _, params, x, _, _ = _setup(False)
    port = _port_stack(params, False, x.shape[-1])
    with torch.no_grad():
        out = port(_t(x))
    assert out.grad_fn is None
    out = port(_t(x))
    assert type(out.grad_fn).__name__ == "_StackBackward"
    frozen = _port_stack(params, False, x.shape[-1]).requires_grad_(False)
    assert frozen(_t(x)).grad_fn is None


def test_backward_chain_matches_autograd_of_the_plain_forward():
    """``transformer1d_backward_reference`` (the chain) against autograd of
    ``transformer1d_reference``: the same function differentiated two
    ways."""
    _, params, x, ctx, rng = _setup(True)
    sd = {k: v.requires_grad_() for k, v in
          state_dict_from_jax_params(params).items()}
    xt, ct = _t(x).requires_grad_(), _t(ctx).requires_grad_()
    kw = dict(num_layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM)
    out, stash = tf.transformer1d_reference(sd, xt, ct, multiplier=2,
                                            with_stash=True, **kw)
    g = _t(rng.standard_normal(x.shape))
    (out * g).sum().backward()
    grads, dx, dctx = tf.transformer1d_backward_reference(
        {k: v.detach() for k, v in sd.items()}, xt.detach(), ct.detach(),
        stash.detach(), g, **kw)
    assert set(grads) == set(sd)
    for name, p in sd.items():
        _assert_close(grads[name].reshape(p.shape), p.grad, 1e-4, 1e-5, name)
    _assert_close(dx, xt.grad, 1e-4, 1e-5, "dx")
    _assert_close(dctx, ct.grad, 1e-4, 1e-5, "dctx")


def test_backward_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card (or a mix of
    devices) never reaches a plain version: the wrappers raise."""
    g = torch.zeros(2, 8, 64, device="meta")
    w = torch.zeros(64, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf.bwd_conv_out(g, g, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf.bwd_conv_in_gn(g, g, w, torch.zeros(64), torch.zeros(64))
