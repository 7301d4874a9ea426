"""The port's resnet-run kernel (K8, ``ops/resnet_fusion.py``) against the
JAX package on the CPU: its plain version against the Pallas kernel
(``resnet_stack_fused(..., interpret=True)``) and against the JAX module
composition in the three layouts the UNet uses (down with every block's
output collected, with and without FiLM; up with skip concat, skip scale
and projection; a run at L = 1), its gradients through the port's autograd
function against ``jax.grad`` of the Pallas path, and a small UNet with the
switch on against JAX's UNet with ``enable_resnet_fusion`` in interpret
mode and against the port's own module composition.

Weights come from the JAX modules' ``init`` (perturbed, so norm scales and
biases are not trivial) through ``state_dict_from_jax_params``.  Bands: 2e-5
for the plain version against the Pallas kernel in fp32; 1e-4 for a UNet at
L >= 32; rtol 1e-4 / atol 1e-5 for gradients; bf16 within 2e-2 of the
output's largest magnitude (a rounding step of the compute dtype carried
through a few products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import blocks as jb
from moleculediffusiontransformer_tpu.nn.unet import XUNet1d as JXUNet1d
from moleculediffusiontransformer_tpu.ops import resnet_fusion as jrf
from moleculediffusiontransformer_tpu.ops import transformer_fusion as jtf
from moleculediffusiontransformer_tpu_torch.nn import blocks as tb
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.nn.unet import XUNet1d
from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf

TOL, UNET_TOL, BF16_BAND = 2e-5, 1e-4, 2e-2
CM = 24


def _tree(seed, cin, cout, use_mapping, length=8):
    mod = jb.ResnetBlock1d(cout, num_groups=8, use_mapping=use_mapping)
    x = jnp.zeros((2, length, cin))
    mp = jnp.zeros((2, CM)) if use_mapping else None
    params = mod.init(jax.random.PRNGKey(seed), x, mp)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                   ).astype(np.float32), dict(params))


def _blocks(trees, cins, cout, use_mapping):
    out = []
    for tree, cin in zip(trees, cins):
        blk = tb.ResnetBlock1d(cin, cout, num_groups=8,
                               context_mapping_features=CM if use_mapping
                               else None)
        blk.load_state_dict(state_dict_from_jax_params(tree), strict=True)
        out.append(blk)
    return out


def _max_diff(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b).max())


def _down_case(use_mapping, length=16, c=32, batch=4, n=3, seed=0):
    rng = np.random.default_rng(seed)
    trees = [_tree(seed + i, c, c, use_mapping, length) for i in range(n)]
    x = rng.standard_normal((batch, length, c)).astype(np.float32)
    mp = (rng.standard_normal((batch, CM)).astype(np.float32)
          if use_mapping else None)
    return trees, _blocks(trees, [c] * n, c, use_mapping), x, mp


def _up_case(length=8, c=32, batch=4, n=2, seed=20):
    rng = np.random.default_rng(seed)
    trees = [_tree(seed + i, 2 * c, c, True, length) for i in range(n)]
    x = rng.standard_normal((batch, length, c)).astype(np.float32)
    mp = rng.standard_normal((batch, CM)).astype(np.float32)
    skips = [rng.standard_normal((batch, length, c)).astype(np.float32)
             for _ in range(n)]
    return trees, _blocks(trees, [2 * c] * n, c, True), x, mp, skips


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("use_mapping", [True, False])
@pytest.mark.parametrize("length", [16, 1])
def test_down_layout_matches_pallas_and_composition(use_mapping, length):
    """The down layout, every block's output collected (L = 1: the forward
    model's deepest stage, where only the centre tap is nonzero)."""
    trees, blocks, x, mp = _down_case(use_mapping, length)
    want, want_outs = jrf.resnet_stack_fused(trees, _j(x), _j(mp),
                                             collect=True, interpret=True)
    got, got_outs = rf.resnet_stack_reference(
        rf.kernel_weights(blocks, torch.float32), _t(x), _t(mp),
        collect=True)
    assert _max_diff(got, want) <= TOL
    assert len(got_outs) == len(want_outs) == 3
    for g, w in zip(got_outs, want_outs):
        assert _max_diff(g, w) <= TOL
    h = _j(x)
    for t in trees:
        h = jb.ResnetBlock1d(32, num_groups=8, use_mapping=use_mapping).apply(
            {"params": t}, h, _j(mp))
    assert _max_diff(got, h) <= TOL


def test_up_layout_skip_concat_scale_and_projection():
    trees, blocks, x, mp, skips = _up_case()
    scale = 2 ** -0.5
    want, _ = jrf.resnet_stack_fused(trees, _j(x), _j(mp),
                                     [_j(s) for s in skips],
                                     skip_scale=scale, interpret=True)
    got, outs = rf.resnet_stack_reference(
        rf.kernel_weights(blocks, torch.float32), _t(x), _t(mp),
        [_t(s) for s in skips], skip_scale=scale)
    assert outs == []
    assert _max_diff(got, want) <= TOL
    h = _j(x)
    for t, sk in zip(trees, skips):
        h = jnp.concatenate([h, _j(sk) * scale], axis=-1)
        h = jb.ResnetBlock1d(32, num_groups=8, use_mapping=True).apply(
            {"params": t}, h, _j(mp))
    assert _max_diff(got, h) <= TOL
    # the module composition the switch-off path runs
    with torch.no_grad():
        comp, _ = rf.resnet_stack_composition(
            blocks, _t(x), _t(mp), [_t(s) for s in skips], skip_scale=scale)
    assert _max_diff(got, comp.numpy()) <= TOL


def test_bf16_matches_pallas_bf16():
    trees, blocks, x, mp, skips = _up_case()
    bf = jnp.bfloat16
    want, _ = jrf.resnet_stack_fused(trees, _j(x, bf), _j(mp, bf),
                                     [_j(s, bf) for s in skips],
                                     skip_scale=2 ** -0.5, interpret=True)
    got, _ = rf.resnet_stack_reference(
        rf.kernel_weights(blocks, torch.bfloat16), _t(x, torch.bfloat16),
        _t(mp, torch.bfloat16), [_t(s, torch.bfloat16) for s in skips],
        skip_scale=2 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert _max_diff(got, want) <= BF16_BAND * np.abs(want).max()


def test_kernel_weights_lay_the_conv_out_as_im2col():
    """Conv weight (C_out, C_in, 3) -> (C_out, 3 C_in) tap-major: the plain
    im2col product equals torch's own conv."""
    _, blocks, x, _ = _down_case(False, n=1)
    ws = rf.kernel_weights(blocks, torch.float32)[0]
    conv = blocks[0].block1.project
    assert ws[2].shape == (32, 96)
    got = rf._conv3(_t(x), ws[2], ws[3])
    want = conv(_t(x))
    assert _max_diff(got, want.detach().numpy()) <= TOL


def test_gradients_match_jax_grad_of_the_pallas_path():
    """Through the port's autograd function (kernel forward, the module
    composition's autograd backward) against ``jax.grad`` of
    ``resnet_stack_fused`` (its ``custom_vjp``), for every block parameter,
    x, the mapping and the skips."""
    trees, blocks, x, mp, skips = _up_case(batch=2, seed=30)
    scale = 2 ** -0.5
    rng = np.random.default_rng(31)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def loss(tr, xx, mm, ss):
        out, _ = jrf.resnet_stack_fused(tr, xx, mm, ss, skip_scale=scale,
                                        interpret=True)
        return jnp.sum(out * r)

    gt, gx, gm, gs = jax.grad(loss, argnums=(0, 1, 2, 3))(
        trees, _j(x), _j(mp), [_j(s) for s in skips])
    xt, mt = _t(x).requires_grad_(), _t(mp).requires_grad_()
    st = [_t(s).requires_grad_() for s in skips]
    out, _ = rf.resnet_stack(blocks, rf.kernel_weights(blocks, torch.float32),
                             xt, mt, st, skip_scale=scale)
    assert type(out.grad_fn).__name__ == "_RecomputeBackward"
    (out * _t(r)).sum().backward()
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **close)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), **close)
    for a, b in zip(st, gs):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **close)
    for blk, tree in zip(blocks, gt):
        want = state_dict_from_jax_params(tree)
        for name, p in blk.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       err_msg=name, **close)


def test_collected_outputs_carry_gradients():
    """Down layout: a loss on the collected skips (not only on the last
    output) reaches x and the parameters, equal to the composition's."""
    _, blocks, x, mp = _down_case(True, batch=2)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))

    def grads(fused):
        xt = _t(x).requires_grad_()
        for blk in blocks:
            blk.zero_grad(set_to_none=True)
        if fused:
            out, outs = rf.resnet_stack(
                blocks, rf.kernel_weights(blocks, torch.float32), xt, _t(mp),
                collect=True)
        else:
            out, outs = rf.resnet_stack_composition(blocks, xt, _t(mp))
        (sum((o * (i + 1)).sum() for i, o in enumerate(outs))
         + (out * r).sum()).backward()
        return [xt.grad] + [p.grad for b in blocks for p in b.parameters()]

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


UNET = dict(in_channels=4, channels=32, multipliers=(1, 2, 4),
            factors=(2, 2), num_blocks=(2, 2), attentions=(1, 1),
            attention_heads=2, attention_features=16, attention_multiplier=2,
            context_embedding_features=16, context_embedding_max_length=6)


@pytest.fixture(scope="module")
def unet():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 4)).astype(np.float32)
    t = np.array([0.3, -0.7], np.float32)
    emb = rng.standard_normal((2, 6, 16)).astype(np.float32)
    jmod = JXUNet1d("cfg", **UNET)
    variables = jmod.init(jax.random.PRNGKey(6), _j(x), _j(t),
                          embedding=_j(emb))
    port = XUNet1d("cfg", **UNET)
    port.load_state_dict(state_dict_from_jax_params(variables["params"]),
                         strict=True)
    return jmod, variables, port.eval(), x, t, emb


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_unet_with_the_switch_on(unet, scale, monkeypatch):
    """A small CFG UNet (down and up runs at L 16 and 8) with the switch on:
    against JAX's UNet with ``enable_resnet_fusion`` in interpret mode, and
    against the port's switch-off composition."""
    jmod, variables, port, x, t, emb = unet
    try:
        jrf.enable_resnet_fusion(True)
        jtf._INTERPRET = True
        want = np.asarray(jmod.apply(variables, _j(x), _j(t),
                                     embedding=_j(emb), embedding_scale=scale))
    finally:
        jrf.enable_resnet_fusion(False)
        jtf._INTERPRET = False
    args = (_t(x), _t(t))
    calls = []
    real = rf.resnet_stack_forward
    monkeypatch.setattr(rf, "resnet_stack_forward",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    with torch.no_grad():
        off = port(*args, embedding=_t(emb), embedding_scale=scale)
        assert not calls
        rf.enable_resnet_fusion(True)
        try:
            on = port(*args, embedding=_t(emb), embedding_scale=scale)
        finally:
            rf.enable_resnet_fusion(False)
    # two down runs and two up runs each eval; the bottleneck stays modules
    assert len(calls) == 4
    assert _max_diff(on, want) <= UNET_TOL
    assert _max_diff(on, off.numpy()) <= UNET_TOL


def test_switch_is_off_by_default_and_gates():
    assert not rf.resnet_fusion_enabled()
    _, blocks, x, _ = _down_case(False, n=1)
    assert rf.fusable(_t(x), blocks, 8)
    assert not rf.fusable(_t(x), blocks, 7)
    assert not rf.fusable(_t(x), [], 8)


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card never reaches
    the plain version: the wrapper raises."""
    _, blocks, x, _ = _down_case(False, n=1)
    ws = rf.kernel_weights(blocks, torch.float32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rf.resnet_stack_forward(ws, torch.zeros(4, 16, 32, device="meta"),
                                None)


def _port_blocks(cins, cout, cm, seed=40):
    """Blocks of the port alone, initialised from a seed (no JAX)."""
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    gen = torch.Generator().manual_seed(seed)
    blocks = [tb.ResnetBlock1d(cin, cout, num_groups=8,
                               context_mapping_features=cm) for cin in cins]
    for blk in blocks:
        init_parameters(blk, gen)
    return blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_film_weights_are_one_matrix_and_follow_the_parameters(dtype):
    """``kernel_weights`` lays the blocks' FiLM weights and biases out as
    consecutive rows of one matrix (the kernel's one FiLM product a run),
    equal to each block's own; ``WeightCache`` builds them once per
    parameter version and again after an in-place change."""
    blocks = _port_blocks([64, 64, 64], 32, CM)
    cache = rf.WeightCache()
    ws = cache.get(blocks, dtype)
    assert cache.get(blocks, dtype) is ws            # not rebuilt a call
    assert rf.film_contiguous(ws)

    def same(weights):
        for blk, w in zip(blocks, weights):
            dense = blk.to_scale_shift.to_scale_shift[1]
            assert w[4].dtype == dtype and w[5].dtype == torch.float32
            assert torch.equal(w[4], dense.weight.detach().to(dtype))
            assert torch.equal(w[5], dense.bias.detach().float())

    same(ws)
    with torch.no_grad():
        blocks[1].to_scale_shift.to_scale_shift[1].weight.add_(1.0)
    again = cache.get(blocks, dtype)
    assert again is not ws and rf.film_contiguous(again)
    same(again)
    assert not torch.equal(again[1][4], ws[1][4])
    # a list whose FiLM entries are separate tensors is not one matrix
    apart = [[w.clone() for w in blk] for blk in ws]
    assert not rf.film_contiguous(apart)


@pytest.mark.parametrize("cins,cout,cm,want", [
    ([32, 32, 32], 32, CM, 7),        # a down run of 3: 2 convs a block + FiLM
    ([64, 64, 64, 64], 32, CM, 13),   # an up run of 4: + 4 projections
    ([32, 32, 32], 32, None, 6),      # no mapping: no FiLM product
    ([64, 32], 32, CM, 6)])           # only the widening block projects
def test_tc_products_follow_the_run(cins, cout, cm, want):
    """The tensor-core products a bf16 kernel call sends (what the card's
    smoke run and tests hold the kernel's count to) follow from the run."""
    ws = rf.kernel_weights(_port_blocks(cins, cout, cm), torch.bfloat16)
    assert rf.tc_products(ws, cm is not None) == want


def test_conv3_at_length_one_is_the_centre_tap():
    """At L = 1 both neighbours of a row are the zero padding: the k3 conv
    is the product with W's centre column block (the kernel's K = C
    product, read in place through W's row stride)."""
    blocks = _port_blocks([32], 32, None)
    w, b = rf.kernel_weights(blocks, torch.float32)[0][2:4]
    v = torch.randn(5, 1, 32, generator=torch.Generator().manual_seed(41))
    got = rf._conv3(v, w, b)
    want = v @ w[:, 32:64].t() + b
    assert _max_diff(got, want.numpy()) <= 1e-6
