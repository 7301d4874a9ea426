"""The Transformer1d stack kernels (``csrc/transformer1d_fwd.cu`` with and
without its stash, and the backward chain of ``csrc/transformer1d_bwd.cu``)
against their plain PyTorch versions on an NVIDIA card, at the stack shapes
of the 91M inverse QM9 model.  Marked ``cuda_hw``: every test skips without
a CUDA card (decided inside the fixture).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: 1e-4 in float32 with TF32 off (only the order of float32 sums
differs) and 2e-2 in bfloat16 on unit-scale inputs (the JAX fused-vs-
composition band, 0.016); backward outputs are held to the same fractions of
each tensor's largest magnitude, since weight grads sum over all b*L rows."""
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.nn.attention import Transformer1d
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

pytestmark = pytest.mark.cuda_hw

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (L, C, layers, cross) of the flagship's stacks
STACKS = [(8, 256, 2, False), (8, 256, 4, True), (2, 512, 2, False),
          (2, 512, 4, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _stack(dev, length, c, layers, cross, dtype, batch=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mod = Transformer1d(layers, c, 8, 64, 2,
                        context_features=128 if cross else None, dtype=dtype)
    init_parameters(mod, gen)
    x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
    ctx = (torch.randn(batch, 12, 128, generator=gen).to(dev, dtype)
           if cross else None)
    return mod.to(dev), x, ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross", STACKS)
def test_kernel_matches_plain_version(cuda, length, c, layers, cross, dtype):
    mod, x, ctx = _stack(cuda, length, c, layers, cross, dtype)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    with torch.no_grad():
        before = tf.LAUNCHES
        out = tf.transformer1d_forward(mod.kernel_params(), x, ctx, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES == before + 1
        ref = tf.transformer1d_reference(mod.kernel_params(), x, ctx, **kw)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_module_dispatches_to_kernel(cuda):
    mod, x, ctx = _stack(cuda, 8, 256, 1, True, torch.float32, batch=4)
    with torch.no_grad():
        before = tf.LAUNCHES
        out = mod(x, ctx)
        assert tf.LAUNCHES == before + 1
        mod.disable_fusion = True
        composed = mod(x, ctx)
        assert tf.LAUNCHES == before + 1
    assert (out - composed).abs().max().item() <= TOL[torch.float32]


def test_kernel_refuses_what_it_does_not_take(cuda):
    mod, x, _ = _stack(cuda, 8, 256, 1, False, torch.float32, batch=4)
    kw = dict(num_layers=1, heads=8, head_dim=64, multiplier=2)
    params = mod.kernel_params()
    with pytest.raises(ValueError, match="contiguous"):
        tf.transformer1d_forward(params, x.transpose(0, 1), None, **kw)
    with pytest.raises(TypeError):
        tf.transformer1d_forward(params, x.half(), None, **kw)
    long = torch.zeros(2, tf.MAX_LENGTH + 1, 256, device=cuda)
    with pytest.raises(ValueError, match="L <="):
        tf.transformer1d_forward(params, long, None, **kw)


TRAIN_BATCH = 512    # the training micro-batch (2 x 512 = batch 1024)


def _within(got, want, dtype, what):
    scale = max(want.float().abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, f"{what}: {err} > {TOL[dtype]} x {scale}"


def _chain_case(dev, length, c, layers, cross, dtype, batch=TRAIN_BATCH):
    """A stack, its inputs, the plain forward's stash and an output grad."""
    mod, x, ctx = _stack(dev, length, c, layers, cross, dtype, batch=batch)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    kp = mod.kernel_params()
    with torch.no_grad():
        out, stash = tf.transformer1d_reference(kp, x, ctx, with_stash=True,
                                                **kw)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(
        dev, dtype)
    return mod, kp, x, ctx, out, stash, g, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross", STACKS)
def test_stash_forward_matches_plain_version(cuda, length, c, layers, cross,
                                             dtype):
    _, kp, x, ctx, out, stash, _, kw = _chain_case(cuda, length, c, layers,
                                                   cross, dtype)
    before = (tf.LAUNCHES, tf.STASH_LAUNCHES)
    with torch.no_grad():
        got, got_stash = tf.transformer1d_forward(kp, x, ctx, with_stash=True,
                                                  **kw)
    torch.cuda.synchronize()
    assert (tf.LAUNCHES, tf.STASH_LAUNCHES) == (before[0], before[1] + 1)
    # each layer's self, cross and feed-forward input, then conv out's
    assert got_stash.shape == stash.shape == (
        layers * (3 if cross else 2) + 1, *x.shape)
    _within(got, out, dtype, "out")
    for i in range(stash.shape[0]):
        _within(got_stash[i], stash[i], dtype, f"slot {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross", STACKS)
def test_backward_kernels_match_plain_versions(cuda, length, c, layers,
                                               cross, dtype):
    """K3, every layer's K2 and K4, each on the plain stash, output by
    output."""
    _, kp, x, ctx, _, stash, g, kw = _chain_case(cuda, length, c, layers,
                                                 cross, dtype)
    w = tf._kernel_weights(kp, layers, cross, dtype)
    with torch.no_grad():
        got = tf.bwd_conv_out(g, stash[-1], w[-2])
        want = tf.bwd_conv_out_reference(g, stash[-1], w[-2])
        for name, a, b in zip(["dy", "dW", "db"], got, want):
            _within(a, b, dtype, f"K3 {name}")
        per_layer, per_stash = (20, 3) if cross else (12, 2)
        ctx_dt = ctx.to(dtype) if cross else None
        for i in range(layers):
            lw = w[4 + i * per_layer:4 + (i + 1) * per_layer]
            args = (g, stash[i * per_stash],
                    stash[i * per_stash + 1] if cross else None,
                    stash[i * per_stash + per_stash - 1], ctx_dt, lw)
            got = tf.bwd_layer(*args, heads=8, head_dim=64)
            want = tf.bwd_layer_reference(*args, heads=8, head_dim=64)
            _within(got[0], want[0], dtype, f"K2 layer {i} dy")
            if cross:
                _within(got[1], want[1], dtype, f"K2 layer {i} dctx")
            for j, (a, b) in enumerate(zip(got[2], want[2])):
                _within(a, b, dtype, f"K2 layer {i} grad {j}")
        got = tf.bwd_conv_in_gn(g, x, w[2], w[0], w[1])
        want = tf.bwd_conv_in_gn_reference(g, x, w[2], w[0], w[1])
        for name, a, b in zip(["dx", "dW", "db", "dgamma", "dbeta"], got,
                              want):
            _within(a, b, dtype, f"K4 {name}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_chain_is_bitwise_deterministic(cuda, dtype):
    """No float atomics: two backward calls on the same inputs agree bit for
    bit."""
    _, kp, x, ctx, _, stash, g, kw = _chain_case(cuda, 8, 256, 4, True,
                                                 dtype)
    runs = [tf.transformer1d_backward(kp, x, ctx, stash, g, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    (g1, dx1, dc1), (g2, dx2, dc2) = runs
    assert torch.equal(dx1, dx2) and torch.equal(dc1, dc2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


def test_dispatch_gives_gradients_on_the_card(cuda):
    """Through the module on the card, x, the context and every stack
    parameter get gradients, from the stash forward and the backward
    kernels, equal to the module composition's."""
    mod, x, ctx = _stack(cuda, 8, 256, 2, True, torch.float32, batch=16)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(
        cuda)

    def grads(fused):
        mod.disable_fusion = not fused
        mod.zero_grad(set_to_none=True)
        xx, cc = x.clone().requires_grad_(), ctx.clone().requires_grad_()
        (mod(xx, cc) * r).sum().backward()
        out = {n: p.grad for n, p in mod.named_parameters()}
        out["x"], out["context"] = xx.grad, cc.grad
        return out

    before = (tf.STASH_LAUNCHES, tf.CONV_OUT_BWD_LAUNCHES,
              tf.LAYER_BWD_LAUNCHES, tf.CONV_IN_GN_BWD_LAUNCHES)
    got = grads(True)
    torch.cuda.synchronize()
    assert (tf.STASH_LAUNCHES, tf.CONV_OUT_BWD_LAUNCHES,
            tf.LAYER_BWD_LAUNCHES, tf.CONV_IN_GN_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 1)
    want = grads(False)
    for name, g in got.items():
        assert g is not None, f"{name} got no gradient"
        _within(g, want[name], torch.float32, name)
