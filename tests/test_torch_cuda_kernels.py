"""The Transformer1d stack kernels (``csrc/transformer1d_fwd.cu`` with and
without its stash and with a uniform context, and the backward chain of
``csrc/transformer1d_bwd.cu``), their GEMM alone (``csrc/gemm_tc.cuh``,
through the ``t1d_gemm_tc`` entry) and the resnet-run kernel
(``csrc/resnet_fwd.cu``) against their plain PyTorch versions on an NVIDIA
card, at the shapes of the 91M inverse and the 18M forward QM9 models; the
streaming-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) at the long model's shapes; and the
resident-KV attention kernels (``csrc/attention.cu``) at the micro-shapes of
those models and of the AR transformer's decode step.
Marked ``cuda_hw``: every test skips without a CUDA card (decided inside
the fixture).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: 1e-4 in float32 with TF32 off (only the order of float32 sums
differs) and 2e-2 in bfloat16 on unit-scale inputs (the JAX fused-vs-
composition band, 0.016); backward outputs are held to the same fractions of
each tensor's largest magnitude, since weight grads sum over all b*L rows."""
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.nn.attention import Transformer1d
from moleculediffusiontransformer_tpu_torch.nn.blocks import ResnetBlock1d
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

pytestmark = pytest.mark.cuda_hw

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (L, C, layers, cross) of the flagship's stacks
STACKS = [(8, 256, 2, False), (8, 256, 4, True), (2, 512, 2, False),
          (2, 512, 4, True)]
# (L, C, layers, cross, batch, context length) of the stack kernels' cases:
# the flagship's stacks at the test's own batch (None), then at batch 1 and
# 3 (products of 1 to 24 rows), and the 18M forward preset's stacks
# (context 64)
STACK_CASES = [(*st, None, 12) for st in STACKS] + [
    (8, 256, 4, True, 1, 12), (8, 256, 4, True, 3, 12),
    (2, 512, 2, False, 1, 12), (2, 512, 4, True, 3, 12),
    (4, 128, 2, True, None, 64), (1, 256, 2, True, None, 64),
    (4, 128, 2, True, 1, 64), (1, 256, 2, True, 3, 64)]


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


def _stack(dev, length, c, layers, cross, dtype, batch=128, seed=0,
           ctx_len=12):
    gen = torch.Generator().manual_seed(seed)
    mod = Transformer1d(layers, c, 8, 64, 2,
                        context_features=128 if cross else None, dtype=dtype)
    init_parameters(mod, gen)
    x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
    ctx = (torch.randn(batch, ctx_len, 128, generator=gen).to(dev, dtype)
           if cross else None)
    return mod.to(dev), x, ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross,batch,ctx_len", STACK_CASES)
def test_kernel_matches_plain_version(cuda, length, c, layers, cross, batch,
                                      ctx_len, dtype):
    """Every bf16 product of the stack goes to the tensor cores, every
    float32 one to the CUDA cores."""
    mod, x, ctx = _stack(cuda, length, c, layers, cross, dtype,
                         batch=batch or 128, ctx_len=ctx_len)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    with torch.no_grad():
        before = tf.LAUNCHES
        products = tf.gemm_tc_launches()
        out = tf.transformer1d_forward(mod.kernel_params(), x, ctx, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES == before + 1
        assert tf.gemm_tc_launches() - products == (
            tf.stack_products(layers, cross) if dtype == torch.bfloat16 else 0)
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


def test_head_256_takes_the_composition_on_the_card(cuda):
    """A head size past ``MAX_HEAD_DIM`` is the composition's: the module
    runs on the card and launches no stack kernel (the wrapper itself
    refuses that geometry)."""
    gen = torch.Generator().manual_seed(3)
    mod = Transformer1d(1, 64, 2, 256, 2, context_features=32)
    init_parameters(mod, gen)
    mod = mod.to(cuda)
    x = torch.randn(4, 8, 64, generator=gen).to(cuda)
    ctx = torch.randn(4, 12, 32, generator=gen).to(cuda)
    names = ("LAUNCHES", "STASH_LAUNCHES", "UNIFORM_LAUNCHES")
    before = [getattr(tf, name) for name in names]
    x.requires_grad_()
    out = mod(x, ctx)
    out.sum().backward()
    torch.cuda.synchronize()
    assert [getattr(tf, name) for name in names] == before
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert torch.isfinite(x.grad).all()
    mod.disable_fusion = True
    with torch.no_grad():
        # the same composition either way: only cuBLAS's choice of algorithm
        # could differ between the two calls
        assert (mod(x, ctx) - out).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="head_dim"):
        tf.transformer1d_forward(mod.kernel_params(), x.detach(), ctx,
                                 num_layers=1, heads=2, head_dim=256,
                                 multiplier=2)


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


def _chain_case(dev, length, c, layers, cross, dtype, batch=TRAIN_BATCH,
                ctx_len=12):
    """A stack, its inputs, the plain forward's stash and an output grad."""
    mod, x, ctx = _stack(dev, length, c, layers, cross, dtype,
                         batch=batch or TRAIN_BATCH, ctx_len=ctx_len)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    kp = mod.kernel_params()
    with torch.no_grad():
        out, stash = tf.transformer1d_reference(kp, x, ctx, with_stash=True,
                                                **kw)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(
        dev, dtype)
    return mod, kp, x, ctx, out, stash, g, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross,batch,ctx_len", STACK_CASES)
def test_stash_forward_matches_plain_version(cuda, length, c, layers, cross,
                                             batch, ctx_len, dtype):
    _, kp, x, ctx, out, stash, _, kw = _chain_case(
        cuda, length, c, layers, cross, dtype, batch, ctx_len)
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
@pytest.mark.parametrize("length,c,layers,cross,batch,ctx_len", STACK_CASES)
def test_backward_kernels_match_plain_versions(cuda, length, c, layers,
                                               cross, batch, ctx_len, dtype):
    """K3, every layer's K2 and K4, each on the plain stash, output by
    output; the bf16 products of all three on the tensor cores."""
    _, kp, x, ctx, _, stash, g, kw = _chain_case(
        cuda, length, c, layers, cross, dtype, batch, ctx_len)
    w = tf._kernel_weights(kp, layers, cross, dtype)
    conv_products = tf.CONV_BWD_PRODUCTS if dtype == torch.bfloat16 else 0
    with torch.no_grad():
        products = tf.gemm_tc_launches()
        got = tf.bwd_conv_out(g, stash[-1], w[-2])
        assert tf.gemm_tc_launches() - products == conv_products
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
            products = tf.gemm_tc_launches()
            got = tf.bwd_layer(*args, heads=8, head_dim=64)
            assert tf.gemm_tc_launches() - products == (
                tf.stack_products(1, cross, backward=True)
                if dtype == torch.bfloat16 else 0)
            want = tf.bwd_layer_reference(*args, heads=8, head_dim=64)
            _within(got[0], want[0], dtype, f"K2 layer {i} dy")
            if cross:
                _within(got[1], want[1], dtype, f"K2 layer {i} dctx")
            for j, (a, b) in enumerate(zip(got[2], want[2])):
                _within(a, b, dtype, f"K2 layer {i} grad {j}")
        products = tf.gemm_tc_launches()
        got = tf.bwd_conv_in_gn(g, x, w[2], w[0], w[1])
        assert tf.gemm_tc_launches() - products == conv_products
        want = tf.bwd_conv_in_gn_reference(g, x, w[2], w[0], w[1])
        for name, a, b in zip(["dx", "dW", "db", "dgamma", "dbeta"], got,
                              want):
            _within(a, b, dtype, f"K4 {name}")
    torch.cuda.synchronize()


# C of K3 and K4 (the 18M model's 128, the 91M model's 256 and 512, and the
# smallest the kernels take) and their rows at L 1: one row, a few, and the
# 91M model's batch 512 at L 4 and L 8 (the row-split column sums and weight
# grads split into chunks, the last one ragged at 4,096 rows and C 256)
CONV_C = [32, 128, 256, 512]
CONV_ROWS = [1, 24, 2048, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", CONV_ROWS)
@pytest.mark.parametrize("c", CONV_C)
def test_conv_backward_kernels_match_plain_versions(cuda, c, rows, dtype):
    """K3 and K4 against their plain versions, output by output; a bf16 call
    sends exactly its ``CONV_BWD_PRODUCTS`` products to the tensor cores and
    a float32 call none; two calls agree bit for bit (no float atomics in
    the split weight grads and column sums)."""
    gen = torch.Generator().manual_seed(rows + 7 * c)
    g, y, x = (torch.randn(rows, 1, c, generator=gen).to(cuda, dtype)
               for _ in range(3))
    w = (torch.randn(c, c, generator=gen) / c ** 0.5).to(cuda, dtype)
    gs = (1 + 0.1 * torch.randn(c, generator=gen)).to(cuda)
    gb = (0.1 * torch.randn(c, generator=gen)).to(cuda)
    conv_products = tf.CONV_BWD_PRODUCTS if dtype == torch.bfloat16 else 0
    for name, kernel, plain, args, outs in (
            ("K3", tf.bwd_conv_out, tf.bwd_conv_out_reference, (g, y, w),
             ["dy", "dW", "db"]),
            ("K4", tf.bwd_conv_in_gn, tf.bwd_conv_in_gn_reference,
             (g, x, w, gs, gb), ["dx", "dW", "db", "dgamma", "dbeta"])):
        with torch.no_grad():
            products = tf.gemm_tc_launches()
            got = kernel(*args)
            assert tf.gemm_tc_launches() - products == conv_products, name
            again = kernel(*args)
            want = plain(*args)
        torch.cuda.synchronize()
        for out, a, b, c2 in zip(outs, got, want, again):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, out)
            _within(a, b, dtype, f"{name} {out}")
            assert torch.equal(a, c2), f"{name} {out}: two calls differ"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross,batch,ctx_len", [
    (8, 256, 4, True, None, 12), (8, 256, 4, True, 3, 12),
    (4, 128, 2, True, 1, 64), (1, 256, 2, True, None, 64)])
def test_backward_chain_is_bitwise_deterministic(cuda, length, c, layers,
                                                 cross, batch, ctx_len,
                                                 dtype):
    """No float atomics: two backward calls on the same inputs agree bit for
    bit (the bf16 weight grads split over rows too)."""
    _, kp, x, ctx, _, stash, g, kw = _chain_case(
        cuda, length, c, layers, cross, dtype, batch, ctx_len)
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


# ---------------------------------- the stack GEMM alone (gemm_tc.cuh) ---

# rows of a product (M of nt and nn, the summed K of tn): a request of 1
# under CFG at L 1 (2), one context (12), a ragged tile (65), batch 128 and
# 1,024 at L 8
GEMM_ROWS = [2, 12, 65, 1024, 8192]
# (N, K) of nt and nn, (M, N) of the weight grad of tn; K 200 is a multiple
# of 8 but not of a 64-wide k-step
GEMM_NK = [(64, 1024), (128, 256), (256, 64), (1024, 128), (256, 200)]
# bf16 inputs, float32 sums in another order: the output's bf16 rounding is
# the larger term
GEMM_TOL = 1e-2


def _gemm_case(dev, layout, rows, n, k, dtype=torch.bfloat16, seed=0):
    """Operands of nt (x (rows, k), y (n, k)), nn (x (rows, k), y (k, n))
    and tn (x (rows, n), y (rows, k): the (n, k) weight grad)."""
    gen = torch.Generator().manual_seed(seed + rows + 7 * n + 13 * k)
    shapes = {"nt": ((rows, k), (n, k)), "nn": ((rows, k), (k, n)),
              "tn": ((rows, n), (rows, k))}[layout]
    return [torch.randn(sh, generator=gen).to(dev, dtype) for sh in shapes]


def _gemm_within(got, want, what):
    scale = max(want.float().abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GEMM_TOL * scale, f"{what}: {err} > {GEMM_TOL} x {scale}"


@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("rows", GEMM_ROWS)
@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_gemm_tc_matches_matmul(cuda, layout, rows, n, k):
    """Each layout on the tensor cores against torch.matmul of the same bf16
    operands in float32; the weight grad (tn) with its rows split as K2
    splits them."""
    x, y = _gemm_case(cuda, layout, rows, n, k)
    odt = torch.float32 if layout == "tn" else torch.bfloat16
    info = {}
    before = tf.gemm_tc_launches()
    out, _ = tf.gemm_tc(x, y, layout, out_dtype=odt,
                        split=layout == "tn", info=info)
    torch.cuda.synchronize()
    assert tf.gemm_tc_launches() == before + 1 and info["route"] in (1, 2)
    a, b = x.float(), y.float()
    want = {"nt": lambda: torch.matmul(a, b.t()),
            "nn": lambda: torch.matmul(a, b),
            "tn": lambda: torch.matmul(a.t(), b)}[layout]()
    assert out.dtype == odt and out.shape == want.shape
    _gemm_within(out, want, f"{layout} rows {rows} n {n} k {k}")


# (layout, epilogue, output type): each epilogue where K1 and K2 use it
GEMM_EPILOGUES = [("nt", "none", torch.bfloat16), ("nt", "bias", torch.bfloat16),
                  ("nt", "bias", torch.float32),
                  ("nt", "bias_res", torch.bfloat16),
                  ("nt", "bias_gelu", torch.bfloat16),
                  ("nn", "none", torch.bfloat16), ("nn", "res", torch.float32),
                  ("nn", "mul", torch.float32), ("tn", "none", torch.float32)]


@pytest.mark.parametrize("rows", [2, 65, 1024])
@pytest.mark.parametrize("layout,epi,odt", GEMM_EPILOGUES)
def test_gemm_tc_epilogues(cuda, layout, epi, odt, rows):
    """Every epilogue against the product in float32 plus the epilogue in
    plain PyTorch (``gemm_tc_reference``), with the second output (out_t)
    where K2 asks for it (dh, EPI_MUL)."""
    n, k = 256, 128
    x, y = _gemm_case(cuda, layout, rows, n, k)
    shape = (n, k) if layout == "tn" else (rows, n)
    gen = torch.Generator().manual_seed(rows)
    extra = {}
    if epi in ("bias", "bias_res", "bias_gelu"):
        extra["bias"] = torch.randn(shape[1], generator=gen).to(cuda)
    if epi in ("bias_res", "res"):
        extra["res"] = torch.randn(shape, generator=gen).to(cuda, odt)
    if epi == "mul":
        extra["mul"] = torch.randn(shape, generator=gen).to(cuda)
    kw = dict(epi=epi, out_dtype=odt, want_out_t=epi == "mul", **extra)
    info = {}
    out, out_t = tf.gemm_tc(x, y, layout, info=info, **kw)
    want, want_t = tf.gemm_tc_reference(x, y, layout, **kw)
    torch.cuda.synchronize()
    assert info["route"] in (1, 2)
    _gemm_within(out, want, f"{layout} {epi}")
    if want_t is not None:
        assert out_t.dtype == x.dtype
        _gemm_within(out_t, want_t, f"{layout} {epi} out_t")


# (rows, n, k, whether the 64-row k-steps fall into chunks of one length):
# K2's dW_out of the L 8 C 256 stacks at batch 512 (8 chunks of 8 k-steps)
# and their dW_kv at batch 1,024 (9 chunks of 15 k-steps, the last of 8)
SPLIT_CASES = [(4096, 256, 512, True), (8192, 1024, 256, False)]


@pytest.mark.parametrize("rows,n,k,even", SPLIT_CASES)
def test_gemm_tc_split_rows_is_bitwise_repeatable(cuda, rows, n, k, even):
    """A weight grad split over its rows into chunks as K2 splits it: two
    calls agree bit for bit, and with the unsplit sum."""
    x, y = _gemm_case(cuda, "tn", rows, n, k)
    runs, info = [], {}
    for _ in range(2):
        runs.append(tf.gemm_tc(x, y, "tn", out_dtype=torch.float32,
                               split=True, info=info)[0])
    whole, _ = tf.gemm_tc(x, y, "tn", out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert info["splits"] > 1
    assert ((rows // 64) % info["splits"] == 0) == even
    assert torch.equal(runs[0], runs[1])
    _gemm_within(runs[0], whole, "split against unsplit")
    _gemm_within(runs[0], torch.matmul(x.float().t(), y.float()), "split")


def test_gemm_tc_route(cuda):
    """The route is the dtype's and the shape's: bf16 with 16-byte rows takes
    the tensor cores (64 x 64 blocks for a few rows, 128 x 128 when that
    grid fills the card), float32 and a K that is not a multiple of 8 take
    the CUDA cores, which the tensor-core count does not see."""
    def run(x, y, layout="nt", **kw):
        info = {}
        before = tf.gemm_tc_launches()
        out, _ = tf.gemm_tc(x, y, layout, info=info, **kw)
        torch.cuda.synchronize()
        return out, info["route"], tf.gemm_tc_launches() - before

    x, y = _gemm_case(cuda, "nt", 2, 256, 128)
    assert run(x, y)[1:] == (1, 1)
    x, y = _gemm_case(cuda, "nt", 8192, 1024, 128)
    assert run(x, y)[1:] == (2, 1)
    x, y = _gemm_case(cuda, "tn", 4096, 256, 256)
    assert run(x, y, "tn", out_dtype=torch.float32, split=True)[1:] == (2, 1)
    x, y = _gemm_case(cuda, "nt", 65, 256, 128, dtype=torch.float32)
    out, route, launched = run(x, y)
    assert (route, launched) == (0, 0)
    _within(out, torch.matmul(x, y.t()), torch.float32, "float32")
    x, y = _gemm_case(cuda, "nt", 65, 256, 60)
    out, route, launched = run(x, y)
    assert (route, launched) == (0, 0)
    _gemm_within(out, torch.matmul(x.float(), y.float().t()), "K 60")


# ---------------------------------------------- K8, the resnet-run kernel ---

# (L, C, blocks, layout, C_m): the resnet runs of the 91M inverse preset and
# the 18M forward preset (L 1: the centre tap alone); a single block (the
# bottleneck's shape); an L that does not divide 64; a group too long for
# the GroupNorm kernel's registers (L 1,024 x 8 channels); a group row of 4
# bf16 values (no 16-byte vectors); and a down run without collect, whose
# conv 2 writes in place over its residual.  "single" and "flat": no skips,
# no collect.
RUNS = [(8, 256, 3, "down", 512), (2, 512, 3, "down", 512),
        (2, 512, 4, "up", 512), (8, 256, 4, "up", 512),
        (4, 128, 3, "down", 256), (1, 256, 3, "down", 256),
        (1, 256, 4, "up", 256), (4, 128, 4, "up", 256),
        (2, 512, 1, "single", 512), (12, 128, 2, "down", 64),
        (1024, 64, 2, "down", 64), (16, 32, 2, "down", 64),
        (8, 256, 3, "flat", 512)]
RESNET_BATCH = 256


def _resnet_case(dev, length, c, n, layout, cm, dtype, batch=RESNET_BATCH,
                 seed=0):
    gen = torch.Generator().manual_seed(seed)
    cin = 2 * c if layout == "up" else c
    blocks = [ResnetBlock1d(cin, c, num_groups=8, context_mapping_features=cm)
              for _ in range(n)]
    for blk in blocks:
        init_parameters(blk, gen)
        with torch.no_grad():
            for p in blk.parameters():
                if p.dim() == 1:     # non-trivial norm scales and biases
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
    blocks = [blk.to(dev) for blk in blocks]
    x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
    mp = torch.randn(batch, cm, generator=gen).to(dev, dtype)
    skips = ([torch.randn(batch, length, c, generator=gen).to(dev, dtype)
              for _ in range(n)] if layout == "up" else None)
    kw = dict(skip_scale=2 ** -0.5 if layout == "up" else 1.0,
              collect=layout == "down")
    return blocks, rf.kernel_weights(blocks, dtype), x, mp, skips, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,n,layout,cm", RUNS)
def test_resnet_kernel_matches_plain_version(cuda, length, c, n, layout, cm,
                                             dtype):
    """All three layouts; every bf16 product on the tensor cores (a float32
    call sends none there); two calls agree bit for bit."""
    _, w, x, mp, skips, kw = _resnet_case(cuda, length, c, n, layout, cm,
                                          dtype)
    with torch.no_grad():
        before = rf.RESNET_LAUNCHES
        products = rf.gemm_tc_launches()
        out, outs = rf.resnet_stack_forward(w, x, mp, skips, **kw)
        torch.cuda.synchronize()
        assert rf.RESNET_LAUNCHES == before + 1
        assert rf.gemm_tc_launches() - products == (
            rf.tc_products(w, True) if dtype == torch.bfloat16 else 0)
        ref, ref_outs = rf.resnet_stack_reference(w, x, mp, skips, **kw)
        again, _ = rf.resnet_stack_forward(w, x, mp, skips, **kw)
    assert out.dtype == dtype and out.shape == (RESNET_BATCH, length, c)
    _within(out, ref, dtype, "out")
    assert len(outs) == len(ref_outs) == (n if kw["collect"] else 0)
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        _within(a, b, dtype, f"block {i}")
    assert torch.equal(out, again)


def test_resnet_kernel_refuses_what_it_does_not_take(cuda):
    _, w, x, mp, skips, kw = _resnet_case(cuda, 2, 512, 2, "up", 512,
                                          torch.float32, batch=4)
    with pytest.raises(ValueError, match="contiguous"):
        rf.resnet_stack_forward(w, x.transpose(0, 1), mp, skips, **kw)
    with pytest.raises(TypeError):
        rf.resnet_stack_forward(w, x.half(), mp, skips, **kw)
    with pytest.raises(ValueError, match="block 0"):
        rf.resnet_stack_forward(w, x, mp, None, **kw)   # skips missing
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rf.resnet_stack_forward(w, x.cpu(), mp, skips, **kw)
    apart = [[t.clone() for t in ws] for ws in w]   # FiLM not one matrix
    with pytest.raises(ValueError, match="FiLM"):
        rf.resnet_stack_forward(apart, x, mp, skips, **kw)


def test_resnet_grads_on_the_card(cuda):
    """The autograd function (kernel forward, autograd of the composition
    backward) against autograd of the module composition, on the card."""
    blocks, w, x, mp, skips, kw = _resnet_case(cuda, 8, 256, 4, "up", 512,
                                               torch.float32, batch=32)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(
        cuda)

    def grads(fused):
        for blk in blocks:
            blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        if fused:
            out, _ = rf.resnet_stack(blocks, w, xx, mp, skips, **kw)
        else:
            out, _ = rf.resnet_stack_composition(
                blocks, xx, mp, skips, skip_scale=kw["skip_scale"])
        (out * r).sum().backward()
        return [xx.grad] + [p.grad for blk in blocks
                            for p in blk.parameters()]

    before = rf.RESNET_LAUNCHES
    got = grads(True)
    assert rf.RESNET_LAUNCHES == before + 1
    for a, b in zip(got, grads(False)):
        _within(a, b, torch.float32, "grad")


# ------------------------------- K1 uniform_ctx, the shared-KV null half ---

# (L, C, layers, m, batch): the cross stacks of the inverse preset (context
# 12) and of the forward preset (context 64) at batch 128, and null halves
# of 1 and 3 requests
UNIFORM = [(8, 256, 4, 12, 128), (2, 512, 4, 12, 128), (4, 128, 2, 64, 128),
           (1, 256, 2, 64, 128), (8, 256, 4, 12, 1), (2, 512, 4, 12, 3),
           (4, 128, 2, 64, 3), (1, 256, 2, 64, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,m,batch", UNIFORM)
def test_uniform_kernel_matches_plain_version(cuda, length, c, layers, m,
                                              batch, dtype):
    gen = torch.Generator().manual_seed(length * c)
    mod = Transformer1d(layers, c, 8, 64, 2, context_features=128,
                        dtype=dtype)
    init_parameters(mod, gen)
    mod = mod.to(cuda)
    x = torch.randn(batch, length, c, generator=gen).to(cuda, dtype)
    table = torch.randn(1, m, 128, generator=gen).to(cuda, dtype)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    kp = mod.kernel_params()
    with torch.no_grad():
        before = (tf.LAUNCHES, tf.UNIFORM_LAUNCHES)
        products = tf.gemm_tc_launches()
        out = tf.transformer1d_forward(kp, x, table, uniform_ctx=True, **kw)
        torch.cuda.synchronize()
        assert (tf.LAUNCHES, tf.UNIFORM_LAUNCHES) == (before[0],
                                                      before[1] + 1)
        assert tf.gemm_tc_launches() - products == (
            tf.stack_products(layers, True) if dtype == torch.bfloat16 else 0)
        ref = tf.transformer1d_reference(kp, x, table, uniform_ctx=True,
                                         **kw)
        per_row = tf.transformer1d_forward(
            kp, x, table.expand(batch, m, 128).contiguous(), **kw)
    _within(out, ref, dtype, "out")
    _within(out, per_row, dtype, "against the per-row kernel")
    with pytest.raises(ValueError, match="uniform_ctx"):
        tf.transformer1d_forward(kp, x, table.expand(2, m, 128),
                                 uniform_ctx=True, **kw)


def test_unet_dispatches_to_the_new_kernels(cuda):
    """A small CFG UNet on the card with both switches on: each resnet run
    (whose input is a conv's channels-last view) goes through K8, each
    cross stack's null half through the uniform-context kernel, and the
    output equals the switch-off composition's."""
    from moleculediffusiontransformer_tpu_torch.nn.unet import XUNet1d
    unet = XUNet1d("cfg", in_channels=4, channels=64, multipliers=(1, 2, 4),
                   factors=(2, 2), num_blocks=(2, 2), attentions=(1, 1),
                   attention_heads=2, attention_features=32,
                   attention_multiplier=2, context_embedding_features=128,
                   context_embedding_max_length=12)
    init_parameters(unet, torch.Generator().manual_seed(8))
    unet = unet.to(cuda).eval()
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 32, 4, generator=gen).to(cuda)
    t = torch.rand(4, generator=gen).to(cuda)
    emb = torch.randn(4, 12, 128, generator=gen).to(cuda)
    with torch.no_grad():
        off = unet(x, t, embedding=emb, embedding_scale=2.0)
        before = (rf.RESNET_LAUNCHES, tf.UNIFORM_LAUNCHES)
        rf.enable_resnet_fusion(True)
        tf.enable_sharedkv(True)
        try:
            on = unet(x, t, embedding=emb, embedding_scale=2.0)
        finally:
            rf.enable_resnet_fusion(False)
            tf._SHAREDKV = None
    torch.cuda.synchronize()
    # 2 down and 2 up runs; 2 down, the bottleneck's and 2 up cross stacks
    assert (rf.RESNET_LAUNCHES, tf.UNIFORM_LAUNCHES) == (before[0] + 4,
                                                         before[1] + 5)
    _within(on, off, torch.float32, "UNet")


# ---------------------------------------------------------------- K5, K6, K7

def _flash_case(dev, bh, n, m, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shapes = [(bh, n, d), (bh, m, d), (bh, m, d), (bh, n, d)]
    return [torch.randn(s, generator=gen).to(dev, dtype) for s in shapes]


# (bh, n, m, d): the long model's attention (8 heads of 64 at 4096 tokens),
# a rectangular case, and the other head sizes the kernels are built for
FLASH_CASES = [(16, 4096, 4096, 64), (4, 2048, 4096, 64), (3, 256, 384, 16),
               (2, 384, 128, 32), (2, 256, 256, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,m,d", FLASH_CASES)
def test_flash_forward_matches_plain_version(cuda, bh, n, m, d, dtype):
    """K5 at every head size it is built for (bf16: ``mma.sync`` at 16 and
    32, ``wgmma`` at 64 and 128) against its plain version; three calls,
    with and without lse, give the same bits."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    q, k, v, _ = _flash_case(cuda, bh, n, m, d, dtype)
    scale = d ** -0.5
    before = fa.FLASH_FWD_LAUNCHES
    out, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
    bare, none = fa.flash_forward(q, k, v, scale)
    again, lse_again = fa.flash_forward(q, k, v, scale, with_lse=True)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_LAUNCHES == before + 3 and none is None
    assert torch.equal(out, bare) and torch.equal(out, again)
    assert torch.equal(lse, lse_again)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _within(out, ref, dtype, "o")
    _within(lse, ref_lse, torch.float32, "lse")


@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_forward_takes_any_scale(cuda, d, scale):
    """bf16 K5 (``mma.sync`` at d 16, ``wgmma`` at d 64) at a negative and a
    zero scale, which its running max over the raw scores must survive,
    against its plain version."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    q, k, v, _ = _flash_case(cuda, 2, 256, 384, d, torch.bfloat16, seed=3)
    out, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, scale)
    _within(out, ref, torch.bfloat16, "o")
    _within(lse, ref_lse, torch.float32, "lse")


@pytest.mark.parametrize("m,d", [(192, 64), (64, 128), (192, 32)])
def test_flash_forward_entry_takes_odd_kv_tiles(cuda, m, d):
    """The bf16 forward's entry point sweeps 64-row KV tiles, so it takes an
    odd count of them, which the wrapper's 128 rule never hands it."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    q, k, v, _ = _flash_case(cuda, 2, 128, m, d, torch.bfloat16, seed=4)
    o = torch.empty_like(q)
    err = fa._library().fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), None,
                                   *fa._args((q, k, v, o), q, k, d ** -0.5))
    torch.cuda.synchronize()
    assert err == 0
    _within(o, fa.flash_attention_reference(q, k, v, d ** -0.5)[0],
            torch.bfloat16, "o")


# the backward's further cases: the widest head at the long model's length,
# more query than KV rows, and the smallest shape the wrapper takes at every
# head size
FLASH_BWD_CASES = FLASH_CASES + [
    (8, 4096, 4096, 128), (16, 4096, 2048, 64), (2, 128, 128, 16),
    (2, 128, 128, 32), (2, 128, 128, 64), (2, 128, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,m,d", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_version(cuda, bh, n, m, d, dtype):
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    q, k, v, do = _flash_case(cuda, bh, n, m, d, dtype, seed=1)
    scale = d ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, scale)
    before = (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES)
    got = fa.flash_backward(q, k, v, o, lse, do, scale)
    again = fa.flash_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and torch.equal(g, a), name
        _within(g, w, dtype, name)


def test_flash_autograd_and_refusals(cuda):
    """``flash_attention`` under autograd on the card against autograd of
    the one-shot product, on split-head views; and what the wrappers
    refuse."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import sdpa
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    gen = torch.Generator().manual_seed(2)
    b, n, h, d = 2, 2048, 4, 64
    bufs = [torch.randn(b, n, h, d, generator=gen).to(cuda) for _ in range(4)]
    views = [t.transpose(1, 2).requires_grad_() for t in bufs[:3]]
    do = bufs[3].transpose(1, 2)
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    out = sdpa(*views, d ** -0.5, torch.float32)     # routes: n >= threshold
    got = torch.autograd.grad(out, views, do)
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == tuple(c + 1 for c in counts)
    sim = torch.matmul(views[0], views[1].transpose(-1, -2)) * d ** -0.5
    ref = torch.matmul(torch.softmax(sim, dim=-1), views[2])
    want = torch.autograd.grad(ref, views, do)
    _within(out, ref, torch.float32, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _within(g, w, torch.float32, name)

    q, k, v, _ = _flash_case(cuda, 2, 256, 256, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_forward(q[:, :200], k, v, 0.125)        # n % 128
    with pytest.raises(ValueError):
        fa.flash_forward(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="cannot address"):
        fa.flash_forward(torch.zeros(2, 1, 256, 128, device=cuda)[..., ::2],
                         k[:, None], v[:, None], 0.125)  # last stride 2
    with pytest.raises(ValueError):
        fa.flash_forward(q, k.cpu(), v, 0.125)


# (b, h, n, m, d) of the split-head cases: the long model's attention at
# batch 1 and a cross-attention case at every head size
SPLIT_HEAD_CASES = [(1, 8, 4096, 4096, 64), (2, 3, 256, 384, 16),
                    (2, 3, 384, 256, 32), (2, 3, 256, 384, 64),
                    (2, 3, 256, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,m,d", SPLIT_HEAD_CASES)
def test_flash_kernels_on_split_head_views(cuda, b, h, n, m, d, dtype):
    """K5, K6 and K7 read q and do as transposed views of (b, n, h, d)
    buffers and k, v as ``.chunk`` views of one (b, m, 2 h d) projection,
    and write o, dq, dk, dv in (b, rows, h, d) memory: bit for bit what the
    same values give contiguous, with one launch of each kernel a call."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    gen = torch.Generator().manual_seed(b + h + n + m + d)

    def split(t):
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

    q = split(torch.randn(b, n, h * d, generator=gen).to(cuda, dtype))
    k, v = (split(t) for t in torch.randn(
        b, m, 2 * h * d, generator=gen).to(cuda, dtype).chunk(2, dim=-1))
    do = split(torch.randn(b, n, h * d, generator=gen).to(cuda, dtype))
    flat = [t.contiguous() for t in (q, k, v)]
    scale = d ** -0.5
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    o, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
    got = fa.flash_backward(q, k, v, o, lse, do, scale)
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == tuple(c + 1 for c in counts)
    o_flat, lse_flat = fa.flash_forward(*flat, scale, with_lse=True)
    want = fa.flash_backward(*flat, o_flat, lse_flat, do.contiguous(), scale)
    torch.cuda.synchronize()
    assert o.shape == (b, h, n, d) and o.transpose(1, 2).is_contiguous()
    assert torch.equal(o, o_flat) and torch.equal(lse, lse_flat)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == t.shape and g.transpose(1, 2).is_contiguous(), name
        assert torch.equal(g, w), name


def test_flash_kernels_refuse_a_bad_stride(cuda):
    """Views the kernels cannot address raise before any launch: a row
    stride that is not a multiple of 16 bytes, a last dimension that is not
    unit-stride."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    good = torch.zeros(2, 256, 2, 64, device=cuda,
                       dtype=torch.bfloat16).transpose(1, 2)
    rows = torch.zeros(2, 256, 1, 68, device=cuda, dtype=torch.bfloat16)[
        ..., :64].transpose(1, 2)                        # 136-byte rows
    cols = torch.zeros(2, 2, 256, 128, device=cuda,
                       dtype=torch.bfloat16)[..., ::2]   # last stride 2
    before = fa.FLASH_FWD_LAUNCHES
    for bad in (rows, cols):
        with pytest.raises(ValueError, match="cannot address"):
            fa.flash_forward(bad, good[:, :bad.shape[1]], good[:, :bad.shape[
                1]], 0.125)
    with pytest.raises(ValueError, match="cannot address"):
        fa.flash_backward(good, good, good, good, torch.zeros(
            4, 256, device=cuda), cols, 0.125)
    assert fa.FLASH_FWD_LAUNCHES == before


def test_long_model1d_launches_the_flash_kernels(cuda, monkeypatch):
    """A narrow ``Model1d`` whose one attention layer runs at 2048 tokens:
    a training step launches K5 with lse, K6 and K7 once each, a denoise
    K5 once; with ``MDT_FLASH=0`` the same loss comes from the one-shot
    path."""
    from moleculediffusiontransformer_tpu_torch.models import audio
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    model = audio.build_model1d(
        generator=torch.Generator().manual_seed(3), in_channels=2,
        channels=32, patch_size=2, multipliers=(1, 2), factors=(2,),
        num_blocks=(1,), attentions=(0, 1), attention_heads=2,
        attention_features=32, attention_multiplier=2)
    assert next(model.parameters()).device.type == "cuda"
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8192, 2, generator=gen).to(cuda)
    sigmas = torch.rand(2, generator=gen).to(cuda)
    noise = torch.randn(2, 8192, 2, generator=gen).to(cuda)
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    loss = model(x, sigmas=sigmas, noise=noise)
    loss.backward()
    with torch.no_grad():
        model.denoise(x, sigmas)
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == (counts[0] + 2, counts[1] + 1,
                                       counts[2] + 1)
    grads = [p.grad.clone() for p in model.parameters()]
    monkeypatch.setenv("MDT_FLASH", "0")
    model.zero_grad()
    plain = model(x, sigmas=sigmas, noise=noise)
    plain.backward()
    assert fa.FLASH_FWD_LAUNCHES == counts[0] + 2
    assert abs(loss.item() - plain.item()) <= 1e-4 * abs(plain.item())
    for g, p in zip(grads, model.parameters()):
        # a grad that is zero but for float32 noise (a conv bias right
        # before a GroupNorm) is held to 1e-6 absolute
        scale = max(p.grad.abs().max().item(), 1e-3)
        assert (g - p.grad).abs().max().item() <= 1e-3 * scale


# ------------------------------------------------------------------ K9, K10

# (bh, n, m, d): the shapes of the JAX package's own tests of these kernels;
# the 91M preset's attention under CFG at 512 requests and the 18M preset's
# (d 64); the AR transformer's decode step at batch 1024 under CFG, self
# (m 65) and cross (m 13) attention; other head sizes, lengths that are no
# multiple of the warp width, and one shape past the packed kernel's range;
# then the routes' edges: n 1 at d 64 and 128 (a row-route team of several
# warps), n 15, 16, 17 at m 64 (row route, tile route, a ragged tile), K10
# at bh 8 and 130, m 1, m no multiple of 8 (masked keys in a staged tile,
# 16-key tiles, a 100-key two-chunk tile), the two-pass tile (m > 256) and
# long m on the row route; then several row-route teams a warp with the
# last block's tail teams idle
ATTENTION_CASES = [(8, 16, 24, 64), (128, 16, 12, 64), (8192, 8, 8, 64),
                   (8192, 8, 12, 64), (8192, 2, 2, 64), (8192, 2, 12, 64),
                   (64, 4, 64, 64), (64, 1, 64, 64), (16384, 1, 65, 16),
                   (16384, 1, 13, 16), (5, 7, 33, 8), (3, 64, 64, 128),
                   (2, 17, 5, 32), (64, 256, 256, 64), (2, 100, 256, 128),
                   (4096, 1, 64, 128), (1024, 1, 64, 64), (1024, 15, 64, 64),
                   (1024, 16, 64, 64), (1024, 17, 64, 64), (8, 1, 13, 16),
                   (130, 1, 13, 16), (130, 4, 64, 64), (64, 1, 1, 64),
                   (64, 20, 1, 16), (32, 3, 37, 32), (16, 33, 100, 64),
                   (8, 40, 13, 128), (8, 64, 300, 64), (4, 1, 1000, 16),
                   (4, 2, 700, 8), (601, 1, 13, 16), (1201, 2, 13, 16),
                   (2001, 2, 7, 64)]
# (bh, n, m, d, dtype) at the largest m a call takes at n 64 (d 64: the
# tile route in bf16, the CUDA-core tiles in float32; d 128: the CUDA-core
# tiles in both, and the tile route's own limit in bf16)
ATTENTION_LIMIT_CASES = [(4, 64, 832, 64, torch.bfloat16),
                         (4, 64, 704, 64, torch.float32),
                         (4, 64, 386, 128, torch.bfloat16),
                         (4, 64, 384, 128, torch.bfloat16),
                         (4, 64, 386, 128, torch.float32)]


def _attention_module():
    import importlib
    return importlib.import_module(
        "moleculediffusiontransformer_tpu_torch.ops.attention")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,m,d", ATTENTION_CASES)
def test_attention_kernels_match_plain_version(cuda, bh, n, m, d, dtype):
    """K9 at every shape and K10 where n, m <= 64 (past that
    ``packed_attention`` goes to K9), each bitwise equal across two calls."""
    at = _attention_module()
    q, k, v, _ = _flash_case(cuda, bh, n, m, d, dtype, seed=bh + n + m)
    want = at.attention_reference(q, k, v, d ** -0.5)
    before = (at.ATTENTION_LAUNCHES, at.PACKED_ATTENTION_LAUNCHES)
    got = at.attention(q, k, v)
    again = at.attention(q, k, v)
    packed = at.packed_attention(q, k, v)
    packed_again = at.packed_attention(q, k, v)
    torch.cuda.synchronize()
    small = max(n, m) <= at.PACK_MAX
    assert (at.ATTENTION_LAUNCHES, at.PACKED_ATTENTION_LAUNCHES) == (
        before[0] + (2 if small else 4), before[1] + (2 if small else 0))
    for name, a, b in (("K9", got, again), ("K10", packed, packed_again)):
        assert a.dtype == dtype and a.shape == q.shape
        assert torch.equal(a, b), name
        _within(a, want, dtype, name)
    scaled = at.attention(q, k, v, scale=0.3)
    _within(scaled, at.attention_reference(q, k, v, 0.3), dtype, "scale")


@pytest.mark.parametrize("bh,n,m,d,dtype", ATTENTION_LIMIT_CASES)
def test_attention_kernels_at_the_range_limit(cuda, bh, n, m, d, dtype):
    """K9 at the largest m a route takes, bitwise equal across two calls;
    one more key is refused."""
    at = _attention_module()
    q, k, v, _ = _flash_case(cuda, bh, n, m, d, dtype, seed=m)
    got, again = at.attention(q, k, v), at.attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _within(got, at.attention_reference(q, k, v, d ** -0.5), dtype, "K9")
    if at.plan(bh, n, m + 1, d, dtype) is None:
        q, k, v, _ = _flash_case(cuda, bh, n, m + 1, d, dtype)
        with pytest.raises(ValueError, match="flash_attention"):
            at.attention(q, k, v)


def test_attention_refusals(cuda):
    at = _attention_module()
    q, k, v, _ = _flash_case(cuda, 4, 8, 12, 64, torch.float32)
    for fn in (at.attention, at.packed_attention):
        with pytest.raises(RuntimeError, match="no backward kernel"):
            fn(q.clone().requires_grad_(), k, v)
        with torch.no_grad():
            fn(q.clone().requires_grad_(), k, v)        # fine without grad
        with pytest.raises(ValueError):
            fn(q.transpose(0, 1), k, v)                  # a view
        with pytest.raises(ValueError):
            fn(q.half(), k.half(), v.half())
        with pytest.raises(ValueError):
            fn(q, k.cpu(), v.cpu())
        with pytest.raises(ValueError):
            fn(q[..., :24].contiguous(), k[..., :24].contiguous(),
               v[..., :24].contiguous())                 # d 24
    big_q = torch.zeros(1, 16, 128, device=cuda)
    big_k = torch.zeros(1, 1024, 128, device=cuda)
    for fn in (at.attention, at.packed_attention):
        with pytest.raises(ValueError, match="flash_attention"):
            fn(big_q, big_k, big_k.clone())
