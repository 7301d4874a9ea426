"""The port's streaming attention (``ops/flash_attention.py``) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

On a CPU tensor every wrapper of the port runs its plain PyTorch version, so
these tests hold the plain versions -- the arithmetic the CUDA kernels repeat
-- to the Pallas forward (``_fwd_kernel``), its logsumexp, and the two
backward kernels (``_dq_kernel``, ``_dkv_kernel``), and the routing of
``nn.attention.sdpa`` to the JAX ``packed_sdpa``'s.  Inputs come from a numpy
seed handed to both packages.

Tolerances: float32 forward atol/rtol 2e-6 (the band of
``tests/test_flash_attention.py``: online rescaling equals the one-shot
softmax up to the order of float32 sums); gradients atol 5e-5 / rtol 1e-4
(JAX's own band for the streaming backward); bfloat16 within 2e-2 on
unit-scale inputs (one rounding of the output) and, for the backward, within
2e-2 of each gradient's largest magnitude (p and ds rounded to bfloat16 as
operands of the second products, then one rounding of each output).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.nn import attention as jattn
from moleculediffusiontransformer_tpu_torch.nn import attention as tattn
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.ops import flash_attention as tfa

# the JAX ``ops`` package exports a function of the module's name
jfa = importlib.import_module(
    "moleculediffusiontransformer_tpu.ops.flash_attention")

FWD_TOL = dict(atol=2e-6, rtol=2e-6)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
# (bh, n, m, d, block_q, block_kv)
CASES = [(4, 256, 256, 16, 128, 128),     # several blocks both ways
         (2, 512, 256, 16, 128, 256),     # rectangular, cross-attention
         (2, 128, 512, 32, 128, 256),     # a long KV sweep
         (3, 384, 384, 32, 128, 128),
         (2, 128, 128, 32, 128, 128)]     # one block: no rescaling


def _qkv(seed, bh, n, m, d, extra=0):
    rng = np.random.default_rng(seed)
    shapes = [(bh, n, d), (bh, m, d), (bh, m, d)] + [(bh, n, d)] * extra
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("bh,n,m,d,block_q,block_kv", CASES)
def test_plain_forward_matches_pallas_interpret(bh, n, m, d, block_q,
                                                block_kv):
    q, k, v = _qkv(0, bh, n, m, d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=block_q, block_kv=block_kv,
                               interpret=True)
    got, _ = tfa.flash_attention_reference(*_t(q, k, v), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    # the public function on CPU tensors is the plain version
    pub = tfa.flash_attention(*_t(q, k, v))
    assert torch.equal(pub, got)


def test_plain_forward_bf16_close_to_pallas_interpret():
    q, k, v = _qkv(1, 2, 256, 256, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, block_q=128, block_kv=128,
                               interpret=True)
    got, lse = tfa.flash_attention_reference(
        *_t(q, k, v, dtype=torch.bfloat16), 16 ** -0.5)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_extreme_logits_stay_finite():
    """Scores of +-400: the plain version subtracts the row max as the
    kernels' running max does."""
    q, k, v = _qkv(2, 2, 128, 512, 16)
    q = q * 40.0
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=1.0, block_q=128, block_kv=128,
                               interpret=True)
    got, lse = tfa.flash_attention_reference(*_t(q, k, v), 1.0)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("bh,n,m,d,block_q,block_kv", CASES[:3])
def test_plain_lse_matches_pallas_interpret(bh, n, m, d, block_q, block_kv):
    q, k, v = _qkv(3, bh, n, m, d)
    _, want = jfa._fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              d ** -0.5, block_q, block_kv, with_lse=True,
                              interpret=True)
    _, got = tfa.flash_attention_reference(*_t(q, k, v), d ** -0.5)
    # the TPU kernel writes lse broadcast over 128 lanes; the port's is
    # (bh, n)
    assert got.shape == (bh, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("bh,n,m,d,block_q,block_kv", CASES[:4])
def test_plain_backward_matches_pallas_interpret(bh, n, m, d, block_q,
                                                 block_kv):
    q, k, v, do = _qkv(4, bh, n, m, d, extra=1)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, block_q, block_kv,
                               with_lse=True, interpret=True)
    want = jfa._bwd_pallas(jq, jk, jv, jo, jlse, jdo, scale, block_q,
                           block_kv, interpret=True)
    o, lse = tfa.flash_attention_reference(*_t(q, k, v), scale)
    got = tfa.flash_attention_backward_reference(*_t(q, k, v), o, lse,
                                                 *_t(do), scale)
    _, vjp = jax.vjp(lambda a, b, c: jfa._flash_jnp(a, b, c, scale),
                     jq, jk, jv)
    for g, w, c in zip(got, want, vjp(jdo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(c), **GRAD_TOL)
    # the wrapper on CPU tensors is the plain version
    for g, w in zip(tfa.flash_backward(*_t(q, k, v), o, lse, *_t(do), scale),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bh,n,m,d,block_q,block_kv", CASES[:4])
def test_plain_backward_bf16_matches_pallas_interpret(bh, n, m, d, block_q,
                                                      block_kv):
    """bfloat16 inputs through both backward paths.  The Pallas kernels run
    their dots on bf16 operands at default precision; the plain version
    rounds p and ds to bf16 where the CUDA kernels feed them to the tensor
    cores.  The two differ by the order of float32 sums before each
    rounding: within 2e-2 of each gradient's largest magnitude."""
    q, k, v, do = _qkv(11, bh, n, m, d, extra=1)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, block_q, block_kv,
                               with_lse=True, interpret=True)
    want = jfa._bwd_pallas(jq, jk, jv, jo, jlse, jdo, scale, block_q,
                           block_kv, interpret=True)
    lo = _t(q, k, v, do, dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_reference(*lo[:3], scale)
    got = tfa.flash_attention_backward_reference(*lo[:3], o, lse, lo[3],
                                                 scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max(), \
            name


def test_plain_backward_bf16_rounds_once():
    """The plain backward's rounding points in bfloat16 are the tensor-core
    kernels': float32 scores from bf16 operands, p and ds rounded to bf16
    once as operands of the second products, float32 sums, each output
    rounded once.  Written out here step by step, the result is equal bit
    for bit; it stays within 2e-2 of the float32 backward of the same
    values, and the rounding of p and ds is visible against it."""
    q, k, v, do = _qkv(5, 2, 256, 256, 16, extra=1)
    scale = 16 ** -0.5
    lo = _t(q, k, v, do, dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_reference(*lo[:3], scale)
    got = tfa.flash_attention_backward_reference(*lo[:3], o, lse, lo[3],
                                                 scale)
    hi = [t.float() for t in lo]
    want = tfa.flash_attention_backward_reference(*hi[:3], o.float(), lse,
                                                  hi[3], scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w).abs().max() <= 2e-2 * w.abs().max()

    qf, kf, vf, dof = hi
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.unsqueeze(-1))
    ds = (dof @ vf.transpose(-1, -2) - di) * p * scale
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    assert not torch.equal(p16, p) and not torch.equal(ds16, ds)
    by_hand = (ds16 @ kf, ds16.transpose(-1, -2) @ qf,
               p16.transpose(-1, -2) @ dof)
    for g, w in zip(got, by_hand):
        assert torch.equal(g, w.bfloat16())
    # the rounding of the operands shows before the outputs are rounded
    assert not torch.equal(by_hand[0], want[0])


@pytest.mark.parametrize("n,m", [(256, 256), (128, 384)])
def test_autograd_function_matches_one_shot_sdpa(n, m):
    """``flash_attention`` under autograd (forward with lse, the backward
    pair) against autograd of the one-shot product of ``sdpa``."""
    b, h, d = 2, 2, 16
    q, k, v, do = _qkv(6, b * h, n, m, d, extra=1)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = tfa.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, *_t(do))
    ref_leaves = [t.requires_grad_() for t in _t(q, k, v)]
    shaped = [t.reshape(b, h, -1, d) for t in ref_leaves]
    assert min(n, m) < tfa.LONG_SEQ_THRESHOLD      # sdpa: the one-shot path
    ref = tattn.sdpa(*shaped, d ** -0.5, torch.float32).reshape(b * h, n, d)
    want = torch.autograd.grad(ref, ref_leaves, *_t(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
    # without autograd the forward keeps no lse and gives the same output
    with torch.no_grad():
        assert torch.equal(tfa.flash_attention(*_t(q, k, v)), out.detach())


def test_flash_takes_and_switch(monkeypatch):
    # the card's crossover routes from 512; the JAX package keeps its TPU's
    assert tfa.LONG_SEQ_THRESHOLD == 512 and jfa.LONG_SEQ_THRESHOLD == 2048
    assert tfa.flash_takes(4096, 4096, 64, torch.bfloat16)
    assert tfa.flash_takes(2048, 4096, 128, torch.float32)
    assert not tfa.flash_takes(4096, 4100, 64, torch.float32)   # m % 128
    assert not tfa.flash_takes(64, 4096, 64, torch.float32)
    assert not tfa.flash_takes(4096, 4096, 48, torch.float32)   # head size
    assert not tfa.flash_takes(4096, 4096, 64, torch.float16)
    for value, want in (("0", False), ("false", False), ("off", False),
                        ("1", True)):
        monkeypatch.setenv("MDT_FLASH", value)
        assert tfa.flash_enabled() is want is jfa.flash_enabled()
    monkeypatch.delenv("MDT_FLASH")
    assert tfa.flash_enabled() and jfa.flash_enabled()


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    q, k, v = _t(*_qkv(7, 2, 128, 128, 16))
    with pytest.raises(ValueError):
        tfa.flash_forward(q, k.to("meta"), v, 0.25)
    with pytest.raises(ValueError):       # the kernels' checks, device-free
        tfa._check(q, k[:, :100], v[:, :100])
    with pytest.raises(ValueError):
        tfa._check(q.transpose(0, 1), k, v)
    with pytest.raises(ValueError):
        tfa._check(q, k, v, o=q, do=q, lse=torch.zeros(2, 128, 1))
    tfa._check(q, k, v, o=q, do=q, lse=torch.zeros(2, 128))


class _Spy:
    """Counts the calls that ``sdpa`` routes to ``flash_attention``."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = tfa.flash_attention

        def spy(*args, **kw):
            self.calls += 1
            return inner(*args, **kw)

        monkeypatch.setattr(tfa, "flash_attention", spy)


def _attention_pair(seed, features, head_features, heads, x):
    jmod = jattn.Attention(features=features, head_features=head_features,
                           num_heads=heads)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tmod = tattn.Attention(features, head_features, heads)
    tmod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmod, params, tmod


def test_attention_module_routes_like_jax(monkeypatch):
    """The ``Attention`` module at (2, 512, 32) with the threshold patched
    to 512 in both packages: the JAX side through its Pallas kernels in
    interpret mode, the port through ``flash_attention`` (plain versions on
    the CPU).  Output within 5e-6, every gradient within 5e-5 / 1e-4; with
    ``MDT_FLASH=0`` the port does not route and still agrees."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 512)
    monkeypatch.setattr(tfa, "LONG_SEQ_THRESHOLD", 512)
    monkeypatch.setenv("MDT_FLASH_INTERPRET", "1")
    monkeypatch.delenv("MDT_FLASH", raising=False)
    x = np.random.default_rng(8).standard_normal((2, 512, 32)).astype(
        np.float32)
    jmod, params, tmod = _attention_pair(0, 32, 16, 2, x)

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) ** 2)

    want = jmod.apply({"params": params}, jnp.asarray(x))
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda xx: jmod.apply({"params": params}, xx))(jnp.asarray(x)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    want_grads = state_dict_from_jax_params(gp)

    spy = _Spy(monkeypatch)
    for flash, calls in (("1", 1), ("0", 0)):
        monkeypatch.setenv("MDT_FLASH", flash)
        spy.calls = 0
        xt = torch.tensor(x, requires_grad=True)
        tmod.zero_grad()
        out = tmod(xt)
        (out ** 2).sum().backward()
        assert spy.calls == calls
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=5e-6, rtol=5e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   **GRAD_TOL)
        for name, p in tmod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       want_grads[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_default_threshold_does_not_route_1024(monkeypatch):
    """At the default threshold (512, the card's crossover) n = 256 stays on
    the one-shot product and n = 512 routes, and so does n = 1024, which
    the JAX package (its TPU's 2,048) does not stream."""
    monkeypatch.delenv("MDT_FLASH", raising=False)
    spy = _Spy(monkeypatch)
    rng = np.random.default_rng(9)
    for n, calls in ((256, 0), (512, 1), (1024, 1)):
        q, k, v = (torch.tensor(rng.standard_normal((1, 1, n, 16)).astype(
            np.float32)) for _ in range(3))
        spy.calls = 0
        out = tattn.sdpa(q, k, v, 0.25, torch.float32)
        assert spy.calls == calls and out.shape == (1, 1, n, 16)
    # rectangular: the shorter side decides
    q = torch.zeros(1, 1, 512, 16)
    k = torch.zeros(1, 1, 256, 16)
    spy.calls = 0
    tattn.sdpa(q, k, k, 0.25, torch.float32)
    assert spy.calls == 0


def test_sdpa_takes_split_head_views(monkeypatch):
    """``AttentionBase`` hands ``sdpa`` transposed views of (b, n, h, d)
    buffers; the flash route must take them and equal the one-shot path."""
    monkeypatch.setattr(tfa, "LONG_SEQ_THRESHOLD", 256)
    rng = np.random.default_rng(10)
    b, n, h, d = 2, 256, 2, 16
    q, k, v = (torch.tensor(rng.standard_normal((b, n, h, d)).astype(
        np.float32)).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    monkeypatch.setenv("MDT_FLASH", "1")
    got = tattn.sdpa(q, k, v, d ** -0.5, torch.float32)
    monkeypatch.setenv("MDT_FLASH", "0")
    want = tattn.sdpa(q, k, v, d ** -0.5, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_plain_forward_bf16_rounds_once():
    """The plain forward's rounding points in bfloat16 are the tensor-core
    kernel's: float32 scores from bf16 operands, the float32 normaliser, p
    rounded to bf16 once as the operand of p v, a float32 sum, the output
    rounded once.  Written out here step by step, the result is equal bit
    for bit; the rounding of p is visible against the float32 product, and
    the result stays within 2e-2 of the Pallas kernel in interpret mode
    (the kernel rounds p against its running max, the plain version against
    the row's final max: the bf16 band, not bit for bit)."""
    q, k, v = _qkv(12, 2, 256, 256, 32)
    scale = 32 ** -0.5
    lo = _t(q, k, v, dtype=torch.bfloat16)
    got, lse = tfa.flash_attention_reference(*lo, scale)

    qf, kf, vf = (t.float() for t in lo)
    s = qf @ kf.transpose(-1, -2) * scale
    mx = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    p16 = p.bfloat16().float()
    assert not torch.equal(p16, p)
    by_hand = (p16 @ vf) / l
    assert torch.equal(got, by_hand.bfloat16())
    assert torch.equal(lse, (mx + torch.log(l)).squeeze(-1))
    assert not torch.equal(by_hand, (p @ vf) / l)

    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)),
                               block_q=128, block_kv=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def _split_head_inputs(seed, b, h, n, m, d, kv_from_one_projection):
    """q, k, v as (b, h, rows, d) views the way ``AttentionBase`` makes
    them: transposed views of (b, rows, h, d) buffers, k and v either two
    such buffers or ``.chunk`` views of one (b, m, 2 h d) projection; and
    do as a view like q."""
    rng = np.random.default_rng(seed)

    def rows(r, w):
        return torch.tensor(rng.standard_normal((b, r, w)).astype(np.float32))

    def split(t):
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

    q, do = split(rows(n, h * d)), split(rows(n, h * d))
    if kv_from_one_projection:
        k, v = (split(t) for t in rows(m, 2 * h * d).chunk(2, dim=-1))
    else:
        k, v = split(rows(m, h * d)), split(rows(m, h * d))
    return q, k, v, do


@pytest.mark.parametrize("kv_from_one_projection", [False, True])
@pytest.mark.parametrize("n,m", [(256, 256), (128, 384)])
def test_flash_attention_on_split_head_views(n, m, kv_from_one_projection):
    """``flash_attention`` on the views equals the call on the same values
    made contiguous: the output at 2e-6, every gradient at atol 5e-5 /
    rtol 1e-4; the output and dq come back in (b, n, h, d) memory, dk and
    dv in (b, m, h, d), so that merging the heads is free."""
    b, h, d = 2, 3, 16
    q, k, v, do = _split_head_inputs(13, b, h, n, m, d,
                                     kv_from_one_projection)
    for t in (q, k, v, do):
        assert not t.is_contiguous() and tfa.stride_problem(t) is None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert out.shape == (b, h, n, d) and out.transpose(1, 2).is_contiguous()
    got = torch.autograd.grad(out, leaves, do)
    flat = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    ref = tfa.flash_attention(*flat)
    want = torch.autograd.grad(ref, flat, do.contiguous())
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.transpose(1, 2).is_contiguous()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
    with torch.no_grad():
        bare = tfa.flash_attention(q, k, v)
    assert bare.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(bare.numpy(), ref.detach().numpy(), **FWD_TOL)


def test_sdpa_hands_split_heads_through_uncopied(monkeypatch):
    """``AttentionBase`` at (2, 256, 48) with 3 heads of 16 and the
    threshold patched to 256: ``flash_forward`` receives the module's
    (b, h, n, d) views of its projections (q from ``to_q``, k and v the
    ``.chunk`` halves of ``to_kv``) as they are, and the merged output's
    transpose is free; the result equals the one-shot route."""
    monkeypatch.setattr(tfa, "LONG_SEQ_THRESHOLD", 256)
    monkeypatch.setenv("MDT_FLASH", "1")
    seen = []
    inner = tfa.flash_forward

    def spy(q, k, v, *args, **kw):
        seen.append((q, k, v))
        out = inner(q, k, v, *args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tfa, "flash_forward", spy)
    mod = tattn.Attention(48, 16, 3)
    x = torch.tensor(np.random.default_rng(14).standard_normal(
        (2, 256, 48)).astype(np.float32))
    with torch.no_grad():
        got = mod(x)
        proj_q = mod.to_q(mod.norm(x))
        proj_kv = mod.to_kv(mod.norm_context(x))
    (q, k, v), o = seen
    b, n, h, d = 2, 256, 3, 16
    for t, base, offset in ((q, proj_q, 0), (k, proj_kv, 0),
                            (v, proj_kv, h * d)):
        assert t.shape == (b, h, n, d) and not t.is_contiguous()
        assert t.stride() == (base.stride(0), d, base.stride(1), 1)
        np.testing.assert_array_equal(
            t.transpose(1, 2).reshape(b, n, h * d).numpy(),
            base[..., offset:offset + h * d].numpy())
    assert o.transpose(1, 2).is_contiguous()
    monkeypatch.setenv("MDT_FLASH", "0")
    with torch.no_grad():
        want = mod(x)
    assert len(seen) == 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-6,
                               rtol=5e-6)


@pytest.mark.parametrize("case", ["last_stride", "row_stride_bf16",
                                  "row_stride_fp32", "head_stride",
                                  "base_address", "3d_base_address",
                                  "3d_view", "5d"])
def test_stride_rule_refuses(case):
    """What the kernels cannot address: a last dimension that is not
    unit-stride, a row, head or batch stride or a base address (of a view or
    of a contiguous (bh, n, d) tensor) that is not a multiple of 16 bytes, a
    non-contiguous (bh, n, d) tensor.  ``_check``
    raises with the rule's reason."""
    buf = torch.zeros(2, 256, 3, 80)
    bad = {
        "last_stride": buf[..., ::2][..., :16].transpose(1, 2),
        # (b, n, h, 68) bf16: rows of 136 bytes
        "row_stride_bf16": torch.zeros(2, 256, 1, 68, dtype=torch.bfloat16)[
            ..., :64].transpose(1, 2),
        # (b, n, 1, 66) float32: rows of 264 bytes
        "row_stride_fp32": torch.zeros(2, 256, 1, 66)[..., :64].transpose(
            1, 2),
        # heads 66 float32 apart (264 bytes), rows 132 (528 bytes)
        "head_stride": torch.zeros(2, 256, 2, 66)[..., :64].transpose(1, 2),
        "base_address": torch.zeros(2 * 256 * 64 + 1)[1:].reshape(
            2, 1, 256, 64),
        "3d_base_address": torch.zeros(2 * 256 * 64 + 1)[1:].reshape(
            2, 256, 64),
        "3d_view": torch.zeros(256, 2, 64).transpose(0, 1),
        "5d": torch.zeros(1, 2, 1, 256, 64),
    }[case]
    assert tfa.stride_problem(bad) is not None
    if bad.dim() in (3, 4):
        good = torch.zeros(bad.shape, dtype=bad.dtype)
        assert tfa.stride_problem(good) is None
        with pytest.raises(ValueError, match="cannot address"):
            tfa._check(bad, good, good)
    # a split-head view of a (b, n, h, d) buffer passes in both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        view = torch.zeros(2, 256, 3, 64, dtype=dtype).transpose(1, 2)
        assert tfa.stride_problem(view) is None
        tfa._check(view, view, view, o=view, do=view,
                   lse=torch.zeros(6, 256))


def test_check_remembers_layouts_not_addresses(monkeypatch):
    """A layout that passed ``_check`` once passes again from memory, and
    ``_args`` gives the same arguments from memory as made afresh; but a base
    address off the 16-byte rule is refused on a remembered layout too."""
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)   # no card here
    q = torch.zeros(2, 256, 3, 64).transpose(1, 2)
    k = torch.zeros(2, 384, 6, 64)
    kv = (k[:, :, :3].transpose(1, 2), k[:, :, 3:].transpose(1, 2))
    key = tfa._check(q, *kv)
    assert key in tfa._CHECKED and tfa._check(q, *kv) == key
    o = tfa._split_heads_like(q)
    fresh = tfa._args((q, *kv, o), q, kv[0], 0.125)
    for _ in range(2):
        got = tfa._args((q, *kv, o), q, kv[0], 0.125, key)
        assert list(got[0]) == list(fresh[0]) and got[1:] == fresh[1:]
    assert key in tfa._ARGS
    # the same shape and strides four bytes into a larger buffer
    shifted = torch.zeros(2 * 256 * 3 * 64 + 1)[1:].reshape(
        2, 256, 3, 64).transpose(1, 2)
    assert tfa._layout([shifted]) == tfa._layout([q])
    with pytest.raises(ValueError, match="base address"):
        tfa._check(shifted, *kv)
