"""The port's serving artifacts (``design/export.py``) and ``ArtifactServer``
(``design/serve.py``) on the CPU, float32, at the small sizes of the JAX
package's ``tests/test_export.py``.

An artifact served by the port equals the port's live path on the same
weights and draws within 1e-6 of the output's scale (the same operators:
bitwise is expected), and the JAX package's live ``sample``, ``inpaint`` and
``generate_sequence`` and its ``export_encoder`` artifact within 1e-4 on
JAX's draws (made here by the key splits of the JAX samplers: torch cannot
reproduce threefry), the AR ids equal.  Weights cross with
``nn.jax_import`` / ``state_dict_to_params``.  Also: the weights stay call
arguments, the bundle's header round trip, the kernels' operators in the
exported graph with fakes of the plain versions' shapes and dtypes, a
served request that imports nothing of ``models/``, and the CLI's
``export``, ``export-torch``, ``inspect`` and ``serve`` (against the JAX
CLI's ``inspect`` and ``export-torch``)."""
import json
import operator
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu import cli as jax_cli
from moleculediffusiontransformer_tpu.core.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from moleculediffusiontransformer_tpu.design import export as jexport
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.models import transformers as jt
from moleculediffusiontransformer_tpu.nn.torch_import import \
    state_dict_to_params
from moleculediffusiontransformer_tpu_torch import cli
from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
    checkpoint_state, save_checkpoint)
from moleculediffusiontransformer_tpu_torch.data.preprocess import \
    MinMaxScaler
from moleculediffusiontransformer_tpu_torch.data.tokenizer import \
    CharTokenizer
from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.design.serve import \
    ArtifactServer
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
from moleculediffusiontransformer_tpu_torch.ops import \
    transformer_fusion as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-4        # the JAX suite's full-UNet band
LIVE_TOL = 1e-6       # of the output's scale
CPU = torch.device("cpu")
# tests/test_export.py's tiny sampler, AR transformer and encoder
SAMPLER = dict(max_length=16, channels=16, pred_dim=8, text_embed_dim=16,
               embed_dim_position=8, context_embedding_max_length=12,
               multipliers=(1, 2), factors=(2,), num_blocks=(1,),
               attentions=(1,), attention_heads=2, attention_features=8,
               pre_transformer=1, patch_size=1)
AR = dict(dim=32, depth=2, logits_dim=24, dim_head=8, heads=4,
          text_embed_dim=16, max_text_len=12)
ENCODER = dict(dim=32, depth=2, heads=4, ff_mult=2, logits_dim=1,
               logits_dim_length=12, max_length=16, max_tokens=24,
               embed_dim=8)
BATCH, STEPS = 4, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _sample_draws(key, num_steps, shape):
    """The draws ``models.qm_diffusion.sample`` makes from ``key``."""
    k_noise, k_samp = jax.random.split(key)
    steps = [_normal(k, shape)
             for k in jax.random.split(k_samp, num_steps - 1)]
    return dict(noise=_t(_normal(k_noise, shape)), step_noise=_t(steps))


def _inpaint_draws(key, num_steps, resamples, shape):
    """The draws ``diffusion.samplers.inpaint_adpm2`` makes from ``key``."""
    key, k0 = jax.random.split(key)
    source_noise, step_noise, renoise = [], [], []
    for k in jax.random.split(key, num_steps - 1):
        k_src, k_steps = jax.random.split(k)
        source_noise.append(_normal(k_src, shape))
        pairs = [jax.random.split(jax.random.fold_in(k_steps, r))
                 for r in range(resamples)]
        step_noise.append([_normal(a, shape) for a, _ in pairs])
        renoise.append([_normal(b, shape) for _, b in pairs])
    draws = dict(noise=_t(_normal(k0, shape)), source_noise=_t(source_noise),
                 step_noise=_t(step_noise))
    if resamples > 1:
        draws["renoise"] = _t(renoise)
    return draws


def _step_uniforms(key, steps, batch, vocab):
    """The uniforms the JAX ``generate_sequence`` scan draws."""
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k1, (batch, vocab))))
    return _t(np.stack(out))


def _pair(jmodel, port, *example, seed, **kw):
    """JAX variables carrying the port model's seeded weights (the template
    from ``eval_shape``: nothing is compiled), and the port model."""
    init_parameters(port, torch.Generator().manual_seed(seed))
    shapes = jax.eval_shape(partial(jmodel.init, **kw), jax.random.PRNGKey(0),
                            *example)["params"]
    return {"params": state_dict_to_params(port.state_dict(), shapes)}, \
        port.eval()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _checkpoint(model, path):
    return save_checkpoint(str(path), checkpoint_state(model))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def qm(tmp_path_factory):
    """The tiny sampler in both packages, its port checkpoint, and the
    port's sampler (batch 4, 8 steps, scale 2.0) and inpainter (2
    resamples) artifacts."""
    tmp = tmp_path_factory.mktemp("serve")
    jm = jqm.QMDiffusion(**SAMPLER)
    variables, port = _pair(jm, tqm.QMDiffusion(**SAMPLER),
                            jnp.zeros((2, 12)), jnp.zeros((2, 16, 8)),
                            jax.random.PRNGKey(0), seed=1)
    ck = _checkpoint(port, tmp / "qm.pt")
    sampler = str(tmp / "sampler.pt2")
    art = dx.export_sampler(port, batch=BATCH, num_steps=STEPS,
                            cond_scale=2.0, device=CPU)
    dx.save_artifact(art, sampler, extra={"task": "inverse_diffusion"})
    inpainter = str(tmp / "inpainter.pt2")
    dx.save_artifact(dx.export_inpainter(port, batch=2, num_steps=4,
                                         num_resamples=2, cond_scale=2.0,
                                         device=CPU), inpainter)
    props = np.random.default_rng(0).uniform(-1, 1, (BATCH, 12)).astype(
        np.float32)
    return dict(tmp=tmp, jm=jm, variables=variables, port=port, ck=ck,
                art=art, sampler=sampler, inpainter=inpainter, props=props,
                server=ArtifactServer(sampler, ck, device="cpu"))


@pytest.fixture(scope="module")
def ar(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ar")
    jm = jt.MoleculeTransformerSequence(**AR)
    variables, port = _pair(
        jm, tt.MoleculeTransformerSequence(**AR, device="cpu"),
        jnp.zeros((2, 12)), jnp.ones((2, 1), jnp.int32), seed=2,
        cond_drop_prob=0.0)
    path = str(tmp / "generator.pt2")
    dx.save_artifact(dx.export_generator(port, batch=2, start_len=1,
                                         tokens_to_generate=6,
                                         cond_scale=1.5, device=CPU), path)
    return dict(jm=jm, variables=variables, port=port, path=path,
                ck=_checkpoint(port, tmp / "ar.pt"))


def test_sampler_artifact_equals_live_and_jax(qm):
    """Fed JAX's draws, the served sample equals the port's live ``sample``
    (1e-6 of scale) and the JAX package's (1e-4)."""
    server = qm["server"]
    assert (server.kind, server.batch, server.tier) == ("sampler", BATCH,
                                                        "eager")
    assert server.meta["sampler"]["num_steps"] == STEPS
    key = jax.random.PRNGKey(7)
    draws = _sample_draws(key, STEPS, (BATCH, 16, 8))
    served = server.call(qm["props"], **draws)
    live = tqm.sample(qm["port"], _t(qm["props"]), num_steps=STEPS,
                      cond_scale=2.0, **draws)
    want = jqm.sample(qm["jm"], qm["variables"], jnp.asarray(qm["props"]),
                      key, num_steps=STEPS, cond_scale=2.0)
    assert served.shape == (BATCH, 16, 8) and served.dtype == torch.float32
    assert _rel(served, live) <= LIVE_TOL
    assert np.abs(served.numpy() - np.asarray(want)).max() <= JAX_TOL
    # padded serving: 2 rows through the batch-4 artifact are the full
    # batch's first 2 rows when row 0 pads it
    full = np.concatenate([qm["props"][:2], qm["props"][:1],
                           qm["props"][:1]])
    np.testing.assert_array_equal(
        server.call_padded(qm["props"][:2], seed=5),
        server.call(full, seed=5)[:2].numpy())
    with pytest.raises(ValueError, match="exceeds"):
        server.call_padded(np.zeros((5, 12), np.float32))
    with pytest.raises(ValueError, match="draws"):
        server.call(qm["props"], uniforms=draws["noise"])


def test_inpainter_artifact_equals_live_and_jax(qm):
    server = ArtifactServer(qm["inpainter"], qm["ck"], device="cpu")
    assert server.kind == "inpainter"
    key = jax.random.PRNGKey(5)
    shape = (2, 16, 8)
    props = qm["props"][:2]
    source = np.asarray(jax.random.normal(jax.random.PRNGKey(6), shape))
    mask = np.zeros(shape, bool)
    mask[:, :4] = True
    draws = _inpaint_draws(key, 4, 2, shape)
    served = server.call(props, source, mask, **draws)
    live = tqm.inpaint(qm["port"], _t(props), _t(source), _t(mask),
                       num_steps=4, num_resamples=2, cond_scale=2.0, **draws)
    want = jqm.inpaint(qm["jm"], qm["variables"], jnp.asarray(props),
                       jnp.asarray(source), jnp.asarray(mask), key,
                       num_steps=4, num_resamples=2, cond_scale=2.0)
    assert _rel(served, live) <= LIVE_TOL
    assert np.abs(served.numpy() - np.asarray(want)).max() <= JAX_TOL
    np.testing.assert_array_equal(served.numpy()[mask], source[mask])


def test_generator_artifact_gives_live_and_jax_ids(ar):
    """Fed JAX's uniforms, the served ids are the port's live
    ``generate_sequence``'s and the JAX package's, token for token."""
    server = ArtifactServer(ar["path"], ar["ck"], device="cpu")
    assert (server.kind, server.batch) == ("generator", 2)
    props = np.random.default_rng(1).uniform(-1, 1, (2, 12)).astype(
        np.float32)
    start = np.ones((2, 1), np.int64)
    key = jax.random.PRNGKey(3)
    uniforms = _step_uniforms(key, 6, 2, 24)
    served = server.call(props, start, uniforms=uniforms)
    live = tt.generate_sequence(ar["port"], _t(props), _t(start),
                                uniforms=uniforms, tokens_to_generate=6,
                                cond_scale=1.5)
    want = jt.generate_sequence(ar["jm"], ar["variables"], jnp.asarray(props),
                                jnp.asarray(start, jnp.int32), key,
                                tokens_to_generate=6, cond_scale=1.5)
    assert served.shape == (2, 7) and served.dtype == torch.int64
    assert torch.equal(served, live)
    np.testing.assert_array_equal(served.numpy(), np.asarray(want))
    # a seed draws the uniforms on the serving device: repeatable
    assert torch.equal(server.call(props, start, seed=4),
                       server.call(props, start, seed=4))


def test_encoder_artifact_equals_live_and_jax_artifact(tmp_path):
    jm = jt.MoleculeTransformerSequenceEncoder(**ENCODER)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (3, 16), 0,
                                        24))
    variables, port = _pair(jm, tt.MoleculeTransformerSequenceEncoder(
        **ENCODER, device="cpu"), jnp.asarray(ids), seed=3)
    path = str(tmp_path / "encoder.pt2")
    dx.save_artifact(dx.export_encoder(port, batch=3, max_length=16,
                                       device=CPU), path)
    server = ArtifactServer(path, _checkpoint(port, tmp_path / "e.pt"),
                            device="cpu")
    assert server.kind == "encoder"
    served = server.call(ids)
    with torch.no_grad():
        live = port(_t(ids))
    jart = jexport.deserialize(jexport.serialize(jexport.export_encoder(
        jm, variables, batch=3, max_length=16, platforms=("cpu",))))
    want = np.asarray(jart.call(variables, jnp.asarray(ids, jnp.int32)))
    assert served.shape == live.shape == want.shape
    assert _rel(served, live) <= LIVE_TOL
    assert np.abs(served.numpy() - want).max() <= JAX_TOL


def test_params_stay_swappable_and_reload(qm, tmp_path):
    """The weights are call arguments: other weights give another output,
    and ``reload_checkpoint`` serves exactly a fresh model's output."""
    server = qm["server"]
    a = server.call(qm["props"], seed=3)
    other = tqm.QMDiffusion(**SAMPLER)
    init_parameters(other, torch.Generator().manual_seed(9))
    ck2 = _checkpoint(other.eval(), tmp_path / "other.pt")
    try:
        server.reload_checkpoint(ck2)
        assert server.restored_from == ck2
        assert not torch.allclose(a, server.call(qm["props"], seed=3))
        draws = dict(noise=torch.randn(BATCH, 16, 8),
                     step_noise=torch.randn(STEPS - 1, BATCH, 16, 8))
        live = tqm.sample(other, _t(qm["props"]), num_steps=STEPS,
                          cond_scale=2.0, **draws)
        assert _rel(server.call(qm["props"], **draws), live) <= LIVE_TOL
        # a reference-layout state dict (.npz) loads as well; a wrong one
        # not
        npz = str(tmp_path / "sd.npz")
        np.savez(npz, **{k: v.numpy() for k, v in qm["port"].state_dict()
                         .items()})
        server.reload_checkpoint(npz)
        assert torch.equal(server.call(qm["props"], seed=3), a)
        np.savez(npz, nothing=np.zeros(1))
        with pytest.raises(ValueError, match="does not fit"):
            server.reload_checkpoint(npz)
    finally:
        server.reload_checkpoint(qm["ck"])


def _weight_source(node):
    """The node a kernel operator's weight argument comes from, past the
    operations that copy nothing: splits (K8's FiLM views) and their items,
    reshapes of a conv's (C, C, 1) weight, a cast to the dtype it has."""
    def copies_nothing(n):
        name = str(n.target)
        if name.startswith("aten.to."):
            return n.meta["val"].dtype == n.args[0].meta["val"].dtype
        return n.target is operator.getitem or any(
            k in name for k in ("split", "reshape", "view"))

    while node.op == "call_function" and copies_nothing(node):
        node = node.args[0]
    return node


def test_kernel_weights_are_made_once_per_load(qm, ar, tmp_path):
    """The stacks' and K8's kernel weights (the casts, K8's layout and FiLM
    matrix) are inputs of the denoise program, made by the artifact's
    ``prepare`` program at load and again at ``reload_checkpoint``; the
    generator's context is a program of its own, run once a request; no
    program copies a host constant.  With both switches on, the server
    equals the live path before and after a reload."""
    for art in (qm["art"], dx.read_artifact(ar["path"])):
        for program in (art.program, *art.programs.values()):
            assert not any("lift_fresh_copy" in str(n.target)
                           for n in program.graph.nodes)
    assert sorted(dx.read_artifact(ar["path"]).programs) == ["context"]
    props = _t(qm["props"])
    other = tqm.QMDiffusion(**SAMPLER)
    init_parameters(other, torch.Generator().manual_seed(9))
    ck2 = _checkpoint(other.eval(), tmp_path / "other.pt")
    draws = dict(noise=torch.randn(BATCH, 16, 8),
                 step_noise=torch.randn(STEPS - 1, BATCH, 16, 8))
    rf.enable_resnet_fusion(True)
    tf.enable_sharedkv(True)
    try:
        art = dx.export_sampler(qm["port"], batch=BATCH, num_steps=STEPS,
                                cond_scale=2.0, device=CPU)
        path = str(tmp_path / "switches_on.pt2")
        dx.save_artifact(art, path)
        server = ArtifactServer(path, qm["ck"], device="cpu")
        assert sorted(server.programs) == ["prepare"]
        # bfloat16 too: there every stack weight is cast
        bf16 = tqm.QMDiffusion(**SAMPLER, dtype=torch.bfloat16).eval()
        for program in (art.program, dx.export_sampler(
                bf16, batch=2, num_steps=STEPS, device=CPU).program):
            ops = {"mdt_torch.t1d_forward.default": 2,
                   "mdt_torch.resnet_run.default": 3}
            seen = {k: 0 for k in ops}
            for n in program.graph.nodes:
                if str(n.target) in ops:
                    seen[str(n.target)] += 1
                    weights = n.args[ops[str(n.target)]]
                    assert all(_weight_source(w).op == "placeholder"
                               for w in weights), n
            assert all(seen.values())
        for model, ck in ((qm["port"], None), (other, ck2)):
            if ck:
                server.reload_checkpoint(ck)
            live = tqm.sample(model, props, num_steps=STEPS, cond_scale=2.0,
                              **draws)
            assert _rel(server.call(props, **draws), live) <= LIVE_TOL
    finally:
        rf.enable_resnet_fusion(False)
        tf.enable_sharedkv(False)


def test_placeholder_params_are_seeded(qm):
    """No checkpoint: every variable from ``np.random.RandomState(seed)``,
    N(0, 0.02), in the program's order."""
    got = ArtifactServer(qm["sampler"], seed=1, device="cpu").variables
    assert list(got) == list(qm["port"].state_dict())
    for seed, equal in ((1, True), (0, False)):
        rng = np.random.RandomState(seed)
        want = [rng.normal(0, 0.02, tuple(v.shape)) for v in got.values()]
        assert all(np.allclose(v.numpy(), w, rtol=0, atol=1e-7)
                   for v, w in zip(got.values(), want)) == equal


def test_variables_skeleton_is_the_models_state_dict(qm):
    skel = dx.variables_skeleton(qm["server"].program)
    want = qm["port"].state_dict()
    assert {k: tuple(v.shape) for k, v in skel.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not any(v.any() for v in skel.values())


def test_bundle_roundtrip(qm, tmp_path):
    tok = CharTokenizer().fit_on_texts(["CCO", "CCN", "C1CC1"])
    scaler = MinMaxScaler().fit(np.linspace(0, 1, 24).reshape(2, 12))
    path = str(tmp_path / "bundle.pt2")
    dx.save_artifact(qm["art"], path, tokenizer=tok, scaler=scaler,
                     training_smiles=["CCO", "CCN"],
                     extra={"task": "inverse_diffusion"})
    program, header = dx.load_bundle(path)
    assert header["training_smiles"] == ["CCO", "CCN"]
    assert header["task"] == "inverse_diffusion"
    assert header["tokenizer"]["word_index"] == tok.word_index
    assert header["kind"] == "sampler" and header["device"] == "cpu"
    server = ArtifactServer(path, qm["ck"], device="cpu")
    assert server.tokenizer.word_index == tok.word_index
    assert np.allclose(server.scaler.data_min_, scaler.data_min_)
    assert server.training_smiles == ["CCO", "CCN"]
    assert server.meta["task"] == "inverse_diffusion"
    assert torch.equal(server.call(qm["props"], seed=1),
                       qm["server"].call(qm["props"], seed=1))
    # an artifact exported on the CPU refuses another device
    with pytest.raises(ValueError, match="exported on cpu"):
        ArtifactServer(path, device="meta")


def test_operators_in_the_program_and_their_fakes(qm):
    """The kernels are single graph nodes of the exported program (K8 and
    the uniform-context K1 with their switches on at export), and their
    fakes give the plain versions' shapes and dtypes."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    stacks = [m for m in qm["port"].modules() if isinstance(m, Transformer1d)]
    names = [str(n.target) for n in qm["server"].program.graph.nodes
             if n.op == "call_function"]
    assert names.count("mdt_torch.t1d_forward.default") == len(stacks)
    assert "mdt_torch.resnet_run.default" not in names
    rf.enable_resnet_fusion(True)
    tf.enable_sharedkv(True)
    try:
        art = dx.export_sampler(qm["port"], batch=2, num_steps=4,
                                cond_scale=2.0, device=CPU)
    finally:
        rf.enable_resnet_fusion(False)
        tf.enable_sharedkv(False)
    nodes = [n for n in art.program.graph.nodes if n.op == "call_function"]
    t1d = [n for n in nodes if str(n.target) == "mdt_torch.t1d_forward"
           ".default"]
    cross = [m for m in stacks if m.context_features]
    # each cross stack twice: the conditioned half, the null half's table
    assert len(t1d) == len(stacks) + len(cross)
    assert sum(n.args[-1] for n in t1d) == len(cross)
    runs = sum(str(n.target) == "mdt_torch.resnet_run.default"
               for n in nodes)
    assert runs == 2 * len(qm["port"].unet.downsamples)
    # the fakes against the plain versions
    from torch._subclasses.fake_tensor import FakeTensorMode
    stack = cross[0]
    x = torch.randn(2, 8, stack.channels)
    ctx = torch.randn(2, 12, stack.context_features)
    geometry = (stack.num_layers, stack.num_heads, stack.head_features,
                stack.multiplier)
    for dtype in (torch.float32, torch.bfloat16):
        weights = tf._kernel_weights(stack.kernel_params(), stack.num_layers,
                                     True, dtype)
        args = (x.to(dtype), ctx, weights, *geometry, False)
        plain = torch.ops.mdt_torch.t1d_forward(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = torch.ops.mdt_torch.t1d_forward(
                *[mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                  [mode.from_tensor(w) for w in a] if isinstance(a, list)
                  else a for a in args])
        assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)
    down = qm["port"].unet.downsamples[0]
    blocks = list(down.blocks)
    xr = torch.randn(2, 8, blocks[0].block1.groupnorm.weight.shape[0])
    mapping = torch.randn(
        2, blocks[0].to_scale_shift.to_scale_shift[1].weight.shape[1])
    for collect in (False, True):
        weights = rf.kernel_weights(blocks, torch.float32)
        args = (xr, mapping, [None] * len(blocks),
                [w for ws in weights for w in ws],
                [len(ws) for ws in weights], down.num_groups, 1.0, collect)
        plain = torch.ops.mdt_torch.resnet_run(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = torch.ops.mdt_torch.resnet_run(
                mode.from_tensor(xr), mode.from_tensor(mapping), *args[2:])
        assert [(f.shape, f.dtype) for f in fake] == [
            (p.shape, p.dtype) for p in plain]


def test_mesh_and_another_device_are_refused(qm):
    """A mesh is the sampler's only (as in JAX; the mesh sampler is
    ``tests/test_torch_parallel.py``'s), and an artifact is exported on
    the device the model is on."""
    with pytest.raises(ValueError, match="export_sampler only"):
        dx.export_inpainter(qm["port"], batch=2, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="serves on"):
        dx.export_encoder(qm["port"], batch=2, device="meta")


def test_served_request_imports_no_models(qm):
    """A serving process loads the artifact and answers with nothing of
    ``models/`` imported."""
    code = (
        "import sys, numpy as np\n"
        "from moleculediffusiontransformer_tpu_torch.design.serve import "
        "ArtifactServer\n"
        f"s = ArtifactServer({qm['sampler']!r}, {qm['ck']!r}, device='cpu')\n"
        "out = s.call_padded(np.zeros((1, 12), np.float32), seed=0)\n"
        "assert out.shape == (1, 16, 8) and np.isfinite(out).all()\n"
        "print(sorted(m for m in sys.modules if '_torch.models' in m or "
        "m.split('.')[0] in ('jax', 'flax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ----------------------------------------------------------------- the CLI

def _run(capsys, argv):
    payload = cli.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(payload, default=float))
    return out


@pytest.mark.parametrize("argv", [
    ["export", "--task", "inverse_diffusion", "--preset", "tiny", "--out",
     "x.pt2"],
    ["export-torch", "--checkpoint", "x.pt", "--out", "x.npz"],
    ["inspect", "x.pt2"],
    ["serve", "x.pt2"]])
def test_without_a_card_the_default_device_fails(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs")
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_cli_export_inspect_serve(tmp_path, capsys):
    """``export`` a tiny AR generator with its vocabulary bundled, ``inspect``
    it (JAX's keys, ``platforms`` -> ``device``, and its ``param_count``
    against JAX's ``inspect`` of the same architecture), ``serve`` it."""
    rows = ["--rows", "64", "--seed", "0"]
    out = str(tmp_path / "gen.pt2")
    got = _run(capsys, ["export", "--task", "inverse_transformer", "--preset",
                        "tiny", "--device", "cpu", "--batch", "2",
                        "--tokens", "4", "--embed-vocab", "--out", out,
                        *rows])
    assert (got["kind"], got["device"], got["bundled"]) == (
        "generator", "cpu", True)
    info = _run(capsys, ["inspect", out, "--device", "cpu"])
    jout = str(tmp_path / "gen.mdtx")
    jax_cli.main(["export", "--task", "inverse_transformer", "--preset",
                  "tiny", "--batch", "2", "--tokens", "4", "--embed-vocab",
                  "--platforms", "cpu", "--out", jout, *rows])
    capsys.readouterr()
    jax_cli.main(["inspect", jout])
    want = json.loads(capsys.readouterr().out)
    want["device"] = want.pop("platforms")
    assert set(info) == set(want)
    assert info["kind"] == want["kind"] == "generator"
    assert info["bundle"]["tokenizer_vocab"] == want["bundle"][
        "tokenizer_vocab"]
    assert info["bundle"]["novelty_corpus"] == want["bundle"][
        "novelty_corpus"]
    served = _run(capsys, ["serve", out, "--device", "cpu", "--num", "2",
                           *rows])
    assert served["kind"] == "generator" and len(served["smiles"]) == 2
    assert served["tier"] == "eager"


@pytest.mark.parametrize("task", ["inverse_diffusion", "forward_transformer"])
def test_inspect_param_count_equals_jax(tmp_path, capsys, task):
    """``inspect``'s parameter count equals JAX's for the same architecture
    (the recipes' tiny preset in both packages)."""
    out = str(tmp_path / "a.pt2")
    _run(capsys, ["export", "--task", task, "--preset", "tiny",
                  "--device", "cpu", "--batch", "1", "--timesteps", "2",
                  "--vocab", "22", "--out", out])
    info = _run(capsys, ["inspect", out, "--device", "cpu"])
    from moleculediffusiontransformer_tpu.train import recipes as jrecipes
    model = jrecipes.build_model(task, 22, "tiny")
    ia, kw = jrecipes.init_example(task, model, max_length=64)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *ia, **kw)
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes["params"]))
    assert info["param_count"] == want


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_export_torch_equals_jax(tmp_path, capsys, suffix):
    """The port's ``export-torch`` of a checkpoint writes, key for key and
    value for value, what the JAX CLI's ``export-torch`` writes from a
    msgpack checkpoint of the same weights."""
    jm = jt.MoleculeTransformerSequenceEncoder(**ENCODER)
    variables, port = _pair(jm, tt.MoleculeTransformerSequenceEncoder(
        **ENCODER, device="cpu"), jnp.zeros((2, 16), jnp.int32), seed=4)
    msgpack = str(tmp_path / "e.msgpack")
    jax_save_checkpoint(msgpack, {"params": variables["params"]})
    jout, tout = (str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}"))
    jax_cli.main(["export-torch", "--checkpoint", msgpack, "--out", jout])
    got = _run(capsys, ["export-torch", "--checkpoint",
                        _checkpoint(port, tmp_path / "e.pt"), "--out", tout,
                        "--device", "cpu"])
    if suffix == ".npz":
        with np.load(jout) as a, np.load(tout) as b:
            want = {k: a[k] for k in a.files}
            have = {k: b[k] for k in b.files}
    else:
        want = {k: v.numpy() for k, v in torch.load(jout).items()}
        have = {k: v.numpy() for k, v in torch.load(tout).items()}
    assert set(have) == set(want) and got["tensors"] == len(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
