"""The port's other axes of ``parallel/`` on the CPU: tensor (``tp``),
sequence (``sp``), pipeline (``pp``) and expert (``ep``) parallelism, on
gloo ranks spawned by ``tests/torch_parallel_axes_workers.py`` (one spawn
of 2 ranks, one of 4 for the 2 x 2 meshes), against the same work in one
process and against the JAX package's axis on 8 virtual CPU devices.

Every comparison with JAX takes its draws from numpy or from JAX's key
computed here (threefry and Philox never agree on a seed): the diffusion
sigmas and noise, the CFG keep masks (all kept where JAX runs without
dropout).

Bands.  tp: the loss, the grads and the parameters after 2 SGD steps
within rtol 1e-4 / atol 1e-5 of JAX's (and 1e-5 of each tensor's scale of
one process's), the parameters moved past the band.  sp: the loss within
rtol 1e-5 and the grads within 1e-5 of each tensor's scale plus 1e-6 of
the largest grad of the model (a bias feeding a GroupNorm has a grad that
is a sum of terms cancelling to ~1e-7; its rounding is no figure of the
tensor).  pp: logits, loss and grads within atol 1e-5.  ep: the loss
within rtol 1e-6 and the grads within atol 1e-5, with tokens dropped."""
import functools
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.diffusion import objectives as jobj
from moleculediffusiontransformer_tpu.models import audio as jaudio
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.models import transformers as jtr
from moleculediffusiontransformer_tpu.parallel import (make_mesh, replicate,
                                                       seq_sharding,
                                                       shard_batch_sp)
from moleculediffusiontransformer_tpu.parallel import ep as jep
from moleculediffusiontransformer_tpu.parallel import pp as jpp
from moleculediffusiontransformer_tpu.parallel import tp as jtp
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch import parallel
from moleculediffusiontransformer_tpu_torch.nn import unet as tunet
from moleculediffusiontransformer_tpu_torch.nn.jax_import import (
    _LEAF_NAMES, _flatten, state_dict_from_jax_params, torch_key)
from moleculediffusiontransformer_tpu_torch.parallel import collectives
from moleculediffusiontransformer_tpu_torch.train import trainer

import torch_parallel_axes_workers as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QM = dict(max_length=32, channels=32, pred_dim=8, text_embed_dim=16,
          embed_dim_position=16, context_embedding_max_length=12,
          multipliers=(1, 2), factors=(2,), num_blocks=(1,),
          attentions=(1,), attention_heads=2, attention_features=16,
          pre_transformer=1)
# JAX's tiny model of test_sp_train_step_equals_replicated_oracle
QM_TINY = dict(max_length=8, channels=16, pred_dim=6, text_embed_dim=16,
               embed_dim_position=8, context_embedding_max_length=12,
               multipliers=(1, 2), factors=(2,), num_blocks=(1,),
               attentions=(1,), attention_heads=2, attention_features=8,
               pre_transformer=1, patch_size=1)
# a Model1d at 64 samples: over 2 ranks its levels hold 16, 4 and 1
# columns a rank, so the second factor-4 downsample's left halo (4) and
# the bottleneck's k3 halo (1) equal their local lengths; attention at the
# level of 8 tokens (4 a rank)
M1 = dict(in_channels=2, channels=32, patch_size=2, multipliers=(1, 2, 2),
          factors=(4, 4), num_blocks=(1, 1), attentions=(1, 0, 0),
          attention_heads=2, attention_features=16, attention_multiplier=2)
# a base UNet whose stack at 8 tokens (4 a rank) carries the relative
# bias in self- and cross-attention
REL_UNET = dict(in_channels=2, channels=32, multipliers=(1, 2), factors=(2,),
                num_blocks=(1,), attentions=(1,), patch_size=2,
                resnet_groups=8, attention_heads=2, attention_features=16,
                attention_multiplier=2, context_embedding_features=8,
                attention_use_rel_pos=True, attention_rel_pos_num_buckets=8,
                attention_rel_pos_max_distance=16)
DEC = dict(dim=32, depth=4, logits_dim=6, dim_head=8, heads=4,
           text_embed_dim=16, max_text_len=12)
GPT = dict(dim=16, depth=2, max_tokens=12, logits_dim=12, dim_head=8,
           heads=2, ff_mult=2, embed_dim=8, ff_num_experts=4,
           ff_expert_top_k=2, ff_expert_capacity_factor=0.5)
BATCH, SGD_LR, KEY = 8, 0.1, 9
# JAX's own test of the tiny model: 3 SGD steps at 1e-3, the losses within
# rtol 1e-5 and the parameters within atol 1e-6
TINY_STEPS, TINY_LR = 3, 1e-3
MIN_ELEMENTS = 64
N_MICRO = (1, 2, 4)
# JAX's pipeline at one of them (JAX's own test_pp holds its n_micro 1, 2
# and 4 equal to its sequential trunk): every port run is held against it
JAX_N_MICRO = 2


def _params(module, *arrays, **kwargs):
    """Random params of ``module``'s shapes (traced, not run: an init
    compiles): a kernel N(0, 1 / fan-in), a norm's scale 1 + N(0, 0.1), any
    other vector N(0, 0.1), an embedding N(0, 1)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *arrays)["params"]
    rng = np.random.default_rng(len(jax.tree_util.tree_leaves(shapes)))

    def draw(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2 and name != "embedding":
            return jnp.asarray(x / np.sqrt(np.prod(s.shape[:-1])))
        if len(s.shape) == 1:
            return jnp.asarray((1.0 if name in ("scale", "gamma") else 0.0)
                               + 0.1 * x)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _random_sd(module, rng) -> dict:
    """Random weights of the port's ``module``: a matrix N(0, 1 / fan-in),
    a norm's scale 1 + N(0, 0.1), any other vector N(0, 0.1)."""
    out = {}
    for name, p in module.state_dict().items():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if p.dim() >= 2:
            x /= np.sqrt(np.prod(p.shape[1:]))
        else:
            x = (1.0 if "norm" in name and name.endswith("weight")
                 else 0.0) + 0.1 * x
        out[name] = x
    return out


def _sd(params) -> dict:
    return {k: v.numpy().copy()
            for k, v in state_dict_from_jax_params(params).items()}


# XLA's LLVM passes at their cheapest: most of this file's time is compiles
# of programs that then run once or twice
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _keep_grads():
    """An optax stage that passes the grads on and keeps them as its
    state: the step's grads, read after it."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _qm_draws(step: int, shape):
    """What the JAX step's ``loss_from_key`` draws at ``step``."""
    ks, kn = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(KEY), step))
    return (np.array(jdist.LogNormalDistribution(-1.2, 1.2)(ks, shape[0])),
            np.array(jax.random.normal(kn, shape)))


@pytest.fixture(scope="module")
def data():
    """Every model's JAX params (and the port's state dict of them) and
    inputs, made from seeds."""
    rng = np.random.default_rng(1)
    out = {}
    for name, kw in (("tp", QM), ("tiny", QM_TINY)):
        jm = jqm.QMDiffusion(**kw)
        shape = (BATCH, kw["max_length"], kw["pred_dim"])
        cond = rng.uniform(-1, 1, (BATCH, 12)).astype(np.float32)
        target = rng.standard_normal(shape).astype(np.float32)
        params = _params(jm, jnp.asarray(cond[:2]),
                           jnp.asarray(target[:2]), jax.random.PRNGKey(1))
        steps = TINY_STEPS if name == "tiny" else 2
        out[name] = dict(jm=jm, params=params, sd=_sd(params), cond=cond,
                         target=target, lr=TINY_LR if name == "tiny"
                         else SGD_LR,
                         draws=[_qm_draws(i, shape) for i in range(steps)])
    jm = jaudio.Model1d(diffusion_sigma_distribution=jdist.
                        UniformDistribution(), **M1)
    x = rng.uniform(-1, 1, (4, 64, 2)).astype(np.float32)
    params = _params(jm, jnp.asarray(x[:2]), jax.random.PRNGKey(1))
    out["m1"] = dict(jm=jm, params=params, sd=_sd(params), x=x, draws=[(
        rng.uniform(0, 1, 4).astype(np.float32),
        rng.standard_normal(x.shape).astype(np.float32))])
    props = rng.uniform(-1, 1, (4, 12)).astype(np.float32)
    for kind, kw, output in (
            ("MoleculeTransformer", dict(DEC, pos_fourier_graph_dim=8),
             rng.standard_normal((4, 5, 6)).astype(np.float32)),
            ("MoleculeTransformerSequence", DEC,
             rng.integers(1, 6, (4, 8)))):
        jm = getattr(jtr, kind)(**kw)
        params = _params(jm, jnp.asarray(props), jnp.asarray(output),
                           cond_drop_prob=0.0)
        out[kind] = dict(jm=jm, params=params, sd=_sd(params), kw=kw,
                         props=props, output=output)
    out["rel"] = dict(kw=REL_UNET, sd=_random_sd(
        tunet.UNet1d(**REL_UNET), rng), x=rng.standard_normal(
            (2, 32, 2)).astype(np.float32),
        time=rng.uniform(0, 1, 2).astype(np.float32),
        embedding=rng.standard_normal((2, 6, 8)).astype(np.float32),
        weights=rng.standard_normal((2, 32, 2)).astype(np.float32))
    jm = jtr.MoleculeTransformerGPT(**GPT)
    ids = rng.integers(1, 12, (BATCH, 10))
    params = _params(jm, jnp.asarray(ids))
    out["gpt"] = dict(jm=jm, params=params, sd=_sd(params), ids=ids)
    return out


def _calls(data, shape) -> dict:
    """The bodies every rank of a ``shape`` mesh runs."""
    qm, tiny, m1 = data["tp"], data["tiny"], data["m1"]
    calls = {
        "tp": ("tp_steps", (shape, QM, qm["sd"], qm["cond"],
                            qm["target"], qm["draws"], SGD_LR,
                            MIN_ELEMENTS), {}),
        "sp_tiny": ("sp_steps", (shape, "qm", QM_TINY, tiny["sd"],
                                 (tiny["cond"], tiny["target"]),
                                 tiny["draws"], TINY_LR), {}),
        "pair": ("pair_grads", (shape,), {})}
    if shape == (1, 2):
        for route in ("fused", "module"):
            calls[f"sp_m1_{route}"] = (
                "sp_steps", (shape, "model1d", M1, m1["sd"], m1["x"],
                             m1["draws"], SGD_LR),
                dict(disable_fusion=route == "module"))
        for kind in ("MoleculeTransformer", "MoleculeTransformerSequence"):
            d = data[kind]
            calls[kind] = ("pp_runs", (
                (1, 2), kind, d["kw"], d["sd"], d["props"], d["output"],
                np.ones(4, bool), N_MICRO), {})
        calls["pp_errors"] = ("pp_errors", ((1, 2),), {})
        rel = data["rel"]
        calls["rel_pos"] = ("unet_rel_pos", (shape, rel["kw"], rel["sd"],
                                             rel["x"], rel["time"],
                                             rel["embedding"],
                                             rel["weights"]), {})
        calls["mode_errors"] = ("mode_errors", (shape, QM_TINY, tiny["sd"],
                                                MIN_ELEMENTS), {})
    else:
        d = data["MoleculeTransformerSequence"]
        calls["pp"] = ("pp_runs", ((2, 2), "MoleculeTransformerSequence",
                                   DEC, d["sd"], d["props"], d["output"],
                                   np.array([True, False, True, True]),
                                   (2,)), {})
        calls["ep"] = ("ep_step", ((2, 2), GPT, data["gpt"]["sd"],
                                   data["gpt"]["ids"], 1e-2, SGD_LR), {})
        calls["routing"] = ("seq_routing", ((2, 2),), {})
    return calls


@pytest.fixture(scope="module")
def spawned(data, tmp_path_factory):
    """Both spawns, started at once; the references are computed while
    they run."""
    tmp = tmp_path_factory.mktemp("axes")
    # a spawn blocks until each child has read its arguments, after its
    # imports: the processes start from a thread
    pool = ThreadPoolExecutor(2)
    yield {shape: pool.submit(W.Ranks, shape[0] * shape[1],
                              str(tmp / f"{shape[0]}"), _calls(data, shape))
           for shape in ((1, 2), (2, 2))}
    pool.shutdown()


@pytest.fixture(scope="module")
def ranks(spawned, rehearsal, jax_runs, singles):
    return {shape: r.result().results() for shape, r in spawned.items()}


# ----------------------------------------------------- the references --

def _one_process(kind, kw, sd, data, draws, lr=SGD_LR):
    """The port's SGD steps in one process on the global batch: the
    losses, the last grads, the parameters."""
    model = W.build(kind, kw, sd)
    opt = W.SGD(lr)
    state = trainer.TrainState.create(model, opt)
    losses = []
    for sigmas, noise in draws:
        draw = dict(sigmas=torch.as_tensor(sigmas),
                    noise=torch.as_tensor(noise))
        if kind == "qm":
            loss = trainer.make_diffusion_train_step(model, opt)(
                state, *map(torch.as_tensor, data), **draw)
        else:
            loss = trainer.make_model1d_train_step(model, opt)(
                state, torch.as_tensor(data), **draw)
        losses.append(loss.item())
    return losses, W._grads(model), W.numpy(dict(model.named_parameters()))


def _decoder(kind, sd, keep):
    """The sequential decoder's logits, loss and grads."""
    d = sd
    model = W.build(kind, d["kw"], d["sd"])
    run = dict(cond_drop_prob=0.5, keep=torch.as_tensor(keep))
    props, output = torch.as_tensor(d["props"]), torch.as_tensor(d["output"])
    with torch.no_grad():
        logits = model(props, output, **run).numpy()
    loss = model(props, output, return_loss=True, **run)
    loss.backward()
    return logits, loss.item(), W._grads(model)


@pytest.fixture(scope="module")
def singles(data, spawned):
    qm, tiny, m1 = data["tp"], data["tiny"], data["m1"]
    out = {"tp": _one_process("qm", QM, qm["sd"],
                              (qm["cond"], qm["target"]), qm["draws"]),
           "tiny": _one_process("qm", QM_TINY, tiny["sd"],
                                (tiny["cond"], tiny["target"]),
                                tiny["draws"], TINY_LR),
           "m1": _one_process("model1d", M1, m1["sd"], m1["x"],
                              m1["draws"])}
    for kind in ("MoleculeTransformer", "MoleculeTransformerSequence"):
        out[kind] = _decoder(kind, data[kind], np.ones(4, bool))
    out["dropout"] = _decoder("MoleculeTransformerSequence",
                              data["MoleculeTransformerSequence"],
                              np.array([True, False, True, True]))
    gpt = W.build("MoleculeTransformerGPT", GPT, data["gpt"]["sd"])
    opt = W.SGD(SGD_LR)
    loss = trainer.make_gpt_train_step(gpt, opt, aux_loss_weight=1e-2)(
        trainer.TrainState.create(gpt, opt), torch.as_tensor(data["gpt"][
            "ids"]))
    out["gpt"] = (loss.item(), W._grads(gpt), [
        m.dropped.item() for m in gpt.modules() if hasattr(m, "dropped")])
    rel = data["rel"]
    out["rel"] = W.unet_rel_pos(None, rel["kw"], rel["sd"], rel["x"],
                                rel["time"], rel["embedding"],
                                rel["weights"], seq=False)
    return out


def _jax_qm_steps(d, mesh, place):
    """JAX's ``make_diffusion_train_step`` (SGD at ``d["lr"]``, a step a
    draw) with the state and batch placed by ``place``, lowered; and what
    gives, from it compiled, the losses, the last grads and the
    parameters, as the port's state dicts."""
    tx = optax.chain(_keep_grads(), optax.sgd(d["lr"]))
    state, cond, target = place(jtrainer.TrainState.create(d["params"], tx),
                                d["cond"], d["target"])
    key = jax.device_put(jax.random.PRNGKey(KEY), NamedSharding(mesh, P()))
    state = jax.tree_util.tree_map(
        lambda x: x if isinstance(x.sharding, NamedSharding)
        else jax.device_put(x, NamedSharding(mesh, P())), state)
    placement = jax.tree_util.tree_map(lambda x: x.sharding, state)

    def run(step):
        st, losses = state, []
        for _ in d["draws"]:
            st, loss = step(st, cond, target, key)
            # back to the placement the step was compiled for
            st = jax.device_put(st, placement)
            losses.append(float(loss))
        return (losses, _sd(st.opt_state[0]), _sd(st.params))

    jitted = jtrainer.make_diffusion_train_step(d["jm"], tx, donate=False)
    return jitted.lower(state, cond, target, key), run


@pytest.fixture(scope="module")
def jax_runs(data, spawned, rehearsal):
    """JAX's tp step (``make_mesh_2d(4, 2)``, ``tensor_parallel_specs``),
    its sp steps (``shard_batch_sp``, ``seq_sharding``), its
    ``pipeline_forward`` and its ``shard_params_ep`` step: each traced and
    lowered in turn, compiled side by side in threads (XLA's compiler
    releases the interpreter), then run."""
    mesh = jtp.make_mesh_2d(4, 2, backend="cpu")
    data_axis = NamedSharding(mesh, P("data"))

    def tp():
        def place(state, cond, target):
            specs = jtp.tensor_parallel_specs(state.params, mesh,
                                              min_elements=MIN_ELEMENTS)
            params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                state.params, specs)
            return (state.replace(params=params),
                    jax.device_put(cond, data_axis),
                    jax.device_put(target, data_axis))
        return _jax_qm_steps(data["tp"], mesh, place)

    def sp():
        return _jax_qm_steps(data["tiny"], mesh, lambda state, c, t: (
            replicate(mesh, state), *shard_batch_sp(mesh, c, t)))

    def m1():
        d = data["m1"]
        sigmas, noise = d["draws"][0]
        jm = d["jm"]

        def loss_of(p, x, s, n):
            net = lambda xn, t: jm.apply({"params": p}, xn, t,
                                         method=lambda m, a, b: m.unet(a, b))
            return jobj.VDiffusion().loss(net, x, s, n)

        seq = seq_sharding(mesh)
        args = (replicate(mesh, d["params"]), jax.device_put(d["x"], seq),
                jax.device_put(sigmas, data_axis), jax.device_put(noise, seq))

        def run(f):
            loss, grads = f(*args)
            return float(loss), _sd(grads)

        return jax.jit(jax.value_and_grad(loss_of)).lower(*args), run

    stages = make_mesh(2, axis_name="stage", backend="cpu")

    def pipeline(kind):
        d = data[kind]

        def both(p):
            run = dict(mesh=stages, n_micro=JAX_N_MICRO)
            args = (d["jm"], p, jnp.asarray(d["props"]),
                    jnp.asarray(d["output"]))
            logits = jpp.pipeline_forward(*args, **run)
            return jpp.pipeline_forward(*args, return_loss=True,
                                        **run), logits

        def run(f):
            (loss, logits), grads = f(d["params"])
            return np.asarray(logits), float(loss), _sd(grads)

        return jax.jit(jax.value_and_grad(both, has_aux=True)).lower(
            d["params"]), run

    def ep():
        d = data["gpt"]
        ep_mesh = jep.make_mesh_ep(2, 2, backend="cpu")
        placed, _ = jep.shard_params_ep(ep_mesh, d["params"], 4)
        tx = optax.chain(_keep_grads(), optax.sgd(SGD_LR))
        args = (jtrainer.TrainState.create(placed, tx),
                jep.shard_batch_ep(ep_mesh, jnp.asarray(d["ids"])),
                jax.random.PRNGKey(0))

        def run(f):
            state, loss = f(*args)
            return float(loss), _sd(state.opt_state[0])

        return jtrainer.make_gpt_train_step(
            d["jm"], tx, donate=False, aux_loss_weight=1e-2).lower(
                *args), run

    jobs = {"tp": tp, "sp": sp, "m1": m1, "ep": ep}
    for kind in ("MoleculeTransformer", "MoleculeTransformerSequence"):
        jobs[kind] = functools.partial(pipeline, kind)
    lowered = {k: job() for k, job in jobs.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(
            lambda lr: lr[0].compile(compiler_options=FAST_COMPILE),
            lowered.values())))
    out = {k: run(compiled[k]) for k, (_, run) in lowered.items()}
    out["tp_specs"] = jtp.tensor_parallel_specs(
        data["tp"]["params"], jtp.make_mesh_2d(1, 2, backend="cpu"),
        min_elements=MIN_ELEMENTS)
    return out


# -------------------------------------------------------------- bands --

def _excess(got, want, tol, atol=0.0) -> float:
    return float(np.abs(got - want).max() - tol * np.abs(want).max() - atol)


def _within(got: dict, want: dict, tol: float, floor: float = 0.0) -> None:
    """Every tensor within ``tol`` of its scale plus ``floor`` of the
    largest magnitude of ``want``."""
    assert set(got) == set(want)
    atol = floor * max(np.abs(v).max() for v in want.values())
    worst = max(want, key=lambda k: _excess(got[k], want[k], tol, atol))
    assert _excess(got[worst], want[worst], tol, atol) <= 0, worst


def _close(got: dict, want: dict, rtol: float, atol: float) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                   err_msg=name)


def _moved(after: dict, before: dict, rtol: float, atol: float) -> int:
    return sum(not np.allclose(after[k], before[k], rtol=rtol, atol=atol)
               for k in after)


# ------------------------------------------------------------------ tp --

def _torch_axes(leaf: str, ndim: int):
    """The JAX dim of each torch dim (``nn.jax_import``'s transposes)."""
    if leaf == "kernel":
        return tuple(reversed(range(ndim)))
    if leaf == "tkernel":
        return (1, 2, 0)
    return tuple(range(ndim))


def test_tp_specs_match_jax(data, jax_runs, ranks):
    """Every leaf is sharded along the dim JAX's ``tensor_parallel_specs``
    shards it (in the port's layout), or kept whole where JAX keeps it
    whole; a sharded model reports the same placements."""
    flat = _flatten(jax_runs["tp_specs"])
    want = {}
    for path, value in _flatten(data["tp"]["params"]).items():
        leaf = path[-1]
        spec = tuple(flat[path]) + (None,) * (value.ndim - len(flat[path]))
        axes = _torch_axes(leaf, value.ndim)
        torch_spec = tuple(spec[axes[i]] for i in range(value.ndim))
        want[torch_key(path[:-1] + (_LEAF_NAMES.get(leaf, leaf),))] = (
            torch_spec if "model" in torch_spec else ())
    for shape in ((1, 2), (2, 2)):
        for r in ranks[shape]:
            assert r["tp"]["specs"] == want
            assert r["tp"]["report"] == want
    assert sum(bool(s) for s in want.values()) > len(want) // 3


def _jax_shards(params, specs, mesh) -> dict:
    """Each device's slice of every sharded JAX leaf, by JAX's spec, in the
    port's layout and name: {torch name: {mesh coordinates: array}}."""
    flat, flat_specs = _flatten(params), _flatten(specs)
    out = {}
    for path, value in flat.items():
        spec = flat_specs[path]
        if not any(spec):
            continue
        placed = jax.device_put(value, NamedSharding(mesh, spec))
        axes = _torch_axes(path[-1], value.ndim)
        name = torch_key(path[:-1] + (_LEAF_NAMES.get(path[-1], path[-1]),))
        out[name] = {
            tuple(int(c) for c in np.argwhere(mesh.devices == sh.device)[0]):
            np.transpose(np.asarray(sh.data), axes)
            for sh in placed.addressable_shards}
    return out


def test_tp_and_ep_shards_are_jax_slices(data, ranks):
    """Each rank's tensor-parallel shard of a leaf is the slice of JAX's
    array that JAX's ``tensor_parallel_specs`` gives the device at its mesh
    coordinates (in the port's layout); each rank's experts likewise under
    ``expert_parallel_specs``."""
    tp_mesh = jtp.make_mesh_2d(2, 2, backend="cpu")
    want = _jax_shards(data["tp"]["params"], jtp.tensor_parallel_specs(
        data["tp"]["params"], tp_mesh, min_elements=MIN_ELEMENTS), tp_mesh)
    ep_mesh = jep.make_mesh_ep(2, 2, backend="cpu")
    ep_want = _jax_shards(data["gpt"]["params"], jep.expert_parallel_specs(
        data["gpt"]["params"], 4), ep_mesh)
    for key, want_all in (("tp", want), ("ep", ep_want)):
        for r in ranks[(2, 2)]:
            got = r[key]
            assert set(got["shards"]) == set(want_all)
            for name, shard in got["shards"].items():
                np.testing.assert_array_equal(
                    shard, want_all[name][got["coords"]], name)


def test_tp_shards_hold_half(ranks):
    """Each model rank holds half of every sharded leaf (not FSDP under
    another name: the products run on the shards)."""
    for r in ranks[(1, 2)]:
        assert r["tp"]["held"] * 2 == r["tp"]["sharded"] > 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_step_equals_one_process_and_jax(data, jax_runs, singles, ranks,
                                            shape):
    """Two SGD steps tensor-parallel on JAX's draws: the losses, the
    second step's grads and the parameters after, against one process and
    against JAX's tp step; the replicated parameters are the same bits on
    every rank."""
    losses, grads, params = jax_runs["tp"]
    one = singles["tp"]
    got = ranks[shape][0]["tp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close(got["grads"], grads, 1e-4, 1e-5)
    _close(got["params"], params, 1e-4, 1e-5)
    np.testing.assert_allclose(got["losses"], one[0], rtol=1e-5)
    _within(got["grads"], one[1], 1e-5)
    _within(got["params"], one[2], 1e-5)
    assert _moved(got["params"], data["tp"]["sd"], 1e-4, 1e-5) > len(
        params) // 2
    for r in ranks[shape][1:]:
        assert r["tp"]["losses"] == got["losses"]
        for k in params:
            assert np.array_equal(r["tp"]["params"][k], got["params"][k]), k


# ------------------------------------------------------------------ sp --

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sp_tiny_qm_step_equals_one_process_and_jax(data, jax_runs, singles,
                                                    ranks, shape):
    """JAX's tiny QM model of ``test_sp_train_step_equals_replicated_
    oracle`` (3 SGD steps at 1e-3), its length over 'seq' (8 columns: 4
    a rank, then 2 after the downsample, whose left halo is 2): against one
    process at that test's bands (the losses within rtol 1e-5, the
    parameters within atol 1e-6), and against JAX's sp step at the port's
    training band with JAX (the losses within rtol 1e-5, the parameters
    within rtol 1e-4 / atol 1e-5: JAX's one device and the port's one
    process already differ by 2.4e-6 here); the steps move the parameters
    past the first band."""
    losses, _, params = jax_runs["sp"]
    one = singles["tiny"]
    got = ranks[shape][0]["sp_tiny"]
    np.testing.assert_allclose(got["losses"], one[0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close(got["params"], one[2], 0.0, 1e-6)
    _close(got["params"], params, 1e-4, 1e-5)
    assert _moved(got["params"], data["tiny"]["sd"], 0.0, 1e-6) > len(
        params) // 2


@pytest.mark.parametrize("route", ["fused", "module"])
def test_sp_model1d_equals_one_process_and_jax(data, jax_runs, singles,
                                               ranks, route):
    """A Model1d with an attention level and two factor-4 levels, its
    length over 2 ranks (halos equal to the local length at two levels,
    the ends of the sequence zeros): the loss and grads of a step against
    one process and JAX's loss under ``seq_sharding``.  "fused": the
    attention level on the stack's fused route (x gathered, the rank's
    rows kept); "module": the composition (queries local, K/V gathered)."""
    loss, grads = jax_runs["m1"]
    one = singles["m1"]
    got = ranks[(1, 2)][0][f"sp_m1_{route}"]
    assert got["local_length"] == 32
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], one[0][0], rtol=1e-5)
    _within(got["grads"], grads, 1e-5, 1e-6)
    _within(got["grads"], one[1], 1e-5, 1e-6)


def test_sp_relative_bias_equals_one_process(data, singles, ranks):
    """A UNet whose stack carries the relative position bias in self- and
    cross-attention (the composition route: the stack kernel takes no
    bias), its length over 2 ranks: each rank's queries take the bias of
    their positions in the whole sequence, so the output and the grads
    equal one process's."""
    one = singles["rel"]
    # the down, bottleneck and up stacks, each in self- and cross-attention
    assert one["biases"] == 6
    got = [r["rel_pos"] for r in ranks[(1, 2)]]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got], 1),
                               one["y"], rtol=1e-5, atol=1e-5)
    for g in got:
        _within(g["grads"], one["grads"], 1e-5, 1e-6)


def test_the_mesh_names_the_mode(ranks):
    """The train steps take their mode from the mesh's names, never from
    the model's state: the tensor-parallel ``("data", "model")`` mesh
    refuses an unsharded model, the sequence mesh a sharded one."""
    got = ranks[(1, 2)][0]["mode_errors"]
    assert "shard_params_tp" in got["unsharded_on_tp"]
    assert "make_mesh_sp" in got["unsharded_on_tp"]
    assert "whole weights" in got["sharded_on_sp"]


def test_shard_seq_rank_routing(ranks):
    """JAX's routing on a 2 x 2 mesh: rank >= 3 leaves by (rows, length),
    rank 2 by rows, rank 1 whole; ``shard_batch_sp`` likewise."""
    tree = {"scalar_per_example": np.arange(8, dtype=np.float32),
            "cond": np.arange(8 * 12, dtype=np.float32).reshape(8, 12),
            "acts": np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4),
            "acts4": np.arange(8 * 16 * 4 * 2,
                               dtype=np.float32).reshape(8, 16, 4, 2)}
    for r in ranks[(2, 2)]:
        got = r["routing"]
        d, m = got["coords"]
        rows, cols = slice(4 * d, 4 * d + 4), slice(8 * m, 8 * m + 8)
        np.testing.assert_array_equal(got["scalar_per_example"],
                                      tree["scalar_per_example"])
        np.testing.assert_array_equal(got["cond"], tree["cond"][rows])
        np.testing.assert_array_equal(got["acts"], tree["acts"][rows, cols])
        np.testing.assert_array_equal(got["acts4"],
                                      tree["acts4"][rows, cols])
        np.testing.assert_array_equal(got["sp_cond"], tree["cond"][rows])
        np.testing.assert_array_equal(got["sp_target"],
                                      tree["acts"][rows, cols])
        assert got["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]


# ------------------------------------------------------------------ pp --

@pytest.mark.parametrize("kind", ["MoleculeTransformer",
                                  "MoleculeTransformerSequence"])
def test_stack_layer_params_equals_jax(data, kind):
    """The port's stacked leaves of JAX's weights equal JAX's
    ``stack_layer_params``, leaf for leaf under the name map; unstacking
    gives the weights back."""
    d = data[kind]
    jstacked, jrest = jpp.stack_layer_params(d["params"], d["jm"].depth)
    sd = {k: torch.as_tensor(v) for k, v in d["sd"].items()}
    stacked, rest = parallel.stack_layer_params(sd, d["jm"].depth)
    want = {}
    for i in range(d["jm"].depth):
        layer = {f"layers_{i}_{sfx}": jax.tree_util.tree_map(
            lambda a: a[i], tree) for sfx, tree in jstacked.items()}
        for name, v in state_dict_from_jax_params(layer).items():
            want.setdefault(name.split(".", 2)[2], []).append(v)
    assert set(stacked) == set(want)
    for name, vs in want.items():
        np.testing.assert_array_equal(stacked[name].numpy(),
                                      torch.stack(vs).numpy(), name)
    assert set(rest) == set(state_dict_from_jax_params(jrest))
    back = parallel.unstack_layer_params(stacked, rest)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_split_microbatches_refuses_an_odd_split(ranks):
    with pytest.raises(ValueError):
        parallel.split_microbatches(torch.zeros(5, 3), 2)
    assert parallel.split_microbatches(torch.arange(6.0), 3).shape == (3, 2)
    errors = ranks[(1, 2)][0]["pp_errors"]
    assert "n_micro" in errors["odd_split"]
    assert "stages" in errors["odd_depth"]


@pytest.mark.parametrize("kind", ["MoleculeTransformer",
                                  "MoleculeTransformerSequence"])
def test_pipeline_equals_sequential_and_jax(jax_runs, singles, ranks, kind):
    """The continuous and the token decoder, 2 stages of 2 layers, at 1, 2
    and 4 micro-batches: the logits, the loss and every grad (the layers'
    under their per-layer names) against the sequential trunk and JAX's
    ``pipeline_forward`` (at ``JAX_N_MICRO``), on every stage; each stage
    holds 2 layers."""
    logits, loss, grads = singles[kind]
    for r in ranks[(1, 2)]:
        got = r[kind]
        assert got["local_depth"] == 2
        for n_micro in N_MICRO:
            jlogits, jloss, jgrads = jax_runs[kind]
            run = got[n_micro]
            np.testing.assert_allclose(run["logits"], logits, atol=1e-5)
            np.testing.assert_allclose(run["logits"], jlogits, atol=1e-5)
            assert abs(run["loss"] - loss) <= 1e-5
            assert abs(run["loss"] - jloss) <= 1e-5
            _close(run["grads"], grads, 0.0, 1e-5)
            _close(run["grads"], jgrads, 0.0, 1e-5)


def test_pipeline_over_data_and_stages(singles, ranks):
    """A 2 x 2 (data, stage) mesh through ``make_transformer_train_step``
    with the CFG dropout's keep mask handed in: the loss and the grads
    (averaged over 'data') against one process on the whole batch."""
    _, loss, grads = singles["dropout"]
    for r in ranks[(2, 2)]:
        got = r["pp"]["step"]
        assert abs(got["loss"] - loss) <= 1e-5
        _close(got["grads"], grads, 0.0, 1e-5)


# ------------------------------------------------------------------ ep --

def test_ep_with_drops_equals_one_process_and_jax(data, jax_runs, singles,
                                                  ranks):
    """The MoE GPT at data 2 x expert 2 with a capacity factor of 0.5, at
    which tokens drop: T, the capacity, the slot-major priority and the aux
    loss are the global batch's, so the loss (aux weight 1e-2) and the grads
    equal one process on the whole batch and JAX's ``shard_params_ep``
    step; each rank holds 2 of the 4 experts, and the data ranks' dropped
    picks add up to one process's."""
    loss, grads, dropped = singles["gpt"]
    jloss, jgrads = jax_runs["ep"]
    assert all(d > 0 for d in dropped)
    results = ranks[(2, 2)]
    for r in results:
        got = r["ep"]
        assert got["experts_held"] == 2
        assert abs(got["loss"] - loss) <= 1e-6 * abs(loss)
        assert abs(got["loss"] - jloss) <= 1e-6 * abs(jloss)
        _close(got["grads"], grads, 0.0, 1e-5)
        _close(got["grads"], jgrads, 0.0, 1e-5)
        assert got["specs"]["layers.0.1.moe.w_in"] == ("expert", None, None)
        assert got["specs"]["layers.0.1.moe.router"] == ()
    # the ranks are (data, expert) row-major: ranks 0 and 2 are data ranks
    summed = np.add(results[0]["ep"]["dropped"], results[2]["ep"]["dropped"])
    np.testing.assert_array_equal(summed, dropped)


# ------------------------------------------------------ the collectives --

def test_reduce_from_backward_is_the_identity(ranks):
    """Trap 1: where every rank computes the same thing after a sum, the
    sum's backward is the identity.  x = rank + 1 on 2 ranks of 'model',
    loss = sum(2 y): ``reduce_from``'s grad is 2 (a summing backward gives
    4); ``copy_to``'s and ``psum``'s are summed (4); a gather with a slice
    backward, and ``ppermute``'s reverse hop."""
    for shape in ((1, 2), (2, 2)):
        for r in ranks[shape]:
            got = r["pair"]
            y, g = got["reduce_from"]
            np.testing.assert_array_equal(y, np.full(4, 3.0))
            np.testing.assert_array_equal(g, np.full(4, 2.0))
            np.testing.assert_array_equal(got["copy_to"][1], np.full(4, 4.0))
            np.testing.assert_array_equal(got["psum"][1], np.full(4, 4.0))
            np.testing.assert_array_equal(
                got["gather_slice"][0],
                np.concatenate([np.arange(4.0), np.arange(4.0) + 10])[None])
    y0, g0 = ranks[(1, 2)][0]["pair"]["ppermute"]
    y1, g1 = ranks[(1, 2)][1]["pair"]["ppermute"]
    np.testing.assert_array_equal(y0, np.zeros(4))
    np.testing.assert_array_equal(y1, np.arange(4.0))
    np.testing.assert_array_equal(g0, np.full(4, 3.0))
    np.testing.assert_array_equal(g1, np.zeros(4))


class _FakeTensor:
    def __init__(self, is_cuda):
        self.is_cuda = is_cuda


def test_staging_is_chosen_by_backend_and_device():
    """The host route is chosen before the call, from the group's backend
    and the tensor's device: gloo on a CUDA tensor for what gloo refuses
    there (send/recv), never under NCCL or on the CPU."""
    ax = object.__new__(collectives.Axis)
    for backend, cuda, collective, want in (
            ("gloo", True, "send_recv", True),
            ("gloo", True, "all_reduce", False),
            ("gloo", False, "send_recv", False),
            ("nccl", True, "send_recv", False)):
        ax.backend = backend
        assert ax.staged(_FakeTensor(cuda), collective) is want
    assert collectives.GLOO_STAGED == {"send_recv"}


# ----------------------------------------------- phase 33's rehearsal --

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def rehearsal(spawned):
    """Phase 33's code (``parallel_axes``) on the CPU at tiny widths in
    float32, run in a thread while the references compute (it waits on its
    spawned ranks): its return and the launches it held, recorded (on the
    CPU no kernel launches, so they are not compared)."""
    import sys as _sys
    smoke = _smoke()
    held = []
    smoke.check_launches = lambda what, got, want: held.append((what, want))
    for name, value in (
            ("FLAGSHIP", dict(QM, pred_dim=22)),
            ("LONG", dict(M1, attentions=(0, 1, 1))), ("SP_SAMPLES", 256),
            ("SP_BATCH", 2), ("SP_FP32_SAMPLES", 128), ("TP_BATCH", 8),
            ("AXES_FP32_BATCH", 4),
            ("AR_PRESET", dict(DEC, logits_dim=24)), ("AR_TRAIN_BATCH", 8),
            ("AR_TRAIN_TOKENS", 16), ("PP_MICRO", 2),
            ("GPT_PRESET", dict(dim=16, depth=2, heads=2, dim_head=8,
                                max_tokens=12, logits_dim=12)),
            ("GPT_MOE_BATCH", 8), ("GPT_TRAIN_TOKENS", 8),
            ("PARALLEL_DTYPE", "float32"), ("AXES_TIMEOUT", 120)):
        setattr(smoke, name, value)
    # a spawned rank unpickles its function by module name
    before = _sys.modules.get("chip_smoke")
    _sys.modules["chip_smoke"] = smoke
    pool = ThreadPoolExecutor(1)
    future = pool.submit(smoke.parallel_axes, torch.device("cpu"))
    yield smoke, future, held
    future.exception()
    pool.shutdown()
    if before is None:
        _sys.modules.pop("chip_smoke", None)
    else:
        _sys.modules["chip_smoke"] = before


def test_chip_smoke_runs_the_parallel_axes_phase(rehearsal):
    """The probe's pair, then tp, sp, pp and ep on two ranks, each against
    one process; the launches each rank must count follow the models'
    structure."""
    smoke, future, held = rehearsal
    got = future.result()
    want = dict(held)
    stacks, layers, _ = smoke.preset_stacks(smoke.FLAGSHIP)
    assert want["tp (rank 0)"]["STASH_LAUNCHES"] == stacks * 3
    assert want["tp (rank 1)"]["LAYER_BWD_LAUNCHES"] == layers * 3
    # the tiny long model's attention fuses (at most 64 tokens): K1 stash
    # a fused stack a step, no streaming kernel
    assert want["sp (rank 0)"]["STASH_LAUNCHES"] > 0
    assert want["sp (rank 0)"]["FLASH_FWD_LAUNCHES"] == 0
    assert {"pp (rank 1)", "ep (rank 0)"} <= set(want)
    assert not any(got["tp"].values()) and not any(got["sp"].values())
