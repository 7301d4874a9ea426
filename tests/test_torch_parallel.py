"""The port's data-parallel layer (``parallel/``) on the CPU: two ranks of a
gloo group, spawned by ``tests/torch_parallel_workers.py``, against the
same work in one process and against the JAX package's step.

The ranks run their bodies in two groups of one spawn each (``steps`` and
``paths``), so that the file costs two interpreters a rank, not one a test.

Bands.  Data parallelism changes only the order of the sums: the step's
loss within rtol 1e-5; grads, Adam's moments and parameters within 1e-5 of
each tensor's scale (its largest magnitude).  Adam moves a parameter by
~lr * sign(g) a step, and a grad near 0 whose last bits differ flips an
element by 2 lr, so no band on Adam's parameters can see its update: the
runs that hold parameters take plain SGD (``W.SGD``, as JAX's own DP test
does) at ``SGD_LR``, where two steps move them far past every band (each
such test checks that a step without the update would fail it), and the
runs on ``ClipAdam`` hold its moments, which take the clipped grads with
no sign in between.  Against JAX: PERF.md's training band (loss 1e-4,
grads and parameters rtol 1e-4 / atol 1e-5).  FSDP against DP: float32 as
DP; bfloat16 the losses alone (see ``test_fsdp_equals_dp``), over SGD
steps that change the weights' bf16 casts, and every stack's cached
kernel weights held equal to its weights at every call (a stale cache,
which FSDP's free-and-gather cycle could hide from a key on storage and
version).  On the CPU that cache does not stale even without the drop
before each FSDP forward; the card's check is ``chip_smoke.py``'s phase
32."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from moleculediffusiontransformer_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from moleculediffusiontransformer_tpu.diffusion import distributions as jdist
from moleculediffusiontransformer_tpu.models import qm_diffusion as jqm
from moleculediffusiontransformer_tpu.nn.torch_import import \
    state_dict_to_params
from moleculediffusiontransformer_tpu.parallel import fsdp_specs, make_mesh
from moleculediffusiontransformer_tpu.train import trainer as jtrainer
from moleculediffusiontransformer_tpu_torch import design
from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
    load_checkpoint
from moleculediffusiontransformer_tpu_torch.core.config import TrainConfig
from moleculediffusiontransformer_tpu_torch.data.tokenizer import \
    CharTokenizer
from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.nn.jax_import import (
    _LEAF_NAMES, _flatten, state_dict_from_jax_params, torch_key)
from moleculediffusiontransformer_tpu_torch.ops import cuda_build
from moleculediffusiontransformer_tpu_torch.train import trainer

import torch_parallel_workers as W

SMALL = dict(max_length=32, channels=32, pred_dim=8, text_embed_dim=16,
             embed_dim_position=16, context_embedding_max_length=12,
             multipliers=(1, 2), factors=(2,), num_blocks=(1,),
             attentions=(1,), attention_heads=2, attention_features=16,
             pre_transformer=1)
BATCH = 8
LR = 1e-6
SGD_LR = 0.1
MIN_ELEMENTS = 64
STEPS = 4                # sampling steps of the serving checks
TOL = 1e-5
JAX_KEY, JAX_STEPS = 9, 2


def _excess(got: np.ndarray, want: np.ndarray, tol: float,
            atol: float) -> float:
    """How far ``got`` strays past ``tol`` of ``want``'s scale plus
    ``atol`` (<= 0: within)."""
    return float(np.abs(got - want).max()
                 - tol * np.abs(want).max() - atol)


def _within(got: dict, want: dict, tol: float = TOL,
            atol: float = 0.0) -> None:
    assert set(got) == set(want)
    worst = max(want, key=lambda k: _excess(got[k], want[k], tol, atol))
    assert _excess(got[worst], want[worst], tol, atol) <= 0, worst


def _within_params(got: dict, want: dict, tol: float = TOL) -> None:
    """Parameters: a zero-initialised one (a bias) is its updates alone,
    ~lr a step, so each may also stray by 1% of an update."""
    _within(got, want, tol, atol=1e-2 * LR)


@pytest.fixture(scope="module")
def qm():
    """The small QM model's seeded weights as the port's state dict and as
    JAX's params (the template from ``eval_shape``: nothing compiled), a
    global batch of 8 and three steps' draws."""
    jm = jqm.QMDiffusion(**SMALL)
    sd = _seeded_state_dict(SMALL, 0)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.init, key, jnp.zeros((2, 12)),
                            jnp.zeros((2, 32, 8)), key)["params"]
    rng = np.random.default_rng(1)
    cond = rng.uniform(-1, 1, (BATCH, 12)).astype(np.float32)
    target = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (BATCH, 32))]
    draws = [(np.exp(rng.standard_normal(BATCH) * 1.2 - 1.2)
              .astype(np.float32),
              rng.standard_normal((BATCH, 32, 8)).astype(np.float32))
             for _ in range(3)]
    return dict(jm=jm, params=state_dict_to_params(sd, shapes), sd=sd,
                cond=cond, target=target, draws=draws)


def _seeded_state_dict(preset: dict, seed: int) -> dict:
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    model = tqm.QMDiffusion(**preset)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def _arrays(sd: dict) -> dict:
    """A state dict as numpy copies: what goes to the ranks (a tensor sent
    to a spawned process moves to shared memory, and a numpy view of its
    old storage would dangle)."""
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def tokenizer():
    tok = CharTokenizer()
    tok.fit_on_texts(["CCO", "C1=CC=CC=C1", "CC(=O)N", "[NH4+]", "C#N"])
    return tok


def _serving_preset(tokenizer) -> dict:
    return dict(SMALL, pred_dim=tokenizer.vocab_size)


def _batches(qm):
    """Two batches of (target, conditioning) host arrays: the (X, y) of an
    inverse-model iterator."""
    return [(qm["target"], qm["cond"]),
            (qm["target"][::-1].copy(), qm["cond"][::-1].copy())]


def _jax_draws(step: int):
    """What the JAX step's ``loss_from_key`` draws at ``step`` (from
    ``fold_in(key, step)``): PRNG calls alone, nothing compiled."""
    ks, kn = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(JAX_KEY), step))
    return (np.asarray(jdist.LogNormalDistribution(-1.2, 1.2)(ks, BATCH)),
            np.asarray(jax.random.normal(kn, (BATCH, 32, 8))))


def _step_calls(qm) -> dict:
    """The DP steps (A = 1, 2, the global batch's draws from a generator),
    the DP step on JAX's draws, FSDP against DP, the global norm over
    shards and the multi-host helpers."""
    base = (SMALL, _arrays(qm["sd"]), qm["cond"], qm["target"])
    draws = qm["draws"]
    calls = {
        "dp1": ("run_steps", (*base, None), dict(lr=LR, seed=5)),
        "dp2": ("run_steps", (*base, None),
                dict(lr=LR, seed=5, accumulation=2)),
        "jax": ("run_steps", (*base, [_jax_draws(i)
                                      for i in range(JAX_STEPS)]),
                dict(sgd=SGD_LR)),
        "helpers": ("multihost_helpers",
                    (np.arange(24, dtype=np.float32).reshape(4, 6),), {}),
        "norm": ("global_norm", (_arrays(qm["sd"]),), {}),
    }
    for dtype in (torch.float32, torch.bfloat16):
        for fsdp in (False, True):
            calls[f"{'fsdp' if fsdp else 'dp'}_{dtype}"] = (
                "run_steps", (*base, draws),
                dict(fsdp=fsdp, dtype=dtype, sgd=SGD_LR))
    for fsdp in (False, True):      # with the clip (0.5) and accumulation
        calls[f"{'fsdp' if fsdp else 'dp'}_accumulated"] = (
            "run_steps", (*base, draws),
            dict(fsdp=fsdp, accumulation=2, lr=LR))
    return calls


def _path_calls(qm, tokenizer, props, tmp: str) -> dict:
    """``train_diffusion`` over the group's mesh, replicated and FSDP,
    straight and resumed; the serving entry points over the mesh."""
    calls = {"loop_" + s: ("train_loops", (
        SMALL, _arrays(qm["sd"]), _batches(qm), os.path.join(tmp, s), s,
        LR), {}) for s in ("replicated", "fsdp")}
    calls["serving"] = ("serving", (
        _serving_preset(tokenizer),
        _arrays(_seeded_state_dict(_serving_preset(tokenizer), 3)),
        tokenizer.state_dict(), props, tmp, STEPS), {})
    return calls


@pytest.fixture(scope="module")
def spawned(qm, tokenizer, tmp_path_factory):
    """Both groups of ranks, started at once; the tests' one-process and
    JAX references are computed while they run."""
    tmp = tmp_path_factory.mktemp("ranks")
    props = np.random.default_rng(7).uniform(-1, 1, (4, 12)).astype(
        np.float32)
    return {"steps": W.Ranks(W.many, str(tmp / "steps"), _step_calls(qm)),
            "paths": W.Ranks(W.many, str(tmp / "paths"), _path_calls(
                qm, tokenizer, props, str(tmp / "paths"))),
            "props": props}


def _keep_grads():
    """An optax stage that passes the grads on and keeps them as its
    state: the step's grads, read after it."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def jax_run(qm, spawned):
    """The JAX package's ``make_diffusion_train_step`` on one device, with
    SGD: its losses, the last step's grads and the parameters after
    ``JAX_STEPS`` steps (the port's state dicts)."""
    import optax
    tx = optax.chain(_keep_grads(), optax.sgd(SGD_LR))
    state = jtrainer.TrainState.create(qm["params"], tx)
    step = jtrainer.make_diffusion_train_step(qm["jm"], tx, donate=False)
    key = jax.random.PRNGKey(JAX_KEY)
    cond, target = jnp.asarray(qm["cond"]), jnp.asarray(qm["target"])
    losses = []
    for _ in range(JAX_STEPS):
        state, loss = step(state, cond, target, key)
        losses.append(float(loss))
    return (losses, state_dict_from_jax_params(state.opt_state[0]),
            state_dict_from_jax_params(state.params))


def _moved(after: dict, before: dict, rtol: float, atol: float) -> int:
    """How many tensors of ``after`` lie outside the band around
    ``before``: a step that left the parameters as they were would pass a
    band that none of them leaves."""
    return sum(not np.allclose(after[k], np.asarray(before[k]), rtol=rtol,
                               atol=atol) for k in after)


@pytest.fixture(scope="module")
def singles(qm, spawned):
    """The one-process steps the two-rank DP steps are held against."""
    return {A: W.run_steps(None, SMALL, qm["sd"], qm["cond"], qm["target"],
                           None, lr=LR, seed=5, accumulation=A)
            for A in (1, 2)}


@pytest.fixture(scope="module")
def steps(spawned):
    return spawned["steps"].results()


def test_dp_train_step_matches_jax(qm, jax_run, steps):
    """The two-rank step on JAX's draws against the JAX package's
    single-device ``make_diffusion_train_step`` on the same weights, both
    with SGD: the losses, the grads of the second step (all-reduced, at the
    weights the first step left) and the parameters after 2 steps, which
    most tensors move past the band."""
    losses, grads, params = jax_run
    got = steps[0]["jax"]
    np.testing.assert_allclose(got["losses"], losses, atol=1e-4)
    for name, want in grads.items():
        np.testing.assert_allclose(got["grads"][name], want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name, want in params.items():
        np.testing.assert_allclose(got["params"][name], want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert _moved(got["params"], qm["sd"], 1e-4, 1e-5) > len(params) // 2


@pytest.mark.parametrize("accumulation", [1, 2])
def test_dp_train_step_on_mesh(singles, steps, accumulation):
    """Two ranks, each on its 4 rows, equal one process on the 8 (the JAX
    test of the same name): each rank draws the global batch's sigmas and
    noise from the step's generator, as the one process does, and takes
    its rows.  Loss, grads, Adam's moments and parameters after 2 steps;
    the parameters are the same bits on both ranks."""
    got = [r[f"dp{accumulation}"] for r in steps]
    want = singles[accumulation]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=TOL)
    assert got[0]["losses"] == got[1]["losses"]
    for k in ("grads", "mu", "nu"):
        _within(got[0][k], want[k])
    _within_params(got[0]["params"], want["params"])
    for k in want["params"]:
        assert np.array_equal(got[0]["params"][k], got[1]["params"][k]), k


def test_multihost_helpers(steps):
    """The multi-host helpers at two ranks, the global mesh (the group's,
    whole: a mesh over part of it is refused) and the placements."""
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, r in enumerate(steps):
        h = r["helpers"]
        assert h["local"] == 2 and h["count"] == 2
        assert "not divisible" in h["odd"]
        assert h["global"] == (2, ("data",)) and "2 ranks" in h["part"]
        assert h["placements"] == ([Shard(0)], [Replicate()])
        np.testing.assert_array_equal(h["shard"], full[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(h["a_local"],
                                      full[:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(h["a_full"], full)
        np.testing.assert_array_equal(h["b_local"], full)
        np.testing.assert_array_equal(h["repl"], full)


def _torch_axes(leaf: str, ndim: int):
    """The JAX dim of each torch dim (``nn.jax_import``'s transposes)."""
    if leaf == "kernel" or leaf == "in_proj_weight":
        return tuple(reversed(range(ndim)))
    if leaf == "tkernel":
        return (1, 2, 0)
    return tuple(range(ndim))


def test_fsdp_specs_match_jax(qm, steps):
    """Every parameter is sharded along the dim JAX's ``fsdp_specs`` shards
    (in the port's layout), or kept whole where JAX keeps it whole."""
    jspecs = fsdp_specs(qm["params"], make_mesh(2, backend="cpu"),
                        min_elements=MIN_ELEMENTS)
    flat = _flatten(jspecs)
    want = {}
    for path, value in _flatten(qm["params"]).items():
        leaf = path[-1]
        spec = tuple(flat[path]) + (None,) * (value.ndim - len(flat[path]))
        axes = _torch_axes(leaf, value.ndim)
        torch_spec = tuple(spec[axes[i]] for i in range(value.ndim))
        want[torch_key(path[:-1] + (_LEAF_NAMES.get(leaf, leaf),))] = (
            torch_spec if "data" in torch_spec else ())
    got = steps[0]["fsdp_torch.float32"]["specs"]
    assert got == want
    assert sum(bool(s) for s in got.values()) > len(got) // 2


def test_fsdp_state_is_sharded(qm, steps):
    """Each rank holds about half the parameters and moments: the
    parameters below ``min_elements`` (and those without an even dim) are
    the only ones held whole."""
    total = 3 * sum(v.numel() for v in qm["sd"].values())
    held = [r["fsdp_accumulated"]["held"] for r in steps]
    assert sum(held) >= total
    assert all(h <= 0.52 * total for h in held), (held, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_equals_dp(qm, steps, dtype):
    """Three SGD steps with FSDP against three with DP; the kernel weight
    caches never stale.  Float32: the losses, the last grads and the
    parameters, which the steps move past the band.  Bfloat16: the losses
    (the first within 1e-5, the others within 1e-4 relative: one step's
    bf16 grads differ by up to ~1% of their scale between FSDP and DP, as
    between DP and one process, so the weights the next steps see differ
    too), on weights whose bf16 casts the steps change."""
    for r in steps:
        fsdp, dp = r[f"fsdp_torch.{dtype}"], r[f"dp_torch.{dtype}"]
        assert fsdp["stale"] == [] and dp["stale"] == []
        if dtype == "float32":
            np.testing.assert_allclose(fsdp["losses"], dp["losses"],
                                       rtol=TOL)
            _within(fsdp["grads"], dp["grads"])
            _within(fsdp["params"], dp["params"])
            assert _moved(dp["params"], qm["sd"], TOL, 0.0) > len(
                qm["sd"]) // 2
        else:
            assert abs(fsdp["losses"][0] - dp["losses"][0]) <= TOL * abs(
                dp["losses"][0])
            np.testing.assert_allclose(fsdp["losses"], dp["losses"],
                                       rtol=1e-4)
            assert _moved(dp["params"], qm["sd"], 1e-2, 0.0) > len(
                qm["sd"]) // 2


def test_fsdp_composes_with_accumulation(steps):
    """FSDP at 2 micro-batches with the clip at 0.5 (the norm's squares
    all-reduced over the shards) against DP at 2: the losses, the grads and
    Adam's moments (the clipped grads) after 2 steps."""
    fsdp, dp = (steps[0][f"{k}_accumulated"] for k in ("fsdp", "dp"))
    np.testing.assert_allclose(fsdp["losses"], dp["losses"], rtol=TOL)
    _within_params(fsdp["params"], dp["params"])
    for k in ("grads", "mu", "nu"):
        _within(fsdp[k], dp[k])


def test_global_norm_over_shards(qm, steps):
    """``ClipAdam``'s norm of grads sharded over two ranks (and some kept
    whole) equals the norm of the whole grads."""
    want = trainer._global_norm(list(qm["sd"].values())).item()
    for r in steps:
        assert abs(r["norm"] - want) <= 1e-6 * want


# ---------------------------------------------------- the loop, serving --

@pytest.fixture(scope="module")
def paths(spawned):
    return spawned["paths"].results(), spawned["props"]


def _single_loop(qm, tmp):
    model = W.qm_model(SMALL, qm["sd"])
    config = TrainConfig(batch_size=BATCH, epochs=2, learning_rate=LR,
                         print_loss_every=1)
    _, logger = trainer.train_diffusion(
        model, lambda: iter(_batches(qm)), config, checkpoint_dir=str(tmp),
        eval_fn=W.probe(model))
    return logger.history, model


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_train_diffusion_over_the_group(qm, paths, tmp_path, sharding):
    """``train_diffusion`` with no mesh argument trains over the group's
    two ranks (replicated or FSDP): rank 0 logs the global losses and the
    evals of one process's run, the other rank nothing, and the last
    checkpoint (one file, the full state) loads into a one-process model
    with the one-process run's parameters, and holds its Adam moments."""
    results, _ = paths
    want_log, model = _single_loop(qm, tmp_path)
    logs = results[0][f"loop_{sharding}"]["logs"]
    assert results[1][f"loop_{sharding}"]["logs"]["straight"] == []
    got_log = logs["straight"]
    assert [sorted(r) for r in got_log] == [sorted(r) for r in want_log]
    for got, want in zip(got_log, want_log):
        for k in ("loss", "probe"):
            if k in want:
                assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (k, got)
    ckpt = load_checkpoint(os.path.join(
        results[0][f"loop_{sharding}"]["straight"], "step_4.pt"))
    one = W.qm_model(SMALL, qm["sd"])
    one.load_state_dict(ckpt["model"], strict=True)
    _within_params({k: v.numpy() for k, v in one.state_dict().items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})
    assert ckpt["step"] == 4 and ckpt["epoch"] == 2
    want = load_checkpoint(os.path.join(tmp_path, "step_4.pt"))["adam"]
    for m in ("mu", "nu"):
        assert set(ckpt["adam"][m]) == set(qm["sd"])
        _within({k: v.numpy() for k, v in ckpt["adam"][m].items()},
                {k: v.numpy() for k, v in want[m].items()})


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_train_diffusion_resume_over_the_group(paths, sharding):
    """One epoch, then one more resumed (every rank restores the one file
    and takes its shard), equals two straight: checkpoints bitwise."""
    run = paths[0][0][f"loop_{sharding}"]
    a, b = (load_checkpoint(os.path.join(run[k], "step_4.pt"))
            for k in ("straight", "resumed"))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for m in ("mu", "nu"):
        for k in a["adam"][m]:
            assert torch.equal(a["adam"][m][k], b["adam"][m][k]), (m, k)
    logs = run["logs"]
    assert [r.get("loss") for r in logs["straight"]] == [
        r.get("loss") for r in logs["first"] + logs["resumed"]]


def test_train_diffusion_fsdp_needs_a_group(qm):
    model = W.qm_model(SMALL, qm["sd"])
    config = TrainConfig(batch_size=BATCH, param_sharding="fsdp")
    with pytest.raises(ValueError, match="process group"):
        trainer.train_diffusion(model, lambda: iter(_batches(qm)), config)
    with pytest.raises(ValueError, match="Orbax"):
        trainer.train_diffusion(model, lambda: iter(_batches(qm)),
                                TrainConfig(checkpoint_backend="orbax"))


def test_a_group_of_one_trains_without_collectives(monkeypatch):
    """In a process that has joined a group of one (a lone ``torchrun``
    rank, or ``make_mesh`` called once), ``train_diffusion`` trains on one
    card unless FSDP or a mesh is asked for."""
    from moleculediffusiontransformer_tpu_torch.parallel import mesh as pm
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    monkeypatch.setattr(pm, "make_mesh", lambda device: ("mesh", device))
    cpu = torch.device("cpu")
    assert trainer.training_mesh(TrainConfig(), None, cpu) is None
    assert trainer.training_mesh(TrainConfig(), "given", cpu) == "given"
    assert trainer.training_mesh(TrainConfig(param_sharding="fsdp"), None,
                                 cpu) == ("mesh", "cpu")


def _serving_model(tokenizer):
    return W.qm_model(_serving_preset(tokenizer),
                      _seeded_state_dict(_serving_preset(tokenizer), 3))


def test_generate_from_conditioning_mesh_serving(paths, tokenizer):
    """Two ranks serve one request of 4 (2 rows each): the same SMILES as
    one process and ``raw_samples`` within 1e-5; a batch of 3, padded to 4,
    returns 3 rows."""
    results, props = paths
    model = _serving_model(tokenizer).eval()
    want = design.generate_from_conditioning(
        model, props, tokenizer, torch.Generator().manual_seed(3),
        cond_scale=2.0, timesteps=STEPS)
    for r in results:
        got = r["serving"]
        assert got["even"]["smiles"] == want["smiles"]
        np.testing.assert_allclose(got["even"]["raw_samples"],
                                   want["raw_samples"], atol=TOL)
        assert len(got["padded"]["smiles"]) == 3
        assert got["padded"]["raw_samples"].shape[0] == 3


def test_export_sampler_mesh_served_on_two_ranks(paths, tokenizer,
                                                 tmp_path):
    """The sampler exported with ``mesh=`` (each rank's program 2 rows of
    4) served on both ranks equals the one-card artifact served in one
    process, on the same checkpoint and seed, within 1e-5; that artifact
    refuses to load without its mesh, and a batch that does not divide
    the mesh refuses to export."""
    results, props = paths
    got = results[0]["serving"]
    assert "divide" in got["odd_batch"]
    model = _serving_model(tokenizer).eval()
    path = str(tmp_path / "single.pt2")
    dx.save_artifact(dx.export_sampler(model, batch=len(props),
                                       num_steps=STEPS, cond_scale=2.0,
                                       device="cpu"), path)
    want = design.ArtifactServer(path, got["checkpoint"],
                                 device="cpu").call(props, seed=5).numpy()
    for r in results:
        np.testing.assert_allclose(r["serving"]["served"], want, atol=TOL)
    with pytest.raises(ValueError, match="mesh"):
        design.ArtifactServer(got["artifact"], got["checkpoint"],
                              device="cpu")


def test_other_exporters_refuse_a_mesh(tokenizer):
    model = _serving_model(tokenizer)
    with pytest.raises(ValueError, match="export_sampler only"):
        dx.export_inpainter(model, batch=2, mesh=object(), device="cpu")


def test_builds_take_turns(tmp_path, monkeypatch):
    """Two processes building one library at once (two ranks on a fresh
    tree): nvcc runs once, and both get the library."""
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text("#!/bin/sh\necho x >> " + str(calls) + "\nsleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        cuda_build.build("transformer1d_fwd.cu"))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls.read_text().split()) == 1
    assert sorted(s > 0 for _, s in results) == [False, True]
    assert results[0][0] == results[1][0] and results[0][0].exists()
