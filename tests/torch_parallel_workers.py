"""Rank bodies of ``tests/test_torch_parallel.py``, and the launcher that
runs them: torch and the port only, since each rank is a fresh interpreter
(``spawn``) and a JAX import would cost it seconds.  The parent test
computes the JAX side and hands numpy arrays and state dicts in.

``Ranks(fn, tmp, *args)`` starts ``fn(mesh, *args)`` on two ranks of a gloo
group on the CPU (rendezvous through a file under ``tmp``, so that tests
running side by side never share a port); the caller works on until it
needs each rank's result (``results()``).
The group's join and every collective time out after ``TIMEOUT`` seconds,
and the launcher stops waiting at ``TIMEOUT`` too: a hung collective fails
its test."""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

TIMEOUT = 60
WORLD = 2


def _entry(rank: int, fn: Callable, tmp: str, args: tuple,
           kwargs: dict) -> None:
    import torch.distributed as dist

    from moleculediffusiontransformer_tpu_torch.parallel import (
        distributed_init, make_mesh)
    torch.set_num_threads(1)         # the ranks share the host's cores
    distributed_init(f"file://{os.path.join(tmp, 'rendezvous')}", WORLD,
                     rank, device="cpu",
                     timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        result = fn(make_mesh(device="cpu"), *args, **kwargs)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


class Ranks:
    """``fn(mesh, *args, **kwargs)`` started on each of ``WORLD`` ranks;
    ``results()`` waits for them (at most ``TIMEOUT`` seconds from the
    start) and returns each rank's result."""

    def __init__(self, fn: Callable, tmp: str, *args: Any, **kwargs: Any):
        import tempfile

        import torch.multiprocessing as mp
        os.makedirs(tmp, exist_ok=True)
        self.tmp = tempfile.mkdtemp(dir=tmp)     # a fresh rendezvous file
        self.name = fn.__name__
        self.deadline = time.monotonic() + TIMEOUT
        self.ctx = mp.start_processes(
            _entry, args=(fn, self.tmp, args, kwargs), nprocs=WORLD,
            join=False, start_method="spawn")

    def results(self) -> List[Any]:
        try:
            while not self.ctx.join(
                    timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.name} ran past {TIMEOUT} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(WORLD)]


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def qm_model(preset: dict, state_dict, dtype=torch.float32):
    """The small QM model of ``preset`` holding ``state_dict`` (tensors or
    arrays)."""
    from moleculediffusiontransformer_tpu_torch.models import qm_diffusion
    model = qm_diffusion.QMDiffusion(**preset, dtype=dtype)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()}, strict=True)
    return model


# ------------------------------------------------------------ the steps --

class SGD:
    """Plain SGD, ``p -= lr g`` (the update JAX's own DP test takes): its
    update moves a parameter in proportion to its grad, so a band on the
    parameters sees the update where Adam's ``~lr sign(g)`` would flip
    with a grad's last bits."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        from moleculediffusiontransformer_tpu_torch.train import trainer
        torch._foreach_add_(trainer._local(params), trainer._local(grads),
                            alpha=-self.lr)


def run_steps(mesh, preset, state_dict, cond, target, draws, *,
              accumulation=1, seed=None, fsdp=False, dtype=torch.float32,
              lr=2e-4, clip=0.5, sgd=None):
    """Steps of ``make_diffusion_train_step`` over ``mesh`` (or on one
    process when ``mesh`` is None) on the global batch ``cond``, ``target``:
    step i takes ``draws[i]`` (the global sigmas and noise, this rank's rows
    handed in) or, with ``seed``, a generator seeded ``seed + i``.  The
    optimizer is ``ClipAdam`` (``lr``, ``clip``), or ``SGD(sgd)``.  Returns
    the losses, the final parameters, the last step's grads and Adam's
    moments (whole) and, under FSDP, the elements of the parameters and
    moments this rank holds."""
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        checkpoint_state
    from moleculediffusiontransformer_tpu_torch.parallel import (
        replicate, shard_batch, shard_state_fsdp)
    from moleculediffusiontransformer_tpu_torch.train import trainer
    model = qm_model(preset, state_dict, dtype)
    opt = SGD(sgd) if sgd else trainer.make_optimizer(
        trainer.OptimizerConfig(learning_rate=lr, grad_clip_norm=clip))
    state = trainer.TrainState.create(model, opt)
    out = {"stale": _stale_kernel_params(model)}
    if mesh is not None:
        replicate(mesh, model)
        if fsdp:
            adam = None if sgd else state
            out["specs"] = shard_state_fsdp(model, adam, mesh,
                                            min_elements=64)[1]
            moments = [] if sgd else [*state.opt_state.mu,
                                      *state.opt_state.nu]
            out["held"] = sum(t.numel() for t in trainer._local(
                [*model.parameters(), *moments]))
    step = trainer.make_diffusion_train_step(model, opt, accumulation,
                                             mesh=mesh)

    def mine(*ts):
        ts = tuple(torch.as_tensor(t) for t in ts)
        return ts if mesh is None else shard_batch(mesh, ts)

    c, t = mine(cond, target)
    losses = []
    for i in range(len(draws) if seed is None else 2):
        if seed is None:
            sigmas, noise = mine(*draws[i])
            loss = step(state, c, t, sigmas=sigmas, noise=noise)
        else:
            loss = step(state, c, t, torch.Generator().manual_seed(seed + i))
        losses.append(loss.item())
    out["losses"] = losses
    out["params"] = _numpy(checkpoint_state(model)["model"])
    names = [n for n, _ in model.named_parameters()]
    out["grads"] = _numpy({n: whole(p.grad)
                           for n, p in model.named_parameters()})
    if not sgd:
        for m in ("mu", "nu"):
            out[m] = _numpy({n: whole(x) for n, x in zip(
                names, getattr(state.opt_state, m))})
    return out


def whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def many(mesh, calls: dict) -> dict:
    """Several bodies in one group, one after another: ``calls`` maps a
    name to (the name of a function of this module, args, kwargs); each
    runs as ``fn(mesh, *args, **kwargs)``."""
    return {name: globals()[fn](mesh, *args, **kwargs)
            for name, (fn, args, kwargs) in calls.items()}


def _stale_kernel_params(model) -> list:
    """Forward hooks on every ``Transformer1d`` of ``model`` that record,
    at each call, the parameters whose cached kernel weights differ from
    the weights the stack holds then (what FSDP2 would hide from a cache
    keyed on storage and version)."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    stale = []

    def check(m, args, out):
        cached, casts = m.kernel_params(), m.kernel_casts()
        for name, p in m.named_parameters():
            if not torch.equal(cached[name], casts.get(name, p).detach()):
                stale.append(name)

    for m in model.modules():
        if isinstance(m, Transformer1d):
            m.register_forward_hook(check)
    return stale


def multihost_helpers(mesh, full: np.ndarray):
    """The multi-host helpers on a (4, 6) array every rank holds."""
    from moleculediffusiontransformer_tpu_torch import parallel
    local = parallel.process_local_batch_size(full.shape[0], mesh)
    try:
        parallel.process_local_batch_size(full.shape[0] + 1, mesh)
        odd = None
    except ValueError as e:
        odd = str(e)
    rank = mesh.get_local_rank()
    mine = full[rank * local:(rank + 1) * local]
    (got,) = parallel.shard_batch_global(mesh, (mine,))
    placed = parallel.place_global(mesh, {"a": full, "b": full},
                                   {"a": (None, "data"), "b": ()})
    repl = parallel.replicate_global(mesh, [full])
    whole = parallel.make_global_mesh(device="cpu")
    try:
        parallel.make_mesh(num_devices=1, device="cpu")
        part = None
    except ValueError as e:
        part = str(e)
    return {"local": local, "odd": odd, "count":
            parallel.mesh_process_count(mesh),
            "global": (whole.size(), whole.mesh_dim_names), "part": part,
            "placements": (parallel.batch_sharding(mesh),
                           parallel.replicated(mesh)),
            "shard": got.numpy(), "a_local": placed["a"].to_local().numpy(),
            "a_full": placed["a"].full_tensor().numpy(),
            "b_local": placed["b"].to_local().numpy(),
            "repl": repl[0].to_local().numpy()}


def global_norm(mesh, grads: dict) -> float:
    """``ClipAdam``'s global norm of ``grads`` (whole arrays every rank
    holds) sharded along dim 0 where they divide, the rest whole."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    specs = {k: ("data",) + (None,) * (v.ndim - 1)
             if v.shape[0] % mesh.size() == 0 else ()
             for k, v in grads.items()}
    placed = parallel.place_global(mesh, grads, specs)
    return trainer._global_norm(list(placed.values())).item()


# ------------------------------------------------------------- the loop --

def train_loops(mesh, preset, state_dict, batches, tmp, sharding, lr):
    """``train_diffusion`` over the group's default mesh: 2 epochs into
    ``tmp/straight``, 1 into ``tmp/resumed`` and 1 more resumed there; under
    FSDP the same again on the Orbax checkpoint tier (``_orbax`` after its
    directories and runs); an ``eval_fn`` that samples (through every model
    method, not the forward).  Returns rank 0's logs, the checkpoint paths
    and, under FSDP, ``orbax_shards``' record of the Orbax straight run's
    last checkpoint."""
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.train import trainer
    out, logs = {}, {}
    tiers = [("msgpack", "")] + ([("orbax", "_orbax")] if sharding == "fsdp"
                                 else [])
    for backend, tag in tiers:
        straight, resumed = (os.path.join(tmp, d + tag)
                             for d in ("straight", "resumed"))
        out.update({"straight" + tag: straight, "resumed" + tag: resumed})
        for name, epochs, directory, resume in (
                ("straight", 2, straight, False),
                ("first", 1, resumed, False),
                ("resumed", 1, resumed, True)):
            model = qm_model(preset, state_dict)
            config = TrainConfig(batch_size=len(batches[0][0]),
                                 epochs=epochs, learning_rate=lr,
                                 print_loss_every=1, param_sharding=sharding,
                                 fsdp_min_elements=64,
                                 checkpoint_backend=backend)
            state, logger = trainer.train_diffusion(
                model, lambda: iter(batches), config,
                checkpoint_dir=directory, resume=resume,
                eval_fn=probe(model))
            logs[name + tag] = logger.history
            if (backend, name, sharding) == ("orbax", "straight", "fsdp"):
                out["orbax_shards"] = orbax_shards(mesh, preset, state_dict,
                                                   model, state, straight)
    return {"logs": logs, **out}


@contextlib.contextmanager
def counted_gathers():
    """Count the gathers of tensors made inside the block: the calls of
    ``torch.distributed``'s tensor gathers and of ``DTensor.full_tensor``
    and ``redistribute`` (the object collectives that DCP plans with call
    none of them through ``torch.distributed``'s names)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    calls: List[str] = []
    patched = [(dist, n) for n in ("all_gather", "all_gather_into_tensor",
                                   "gather")]
    patched += [(DTensor, n) for n in ("full_tensor", "redistribute")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in patched]

    def counting(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for owner, name, fn in saved:
        setattr(owner, name, counting(name, fn))
    try:
        yield calls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def orbax_shards(mesh, preset, state_dict, model, state, directory):
    """The last checkpoint of an FSDP run of the Orbax tier against the
    run's final state (what it saved): a freshly sharded model and state
    restored from it, gathers counted; each restored local shard against
    the saved one, bit for bit; whether this rank's files hold exactly its
    own shards of every sharded tensor; this rank's bytes."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import MetadataIndex
    from torch.distributed.tensor import DTensor, Shard

    from moleculediffusiontransformer_tpu_torch.core.checkpoint_orbax import (
        OrbaxCheckpointer, restore_train_state, shard_restore_target)
    from moleculediffusiontransformer_tpu_torch.parallel import \
        shard_state_fsdp
    from moleculediffusiontransformer_tpu_torch.train import trainer

    def local(target):
        flat = {f"model.{k}": v for k, v in target["model"].items()}
        for m in ("mu", "nu"):
            flat.update({f"adam.{m}.{k}": v
                         for k, v in target["adam"][m].items()})
        return flat

    saved = {k: (v.to_local() if isinstance(v, DTensor) else v).clone()
             for k, v in local(shard_restore_target(model, state)).items()}
    fresh = qm_model(preset, state_dict)
    fstate = trainer.TrainState.create(
        fresh, trainer.make_optimizer(trainer.OptimizerConfig()))
    shard_state_fsdp(fresh, fstate, mesh, min_elements=64)
    ck = OrbaxCheckpointer(directory)
    with counted_gathers() as gathers:
        step, target = restore_train_state(ck, fresh, fstate)
    restored = local(target)
    rank, n = mesh.get_local_rank(), mesh.size()
    meta = dcp.FileSystemReader(ck._path(step)).read_metadata()
    sharded, foreign, differ = 0, [], []
    for key, t in restored.items():
        mine = t.to_local() if isinstance(t, DTensor) else t
        if not torch.equal(mine, saved[key]):
            differ.append(key)
        if not (isinstance(t, DTensor) and isinstance(t.placements[0],
                                                      Shard)):
            continue
        sharded += 1
        dim = t.placements[0].dim
        offsets = [0] * t.dim()
        offsets[dim] = sum(len(c) for c in torch.arange(
            t.shape[dim]).chunk(n)[:rank])
        held = meta.storage_data[MetadataIndex(key, torch.Size(offsets))]
        if not held.relative_path.startswith(f"__{rank}_"):
            foreign.append(key)
    rank_bytes = sum(i.length for i in meta.storage_data.values()
                     if i.relative_path.startswith(f"__{rank}_"))
    return {"step": step, "gathers": gathers, "differ": differ,
            "sharded": sharded, "foreign": foreign, "rank_bytes": rank_bytes,
            "bytes": sum(i.length for i in meta.storage_data.values())}


def probe(model):
    """An ``eval_fn``: the mean of a 2-step sample of 2 fixed requests."""
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample

    def fn(state):
        g = torch.Generator().manual_seed(11)
        props = torch.rand(2, 12, generator=g)
        noise = torch.randn(2, model.max_length, model.pred_dim, generator=g)
        out = sample(model, props, num_steps=2, noise=noise,
                     step_noise=torch.zeros(1, *noise.shape))
        return {"probe": out.abs().mean().item()}

    return fn


# ---------------------------------------------------------- the serving --

def serving(mesh, preset, state_dict, vocab: dict, props: np.ndarray,
            tmp: str, steps: int):
    """``generate_from_conditioning(mesh=)`` on ``props`` and on its first
    3 rows, and the sampler exported with ``mesh=`` (rank 0 exports, both
    serve it from the same checkpoint and seed)."""
    import torch.distributed as dist

    from moleculediffusiontransformer_tpu_torch import design
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, save_checkpoint)
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import \
        CharTokenizer
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    model = qm_model(preset, state_dict).eval()
    tok = CharTokenizer.from_state_dict(vocab)
    out = {}
    for name, rows, seed in (("even", len(props), 3), ("padded", 3, 4)):
        rep = design.generate_from_conditioning(
            model, props[:rows], tok, torch.Generator().manual_seed(seed),
            cond_scale=2.0, timesteps=steps, mesh=mesh)
        out[name] = {"smiles": rep["smiles"],
                     "raw_samples": rep["raw_samples"]}
    path, ck = os.path.join(tmp, "mesh.pt2"), os.path.join(tmp, "ck.pt")
    try:
        dx.export_sampler(model, batch=len(props) - 1, num_steps=steps,
                          mesh=mesh, device="cpu")
    except ValueError as e:
        out["odd_batch"] = str(e)
    if mesh.get_local_rank() == 0:
        art = dx.export_sampler(model, batch=len(props), num_steps=steps,
                                cond_scale=2.0, mesh=mesh, device="cpu")
        dx.save_artifact(art, path)
        save_checkpoint(ck, checkpoint_state(model))
    dist.barrier()
    server = design.ArtifactServer(path, ck, device="cpu", mesh=mesh)
    out["served"] = server.call(props, seed=5).numpy()
    out["artifact"], out["checkpoint"] = path, ck
    return out
