"""Rank bodies of ``tests/test_torch_parallel_axes.py`` (tensor, sequence,
pipeline and expert parallelism), and the launcher that runs them: torch
and the port only, since each rank is a fresh interpreter (``spawn``).
The parent test computes the JAX side and the one-process references and
hands numpy arrays in.

``Ranks(world, tmp, calls)`` starts ``world`` ranks of a gloo group on the
CPU, each running every body of ``calls`` in turn (``run``); the caller
works on until it needs the results (``results()``).  The join, every
collective and the wait time out after ``TIMEOUT`` seconds."""
from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

TIMEOUT = 120


def _entry(rank: int, world: int, tmp: str, calls: dict) -> None:
    import torch.distributed as dist

    from moleculediffusiontransformer_tpu_torch.parallel import \
        distributed_init
    torch.set_num_threads(1)         # the ranks share the host's cores
    distributed_init(f"file://{os.path.join(tmp, 'rendezvous')}", world,
                     rank, device="cpu",
                     timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        result = {name: _fn(fn)(*args, **kwargs)
                  for name, (fn, args, kwargs) in calls.items()}
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def _fn(name: str):
    """A body by name: of this module, or ``module:function``."""
    if ":" in name:
        import importlib
        module, fn = name.split(":")
        return getattr(importlib.import_module(module), fn)
    return globals()[name]


class Ranks:
    """``calls`` (name -> (function of this module, args, kwargs)) run on
    each of ``world`` spawned ranks; ``results()`` waits (at most
    ``TIMEOUT`` seconds from the start) and returns each rank's dict."""

    def __init__(self, world: int, tmp: str, calls: dict):
        import tempfile

        import torch.multiprocessing as mp
        os.makedirs(tmp, exist_ok=True)
        self.tmp = tempfile.mkdtemp(dir=tmp)
        self.world = world
        self.deadline = time.monotonic() + TIMEOUT
        self.ctx = mp.start_processes(
            _entry, args=(world, self.tmp, calls), nprocs=world, join=False,
            start_method="spawn")

    def results(self) -> List[Dict[str, Any]]:
        try:
            while not self.ctx.join(
                    timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"the ranks ran past {TIMEOUT} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def numpy(sd) -> Dict[str, np.ndarray]:
    return {k: whole(v).detach().float().cpu().numpy().copy()
            for k, v in sd.items()}


def whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


class SGD:
    """Plain SGD, ``p -= lr g``: a band on the parameters sees its update
    (``torch_parallel_workers.SGD``'s reasoning)."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        from moleculediffusiontransformer_tpu_torch.train import trainer
        torch._foreach_add_(trainer._local(params), trainer._local(grads),
                            alpha=-self.lr)


def build(kind: str, kw: dict, state_dict) -> torch.nn.Module:
    """A float32 CPU model of ``kind`` holding ``state_dict``."""
    from moleculediffusiontransformer_tpu_torch.models import (audio,
                                                               qm_diffusion,
                                                               transformers)
    if kind == "qm":
        model = qm_diffusion.QMDiffusion(**kw)
    elif kind == "model1d":
        model = audio.Model1d(**kw)
    else:
        model = getattr(transformers, kind)(**kw, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()}, strict=True)
    return model


def _grads(model) -> Dict[str, np.ndarray]:
    """Every parameter's grad, whole (zeros where the loss does not reach
    the parameter, as under ``jax.grad``)."""
    return numpy({n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in model.named_parameters()})


# ------------------------------------------------------------------ tp --

def tp_steps(shape, preset, state_dict, cond, target, draws, lr,
             min_elements):
    """SGD steps of the QM model tensor-parallel on a ``shape`` (data,
    model) mesh, step i on ``draws[i]`` (the global batch's); the losses,
    the last grads and the parameters (whole), the specs, and the elements
    of the sharded leaves this rank holds against their whole sizes."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_2d(*shape, device="cpu")
    model = build("qm", preset, state_dict)
    specs = parallel.shard_params_tp(model, mesh, min_elements=min_elements)
    sharded = [p for n, p in model.named_parameters() if specs[n]]
    out = {"specs": specs, "report": parallel.tensor_parallel_specs(
        model, mesh), "held": sum(p.to_local().numel() for p in sharded),
        "sharded": sum(p.numel() for p in sharded),
        "coords": (mesh.get_local_rank("data"),
                   mesh.get_local_rank("model")),
        "shards": {n: p.to_local().detach().numpy().copy()
                   for n, p in model.named_parameters() if specs[n]}}
    opt = SGD(lr)
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, mesh=mesh)
    c, t = parallel.shard_batch(mesh["data"], (cond, target))
    out["losses"] = []
    for sigmas, noise in draws:
        s, nz = parallel.shard_batch(mesh["data"], (sigmas, noise))
        out["losses"].append(step(state, c, t, sigmas=s, noise=nz).item())
    out["grads"] = _grads(model)
    out["params"] = numpy(dict(model.named_parameters()))
    return out


# ------------------------------------------------------------------ sp --

def sp_steps(shape, kind, kw, state_dict, data, draws, lr,
             disable_fusion=False, dtype=None):
    """SGD steps of ``kind`` ("qm": ``data`` is (cond, target); "model1d":
    ``data`` is x) sequence-parallel on a ``shape`` (data, seq) mesh,
    each step on ``draws[i]`` (the global batch's sigmas and noise, this
    rank taking its block); the losses, the last grads, the parameters."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_sp(*shape, device="cpu")
    model = build(kind, kw, state_dict)
    for m in model.modules():
        if isinstance(m, Transformer1d):
            m.disable_fusion = disable_fusion
    opt = SGD(lr)
    state = trainer.TrainState.create(model, opt)
    if kind == "qm":
        step = trainer.make_diffusion_train_step(model, opt, mesh=mesh)
        inputs = parallel.shard_batch_sp(mesh, *data)
    else:
        step = trainer.make_model1d_train_step(model, opt, mesh=mesh)
        inputs = (parallel.shard_seq(mesh, data),)
    out = {"losses": []}
    for sigmas, noise in draws:
        s = parallel.shard_batch(mesh["data"], sigmas)
        nz = parallel.shard_seq(mesh, noise)
        out["losses"].append(step(state, *inputs, sigmas=s,
                                  noise=nz).item())
    out["grads"] = _grads(model)
    out["params"] = numpy(dict(model.named_parameters()))
    out["local_length"] = inputs[-1].shape[1]
    return out


def unet_rel_pos(shape, kw, state_dict, x, time, embedding, weights,
                 seq=True):
    """A base ``UNet1d`` whose stacks carry the relative position bias in
    self- and cross-attention, over the sequence axis of a ``shape`` mesh
    (``seq``) or in one process: its output on this rank's block of x and
    the grads of sum(output * weights), summed over the ranks."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        RelativePositionBias
    from moleculediffusiontransformer_tpu_torch.nn.unet import UNet1d
    from moleculediffusiontransformer_tpu_torch.parallel import collectives
    model = UNet1d(**kw)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()}, strict=True)
    biases = sum(isinstance(m, RelativePositionBias) for m in model.modules())
    x, w = torch.as_tensor(x), torch.as_tensor(weights)
    mesh = None
    if seq:
        mesh = parallel.make_mesh_sp(*shape, device="cpu")
        parallel.sp.set_sequence_axis(model, mesh)
        x, w = parallel.shard_seq(mesh, (x, w))
    y = model(x, torch.as_tensor(time), embedding=torch.as_tensor(embedding))
    loss = (y * w).sum()
    loss.backward()
    if mesh is not None:
        collectives.sync_grads(mesh, [p.grad for p in model.parameters()],
                               loss, partial=True)
    return {"y": y.detach().numpy(), "grads": _grads(model),
            "biases": biases}


def mode_errors(shape, preset, state_dict, min_elements):
    """What the train steps refuse: an unsharded model over the
    tensor-parallel ``("data", "model")`` mesh, a sharded one over the
    sequence mesh."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    out = {}
    tp_mesh = parallel.make_mesh_2d(*shape, device="cpu")
    sp_mesh = parallel.make_mesh_sp(*shape, device="cpu")
    for name, make in (
            ("unsharded_on_tp", lambda m: trainer.make_diffusion_train_step(
                m, SGD(0.1), mesh=tp_mesh)),
            ("sharded_on_sp", lambda m: trainer.make_diffusion_train_step(
                m, SGD(0.1), mesh=sp_mesh))):
        model = build("qm", preset, state_dict)
        if name == "sharded_on_sp":
            parallel.shard_params_tp(model, tp_mesh,
                                     min_elements=min_elements)
        try:
            make(model)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def seq_routing(shape):
    """``shard_seq``'s rank routing and ``shard_batch_sp``'s blocks of
    arange arrays."""
    from moleculediffusiontransformer_tpu_torch import parallel
    mesh = parallel.make_mesh_sp(*shape, device="cpu")
    tree = {"scalar_per_example": np.arange(8, dtype=np.float32),
            "cond": np.arange(8 * 12, dtype=np.float32).reshape(8, 12),
            "acts": np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4),
            "acts4": np.arange(8 * 16 * 4 * 2,
                               dtype=np.float32).reshape(8, 16, 4, 2)}
    out = {k: v.numpy() for k, v in parallel.shard_seq(mesh, tree).items()}
    c, t = parallel.shard_batch_sp(mesh, tree["cond"], tree["acts"])
    out.update(sp_cond=c.numpy(), sp_target=t.numpy(),
               placements=[repr(p) for p in parallel.seq_sharding(mesh)],
               coords=(mesh.get_local_rank("data"),
                       mesh.get_local_rank("seq")))
    return out


# ------------------------------------------------------------------ pp --

def pp_runs(shape, kind, kw, state_dict, props, output, keep, n_micros):
    """The pipelined decoder on a ``shape`` (data, stage) mesh, for each
    of ``n_micros``: its logits, loss and grads (the layers' by their
    per-layer names) on this rank's rows; then, with the last, one SGD
    step of ``make_transformer_train_step`` (grads averaged over 'data')."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_pp(*shape, device="cpu")
    p, o, k = parallel.shard_batch_ep(mesh, (props, output, keep))
    out = {}
    for n_micro in n_micros:
        model = build(kind, kw, state_dict)
        parallel.shard_model_pp(model, mesh)
        run = dict(mesh=mesh, n_micro=n_micro, cond_drop_prob=0.5, keep=k)
        with torch.no_grad():
            logits = parallel.pipeline_forward(model, p, o, **run)
        loss = parallel.pipeline_forward(model, p, o, return_loss=True,
                                         **run)
        loss.backward()
        out[n_micro] = {"logits": logits.numpy(), "loss": loss.item(),
                        "grads": _layer_grads(model)}
    model = build(kind, kw, state_dict)
    model.cond_drop_prob = 0.5
    parallel.shard_model_pp(model, mesh)
    step = trainer.make_transformer_train_step(model, SGD(0.1), mesh=mesh,
                                               n_micro=n_micros[-1])
    state = trainer.TrainState.create(model, SGD(0.1))
    out["step"] = {"loss": step(state, p, o, keep=k).item(),
                   "grads": _layer_grads(model)}
    out["local_depth"] = next(model.stacked_layers.parameters()
                              ).to_local().shape[0]
    return out


def _layer_grads(model) -> Dict[str, np.ndarray]:
    """A pipelined model's grads under the unpipelined names."""
    from moleculediffusiontransformer_tpu_torch import parallel
    stacked = {n.replace("/", "."): whole(p.grad)
               for n, p in model.stacked_layers.named_parameters()}
    rest = {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()
            if not n.startswith("stacked_layers.")}
    return numpy(parallel.unstack_layer_params(stacked, rest))


def pp_errors(shape):
    """What ``split_microbatches`` and ``shard_stacked`` refuse."""
    from moleculediffusiontransformer_tpu_torch import parallel
    mesh = parallel.make_mesh_pp(*shape, device="cpu")
    out = {}
    for name, fn in (
            ("odd_split", lambda: parallel.split_microbatches(
                torch.zeros(5, 3), 2)),
            ("odd_depth", lambda: parallel.shard_stacked(
                mesh, {"w": torch.zeros(3, 2)}))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------------ ep --

def ep_step(shape, kw, state_dict, ids, aux_weight, lr):
    """One SGD step of the MoE GPT expert-parallel on a ``shape`` (data,
    expert) mesh (``make_gpt_train_step(mesh=)``): the loss, the grads, the
    tokens each MoE layer dropped on this rank and the experts it holds."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.nn.moe import MoEFeedForward
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_ep(*shape, device="cpu")
    model = build("MoleculeTransformerGPT", kw, state_dict)
    _, specs = parallel.shard_params_ep(mesh, model, kw["ff_num_experts"])
    shards = {n: p.to_local().detach().numpy().copy()
              for n, p in model.named_parameters() if specs[n]}
    opt = SGD(lr)
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_gpt_train_step(model, opt, aux_loss_weight=aux_weight,
                                       mesh=mesh)
    loss = step(state, parallel.shard_batch_ep(mesh, torch.as_tensor(ids)))
    moes = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
    return {"loss": loss.item(), "grads": _grads(model), "specs": specs,
            "shards": shards, "coords": (mesh.get_local_rank("data"),
                                         mesh.get_local_rank("expert")),
            "dropped": [m.dropped.item() for m in moes],
            "experts_held": moes[0].w_in.to_local().shape[0],
            "params": numpy(dict(model.named_parameters()))}


# ------------------------------------------------------ the f/g pair --

def pair_grads(shape):
    """The grads of x through ``copy_to`` and ``reduce_from`` over the
    mesh's second axis, and of ``psum``: x (4,) = rank + 1 on every rank,
    loss = sum of 2 x after each."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.parallel import collectives
    mesh = parallel.make_mesh_2d(*shape, device="cpu")
    ax = collectives.axis(mesh, "model")
    out = {}
    for name, fn in (("copy_to", collectives.copy_to),
                     ("reduce_from", collectives.reduce_from),
                     ("psum", collectives.psum)):
        x = torch.full((4,), float(ax.rank + 1), requires_grad=True)
        y = fn(x, ax)
        (2 * y).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    x = torch.arange(4.0, requires_grad=True) + 10 * ax.rank
    y = collectives.gather_along(x[None], ax, 1, "slice")
    (y * torch.arange(8.0)).sum().backward()
    out["gather_slice"] = (y.detach().numpy(), None)
    x = (torch.arange(4.0) + 10 * ax.rank).requires_grad_()
    y = collectives.ppermute(x, ax, [(0, 1)])
    (y * 3).sum().backward()
    out["ppermute"] = (y.detach().numpy(), x.grad.numpy())
    return out
