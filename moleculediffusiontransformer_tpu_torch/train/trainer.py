"""Training: Adam behind a global-norm clip, the train steps, and the epoch
loop with checkpoints and exact resume (port of `train/trainer.py`:
``make_optimizer``, ``make_diffusion_train_step``,
``make_transformer_train_step``, ``make_gpt_train_step``,
``make_encoder_train_step``,
``preflight_memory_check``, ``MetricsLogger``, ``train_diffusion``;
``make_model1d_train_step`` is the diffusion step for a model whose loss
takes only the data).

The optimizer is written out rather than taken from ``torch.optim`` so that
it computes what the JAX package's ``optax.chain(clip_by_global_norm(c),
adam(lr))`` computes: the clip scales by ``max_norm / norm`` only when the
norm reaches ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
norm + 1e-6 instead), and Adam's bias corrections and epsilon sit where
optax puts them.  Parameters stay float32 whatever the model's compute
dtype; so do the grads and both moments.

The step runs eagerly: A micro-batches, each with its own draws, their
float32 grads summed by autograd and divided by A, one clip and one Adam
update.  The draws of step N come from a generator seeded from
(``TrainConfig.seed``, N) alone (``step_generator``), so a resumed run
draws what an uninterrupted one draws, as JAX folds the step into its key.

Over a mesh (``parallel/``: one process a card), each rank runs the step on
its rows of the global batch and the grads are averaged over the ranks
before the clip, so the parameters stay the same on every rank; under
``param_sharding="fsdp"`` each rank holds a shard of the parameters and of
the moments.  ``train_diffusion`` writes either checkpoint tier
(``TrainConfig.checkpoint_backend``): the single-file one
(``core/checkpoint.py``) or the async, sharded one
(``core/checkpoint_orbax.py``).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.checkpoint import (checkpoint_state, latest_checkpoint,
                               restore_checkpoint, save_step_checkpoint)
from ..core.checkpoint_orbax import (OrbaxCheckpointer, restore_train_state,
                                     shard_restore_target)
from ..core.config import TrainConfig
from ..data.prefetch import ThreadedLoader, prefetch_to_device, to_device
from ..parallel import mesh as pmesh
from ..parallel.collectives import sync_grads
from ..parallel.fsdp import gathered, shard_state_fsdp

Schedule = Callable[[int], float]
# optax.adam's defaults, which the JAX package trains with
B1, B2, EPS = 0.9, 0.999, 1e-8


# the optimizer reads its fields of ``TrainConfig`` by attribute (the
# reference's Adam(2e-4) + clip 0.5 by default)
OptimizerConfig = TrainConfig


def warmup_cosine_schedule(init_value: float, peak_value: float,
                           warmup_steps: int, decay_steps: int,
                           end_value: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` by step ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        decayed = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * decayed + alpha)

    return schedule


@dataclass
class AdamState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


@dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(learning_rate))``
    over a list of float32 tensors, updated in place."""
    learning_rate: Union[float, Schedule]
    max_norm: float

    def init(self, params: List[torch.Tensor]) -> AdamState:
        """Zero moments shaped and placed as ``params`` (a sharded
        parameter's are sharded with it)."""
        return AdamState(mu=[torch.zeros_like(p, dtype=torch.float32)
                             for p in params],
                         nu=[torch.zeros_like(p, dtype=torch.float32)
                             for p in params])

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState) -> None:
        """Clip ``grads`` by their global norm, then one Adam step on
        ``params`` and ``state`` (in place; ``grads`` stay as they are).

        The moments are updated in place and the step runs over chunks of
        at most ``UPDATE_CHUNK`` elements, so that its temporaries (the
        clipped grads, one scratch list and the update) are at most
        ``scratch_bytes(params)``, not a copy of the optimizer state.  Every
        element sees the same float32 operations in the same order as
        optax's ``mu = g (1 - b1) + mu b1``, ``nu = g g (1 - b2) + nu b2``,
        ``p += step (mu / bc1) / (sqrt(nu / bc2) + eps)``.

        Sharded parameters (FSDP, ``DTensor``s, their grads and moments
        sharded alike) are updated through their local shards; the sum of
        squares of the shards is all-reduced over their mesh before the
        square root, so every rank clips by the same global norm."""
        norm = _global_norm(grads)
        params, grads = _local(params), _local(grads)
        mus, nus = _local(state.mu), _local(state.nu)
        clip = not bool(norm < self.max_norm)
        step_size = -self.lr(state.count)
        count = state.count + 1
        # optax computes 1 - decay**count in float32
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        for rows in _chunks(params):
            p = [params[i] for i in rows]
            g = [grads[i] for i in rows]
            mu = [mus[i] for i in rows]
            nu = [nus[i] for i in rows]
            if clip:
                g = [x / norm for x in g]
                torch._foreach_mul_(g, self.max_norm)
            # addition commutes bit for bit: mu b1 + g (1 - b1) is optax's
            torch._foreach_mul_(mu, B1)
            scratch = torch._foreach_mul(g, 1 - B1)
            torch._foreach_add_(mu, scratch)
            torch._foreach_mul_(nu, B2)
            torch._foreach_copy_(scratch, g)
            torch._foreach_mul_(scratch, g)
            torch._foreach_mul_(scratch, 1 - B2)
            torch._foreach_add_(nu, scratch)
            torch._foreach_copy_(scratch, nu)          # the denominator
            torch._foreach_div_(scratch, bc2)
            torch._foreach_sqrt_(scratch)
            torch._foreach_add_(scratch, EPS)
            updates = torch._foreach_div(mu, bc1)
            torch._foreach_div_(updates, scratch)
            torch._foreach_mul_(updates, step_size)
            torch._foreach_add_(p, updates)
            del scratch, updates, g
        state.count = count

    @staticmethod
    def scratch_bytes(params: List[torch.Tensor]) -> int:
        """The most bytes ``update`` holds beside the parameters, the grads
        and the moments: three float32 copies of its largest chunk (the
        clipped grads, the scratch list and the update)."""
        params = _local(params)
        return 3 * 4 * max((sum(params[i].numel() for i in rows)
                            for rows in _chunks(params)), default=0)


def _local(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor, or a sharded one's local shard (in place: a view)."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The float32 global norm of ``grads``: of the whole grads as they
    are; with sharded ones, each group's shards' sum of squares all-reduced
    over the mesh dims they are sharded along, plus the whole (and
    replicated) grads' once."""
    from torch.distributed.tensor import DTensor, Shard

    def shard_dims(g) -> tuple:
        return tuple(i for i, p in enumerate(g.placements)
                     if isinstance(p, Shard)) if isinstance(g, DTensor) else ()

    if not any(map(shard_dims, grads)):
        return torch.stack([(g * g).sum() for g in _local(grads)]).sum(
            ).sqrt()
    groups: Dict[Any, List[torch.Tensor]] = {}
    for g in grads:
        if shard_dims(g):
            groups.setdefault((g.device_mesh, shard_dims(g)), []).append(
                g.to_local())
    sq = None
    for (mesh, dims), shards in groups.items():
        part = torch.stack([(g * g).sum() for g in shards]).sum()
        for d in dims:
            torch.distributed.all_reduce(part, group=mesh.get_group(d))
        sq = part if sq is None else sq + part
    whole = _local([g for g in grads if not shard_dims(g)])
    if whole:
        sq = sq + torch.stack([(g * g).sum() for g in whole]).sum()
    return sq.sqrt()


# the most elements ``ClipAdam.update`` takes in one chunk (a tensor larger
# than this is a chunk of its own): 64 MB of float32
UPDATE_CHUNK = 2 ** 24


def _chunks(params: List[torch.Tensor]) -> List[List[int]]:
    """Consecutive index runs of ``params`` of at most ``UPDATE_CHUNK``
    elements each (one tensor at least)."""
    out: List[List[int]] = []
    size = UPDATE_CHUNK
    for i, p in enumerate(params):
        if not out or size + p.numel() > UPDATE_CHUNK:
            out.append([])
            size = 0
        out[-1].append(i)
        size += p.numel()
    return out


def make_optimizer(config) -> ClipAdam:
    """Adam + global-norm clip from a config's ``learning_rate``,
    ``grad_clip_norm``, ``lr_schedule`` ("constant", or "cosine": linear
    warmup over ``lr_warmup_steps`` from 0, then cosine decay to
    ``learning_rate * lr_min_ratio`` at ``lr_decay_steps``),
    ``lr_warmup_steps``, ``lr_decay_steps`` and ``lr_min_ratio``."""
    if config.lr_schedule == "constant":
        lr: Union[float, Schedule] = config.learning_rate
    elif config.lr_schedule == "cosine":
        if config.lr_decay_steps is None:
            raise ValueError("lr_schedule='cosine' needs lr_decay_steps")
        lr = warmup_cosine_schedule(
            0.0 if config.lr_warmup_steps else config.learning_rate,
            config.learning_rate, config.lr_warmup_steps,
            config.lr_decay_steps,
            config.learning_rate * config.lr_min_ratio)
    else:
        raise ValueError(f"Unknown lr_schedule: {config.lr_schedule!r}")
    return ClipAdam(learning_rate=lr, max_norm=config.grad_clip_norm)


@dataclass
class TrainState:
    """The optimizer's state, the count of steps taken and the count of
    epochs completed (so that a resumed run labels its epochs as an
    uninterrupted one does); the parameters are the model's own."""
    opt_state: AdamState
    step: int = 0
    epoch: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: ClipAdam) -> "TrainState":
        return cls(opt_state=optimizer.init(list(model.parameters())))


def _accumulated_step(params: List[torch.Tensor], optimizer: ClipAdam,
                      state: TrainState, A: int, batch: int,
                      device: torch.device,
                      loss_of: Callable[[slice], torch.Tensor],
                      mesh=None, partial: bool = False) -> torch.Tensor:
    """One optimizer step over ``A`` micro-batches: ``loss_of(rows)`` is the
    loss of one micro-batch; the float32 grads are summed by autograd,
    divided by A, clipped and applied once, and stay on ``.grad``.  Returns
    the mean loss.  Over a 1-D ``mesh`` the grads that FSDP has not
    reduce-scattered already (all of them under plain data parallelism) and
    the loss are averaged over its ranks before the clip; over a 2-D one
    as ``parallel.collectives.sync_grads`` has it (``partial``: sequence
    parallelism)."""
    if batch % A:
        raise ValueError(f"batch {batch} does not split into {A} "
                         f"micro-batches")
    mb = batch // A
    for p in params:
        p.grad = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(A):
        loss = loss_of(slice(i * mb, (i + 1) * mb))
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    for p in params:
        # a parameter the loss does not reach (the CFG null table at
        # embedding scale 1) has a zero gradient, as under jax.grad
        p.grad = (torch.zeros_like(p) if p.grad is None else p.grad / A)
    loss = loss_sum / A
    if mesh is not None and mesh.ndim > 1:
        sync_grads(mesh, [p.grad for p in params], loss, partial=partial)
    elif mesh is not None:
        from torch.distributed.tensor import DTensor
        pmesh.all_reduce_mean(mesh, [loss, *(
            p.grad for p in params if not isinstance(p.grad, DTensor))])
    optimizer.update(params, [p.grad for p in params], state.opt_state)
    state.step += 1
    return loss


def _accumulation_steps(accumulation_steps: int) -> int:
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got "
                         f"{accumulation_steps}")
    return accumulation_steps


def _part(t: Optional[torch.Tensor], rows: slice) -> Optional[torch.Tensor]:
    return None if t is None else t[rows]


def global_draws(model: nn.Module, target: torch.Tensor, batch: int,
                 accumulation_steps: int, generator: Optional[torch.Generator],
                 length: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sigmas (batch,) and noise (batch, ...) of a step over a batch of
    ``batch`` rows in ``accumulation_steps`` micro-batches, drawn from
    ``generator`` in the order the model's loss draws them: each
    micro-batch's sigmas, then its noise, shaped like the rows of what the
    loss diffuses (``model.diffusion_target(target)``, or ``target`` for a
    model without one), ``length`` long where given (the whole length of
    which ``target`` holds a slice)."""
    mb = batch // accumulation_steps
    diffused = getattr(model, "diffusion_target", lambda t: t)
    row = tuple(diffused(target[:1]).shape[1:])
    if length is not None:
        row = (length, *row[1:])
    sigmas, noise = [], []
    for _ in range(accumulation_steps):
        sigmas.append(model.sigma_distribution(mb, generator, target.device))
        noise.append(torch.randn((mb, *row),
                                 generator=generator, device=target.device,
                                 dtype=torch.float32))
    return torch.cat(sigmas), torch.cat(noise)


def _data_mesh(mesh):
    """The mesh's data axis (the mesh itself when it is 1-D)."""
    return mesh if mesh is None or mesh.ndim == 1 else mesh["data"]


def _sequence_axis(model: nn.Module, mesh):
    """The mode of a 2-D mesh, from its names: over a ('data', 'seq') mesh
    (``parallel.make_mesh_sp``) the model runs sequence-parallel, and this
    is the axis, set on the model (``parallel.sp.set_sequence_axis``); over
    a ('data', 'model') mesh (``parallel.make_mesh_2d``) it runs
    tensor-parallel and must hold its shards (``parallel.shard_params_tp``).
    None but for the sequence mesh."""
    from ..parallel import sp, tp
    if mesh is None or mesh.ndim == 1:
        return None
    other, sharded = mesh.mesh_dim_names[1], tp.is_sharded(model)
    if other == sp.SEQ_AXIS:
        if sharded:
            raise ValueError("a ('data', 'seq') mesh runs sequence "
                             "parallelism: the model must hold whole "
                             "weights, not tensor-parallel shards")
        return sp.sequence_axis(model) or sp.set_sequence_axis(model, mesh)
    if other == "model" and not sharded:
        raise ValueError("a ('data', 'model') mesh runs tensor parallelism: "
                         "shard the model over it first "
                         "(parallel.shard_params_tp); for sequence "
                         "parallelism make the mesh with "
                         "parallel.make_mesh_sp")
    return None


def _step_draws(model: nn.Module, target: torch.Tensor, b: int, A: int,
                generator, mesh, seq) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the global batch's draws: its rows over the
    data axis and, under sequence parallelism, its slice of the length."""
    data = _data_mesh(mesh)
    ranks = 1 if data is None else data.size()
    length = None if seq is None else target.shape[1] * seq.size
    sigmas, noise = global_draws(model, target, b * ranks, A, generator,
                                 length)
    if data is not None:
        rows = pmesh.local_rows(data, b * ranks)
        sigmas, noise = sigmas[rows], noise[rows]
    if seq is not None:
        noise = noise.narrow(1, seq.rank * target.shape[1], target.shape[1])
    return sigmas, noise


def make_diffusion_train_step(model: nn.Module, optimizer: ClipAdam,
                              accumulation_steps: int = 1,
                              remat: bool = False, mesh=None) -> Callable:
    """``step(state, conditioning, target, generator=None, *, sigmas=None,
    noise=None) -> loss`` for the QM diffusion models, whose call is
    ``(conditioning, target, generator, sigmas=, noise=) -> loss``.

    The batch is split into ``accumulation_steps`` = A micro-batches, run
    one after another; their sigmas (b,) and noise (shaped like
    ``model.diffusion_target(target)``) are handed in, or drawn from
    ``generator`` before the first (``global_draws``: each micro-batch's
    sigmas, then its noise, as the model's loss would draw them).  The float32 grads are summed over the
    micro-batches and divided by A, then clipped and applied once; they
    stay on the parameters' ``.grad`` after the step.  Returns the mean loss
    of the micro-batches (a float32 tensor on the model's device).

    ``remat=True`` runs each micro-batch's loss under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward instead of kept, for about one more forward.

    ``mesh`` (``parallel.make_mesh``): data parallelism over its ranks.
    ``conditioning``, ``target`` and handed-in draws are this rank's rows of
    the global batch (``parallel.shard_batch``); a ``generator`` (seeded
    alike on every rank) draws the global batch's sigmas and noise, as one
    card would, and the rank takes its rows, so the step equals the
    single-card step on the global batch up to the order of the sums.  The
    grads are averaged over the ranks after the micro-batches' backward
    (``parallel.mesh.all_reduce_mean``, a few flat buckets) and every rank
    runs the same update.  The returned loss is the global mean.

    A 2-D ``("data", "model")`` mesh (``parallel.make_mesh_2d``): tensor
    parallelism, the model's weights sharded over 'model' first
    (``parallel.shard_params_tp``: each model rank takes the same rows).
    A 2-D ``("data", "seq")`` mesh (``parallel.make_mesh_sp``): sequence
    parallelism (``parallel/sp.py``: ``target`` and handed-in noise are
    this rank's (rows, length) block, ``parallel.shard_batch_sp``, and the
    drawn noise is cut so)."""
    A = _accumulation_steps(accumulation_steps)
    params = list(model.parameters())
    seq = _sequence_axis(model, mesh)

    def loss_of(c: torch.Tensor, t: torch.Tensor, sigmas: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        if not remat:
            return model(c, t, sigmas=sigmas, noise=noise)
        return checkpoint(model, c, t, sigmas=sigmas, noise=noise,
                          use_reentrant=False)

    def train_step(state: TrainState, conditioning: torch.Tensor,
                   target: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   sigmas: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = conditioning.shape[0]
        if (sigmas is None) != (noise is None):
            raise ValueError("hand in both sigmas and noise or neither")
        if sigmas is None:
            sigmas, noise = _step_draws(model, target, b, A, generator,
                                        mesh, seq)
        return _accumulated_step(
            params, optimizer, state, A, b, target.device,
            lambda rows: loss_of(conditioning[rows], target[rows],
                                 sigmas[rows], noise[rows]),
            mesh, partial=seq is not None)

    return train_step


def make_model1d_train_step(model: nn.Module, optimizer: ClipAdam,
                            accumulation_steps: int = 1,
                            mesh=None) -> Callable:
    """``step(state, x, generator=None, *, sigmas=None, noise=None,
    **net_kwargs) -> loss`` for the ``Model1d`` family, whose loss takes
    only the data x (b, L, C): ``model(x, generator, sigmas=, noise=,
    **net_kwargs)``.  Micro-batches, draws, grads and the update are those
    of ``make_diffusion_train_step``; a tensor among ``net_kwargs`` whose
    first dimension is the batch (``embedding``) is split with x.

    ``mesh``: data parallelism over a 1-D mesh (x this rank's rows), or
    sequence parallelism over a 2-D ``("data", "seq")`` one
    (``parallel.make_mesh_sp``; x this rank's (rows, length) block,
    ``parallel.shard_seq``); over either the draws are
    the global batch's, each rank keeping its block.  Under sequence
    parallelism the UNet must draw nothing itself (``unet_type`` "base")."""
    A = _accumulation_steps(accumulation_steps)
    params = list(model.parameters())
    seq = _sequence_axis(model, mesh)
    if seq is not None and getattr(model, "unet_type", "base") != "base":
        raise ValueError(f"sequence parallelism takes a 'base' UNet, not "
                         f"{model.unet_type!r}, which draws inside")

    def train_step(state: TrainState, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   sigmas: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   **net_kwargs) -> torch.Tensor:
        b = x.shape[0]
        if mesh is not None and sigmas is None and noise is None:
            sigmas, noise = _step_draws(model, x, b, A, generator, mesh, seq)

        def loss_of(rows: slice) -> torch.Tensor:
            kw = {k: (v[rows] if isinstance(v, torch.Tensor) and v.dim()
                      and v.shape[0] == b else v)
                  for k, v in net_kwargs.items()}
            return model(x[rows], generator, sigmas=_part(sigmas, rows),
                         noise=_part(noise, rows), **kw)

        return _accumulated_step(params, optimizer, state, A, b, x.device,
                                 loss_of, mesh, partial=seq is not None)

    return train_step


def make_transformer_train_step(model: nn.Module, optimizer: ClipAdam,
                                mesh=None, n_micro: int = 1) -> Callable:
    """``step(state, props, ids, generator=None, *, keep=None) -> loss`` for
    the AR transformer decoders: the next-token cross entropy of
    ``model(props, ids, return_loss=True)`` with the model's conditioning
    dropout, one clip and one Adam update, no accumulation.  The dropout's
    keep mask (b,) is drawn from ``generator`` or handed in.  The float32
    grads stay on the parameters' ``.grad``; returns the loss (a float32
    tensor on the model's device).

    ``mesh``: a ``("data", "stage")`` mesh (``parallel.make_mesh_pp``) over
    which the model was pipelined (``parallel.shard_model_pp``): the loss
    is ``parallel.pipeline_forward``'s in ``n_micro`` micro-batches, on this
    rank's rows over 'data' (``keep`` too), and the grads are averaged over
    'data'."""
    params = list(model.parameters())

    def loss_of(props, ids, generator, keep):
        if mesh is None:
            return model(props, ids, return_loss=True, generator=generator,
                         keep=keep)
        from ..parallel.pp import pipeline_forward
        return pipeline_forward(model, props, ids, mesh=mesh,
                                n_micro=n_micro, return_loss=True,
                                cond_drop_prob=model.cond_drop_prob,
                                keep=keep, generator=generator)

    def train_step(state: TrainState, props: torch.Tensor, ids: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _accumulated_step(
            params, optimizer, state, 1, props.shape[0], ids.device,
            lambda rows: loss_of(props, ids, generator, keep), mesh)

    return train_step


def make_gpt_train_step(model: nn.Module, optimizer: ClipAdam,
                        aux_loss_weight: float = 0.0,
                        ignore_padding_zeros: bool = False,
                        mesh=None) -> Callable:
    """``step(state, ids) -> loss`` for the unconditional GPT decoders: the
    next-token cross entropy of ``model(ids, return_loss=True)`` (the label
    0 skipped with ``ignore_padding_zeros``), one clip and one Adam update,
    no accumulation.  ``aux_loss_weight > 0`` adds that weight times the
    mean over the MoE layers of their load-balance losses
    (``model.moe_aux_losses()``; Switch Transformer's recipe, typically
    1e-2), which a dense model does not have.  The float32 grads stay on
    the parameters' ``.grad``; returns the loss (a float32 tensor on the
    model's device).

    ``mesh``: a ``("data", "expert")`` mesh (``parallel.make_mesh_ep``)
    whose experts the model shards (``parallel.shard_params_ep``): ``ids``
    are this rank's rows over 'data' (``parallel.shard_batch_ep``), the MoE
    layers keep the global batch's capacity and aux loss, and the grads are
    averaged over 'data'."""
    params = list(model.parameters())

    def loss_of(ids: torch.Tensor) -> torch.Tensor:
        loss = model(ids, return_loss=True,
                     ignore_padding_zeros=ignore_padding_zeros)
        if aux_loss_weight:
            aux = model.moe_aux_losses()
            if aux:
                loss = loss + aux_loss_weight * (sum(aux) / len(aux))
        return loss

    def train_step(state: TrainState, ids: torch.Tensor) -> torch.Tensor:
        return _accumulated_step(params, optimizer, state, 1, ids.shape[0],
                                 ids.device, lambda rows: loss_of(ids), mesh)

    return train_step


def make_encoder_train_step(model: nn.Module,
                            optimizer: ClipAdam) -> Callable:
    """``step(state, ids, targets) -> loss`` for the forward encoder: the
    mean squared error of the first ``targets.shape[1]`` logits of each row
    (``model(ids)`` flattened: the (b, 1, 12) outputs of the notebook
    preset) against ``targets`` (b, 12), in float32; one clip and one Adam
    update, no accumulation.  The float32 grads stay on the parameters'
    ``.grad``; returns the loss (a float32 tensor on the model's device)."""
    params = list(model.parameters())

    def loss_of(ids: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = model(ids)
        preds = logits.reshape(logits.shape[0], -1)[:, :targets.shape[1]]
        return (preds.float() - targets.float()).square().mean()

    def train_step(state: TrainState, ids: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        return _accumulated_step(params, optimizer, state, 1, ids.shape[0],
                                 ids.device,
                                 lambda rows: loss_of(ids, targets))

    return train_step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws, on ``device``: seeded from
    (``seed``, ``step``) alone, so that a resumed run draws what an
    uninterrupted one draws (JAX folds the step into its data key)."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def preflight_memory_check(model: nn.Module, state: TrainState,
                           conditioning: torch.Tensor, target: torch.Tensor,
                           accumulation_steps: int = 1,
                           margin: float = 0.92) -> Dict:
    """Run one micro-batch's forward and backward (draws from a throwaway
    generator) and check that the step fits the card's memory.

    The step's peak is estimated as the larger of two readings
    (``torch.cuda.max_memory_allocated`` and ``memory_allocated``, the
    parameters and the optimizer state included): the pass's peak, plus
    the float32 grads the later micro-batches' passes find held when there
    are several; and what the pass leaves allocated (its grads on
    ``.grad``) plus what ``ClipAdam.update`` allocates beside it
    (``ClipAdam.scratch_bytes``; the moments are updated in place).  Above
    ``margin`` of the card's memory (``torch.cuda.mem_get_info``) this
    raises ``RuntimeError`` before the first step.  The pass's grads are
    dropped: the parameters, the optimizer state and the step stay as they
    were.  On the CPU the pass runs and the check only reports.  Returns the
    estimate as a dict."""
    params = list(model.parameters())
    device = target.device
    A = _accumulation_steps(accumulation_steps)
    mb = conditioning.shape[0] // A
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    saved = [p.grad for p in params]
    for p in params:
        p.grad = None
    try:
        model(conditioning[:mb], target[:mb],
              torch.Generator(device=device).manual_seed(0)).backward()
        if on_card:
            torch.cuda.synchronize(device)
            held = torch.cuda.memory_allocated(device)
    finally:
        for p, g in zip(params, saved):
            p.grad = g
    info: Dict[str, Any] = {"ok": True}
    if not on_card:
        return info
    peak = torch.cuda.max_memory_allocated(device)
    grads = sum(4 * p.numel() for p in params)
    scratch = ClipAdam.scratch_bytes(params)
    limit = torch.cuda.mem_get_info(device)[1]
    total = max(peak + (grads if A > 1 else 0), held + scratch)
    info.update(estimated_bytes=total, peak_bytes=peak, held_bytes=held,
                grad_bytes=grads, update_bytes=scratch, bytes_limit=limit)
    if total > margin * limit:
        info["ok"] = False
        raise RuntimeError(
            f"preflight: the train step needs ~{total / 1e9:.2f} GB of "
            f"device memory but the card has {limit / 1e9:.2f} GB (margin "
            f"{margin}).  Reduce batch size or raise "
            f"TrainConfig.accumulation_steps.")
    return info


@dataclass
class MetricsLogger:
    """JSONL-appending metrics log (replaces the reference's print+matplotlib
    observability, SURVEY §5)."""
    path: Optional[str] = None
    history: List[Dict] = field(default_factory=list)

    def log(self, **metrics) -> Dict:
        rec = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()}
        self.history.append(rec)
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


Draws = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms for the duration of the block
    (``torch.backends.cudnn.deterministic``, restored after).  With cuDNN's
    default algorithms two float32 backward passes of the same 91M batch
    differ in most parameters' grads (``chip_smoke.py`` phase 27, PERF.md),
    and a resumed run then drifts from an uninterrupted one."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = previous


def training_mesh(config, mesh, device: torch.device):
    """The mesh ``train_diffusion`` trains over: ``mesh`` when given, else
    the mesh over every rank of the process group when this process has
    joined one of more than one rank (``torchrun``), or of one under FSDP;
    else None (one card, no collective)."""
    if config.param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding "
                         f"{config.param_sharding!r}")
    dist = torch.distributed
    if mesh is None and dist.is_initialized() and (
            dist.get_world_size() > 1 or config.param_sharding == "fsdp"):
        mesh = pmesh.make_mesh(device=device.type)
    if config.param_sharding == "fsdp" and mesh is None:
        raise ValueError("param_sharding='fsdp' shards over a process group:"
                         " join one first (parallel.distributed_init) or "
                         "pass mesh=")
    return mesh


def train_diffusion(model: nn.Module, data_iter_fn: Callable[[], Iterable],
                    config: TrainConfig, *, mesh=None,
                    eval_fn: Optional[Callable[[TrainState], Dict]] = None,
                    checkpoint_dir: Optional[str] = None,
                    resume: bool = False, swap_xy: bool = False,
                    logger: Optional[MetricsLogger] = None,
                    draws: Optional[Draws] = None
                    ) -> Tuple[TrainState, MetricsLogger]:
    """Generic trainer for both QM diffusion directions; trains ``model``
    (its parameters as built or loaded) in place on its device.

    ``data_iter_fn()`` yields (X, y) host batches per epoch.  For the
    inverse model conditioning=y (properties), target=X (one-hot) -- pass
    ``swap_xy=False`` with iterators already in (conditioning, target)
    order, or ``swap_xy=True`` to swap, mirroring ``train_loop_forward``'s
    role swap (`generative.py:525-533`).

    The cadence is the JAX package's: the loss is read back and logged
    every ``config.print_loss_every`` steps (and only then); with
    ``eval_every_steps`` an in-epoch ``eval_fn(state)`` and save; after
    every epoch ``eval_fn``, and a step checkpoint every
    ``checkpoint_every_epochs`` epochs and after the last.  ``resume``
    restores the latest step checkpoint of ``checkpoint_dir`` (model,
    Adam state, step, epochs) and runs ``config.epochs`` more epochs.
    ``config.prefetch`` > 0 assembles batches on a worker thread and copies
    them that many steps ahead (``data/prefetch.py``);
    ``preflight_memory_check`` runs before the first step.

    Step N's draws come from ``step_generator(config.seed, N)``, or are
    ``draws(N)`` -> (sigmas (b,), noise (b, L, C)) when given (the JAX
    package's own draws, in a test).  The loop runs under
    ``deterministic_convs``, so that on the card, as on the CPU, a resumed
    run equals an uninterrupted one.  Returns the state and the logger.

    Data parallelism (``training_mesh``): with ``mesh``, or by default over
    every rank of the process group this process has joined (of more than
    one rank, or of any size under FSDP), every
    rank iterates the same global batches and trains on its rows of each
    (``data_iter_fn`` and ``config.seed`` alike on every rank); rank 0's
    parameters are broadcast first, and ``draws(N)`` gives the global
    batch's.  The logged loss is the global mean.  Rank 0 logs, evaluates
    and saves while the others wait at a barrier; the checkpoint is one
    file holding the full state, whichever way it was trained, and resume
    restores it on every rank before the sharding.  Under
    ``param_sharding="fsdp"`` the model and the moments are sharded over
    the mesh (``parallel.shard_state_fsdp``), a save gathers them, and
    every rank runs ``eval_fn`` on the gathered parameters (a collective),
    rank 0 logging it.

    ``config.checkpoint_backend="orbax"`` (with ``checkpoint_dir``) takes
    the other tier (``core/checkpoint_orbax.py``) at the same cadence: one
    ``OrbaxCheckpointer`` for the run, each save staged to host memory and
    written in the background while the next steps run, every rank writing
    its own shards; resume shards first, then restores into the shards.
    The checkpointer is closed when the loop ends or raises, so every
    queued save has committed (or raised) when this returns."""
    if config.checkpoint_backend not in ("msgpack", "orbax"):
        raise ValueError(f"unknown checkpoint_backend "
                         f"{config.checkpoint_backend!r}")
    logger = logger or MetricsLogger()
    device = next(model.parameters()).device
    mesh = training_mesh(config, mesh, device)
    fsdp = config.param_sharding == "fsdp"
    first = pmesh.is_first_rank(mesh)
    optimizer = make_optimizer(config)
    orbax_ck = None
    if checkpoint_dir and config.checkpoint_backend == "orbax":
        orbax_ck = OrbaxCheckpointer(checkpoint_dir, async_save=True)
    state = TrainState.create(model, optimizer)
    if resume and checkpoint_dir and orbax_ck is None:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt:
            restore_checkpoint(ckpt, model, state)
    if mesh is not None:
        pmesh.replicate(mesh, model)
    if fsdp:
        shard_state_fsdp(model, state, mesh,
                         min_elements=config.fsdp_min_elements)
    if resume and orbax_ck is not None and orbax_ck.latest_step() is not None:
        # sharded restore: each rank reads its own shards straight into
        # them (no whole copy, no gather)
        restore_train_state(orbax_ck, model, state)
    train_step = make_diffusion_train_step(model, optimizer,
                                           config.accumulation_steps,
                                           mesh=mesh)
    ranks = 1 if mesh is None else mesh.size()

    def save() -> None:
        if orbax_ck is not None:    # async: returns before the write lands
            orbax_ck.save(state.step, shard_restore_target(model, state))
            return
        full = checkpoint_state(model, state)    # gathers the FSDP shards
        if first:
            save_step_checkpoint(checkpoint_dir, full, state.step)
        if mesh is not None:
            pmesh.barrier(mesh)

    def evaluate(step: int, epoch: int, **extra) -> None:
        if first or fsdp:
            with gathered(model):
                metrics = eval_fn(state)
            if first:
                logger.log(step=step, epoch=epoch, **extra, **metrics)
        if mesh is not None:
            pmesh.barrier(mesh)

    def mine(t):
        return t if mesh is None else t[pmesh.local_rows(mesh, len(t))]

    loader = ThreadedLoader(data_iter_fn) if config.prefetch > 0 else None

    def device_batches():
        def host_batches():
            for X, y in (data_iter_fn() if loader is None
                         else loader.epoch()):
                yield tuple(map(mine, (y, X) if not swap_xy else (X, y)))

        if loader is None:
            for batch in host_batches():
                yield to_device(batch, device)
            return
        yield from prefetch_to_device(host_batches(), device,
                                      size=config.prefetch)

    t0 = time.time()
    samples_seen = 0
    preflighted = False
    with deterministic_convs():
        try:
            for i in range(config.epochs):
                epoch = state.epoch
                for cond, target in device_batches():
                    if config.preflight_memory_check and not preflighted:
                        preflight_memory_check(model, state, cond, target,
                                               config.accumulation_steps)
                        preflighted = True
                    if draws is None:
                        gen = step_generator(config.seed, state.step, device)
                        loss = train_step(state, cond, target, gen)
                    else:
                        sigmas, noise = map(mine, draws(state.step))
                        loss = train_step(state, cond, target,
                                          sigmas=sigmas.to(device),
                                          noise=noise.to(device))
                    samples_seen += cond.shape[0] * ranks
                    if first and state.step % config.print_loss_every == 0:
                        elapsed = time.time() - t0
                        logger.log(step=state.step, epoch=epoch,
                                   loss=float(loss),
                                   samples_per_sec=samples_seen / max(
                                       elapsed, 1e-9))
                    # in-epoch eval + checkpoint cadence (reference
                    # evals/saves every print_loss steps inside the epoch,
                    # `generative.py:1139-1172`)
                    if (config.eval_every_steps
                            and state.step % config.eval_every_steps == 0):
                        if eval_fn is not None:
                            evaluate(state.step, epoch, in_epoch=True)
                        if checkpoint_dir:
                            save()
                state.epoch += 1
                if eval_fn is not None:
                    evaluate(state.step, epoch)
                if checkpoint_dir and (
                        state.epoch % config.checkpoint_every_epochs == 0
                        or i == config.epochs - 1):
                    save()
        finally:
            if loader is not None:
                loader.close()
            if orbax_ck is not None:
                orbax_ck.close()    # every queued save commits or raises
    return state, logger
