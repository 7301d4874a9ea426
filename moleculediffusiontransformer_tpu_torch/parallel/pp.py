"""Pipeline parallelism: GPipe micro-batches through the AR decoder trunk,
its layers sharded over a 'stage' axis (port of `parallel/pp.py`).

The decoders (``models/transformers.py``) are a stack of ``depth`` equal
(self-attention, cross-attention, feed-forward) layers.  JAX stacks their
parameters on a leading depth axis, shards it over 'stage' and runs one
``shard_map`` program of ``n_micro + n_stages - 1`` ticks: at each, every
stage applies its local layers and hands its activation on with one
``ppermute``; stage 0 feeds fresh micro-batches and the last collects.  The
port runs the same tick schedule eagerly on each rank:

* :func:`stack_layer_params` / :func:`unstack_layer_params` on the port's
  names (``layers.{i}.{0,1,2}...``; JAX's are ``layers_{i}_{sfx}``): the
  stacked dict is keyed by the name under layer 0, which is what
  ``torch.func.functional_call`` of one layer takes;
* :func:`shard_model_pp` keeps, on each stage, only its ``depth /
  n_stages`` layers, stacked (a ``DTensor`` shard over 'stage'); the
  embedding, conditioning and head stay whole and run on every stage;
* :func:`pipeline_layers` runs the ticks.  Every tick's activation passes
  through ``ppermute`` (its backward the reverse hop), so autograd of the
  ticks is GPipe's backward, as JAX gets it from ``jax.grad``: no 1F1B
  machinery.  The stages' programs stay alike, as JAX's SPMD program is:
  stage 0 reads the hop it discards through a select, the non-last stages
  hold their outputs behind a zero select, so that every rank's autograd
  reaches every hop in the same order.  A stage skips the layers in its
  bubble ticks (JAX computes and discards them).
* the last stage's outputs reach every stage by a sum over 'stage' that is
  forward only: ``reduce_from``, whose backward is the identity (every
  stage computes the same head and loss after it; a summing backward would
  scale the trunk's grads by the stage count).  The trunk's inputs enter
  through ``copy_to``, so the embedding's and conditioning's grads, each
  stage's part, are summed over the stages.

On a (data, stage) mesh the pipeline runs on each rank's rows of the
batch over 'data' as it is; the composition with data parallelism is the
train step's (``trainer.make_transformer_train_step(mesh=)`` averages the
grads and the loss over 'data', ``collectives.sync_grads``).  JAX's
``data_axis`` argument, which sets its ``shard_map`` specs, has no
counterpart here.
"""
from __future__ import annotations

import copy
import re
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .collectives import axis as mesh_axis
from .collectives import copy_to, ppermute, reduce_from
from .mesh import mesh_2d

_LAYER_RE = re.compile(r"^layers\.(\d+)\.(.+)$")


def make_mesh_pp(data: int, stages: int, device: str = "cuda"):
    """The 2-D ``("data", "stage")`` mesh of ``data`` x ``stages`` ranks
    over the process group, on the card unless ``device="cpu"``."""
    return mesh_2d(data, stages, ("data", "stage"), device)


def stack_layer_params(params: Dict[str, torch.Tensor], depth: int
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """Split a decoder's flat parameter dict into (stacked, rest): the
    per-layer ``layers.{i}.{name}`` stacked on a leading ``depth`` axis
    under ``name``, and the others as they are."""
    by_name: Dict[str, Dict[int, torch.Tensor]] = {}
    rest: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        m = _LAYER_RE.match(k)
        if m:
            by_name.setdefault(m.group(2), {})[int(m.group(1))] = v
        else:
            rest[k] = v
    stacked = {}
    for name, by_i in by_name.items():
        if sorted(by_i) != list(range(depth)):
            raise ValueError(f"layer parameter {name}: found {sorted(by_i)} "
                             f"for depth {depth}")
        stacked[name] = torch.stack([by_i[i] for i in range(depth)])
    return stacked, rest


def unstack_layer_params(stacked: Dict[str, torch.Tensor],
                         rest: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params`."""
    params = dict(rest)
    for name, t in stacked.items():
        for i in range(t.shape[0]):
            params[f"layers.{i}.{name}"] = t[i]
    return params


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(b, ...) -> (n_micro, b / n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


class _Layer(nn.Module):
    """One trunk layer's residual wiring (``_DecoderBase._trunk``) over the
    three modules of a layer: children ``0``, ``1``, ``2`` as there."""

    def __init__(self, layer: nn.ModuleList):
        super().__init__()
        for i, m in enumerate(layer):
            self.add_module(str(i), m)

    def forward(self, x, cond, text_mask):
        attn, cross, ff = self._modules.values()
        x = attn(x) + x
        x = cross(x, context=cond, context_mask=text_mask) + x
        return ff(x) + x


def make_layer_apply(model: nn.Module) -> Callable:
    """One trunk layer: ``fn(layer_params, x, cond, text_mask)``, layer 0's
    modules run on ``layer_params`` (keyed as :func:`stack_layer_params`
    keys them), the residual wiring of ``_trunk``."""
    layer = _Layer(model.layers[0] if "layers" in model._modules
                   else model._pp_template)

    def apply_layer(layer_params, x, cond, text_mask):
        return torch.func.functional_call(layer, layer_params,
                                          (x, cond, text_mask))

    return apply_layer


class StackedLayers(nn.Module):
    """A stage's layers, stacked: one parameter a layer parameter (a
    ``DTensor`` shard of its depth over 'stage'), registered under its
    name with '.' spelt '/'."""

    def __init__(self, stacked: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in stacked.items():
            self.register_parameter(name.replace(".", "/"), t)

    def local(self) -> Dict[str, torch.Tensor]:
        """{name: (local depth, ...)} of this stage, differentiable."""
        return {name.replace("/", "."): p.to_local()
                for name, p in self.named_parameters()}


def shard_stacked(mesh, stacked: Dict[str, torch.Tensor],
                  axis: str = "stage") -> Dict[str, nn.Parameter]:
    """Each stacked tensor as this stage's ``DTensor`` shard of its depth
    (the stage's ``depth / n_stages`` layers), a parameter."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ax = mesh_axis(mesh, axis)
    at = list(mesh.mesh_dim_names).index(axis)
    placements = [Replicate()] * mesh.ndim
    placements[at] = Shard(0)
    out = {}
    for name, t in stacked.items():
        if t.shape[0] % ax.size:
            raise ValueError(f"depth {t.shape[0]} not divisible by "
                             f"{ax.size} stages")
        local = torch.chunk(t.detach(), ax.size, 0)[ax.rank].contiguous()
        out[name] = nn.Parameter(DTensor.from_local(
            local, mesh, placements, run_check=False, shape=t.shape,
            stride=t.stride()))
    return out


def shard_model_pp(model: nn.Module, mesh, axis: str = "stage") -> nn.Module:
    """Pipeline ``model`` (a ``_DecoderBase``) over ``mesh``'s ``axis``, in
    place: its layers become ``model.stacked_layers``, this stage's part of
    them; ``model.layers`` leaves the module (its layer 0 stays as the
    template :func:`make_layer_apply` runs, on the meta device).  Every rank
    must hold the same parameters first.  The model then runs through
    :func:`pipeline_forward`; make the optimizer state after this."""
    stacked, _ = stack_layer_params(
        {k: v for k, v in model.named_parameters() if k.startswith("layers.")},
        model.depth)
    template = copy.deepcopy(model.layers[0]).to("meta")
    del model.layers
    object.__setattr__(model, "_pp_template", template)
    object.__setattr__(model, "_pp_axis", axis)
    model.stacked_layers = StackedLayers(shard_stacked(mesh, stacked, axis))
    return model


def pipeline_layers(mesh, apply_layer: Callable,
                    stacked: Dict[str, torch.Tensor], x_micro: torch.Tensor,
                    cond_micro: torch.Tensor, mask_micro: torch.Tensor,
                    axis: str = "stage") -> torch.Tensor:
    """The micro-batches through the stages; returns y_micro on every
    stage.  ``stacked``: this stage's layers ({name: (local depth, ...)});
    ``x_micro`` (n_micro, mb, L, dim), ``cond_micro`` (n_micro, mb, m, C),
    ``mask_micro`` (n_micro, mb, m), the same on every stage of ``axis``."""
    ax = mesh_axis(mesh, axis)
    n, s = ax.size, ax.rank
    n_micro = x_micro.shape[0]
    depth = next(iter(stacked.values())).shape[0]
    ring = [(i, (i + 1) % n) for i in range(n)]
    x_micro, cond_micro = copy_to(x_micro, ax), copy_to(cond_micro, ax)
    first = torch.tensor(s == 0, device=x_micro.device)
    last = torch.tensor(s == n - 1, device=x_micro.device)

    def local_apply(x, cond, mask):
        for j in range(depth):
            x = apply_layer({k: v[j] for k, v in stacked.items()}, x, cond,
                            mask)
        return x

    state = torch.zeros_like(x_micro[0])
    outs = [None] * n_micro
    ticks = n_micro + n - 1
    for t in range(ticks):
        m = t - s                      # this stage's micro-batch at tick t
        cur = torch.where(first, x_micro[min(t, n_micro - 1)], state)
        if 0 <= m < n_micro:
            y = local_apply(cur, cond_micro[m], mask_micro[m])
        else:
            y = cur * 0                # a bubble: JAX computes and drops it
        slot = t - (n - 1)             # the last stage's finished micro-batch
        if slot >= 0:
            outs[slot] = y
        if t < ticks - 1:
            state = ppermute(y, ax, ring)
    out = torch.stack(outs)
    return reduce_from(torch.where(last, out, torch.zeros_like(out)), ax)


def pipeline_forward(model: nn.Module, sequences: torch.Tensor,
                     output: torch.Tensor, *, mesh, n_micro: int,
                     return_loss: bool = False, cond_drop_prob: float = 0.0,
                     keep: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     axis: str = "stage") -> torch.Tensor:
    """A pipelined decoder's forward (``shard_model_pp`` first): the
    continuous ``MoleculeTransformer`` (MSE on the shifted stream) or the
    token decoders (shifted cross entropy).  The embedding, conditioning
    and head run whole on every stage; the layers stream through ``axis``.
    The conditioning dropout's keep mask (b,) is handed in (``keep``) or
    drawn from ``generator``.  With ``return_loss`` this is the training
    objective.  On a (data, stage) mesh it runs on this rank's rows; the
    grads' average over 'data' is the train step's."""
    from ..models.transformers import cross_entropy_mean
    continuous = hasattr(model, "embed_vectors")
    cond = model.embed_conditioning(sequences)
    target = None
    if continuous:
        x = model.embed_vectors(output)
        if return_loss:
            x, target = x[:, :-1], x[:, 1:, :model.logits_dim]
    else:
        x = model.embed_tokens(output)
    cond, text_mask = model._text_mask(cond, None, cond_drop_prob, generator,
                                       keep)
    x = model.init_norm(x)
    y = pipeline_layers(
        mesh, make_layer_apply(model), model.stacked_layers.local(),
        split_microbatches(x, n_micro), split_microbatches(cond, n_micro),
        split_microbatches(text_mask, n_micro), axis)
    y = y.reshape((-1,) + tuple(y.shape[2:]))
    logits = model.to_logits(model.final_norm(y))
    if not return_loss:
        return logits
    if continuous:
        return (logits - target).float().square().mean()
    return cross_entropy_mean(logits[:, :-1], output[:, 1:])
