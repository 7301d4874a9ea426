"""Training: Adam behind a global-norm clip, and the diffusion train step with
gradient accumulation (port of `train/trainer.py`: ``make_optimizer``,
``make_diffusion_train_step``, ``make_transformer_train_step``;
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
update.  Checkpointing with the optimizer state, the epoch loop, DDP and
FSDP are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]
# optax.adam's defaults, which the JAX package trains with
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class OptimizerConfig:
    """The optimizer fields of the JAX package's ``core/config.py``
    ``TrainConfig``, with its defaults (the reference's Adam(2e-4) + clip
    0.5).  ``make_optimizer`` reads these by attribute, so a ``TrainConfig``
    serves as well."""
    learning_rate: float = 2e-4
    grad_clip_norm: float = 0.5
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_decay_steps: Optional[int] = None
    lr_min_ratio: float = 0.0


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
        ``params`` and ``state`` (in place)."""
        norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
        if not bool(norm < self.max_norm):
            grads = [(g / norm) * self.max_norm for g in grads]
        step_size = -self.lr(state.count)
        count = state.count + 1
        # optax computes 1 - decay**count in float32
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        mu = torch._foreach_mul(grads, 1 - B1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, B1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, B2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(updates, step_size)
        torch._foreach_add_(params, updates)
        state.mu, state.nu, state.count = mu, nu, count


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
    """The optimizer's state and the count of steps taken; the parameters
    are the model's own."""
    opt_state: AdamState
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: ClipAdam) -> "TrainState":
        return cls(opt_state=optimizer.init(list(model.parameters())))


def _accumulated_step(params: List[torch.Tensor], optimizer: ClipAdam,
                      state: TrainState, A: int, batch: int,
                      device: torch.device,
                      loss_of: Callable[[slice], torch.Tensor]
                      ) -> torch.Tensor:
    """One optimizer step over ``A`` micro-batches: ``loss_of(rows)`` is the
    loss of one micro-batch; the float32 grads are summed by autograd,
    divided by A, clipped and applied once, and stay on ``.grad``.  Returns
    the mean loss."""
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
    optimizer.update(params, [p.grad for p in params], state.opt_state)
    state.step += 1
    return loss_sum / A


def _accumulation_steps(accumulation_steps: int) -> int:
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got "
                         f"{accumulation_steps}")
    return accumulation_steps


def _part(t: Optional[torch.Tensor], rows: slice) -> Optional[torch.Tensor]:
    return None if t is None else t[rows]


def make_diffusion_train_step(model: nn.Module, optimizer: ClipAdam,
                              accumulation_steps: int = 1) -> Callable:
    """``step(state, conditioning, target, generator=None, *, sigmas=None,
    noise=None) -> loss`` for the QM diffusion models, whose call is
    ``(conditioning, target, generator, sigmas=, noise=) -> loss``.

    The batch is split into ``accumulation_steps`` = A micro-batches, run
    one after another; each draws its own sigmas and noise from
    ``generator``, or takes its slice of ``sigmas`` (b,) and ``noise`` (like
    ``target``) when they are handed in.  The float32 grads are summed over
    the micro-batches and divided by A, then clipped and applied once; they
    stay on the parameters' ``.grad`` after the step.  Returns the mean loss
    of the micro-batches (a float32 tensor on the model's device)."""
    A = _accumulation_steps(accumulation_steps)
    params = list(model.parameters())

    def train_step(state: TrainState, conditioning: torch.Tensor,
                   target: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   sigmas: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _accumulated_step(
            params, optimizer, state, A, conditioning.shape[0], target.device,
            lambda rows: model(conditioning[rows], target[rows], generator,
                               sigmas=_part(sigmas, rows),
                               noise=_part(noise, rows)))

    return train_step


def make_model1d_train_step(model: nn.Module, optimizer: ClipAdam,
                            accumulation_steps: int = 1) -> Callable:
    """``step(state, x, generator=None, *, sigmas=None, noise=None,
    **net_kwargs) -> loss`` for the ``Model1d`` family, whose loss takes
    only the data x (b, L, C): ``model(x, generator, sigmas=, noise=,
    **net_kwargs)``.  Micro-batches, draws, grads and the update are those
    of ``make_diffusion_train_step``; a tensor among ``net_kwargs`` whose
    first dimension is the batch (``embedding``) is split with x."""
    A = _accumulation_steps(accumulation_steps)
    params = list(model.parameters())

    def train_step(state: TrainState, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   sigmas: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   **net_kwargs) -> torch.Tensor:
        b = x.shape[0]

        def loss_of(rows: slice) -> torch.Tensor:
            kw = {k: (v[rows] if isinstance(v, torch.Tensor) and v.dim()
                      and v.shape[0] == b else v)
                  for k, v in net_kwargs.items()}
            return model(x[rows], generator, sigmas=_part(sigmas, rows),
                         noise=_part(noise, rows), **kw)

        return _accumulated_step(params, optimizer, state, A, b, x.device,
                                 loss_of)

    return train_step


def make_transformer_train_step(model: nn.Module,
                                optimizer: ClipAdam) -> Callable:
    """``step(state, props, ids, generator=None, *, keep=None) -> loss`` for
    the AR transformer decoders: the next-token cross entropy of
    ``model(props, ids, return_loss=True)`` with the model's conditioning
    dropout, one clip and one Adam update, no accumulation.  The dropout's
    keep mask (b,) is drawn from ``generator`` or handed in.  The float32
    grads stay on the parameters' ``.grad``; returns the loss (a float32
    tensor on the model's device)."""
    params = list(model.parameters())

    def train_step(state: TrainState, props: torch.Tensor, ids: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _accumulated_step(
            params, optimizer, state, 1, props.shape[0], ids.device,
            lambda rows: model(props, ids, return_loss=True,
                               generator=generator, keep=keep))

    return train_step
