"""The diffusion objectives, denoiser and training loss: K-diffusion (Karras
elucidated; the production objective of every QM9 model), v-diffusion (the
``Model1d`` family's) and the v-objective in Karras parametrization, "vk"
(port of `diffusion/objectives.py`).

The network enters as a closure ``net(x, t) -> x_pred``; tensors are
channels-last (b, L, C) and sigmas (b,), broadcast as (b, 1, 1).  Draws come
from a ``torch.Generator`` or are handed in (``loss_from_draws``), since
torch cannot reproduce the JAX package's threefry keys."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import torch

NetFn = Callable[..., torch.Tensor]


def pad_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` with ``ndim`` trailing axes of size 1."""
    return x.reshape(tuple(x.shape) + (1,) * ndim)


def to_batch(batch_size: int, sigma: Optional[float] = None,
             sigmas: Optional[torch.Tensor] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """A (batch,) float32 vector of ``sigma``, or ``sigmas`` as given:
    exactly one of the two."""
    if (sigma is None) == (sigmas is None):
        raise ValueError("Either sigma or sigmas")
    if sigma is not None:
        return torch.full((batch_size,), sigma, dtype=torch.float32,
                          device=device)
    return sigmas


def clip(x: torch.Tensor, dynamic_threshold: float = 0.0) -> torch.Tensor:
    """Clamp to [-1, 1], or Imagen-style dynamic quantile thresholding."""
    if dynamic_threshold == 0.0:
        return x.clamp(-1.0, 1.0)
    x_flat = x.reshape(x.shape[0], -1)
    scale = torch.quantile(x_flat.abs().float(), dynamic_threshold, dim=-1)
    scale = pad_dims(scale.clamp(min=1.0), x.dim() - 1)
    return torch.maximum(torch.minimum(x, scale), -scale) / scale


@dataclass(frozen=True)
class Objective:
    """``seq_axis``: set by ``parallel.sp.set_sequence_axis`` where x holds
    this rank's slice of the length; the loss's means then span the whole
    length (``parallel.sp.mean``)."""
    alias: str = ""
    seq_axis: Any = field(default=None, compare=False, repr=False)

    def mean(self, t: torch.Tensor, dims=None) -> torch.Tensor:
        """``t.mean(dims)`` (every dim when None), over the whole length
        under sequence parallelism."""
        if self.seq_axis is not None:
            from ..parallel import sp
            return sp.mean(t, self.seq_axis, dims)
        return t.mean() if dims is None else t.mean(dim=dims)

    def denoise(self, net: NetFn, x_noisy: torch.Tensor,
                sigmas: torch.Tensor, **cond) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, net: NetFn, x: torch.Tensor, sigmas: torch.Tensor,
             noise: torch.Tensor, **cond) -> torch.Tensor:
        raise NotImplementedError

    def loss_from_draws(self, net: NetFn, x: torch.Tensor,
                        sigma_distribution,
                        generator: Optional[torch.Generator] = None, *,
                        sigmas: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        **cond) -> torch.Tensor:
        """The loss with sigmas (b,) drawn from ``sigma_distribution`` and
        standard normal noise like ``x``, each taken from ``generator``
        (on x's device) unless handed in (the JAX ``loss_from_key``)."""
        if sigmas is None:
            sigmas = sigma_distribution(x.shape[0], generator, x.device)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        return self.loss(net, x, sigmas, noise, **cond)


@dataclass(frozen=True)
class VDiffusion(Objective):
    """v-objective over the half-circle parametrization: the network
    predicts ``noise * alpha - x * beta`` from ``x * alpha + noise * beta``
    at ``alpha, beta = cos, sin(sigma * pi / 2)``."""
    alias: str = "v"

    @staticmethod
    def get_alpha_beta(sigmas: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        angle = sigmas * math.pi / 2
        return torch.cos(angle), torch.sin(angle)

    def denoise(self, net: NetFn, x_noisy: torch.Tensor,
                sigmas: torch.Tensor, **cond) -> torch.Tensor:
        return net(x_noisy, sigmas, **cond)

    def loss(self, net: NetFn, x: torch.Tensor, sigmas: torch.Tensor,
             noise: torch.Tensor, **cond) -> torch.Tensor:
        alpha, beta = self.get_alpha_beta(sigmas.reshape(-1, 1, 1))
        x_noisy = x * alpha + noise * beta
        x_target = noise * alpha - x * beta
        x_denoised = self.denoise(net, x_noisy, sigmas, **cond)
        return self.mean((x_denoised - x_target) ** 2)


@dataclass(frozen=True)
class KDiffusion(Objective):
    """Karras elucidated diffusion (arXiv:2206.00364).  The denoised
    estimate is always clipped to [-1, 1] (or dynamically thresholded)."""
    alias: str = "k"
    sigma_data: float = 0.1
    dynamic_threshold: float = 0.0

    def get_scale_weights(self, sigmas: torch.Tensor):
        sd = self.sigma_data
        c_noise = torch.log(sigmas) * 0.25
        s = sigmas.reshape(-1, 1, 1)
        c_skip = (sd ** 2) / (s ** 2 + sd ** 2)
        c_out = s * sd * (sd ** 2 + s ** 2) ** -0.5
        c_in = (s ** 2 + sd ** 2) ** -0.5
        return c_skip, c_out, c_in, c_noise

    def denoise(self, net: NetFn, x_noisy: torch.Tensor,
                sigmas: torch.Tensor, **cond) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = self.get_scale_weights(sigmas)
        x_pred = net(c_in * x_noisy, c_noise, **cond)
        return clip(c_skip * x_noisy + c_out * x_pred, self.dynamic_threshold)

    def loss_weight(self, sigmas: torch.Tensor) -> torch.Tensor:
        sd = self.sigma_data
        return (sigmas ** 2 + sd ** 2) * (sigmas * sd) ** -2

    def loss(self, net: NetFn, x: torch.Tensor, sigmas: torch.Tensor,
             noise: torch.Tensor, **cond) -> torch.Tensor:
        """Weighted MSE of the (clipped, as in the reference) denoised
        estimate of ``x + sigma * noise`` against ``x``; float32 scalar."""
        x_noisy = x + sigmas.reshape(-1, 1, 1) * noise
        x_denoised = self.denoise(net, x_noisy, sigmas, **cond)
        losses = self.mean((x_denoised - x) ** 2, tuple(range(1, x.dim())))
        return (losses * self.loss_weight(sigmas)).mean()


@dataclass(frozen=True)
class VKDiffusion(Objective):
    """The v-objective in Karras parametrization (sigma_data 1): the network
    sees ``c_in * x_noisy`` at ``t = atan(sigma) * 2 / pi`` and predicts
    ``v = (x - c_skip * x_noisy) / c_out``; nothing is clipped."""
    alias: str = "vk"

    @staticmethod
    def get_scale_weights(sigmas: torch.Tensor):
        sigma_data = 1.0
        s = sigmas.reshape(-1, 1, 1)
        c_skip = (sigma_data ** 2) / (s ** 2 + sigma_data ** 2)
        c_out = -s * sigma_data * (sigma_data ** 2 + s ** 2) ** -0.5
        c_in = (s ** 2 + sigma_data ** 2) ** -0.5
        return c_skip, c_out, c_in

    @staticmethod
    def sigma_to_t(sigmas: torch.Tensor) -> torch.Tensor:
        return torch.atan(sigmas) / math.pi * 2

    @staticmethod
    def t_to_sigma(t: torch.Tensor) -> torch.Tensor:
        return torch.tan(t * math.pi / 2)

    def denoise(self, net: NetFn, x_noisy: torch.Tensor,
                sigmas: torch.Tensor, **cond) -> torch.Tensor:
        c_skip, c_out, c_in = self.get_scale_weights(sigmas)
        x_pred = net(c_in * x_noisy, self.sigma_to_t(sigmas), **cond)
        return c_skip * x_noisy + c_out * x_pred

    def loss(self, net: NetFn, x: torch.Tensor, sigmas: torch.Tensor,
             noise: torch.Tensor, **cond) -> torch.Tensor:
        """MSE of the network's v prediction at ``x + sigma * noise``
        against ``(x - c_skip * x_noisy) / (c_out + 1e-7)``."""
        x_noisy = x + sigmas.reshape(-1, 1, 1) * noise
        c_skip, c_out, c_in = self.get_scale_weights(sigmas)
        x_pred = net(c_in * x_noisy, self.sigma_to_t(sigmas), **cond)
        v_target = (x - c_skip * x_noisy) / (c_out + 1e-7)
        return self.mean((x_pred - v_target) ** 2)


def make_objective(alias: str, *, sigma_data: float = 0.1,
                   dynamic_threshold: float = 0.0) -> Objective:
    """The objective of a ``diffusion_type``: "v", "k" or "vk"."""
    if alias == "v":
        return VDiffusion()
    if alias == "k":
        return KDiffusion(sigma_data=sigma_data,
                          dynamic_threshold=dynamic_threshold)
    if alias == "vk":
        return VKDiffusion()
    raise ValueError(f"type='{alias}' must be one of ('v', 'k', 'vk')")
