"""The K-diffusion (Karras elucidated) objective: denoiser and training loss
(port of `diffusion/objectives.py::KDiffusion`, the production objective of
every QM9 model).

The network enters as a closure ``net(x, t) -> x_pred``; tensors are
channels-last (b, L, C) and sigmas (b,), broadcast as (b, 1, 1).  Draws come
from a ``torch.Generator`` or are handed in (``loss_from_draws``), since
torch cannot reproduce the JAX package's threefry keys."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

NetFn = Callable[..., torch.Tensor]


def clip(x: torch.Tensor, dynamic_threshold: float = 0.0) -> torch.Tensor:
    """Clamp to [-1, 1], or Imagen-style dynamic quantile thresholding."""
    if dynamic_threshold == 0.0:
        return x.clamp(-1.0, 1.0)
    x_flat = x.reshape(x.shape[0], -1)
    scale = torch.quantile(x_flat.abs().float(), dynamic_threshold, dim=-1)
    scale = scale.clamp(min=1.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.maximum(torch.minimum(x, scale), -scale) / scale


@dataclass(frozen=True)
class KDiffusion:
    """Karras elucidated diffusion (arXiv:2206.00364).  The denoised
    estimate is always clipped to [-1, 1] (or dynamically thresholded)."""
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
        losses = ((x_denoised - x) ** 2).mean(dim=tuple(range(1, x.dim())))
        return (losses * self.loss_weight(sigmas)).mean()

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
