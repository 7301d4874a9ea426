"""The K-diffusion (Karras elucidated) objective's denoiser (port of
`diffusion/objectives.py::KDiffusion`, the production objective of every QM9
model).

The network enters as a closure ``net(x, t) -> x_pred``; tensors are
channels-last (b, L, C) and sigmas (b,), broadcast as (b, 1, 1)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

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
