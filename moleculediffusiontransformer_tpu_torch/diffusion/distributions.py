"""Training-time noise-level (sigma) distributions (port of
`diffusion/distributions.py`).

Each draws from an explicit ``torch.Generator``, or maps draws it is handed
(``normals`` / ``uniforms``): torch cannot reproduce JAX's threefry bits, so
a comparison with the JAX package feeds both the same numbers.  QM9 models
use ``LogNormalDistribution(mean=-1.2, std=1.2)``."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


def _draw(fn, num_samples: int, generator: Optional[torch.Generator],
          device: Optional[torch.device]) -> torch.Tensor:
    return fn(num_samples, generator=generator, device=device,
              dtype=torch.float32)


@dataclass(frozen=True)
class LogNormalDistribution:
    mean: float = -1.2
    std: float = 1.2

    def __call__(self, num_samples: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None, *,
                 normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        if normals is None:
            normals = _draw(torch.randn, num_samples, generator, device)
        return torch.exp(self.mean + self.std * normals)


@dataclass(frozen=True)
class UniformDistribution:
    def __call__(self, num_samples: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None, *,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        if uniforms is None:
            uniforms = _draw(torch.rand, num_samples, generator, device)
        return uniforms


@dataclass(frozen=True)
class VKDistribution:
    """The reference draws the CDF variable with ``randn`` (normal), not
    ``rand``; mirrored, as the JAX package mirrors it."""
    min_value: float = 0.0
    max_value: float = float("inf")
    sigma_data: float = 1.0

    def __call__(self, num_samples: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None, *,
                 normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        min_cdf = math.atan(self.min_value / self.sigma_data) * 2 / math.pi
        max_cdf = math.atan(self.max_value / self.sigma_data) * 2 / math.pi
        if normals is None:
            normals = _draw(torch.randn, num_samples, generator, device)
        u = (max_cdf - min_cdf) * normals + min_cdf
        return torch.tan(u * math.pi / 2) * self.sigma_data


def make_distribution(name: str, *, mean: float = -1.2, std: float = 1.2,
                      sigma_data: float = 1.0):
    """The sigma distribution called ``name``: "lognormal", "uniform" or
    "vk"."""
    if name == "lognormal":
        return LogNormalDistribution(mean, std)
    if name == "uniform":
        return UniformDistribution()
    if name == "vk":
        return VKDistribution(sigma_data=sigma_data)
    raise ValueError(f"Unknown sigma distribution: {name}")
