"""Inference sigma schedules (port of `diffusion/schedules.py`; the JAX
package's copy is not imported because its package pulls in jax).

Computed host-side with numpy float32, exactly as the JAX package does."""
from __future__ import annotations

import numpy as np


def linear_schedule(num_steps: int) -> np.ndarray:
    """linspace(1, 0, n + 1)[:-1]: the v-sampler's schedule."""
    return np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float32)[:-1]


def karras_schedule(num_steps: int, sigma_min: float = 1e-3,
                    sigma_max: float = 9.0, rho: float = 3.0) -> np.ndarray:
    """Karras et al. 2022 eq. 5 with a trailing sigma = 0 pad: returns
    ``num_steps + 1`` float32 sigmas.  QM9 uses (1e-3, 9.0, rho=3)."""
    rho_inv = 1.0 / rho
    steps = np.arange(num_steps, dtype=np.float32)
    sigmas = (sigma_max ** rho_inv + (steps / (num_steps - 1))
              * (sigma_min ** rho_inv - sigma_max ** rho_inv)) ** rho
    return np.concatenate([sigmas.astype(np.float32),
                           np.zeros(1, dtype=np.float32)])


def make_schedule(name: str, num_steps: int, *, sigma_min: float = 1e-3,
                  sigma_max: float = 9.0, rho: float = 3.0) -> np.ndarray:
    if name == "linear":
        return linear_schedule(num_steps)
    if name == "karras":
        return karras_schedule(num_steps, sigma_min, sigma_max, rho)
    raise ValueError(f"Unknown schedule: {name}")
