"""The ADPM2 and v diffusion samplers (port of `diffusion/samplers.py`).

``denoise`` is a closure ``denoise(x, sigmas_batch) -> x0_hat`` with sigmas
shaped (batch,); conditioning and CFG live inside it (see ``models/``).
ADPM2 with ``rho=1`` is the production sampler of every QM model, the
deterministic v-sampler that of the ``Model1d`` family; ``inpaint_adpm2``
is ADPM2 under a keep-mask (RePaint-style inpainting).

The step sigmas are computed host-side in numpy float32, as the JAX package
computes them on the device in float32.  The ancestral noise of step ``i``
is ``step_noise[i]`` when given — so a test can feed in the JAX package's
draws, which torch cannot reproduce — and is otherwise drawn from
``generator``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _sqrt_sq_diff(a, b):
    """sqrt(a**2 - b**2) for a >= b >= 0 in the factored form, exact at
    a == b whatever the compiler contracts into an FMA (the naive form can
    give NaN or sqrt(ulp) garbage there)."""
    return np.sqrt(np.maximum((a - b) * (a + b), np.float32(0.0)))


def _batched(denoise: DenoiseFn, x: torch.Tensor, sigma) -> torch.Tensor:
    """Broadcast a scalar step sigma to a (batch,) vector."""
    return denoise(x, torch.full((x.shape[0],), float(sigma), dtype=x.dtype,
                                 device=x.device))


def adpm2_sigmas(sigma, sigma_next, rho: float = 1.0):
    """Ancestral DPM-2 sigma decomposition (float32 numpy scalars in,
    float32 out): (sigma_up, sigma_down, sigma_mid)."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    sigma_up = np.sqrt(sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
                       / sigma ** 2)
    sigma_down = _sqrt_sq_diff(sigma_next, sigma_up)
    sigma_mid = ((sigma ** (1 / rho) + sigma_down ** (1 / rho)) / 2) ** rho
    return sigma_up, sigma_down, np.float32(sigma_mid)


def adpm2_step(denoise: DenoiseFn, x: torch.Tensor, sigma, sigma_next,
               noise: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """One ancestral DPM-2 midpoint step: two denoise evaluations, then
    ``noise * sigma_up``."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    sigma_up, sigma_down, sigma_mid = adpm2_sigmas(sigma, sigma_next, rho)
    d = (x - _batched(denoise, x, sigma)) / float(sigma)
    x_mid = x + d * float(sigma_mid - sigma)
    d_mid = (x_mid - _batched(denoise, x_mid, sigma_mid)) / float(sigma_mid)
    x = x + d_mid * float(sigma_down - sigma)
    return x + noise * float(sigma_up)


def _draw(given: Optional[torch.Tensor], like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """An injected draw, or a standard normal like ``like`` from
    ``generator``."""
    if given is not None:
        return given
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def sample_adpm2(denoise: DenoiseFn, noise: torch.Tensor, sigmas: np.ndarray,
                 num_steps: int, *, step_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 rho: float = 1.0) -> torch.Tensor:
    """ADPM2 over ``sigmas``: ``num_steps - 1`` steps (the reference's loop
    bounds), starting from ``sigmas[0] * noise``.  ``step_noise``
    (num_steps - 1, *noise.shape) or ``generator`` supplies the ancestral
    noise."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    if step_noise is None and generator is None:
        raise ValueError("sample_adpm2 needs step_noise or a generator")
    if step_noise is not None and step_noise.shape[0] != num_steps - 1:
        raise ValueError(f"step_noise has {step_noise.shape[0]} steps, "
                         f"expected {num_steps - 1}")
    x = noise * float(sigmas[0])
    for i in range(num_steps - 1):
        eps = _draw(None if step_noise is None else step_noise[i], x,
                    generator)
        x = adpm2_step(denoise, x, sigmas[i], sigmas[i + 1], eps, rho)
    return x


def inpaint_adpm2(denoise: DenoiseFn, source: torch.Tensor,
                  mask: torch.Tensor, sigmas: np.ndarray, num_steps: int,
                  num_resamples: int, *, noise: Optional[torch.Tensor] = None,
                  source_noise: Optional[torch.Tensor] = None,
                  step_noise: Optional[torch.Tensor] = None,
                  renoise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  rho: float = 1.0) -> torch.Tensor:
    """RePaint-style masked inpainting: ``mask`` is boolean, True = keep
    from ``source``.  x starts at ``sigmas[0] * noise``; before every ADPM2
    step of each of the ``num_resamples`` resamples of step i the kept
    positions take ``source + sigma_i * source_noise[i]``; between resamples
    x is re-noised by ``sqrt(sigma_i**2 - sigma_{i+1}**2) * renoise[i, r]``;
    the result is ``where(mask, source, x)``.

    Every draw can be injected -- ``noise`` (like source), ``source_noise``
    (num_steps - 1, ...), ``step_noise`` and ``renoise`` (num_steps - 1,
    num_resamples, ...; the last resample's renoise is not used) -- and is
    otherwise drawn from ``generator``."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    draws = [noise, source_noise, step_noise]
    if num_resamples > 1:
        draws.append(renoise)
    if generator is None and any(t is None for t in draws):
        raise ValueError("inpaint_adpm2 needs a generator or every draw")
    mask = mask.to(torch.bool)
    x = _draw(noise, source, generator) * float(sigmas[0])
    for i in range(num_steps - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        eps_src = None if source_noise is None else source_noise[i]
        source_noisy = source + _draw(eps_src, source, generator) * float(s)
        for r in range(num_resamples):
            x = torch.where(mask, source_noisy, x)
            eps = None if step_noise is None else step_noise[i, r]
            x = adpm2_step(denoise, x, s, sn, _draw(eps, x, generator), rho)
            if r < num_resamples - 1:
                eps = None if renoise is None else renoise[i, r]
                x = x + _draw(eps, x, generator) * float(_sqrt_sq_diff(s, sn))
    return torch.where(mask, source, x)


def sample_v(denoise: DenoiseFn, noise: torch.Tensor, sigmas: np.ndarray,
             num_steps: int) -> torch.Tensor:
    """DDIM-like v-sampler, deterministic: ``num_steps - 1`` steps from
    ``sigmas[0] * noise``.  As the reference does, it returns the last
    step's ``x_pred``, not the re-noised x."""
    sigmas = np.asarray(sigmas, dtype=np.float32)

    def alpha_beta(sigma):
        angle = np.float32(sigma) * np.float32(math.pi) / np.float32(2)
        return float(np.cos(angle)), float(np.sin(angle))

    x = noise * float(sigmas[0])
    x_pred = x
    for i in range(num_steps - 1):
        alpha, beta = alpha_beta(sigmas[i])
        x_denoised = _batched(denoise, x, sigmas[i])
        x_pred = x * alpha - x_denoised * beta
        x_eps = x * beta + x_denoised * alpha
        alpha_n, beta_n = alpha_beta(sigmas[i + 1])
        x = x_pred * alpha_n + x_eps * beta_n
    return x_pred


_SAMPLERS = {"adpm2": sample_adpm2, "v": sample_v}

# sampler -> objectives it is valid for
SAMPLER_COMPAT = {"adpm2": ("k", "vk"), "v": ("v",)}


def sample(denoise: DenoiseFn, noise: torch.Tensor, sigmas: np.ndarray,
           num_steps: int, *, sampler: str = "adpm2", clamp: bool = True,
           objective_alias: Optional[str] = None,
           **sampler_kwargs) -> torch.Tensor:
    """Run the chosen sampler over the schedule, optionally clamping the
    result to [-1, 1].  "adpm2" and "v" are ported so far."""
    if sampler not in _SAMPLERS:
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
    if objective_alias is not None:
        assert objective_alias in SAMPLER_COMPAT[sampler], (
            f"{sampler} incompatible with objective '{objective_alias}'")
    x = _SAMPLERS[sampler](denoise, noise, sigmas, num_steps,
                           **sampler_kwargs)
    return x.clamp(-1.0, 1.0) if clamp else x
