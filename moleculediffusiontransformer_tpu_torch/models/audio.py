"""Generic 1-D diffusion model and the waveform presets (port of
`models/audio.py`: ``Model1d``, ``sample_model1d`` and the
``AudioDiffusionModel`` / ``AudioDiffusionConditional`` presets).

``Model1d`` is a UNet (``XUNet1d``: "base", "cfg", "ncca" or "all") under a
diffusion objective ("v" for the presets, "k" or "vk"): calling it is the
training loss, ``denoise`` is the sampler's closure, ``sample_model1d`` the
serving path (a linear schedule, the deterministic v-sampler and a clamp by
default; the ADPM2, ancestral Euler and Karras samplers on request).  All tensors channels-last
(b, L, C).  On a 2**15-sample waveform the default preset attends at lengths
32 to 4; a shallower net on a longer waveform attends at thousands of tokens,
and ``nn.attention.sdpa`` then streams attention through
``ops.flash_attention``.

The factory functions put the model on the card unless the caller names a
device.  Parameter names are the reference's (``unet.*``), so the JAX
package's params load with ``strict=True``
(``nn.jax_import.state_dict_from_jax_params``).

The UNet variants' draws (the "cfg"/"all" conditioning dropout of
``embedding_mask_proba``, the "ncca" noise) come from the ``generator`` that
the loss and the sampler are given, or are handed in through the UNet's
keyword arguments (``embedding_keep=``, ``channels_noise=``).

Not ported yet: the upsampler, autoencoder, vocoder, upphaser and
autoregressive assemblies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..diffusion.distributions import UniformDistribution
from ..diffusion.objectives import Objective, make_objective
from ..diffusion.samplers import sample as run_sampler
from ..diffusion.schedules import make_schedule
from ..nn.primitives import init_parameters
from ..nn.unet import XUNet1d

Device = Union[str, torch.device]


class Model1d(nn.Module):
    """XUNet1d + diffusion objective.  ``forward`` returns the training
    loss; sample with :func:`sample_model1d`."""

    def __init__(self, in_channels: int, channels: int,
                 multipliers: Sequence[int], factors: Sequence[int],
                 num_blocks: Sequence[int], attentions: Sequence[int],
                 unet_type: str = "base", patch_size: int = 1,
                 resnet_groups: int = 8, out_channels: Optional[int] = None,
                 context_features: Optional[int] = None,
                 context_channels: Sequence[int] = (),
                 context_embedding_features: Optional[int] = None,
                 context_embedding_max_length: int = 0,
                 attention_heads: Optional[int] = None,
                 attention_features: Optional[int] = None,
                 attention_multiplier: Optional[int] = None,
                 pre_transformer: int = 0, use_nearest_upsample: bool = False,
                 use_skip_scale: bool = True, diffusion_type: str = "v",
                 diffusion_sigma_distribution: Any = UniformDistribution(),
                 diffusion_sigma_data: float = 0.1,
                 diffusion_dynamic_threshold: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        self.unet_type, self.diffusion_type = unet_type, diffusion_type
        self.sigma_distribution = diffusion_sigma_distribution
        self.objective: Objective = make_objective(
            diffusion_type, sigma_data=diffusion_sigma_data,
            dynamic_threshold=diffusion_dynamic_threshold)
        kwargs = dict(
            in_channels=in_channels, channels=channels,
            multipliers=tuple(multipliers), factors=tuple(factors),
            num_blocks=tuple(num_blocks), attentions=tuple(attentions),
            patch_size=patch_size, resnet_groups=resnet_groups,
            out_channels=out_channels, context_features=context_features,
            context_channels=tuple(context_channels),
            attention_heads=attention_heads,
            attention_features=attention_features,
            attention_multiplier=attention_multiplier,
            pre_transformer=pre_transformer,
            use_nearest_upsample=use_nearest_upsample,
            use_skip_scale=use_skip_scale, dtype=dtype)
        if unet_type in ("cfg", "all"):
            kwargs.update(
                context_embedding_features=context_embedding_features,
                context_embedding_max_length=context_embedding_max_length)
        elif context_embedding_features is not None:
            kwargs.update(
                context_embedding_features=context_embedding_features)
        self.unet = XUNet1d(type=unet_type, **kwargs)

    def _net(self, generator: Optional[torch.Generator], net_kwargs):
        """The UNet as the objective calls it; the variants that draw take
        ``generator`` too."""
        if self.unet_type != "base":
            net_kwargs = dict(net_kwargs, generator=generator)

        def net(xn, t):
            return self.unet(xn, t, **net_kwargs)
        return net

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        """Training loss (a scalar).  x (b, L, in_channels); the sigmas (b,)
        and the noise (like x) are drawn from ``generator`` on x's device
        unless handed in, in that order, then the UNet's own draws;
        ``net_kwargs`` go to the UNet (``embedding=`` and
        ``embedding_mask_proba=`` for "cfg"/"all", ``channels_list=`` for
        "ncca")."""
        return self.objective.loss_from_draws(
            self._net(generator, net_kwargs), x, self.sigma_distribution,
            generator, sigmas=sigmas, noise=noise)

    def denoise(self, x: torch.Tensor, sigmas: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                **net_kwargs) -> torch.Tensor:
        """One denoise evaluation, the sampler's closure."""
        return self.objective.denoise(self._net(generator, net_kwargs), x,
                                      sigmas)


@torch.no_grad()
def sample_model1d(model: Model1d, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, *,
                   shape: Optional[Tuple[int, int, int]] = None,
                   num_steps: int = 50, sampler: str = "v",
                   schedule: str = "linear", sigma_min: float = 1e-3,
                   sigma_max: float = 9.0, schedule_rho: float = 3.0,
                   clamp: bool = True,
                   step_noise: Optional[torch.Tensor] = None,
                   sampler_kwargs: Optional[Dict[str, Any]] = None,
                   **net_kwargs) -> torch.Tensor:
    """Sample the ``Model1d`` family; the defaults are
    ``get_default_sampling_kwargs`` (linear schedule, v-sampler, clamp).
    Runs on the model's device: ``noise`` (b, L, in_channels) is moved
    there, or drawn there from ``generator`` at ``shape`` when it is None.
    The stochastic samplers ("adpm2", "aeuler", "karras") take their step
    noise from ``step_noise`` (num_steps - 1, b, L, in_channels) or from
    ``generator``; ``sampler_kwargs`` are the sampler's own settings
    (``s_churn=`` of "karras").  ``net_kwargs`` go to the UNet
    (``embedding=``, ``embedding_scale=``); the UNet variants that draw take
    ``generator`` too."""
    device = next(model.parameters()).device
    if noise is None:
        if shape is None or generator is None:
            raise ValueError("sample_model1d needs noise, or a shape and a "
                             "generator to draw it from")
        noise = torch.randn(shape, generator=generator, device=device)
    sigmas = make_schedule(schedule, num_steps, sigma_min=sigma_min,
                           sigma_max=sigma_max, rho=schedule_rho)

    def denoise(x, s):
        return model.denoise(x, s, generator, **net_kwargs)

    kwargs = dict(sampler_kwargs or {})
    if sampler != "v":
        kwargs.update(step_noise=None if step_noise is None
                      else step_noise.to(device), generator=generator)
    return run_sampler(denoise, noise.to(device), sigmas, num_steps,
                       sampler=sampler, clamp=clamp,
                       objective_alias=model.diffusion_type, **kwargs)


# -------------------------------------------------- presets ---------------

def get_default_model_kwargs() -> Dict[str, Any]:
    return dict(
        channels=128, patch_size=16,
        multipliers=(1, 2, 4, 4, 4, 4, 4), factors=(4, 4, 4, 2, 2, 2),
        num_blocks=(2, 2, 2, 2, 2, 2), attentions=(0, 0, 0, 1, 1, 1, 1),
        attention_heads=8, attention_features=64, attention_multiplier=2,
        diffusion_type="v",
        diffusion_sigma_distribution=UniformDistribution(),
    )


def get_default_sampling_kwargs() -> Dict[str, Any]:
    return dict(schedule="linear", sampler="v", clamp=True)


def build_model1d(device: Optional[Device] = None,
                  generator: Optional[torch.Generator] = None,
                  **kwargs) -> Model1d:
    """A ``Model1d`` on ``device`` -- the card ("cuda") unless the caller
    names another, so a CPU run asks for ``device="cpu"`` -- its parameters
    drawn from ``generator`` (a CPU generator; torch's global RNG when
    None)."""
    model = Model1d(**kwargs)
    if generator is not None:
        init_parameters(model, generator)
    return model.to("cuda" if device is None else device)


def AudioDiffusionModel(device: Optional[Device] = None,
                        generator: Optional[torch.Generator] = None,
                        **kwargs) -> Model1d:
    """The unconditional waveform preset; ``kwargs`` override it."""
    return build_model1d(device, generator,
                         **{**get_default_model_kwargs(), **kwargs})


def AudioDiffusionConditional(embedding_features: int,
                              embedding_max_length: int,
                              device: Optional[Device] = None,
                              generator: Optional[torch.Generator] = None,
                              **kwargs) -> Model1d:
    """The classifier-free-guided preset, conditioned on an embedding
    (b, embedding_max_length, embedding_features); the reference samples it
    at ``embedding_scale=5.0``."""
    defaults = dict(get_default_model_kwargs(), unet_type="cfg",
                    context_embedding_features=embedding_features,
                    context_embedding_max_length=embedding_max_length)
    return build_model1d(device, generator, **{**defaults, **kwargs})
