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

The assemblies on ``Model1d`` (reference `model.py:41-294`), each with its
sampler and, but for the AR model, its preset:
- ``DiffusionUpsampler1d`` (``sample_upsampler``): conditioned on a copy of
  x down- and re-upsampled by a factor drawn a row;
- ``DiffusionAE1d`` (``decode_ae``): an ``Encoder1d`` latent injected as
  context channels;
- ``DiffusionVocoder1d`` (``sample_vocoder``, ``loss_from_wave``): the STFT
  phase over pi, conditioned on the magnitude;
- ``DiffusionUpphaser1d``: the upsampler trained on a randomly re-phased x;
- ``DiffusionAR1d`` (``sample_ar``): chunk after chunk, each conditioned on
  the one before (dropped to zero at random in training).
Each loss draws, in this order, its own augmentation (the factor index, the
random phase, the chunk index and the dropout) and then the sigmas and the
noise from ``generator`` on x's device, or takes them handed in.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..core.utils import closest_power_2
from ..diffusion.distributions import UniformDistribution
from ..diffusion.objectives import Objective, make_objective
from ..diffusion.samplers import sample as run_sampler
from ..diffusion.schedules import make_schedule
from ..nn.autoencoder import Encoder1d
from ..nn.dsp import downsample, upsample
from ..nn.embeddings import sinusoidal_embedding
from ..nn.primitives import init_parameters
from ..nn.stft import STFT
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
                   method: Optional[Callable[..., torch.Tensor]] = None,
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
    ``generator`` too.  ``method``, when given, is the denoise evaluation
    instead of ``model.denoise``: called as ``method(model, x, sigmas,
    **net_kwargs)`` (an assembly's ``denoise_*``)."""
    device = next(model.parameters()).device
    if noise is None:
        if shape is None or generator is None:
            raise ValueError("sample_model1d needs noise, or a shape and a "
                             "generator to draw it from")
        noise = torch.randn(shape, generator=generator, device=device)
    sigmas = make_schedule(schedule, num_steps, sigma_min=sigma_min,
                           sigma_max=sigma_max, rho=schedule_rho)

    def denoise(x, s):
        if method is not None:
            return method(model, x, s, **net_kwargs)
        return model.denoise(x, s, generator, **net_kwargs)

    kwargs = dict(sampler_kwargs or {})
    if sampler != "v":
        kwargs.update(step_noise=None if step_noise is None
                      else step_noise.to(device), generator=generator)
    return run_sampler(denoise, noise.to(device), sigmas, num_steps,
                       sampler=sampler, clamp=clamp,
                       objective_alias=model.diffusion_type, **kwargs)


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _draw_noise(noise: Optional[torch.Tensor], shape, generator,
                device: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``noise`` on ``device``, or standard normal of ``shape`` drawn there
    from ``generator``."""
    if noise is not None:
        return noise.to(device)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


class DiffusionUpsampler1d(Model1d):
    """Super-resolution diffusion (reference `model.py:41-101`): the UNet is
    conditioned, as context channels, on x down- and re-upsampled by one of
    ``factor`` (drawn a row), and with ``factor_features`` on the factor's
    sinusoidal embedding (``context_features`` must then equal it)."""

    def __init__(self, *, factor: Sequence[int] = (2,),
                 factor_features: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.factor = tuple(factor)
        self.factor_features = factor_features

    def random_reupsample(self, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          index: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x re-upsampled by each row's factor, the rows' factor indices
        (b,), drawn from ``generator`` unless handed in)."""
        b = x.shape[0]
        if index is None:
            index = torch.randint(0, len(self.factor), (b,),
                                  generator=generator, device=x.device)
        index = index.to(x.device)
        versions = torch.stack([upsample(downsample(x, f), f)
                                for f in self.factor])     # (F, b, L, C)
        return versions[index, torch.arange(b, device=x.device)], index

    def factor_embedding(self, factors: torch.Tensor
                         ) -> Optional[torch.Tensor]:
        """The UNet's ``features`` for the rows' factors (b,), or None."""
        if self.factor_features is None:
            return None
        return sinusoidal_embedding(factors.float(), self.factor_features)

    def _factor_features(self, index: torch.Tensor) -> Optional[torch.Tensor]:
        table = torch.tensor(self.factor, dtype=torch.float32,
                             device=index.device)
        return self.factor_embedding(table[index])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                factor_index: Optional[torch.Tensor] = None,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        """Training loss: the factor index (b,), then the sigmas and the
        noise, each drawn from ``generator`` unless handed in."""
        channels, index = self.random_reupsample(x, generator, factor_index)
        net = self._net(generator, dict(
            net_kwargs, channels_list=[channels],
            features=self._factor_features(index)))
        return self.objective.loss_from_draws(
            net, x, self.sigma_distribution, generator, sigmas=sigmas,
            noise=noise)

    def denoise_upsample(self, x: torch.Tensor, sigmas: torch.Tensor,
                         channels: torch.Tensor,
                         features: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        return self.objective.denoise(
            lambda xn, t: self.unet(xn, t, channels_list=[channels],
                                    features=features), x, sigmas)


@torch.no_grad()
def sample_upsampler(model: DiffusionUpsampler1d, undersampled: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *,
                     factor: Optional[int] = None,
                     noise: Optional[torch.Tensor] = None,
                     **kwargs) -> torch.Tensor:
    """Upsample (b, L, C) by ``factor`` (the model's first by default;
    reference `model.py:84-101`): sample from ``noise`` (b, factor L, C),
    drawn from ``generator`` unless given, conditioned on the sinc-upsampled
    input.  ``kwargs`` go to ``sample_model1d``."""
    device = _model_device(model)
    factor = factor if factor is not None else model.factor[0]
    channels = upsample(undersampled.to(device), factor)
    features = model.factor_embedding(torch.full(
        (channels.shape[0],), factor, dtype=torch.float32, device=device))
    noise = _draw_noise(noise, channels.shape, generator, device,
                        channels.dtype)
    return sample_model1d(model, noise, generator,
                          method=DiffusionUpsampler1d.denoise_upsample,
                          channels=channels, features=features, **kwargs)


class DiffusionAE1d(Model1d):
    """Diffusion autoencoder (reference `model.py:104-136`): an
    ``Encoder1d`` latent of x enters the UNet as context channels at the
    layer where ``context_channels`` names its width."""

    def __init__(self, *, encoder_channels: int = 16,
                 encoder_patch_size: int = 1,
                 encoder_multipliers: Sequence[int] = (1, 2, 4),
                 encoder_factors: Sequence[int] = (2, 2),
                 encoder_num_blocks: Sequence[int] = (2, 2),
                 encoder_out_channels: Optional[int] = None,
                 encoder_inject_depth: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.encoder_inject_depth = encoder_inject_depth
        self.encoder = Encoder1d(
            in_channels=self.in_channels, channels=encoder_channels,
            multipliers=encoder_multipliers, factors=encoder_factors,
            num_blocks=encoder_num_blocks, patch_size=encoder_patch_size,
            out_channels=encoder_out_channels, dtype=self.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        latent = self.encoder(x)
        net = self._net(generator, dict(net_kwargs, channels_list=[latent]))
        return self.objective.loss_from_draws(
            net, x, self.sigma_distribution, generator, sigmas=sigmas,
            noise=noise)

    def encode(self, x: torch.Tensor, with_info: bool = False):
        return self.encoder(x, with_info=with_info)

    def denoise_latent(self, x: torch.Tensor, sigmas: torch.Tensor,
                       latent: torch.Tensor) -> torch.Tensor:
        return self.objective.denoise(
            lambda xn, t: self.unet(xn, t, channels_list=[latent]), x,
            sigmas)


@torch.no_grad()
def decode_ae(model: DiffusionAE1d, latent: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              downsample_factor: int, noise: Optional[torch.Tensor] = None,
              **kwargs) -> torch.Tensor:
    """Decode a latent (b, l, C_latent) by sampling conditioned on it
    (reference `model.py:128-136`): the output has the power of two nearest
    ``l * downsample_factor`` samples; ``noise`` of that shape is drawn
    from ``generator`` unless given."""
    device = _model_device(model)
    latent = latent.to(device)
    length = closest_power_2(latent.shape[1] * downsample_factor)
    noise = _draw_noise(noise, (latent.shape[0], length, model.in_channels),
                        generator, device)
    return sample_model1d(model, noise, generator,
                          method=DiffusionAE1d.denoise_latent, latent=latent,
                          **kwargs)


def _spectrogram_1d(spec: torch.Tensor) -> torch.Tensor:
    """(b, C, F, T) -> (b, T, C F)."""
    b, c, f, t = spec.shape
    return spec.reshape(b, c * f, t).transpose(1, 2)


class DiffusionVocoder1d(Model1d):
    """Phase diffusion conditioned on the STFT magnitude (reference
    `model.py:139-176`): spectrograms (b, C, F, T) are laid out as
    sequences (b, T, C F); the target is the phase over pi."""

    def __init__(self, *, stft_num_fft: int = 1023,
                 stft_hop_length: int = 256, **kwargs):
        super().__init__(**kwargs)
        self.stft = STFT(num_fft=stft_num_fft, hop_length=stft_hop_length)

    def forward(self, magnitude: torch.Tensor, phase: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        net = self._net(generator, dict(
            net_kwargs, channels_list=[_spectrogram_1d(magnitude)]))
        return self.objective.loss_from_draws(
            net, _spectrogram_1d(phase) / math.pi, self.sigma_distribution,
            generator, sigmas=sigmas, noise=noise)

    def loss_from_wave(self, x: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       **kwargs) -> torch.Tensor:
        """The loss of a wave (b, L, C) through its STFT."""
        magnitude, phase = self.stft.encode(x)
        return self(magnitude, phase, generator, **kwargs)

    def denoise_vocoder(self, x: torch.Tensor, sigmas: torch.Tensor,
                        magnitude_flat: torch.Tensor) -> torch.Tensor:
        return self.objective.denoise(
            lambda xn, t: self.unet(xn, t, channels_list=[magnitude_flat]),
            x, sigmas)


@torch.no_grad()
def sample_vocoder(model: DiffusionVocoder1d, magnitude: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   **kwargs) -> torch.Tensor:
    """Magnitude (b, C, F, T) -> wave (b, L, C) (reference
    `model.py:168-176`): the phase sampled from ``noise`` (b, T, C F),
    drawn from ``generator`` unless given, then the inverse STFT."""
    device = _model_device(model)
    magnitude = magnitude.to(device)
    b, c, f, t = magnitude.shape
    mag_flat = _spectrogram_1d(magnitude)
    noise = _draw_noise(noise, mag_flat.shape, generator, device)
    phase_flat = sample_model1d(model, noise, generator,
                                method=DiffusionVocoder1d.denoise_vocoder,
                                magnitude_flat=mag_flat, **kwargs)
    phase = phase_flat.transpose(1, 2).reshape(b, c, f, t)
    return model.stft.decode(magnitude, phase * math.pi)


class DiffusionUpphaser1d(DiffusionUpsampler1d):
    """The upsampler trained on x with a random STFT phase (reference
    `model.py:179-195`); sampled with ``sample_upsampler``."""

    def __init__(self, *, stft_num_fft: int = 1023,
                 stft_hop_length: int = 256, **kwargs):
        super().__init__(**kwargs)
        self.stft = STFT(num_fft=stft_num_fft, hop_length=stft_hop_length)

    def random_rephase(self, x: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       phase: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (b, L, C) with its STFT magnitude kept and its phase replaced
        by ``phase`` (b, C, F, T), uniform in [-pi, pi) drawn from
        ``generator`` unless handed in."""
        stft = STFT(num_fft=self.stft.num_fft,
                    hop_length=self.stft.hop_length, length=x.shape[1])
        magnitude, like = stft.encode(x)
        if phase is None:
            phase = (torch.rand(like.shape, generator=generator,
                                device=x.device) - 0.5) * 2 * math.pi
        return stft.decode(magnitude, phase.to(x.device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                phase: Optional[torch.Tensor] = None,
                factor_index: Optional[torch.Tensor] = None,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        """Training loss: the random phase, the factor index, then the
        sigmas and the noise, each drawn from ``generator`` unless handed
        in."""
        rephased = self.random_rephase(x, generator, phase)
        resampled, index = self.random_reupsample(rephased, generator,
                                                  factor_index)
        net = self._net(generator, dict(
            net_kwargs, channels_list=[resampled],
            features=self._factor_features(index)))
        return self.objective.loss_from_draws(
            net, x, self.sigma_distribution, generator, sigmas=sigmas,
            noise=noise)


class DiffusionAR1d(Model1d):
    """Chunked autoregressive diffusion (reference `model.py:198-294`):
    trained on a random pair of consecutive chunks, the earlier one (set to
    zero with probability ``dropout`` a row) the context of the later;
    sampled chunk by chunk.  With ``upsample_factor`` the context also
    holds the chunk down- and re-upsampled."""

    def __init__(self, *, chunk_length: int = 16, upsample_factor: int = 0,
                 dropout: float = 0.05, **kwargs):
        super().__init__(**kwargs)
        self.chunk_length, self.upsample_factor = chunk_length, upsample_factor
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                chunk_index: Optional[Union[int, torch.Tensor]] = None,
                dropped: Optional[torch.Tensor] = None,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                **net_kwargs) -> torch.Tensor:
        """Training loss: the chunk index (a scalar in [0, chunks - 1)),
        the dropped rows (b,) bool, then the sigmas and the noise, each
        drawn from ``generator`` unless handed in.  The chunks are gathered
        on the device: no draw is read back to the host."""
        b, t, c = x.shape
        cl = self.chunk_length
        num_chunks = t // cl
        assert num_chunks >= 2, "Input length must be >= chunk_length * 2"
        if chunk_index is None:
            chunk_index = torch.randint(0, num_chunks - 1, (),
                                        generator=generator, device=x.device)
        rows = (torch.as_tensor(chunk_index, device=x.device) * cl
                + torch.arange(cl, device=x.device))
        chunk_prev = x.index_select(1, rows)
        chunk_curr = x.index_select(1, rows + cl)
        if self.dropout > 0:
            if dropped is None:
                dropped = torch.rand(b, generator=generator,
                                     device=x.device) < self.dropout
            chunk_prev = torch.where(dropped.to(x.device).reshape(b, 1, 1),
                                     torch.zeros_like(chunk_prev), chunk_prev)
        channels = chunk_prev
        if self.upsample_factor > 0:
            f = self.upsample_factor
            channels = torch.cat(
                [chunk_prev, upsample(downsample(chunk_curr, f), f)], dim=-1)
        net = self._net(generator, dict(net_kwargs, channels_list=[channels]))
        return self.objective.loss_from_draws(
            net, chunk_curr, self.sigma_distribution, generator,
            sigmas=sigmas, noise=noise)

    def denoise_chunk(self, x: torch.Tensor, sigmas: torch.Tensor,
                      channels: torch.Tensor) -> torch.Tensor:
        return self.objective.denoise(
            lambda xn, t: self.unet(xn, t, channels_list=[channels]), x,
            sigmas)


@torch.no_grad()
def sample_ar(model: DiffusionAR1d, x: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              start: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              **kwargs) -> torch.Tensor:
    """Sample chunk by chunk (reference `model.py:252-294`), each chunk's
    context the chunk before (``start``'s last chunk, or zeros, for the
    first).  ``x`` is the noise (b, T, C), T a multiple of the chunk; with
    ``upsample_factor`` it is the undersampled audio instead, and the noise
    (b, factor T, C) is ``noise`` or drawn from ``generator``.  ``kwargs``
    go to each chunk's ``sample_model1d``."""
    device = _model_device(model)
    x = x.to(device)
    upsampled = None
    if model.upsample_factor > 0:
        upsampled = upsample(x, model.upsample_factor)
        x = _draw_noise(noise, upsampled.shape, generator, device,
                        upsampled.dtype)
    b, t, c = x.shape
    cl = model.chunk_length
    assert t % cl == 0, "noise length must be divisible by chunk_length"
    chunk_prev = (start[:, -cl:].to(device) if start is not None
                  else torch.zeros((b, cl, c), dtype=x.dtype, device=device))
    chunks: List[torch.Tensor] = []
    for i in range(t // cl):
        channels = chunk_prev
        if upsampled is not None:
            channels = torch.cat(
                [chunk_prev, upsampled[:, cl * i: cl * (i + 1)]], dim=-1)
        chunk_prev = sample_model1d(model, x[:, cl * i: cl * (i + 1)],
                                    generator,
                                    method=DiffusionAR1d.denoise_chunk,
                                    channels=channels, **kwargs)
        chunks.append(chunk_prev)
    return torch.cat(chunks, dim=1)


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
                  cls: type = Model1d, **kwargs) -> Model1d:
    """A ``Model1d`` (or the assembly ``cls``, e.g. ``DiffusionAR1d``) on
    ``device`` -- the card ("cuda") unless the caller names another, so a
    CPU run asks for ``device="cpu"`` -- its parameters drawn from
    ``generator`` (a CPU generator; torch's global RNG when None)."""
    model = cls(**kwargs)
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


def AudioDiffusionUpsampler(in_channels: int, device: Optional[Device] = None,
                            generator: Optional[torch.Generator] = None,
                            **kwargs) -> DiffusionUpsampler1d:
    """The upsampler preset: the waveform widths, x's channels as context
    (reference `model.py:322-333`)."""
    defaults = dict(get_default_model_kwargs(), in_channels=in_channels,
                    context_channels=(in_channels,))
    return build_model1d(device, generator, DiffusionUpsampler1d,
                         **{**defaults, **kwargs})


def AudioDiffusionAE(in_channels: int, device: Optional[Device] = None,
                     generator: Optional[torch.Generator] = None,
                     **kwargs) -> DiffusionAE1d:
    """The diffusion-autoencoder preset (reference `model.py:336-350`): a
    patch-16 encoder down by 8,192 to 64 channels, injected at the UNet's
    deepest layer."""
    defaults = dict(
        get_default_model_kwargs(), in_channels=in_channels,
        encoder_channels=16, encoder_patch_size=16,
        encoder_multipliers=(2, 2, 4, 4, 4, 4, 4),
        encoder_factors=(4, 4, 4, 2, 2, 2),
        encoder_num_blocks=(2, 2, 2, 2, 2, 2), encoder_out_channels=64,
        encoder_inject_depth=6,
        context_channels=tuple([0] * 6 + [64]))
    return build_model1d(device, generator, DiffusionAE1d,
                         **{**defaults, **kwargs})


def AudioDiffusionVocoder(in_channels: int, device: Optional[Device] = None,
                          generator: Optional[torch.Generator] = None,
                          **kwargs) -> DiffusionVocoder1d:
    """The vocoder preset (reference `model.py:353-362`): 512 frequency
    bins a channel (n_fft 1,023, hop 256) at 512 UNet channels."""
    freq = 1023 // 2 + 1
    defaults = dict(
        in_channels=in_channels * freq,
        context_channels=(in_channels * freq,),
        stft_num_fft=1023, stft_hop_length=256, channels=512,
        multipliers=(3, 2, 1, 1, 1, 1, 1, 1), factors=(1, 2, 2, 2, 2, 2, 2),
        num_blocks=(1, 1, 1, 1, 1, 1, 1), attentions=(0, 0, 0, 0, 1, 1, 1),
        attention_heads=8, attention_features=64, attention_multiplier=2,
        diffusion_type="v",
        diffusion_sigma_distribution=UniformDistribution())
    return build_model1d(device, generator, DiffusionVocoder1d,
                         **{**defaults, **kwargs})


def AudioDiffusionUpphaser(in_channels: int, device: Optional[Device] = None,
                           generator: Optional[torch.Generator] = None,
                           **kwargs) -> DiffusionUpphaser1d:
    """The upphaser preset: the upsampler's at factor 1 (reference
    `model.py:386-392`)."""
    defaults = dict(get_default_model_kwargs(), in_channels=in_channels,
                    context_channels=(in_channels,), factor=(1,))
    return build_model1d(device, generator, DiffusionUpphaser1d,
                         **{**defaults, **kwargs})
