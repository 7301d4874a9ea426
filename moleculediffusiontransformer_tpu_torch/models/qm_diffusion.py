"""The QM9 diffusion models (port of `models/qm_diffusion.py`).

``QMDiffusion`` (inverse design): a property vector (b, 12) conditions a
diffusion over one-hot SMILES tracks (b, L, vocab).
``QMDiffusionForward`` (property prediction): tokenized SMILES, token ids
divided by the vocabulary size (b, 64), condition a diffusion over a
property track (b, 64, 1), whose first 12 positions are the properties.
In both, a conditioning head (per-scalar Linear(1, d) + GELU, concatenated
with a Fourier position code) feeds a CFG UNet through the K-diffusion
objective (sigma_data 0.1).  ``sample`` is the
serving path: ADPM2 (rho 1) over a Karras (1e-3, 9.0, rho 3) schedule with
batched classifier-free guidance — two doubled-batch UNet evaluations per
step; ``inpaint`` runs the same steps under a keep-mask, each step
``num_resamples`` times.  Calling the model is the training path: the
K-diffusion loss at LogNormal(-1.2, 1.2) noise levels, one UNet pass at
embedding scale 1.

Parameter names (``fc1``, ``unet.*``) are the reference's, so the JAX
package's params (``nn.jax_import.state_dict_from_jax_params``) and
reference checkpoints load with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..diffusion.distributions import LogNormalDistribution
from ..diffusion.objectives import KDiffusion
from ..diffusion.samplers import inpaint_adpm2
from ..diffusion.samplers import sample as run_sampler
from ..diffusion.schedules import karras_schedule
from ..nn.embeddings import positional_encoding_1d
from ..nn.primitives import Dense, gelu, init_parameters
from ..nn.unet import XUNet1d


class QMDiffusionBase(nn.Module):
    """Shared assembly of the QM diffusion models."""

    def __init__(self, max_length: int = 1024, channels: int = 128,
                 pred_dim: int = 1, unet_type: str = "cfg",
                 pos_emb_fourier: bool = True,
                 pos_emb_fourier_add: bool = False,
                 text_embed_dim: int = 1024, embed_dim_position: int = 64,
                 context_embedding_max_length: int = 32,
                 patch_size: int = 4,
                 multipliers: Sequence[int] = (1, 2, 4),
                 factors: Sequence[int] = (4, 4),
                 num_blocks: Sequence[int] = (3, 3),
                 attentions: Sequence[int] = (2, 2),
                 attention_heads: int = 8, attention_features: int = 64,
                 attention_multiplier: int = 2, pre_transformer: int = 0,
                 sigma_data: float = 0.1, sigma_mean: float = -1.2,
                 sigma_std: float = 1.2, dynamic_threshold: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_length, self.pred_dim = max_length, pred_dim
        self.unet_type, self.dtype = unet_type, dtype
        self.pos_emb_fourier = pos_emb_fourier
        self.pos_emb_fourier_add = pos_emb_fourier_add
        self.embed_dim_position = embed_dim_position
        self.context_embedding_max_length = context_embedding_max_length
        self.objective = KDiffusion(sigma_data=sigma_data,
                                    dynamic_threshold=dynamic_threshold)
        self.sigma_distribution = LogNormalDistribution(sigma_mean, sigma_std)
        if pos_emb_fourier and not pos_emb_fourier_add:
            conditioning_features = text_embed_dim + embed_dim_position
        else:
            conditioning_features = text_embed_dim
        self.fc1 = Dense(1, text_embed_dim, dtype=dtype)
        kwargs = dict(in_channels=pred_dim, channels=channels,
                      patch_size=patch_size, multipliers=tuple(multipliers),
                      factors=tuple(factors), num_blocks=tuple(num_blocks),
                      attentions=tuple(attentions),
                      attention_heads=attention_heads,
                      attention_features=attention_features,
                      attention_multiplier=attention_multiplier,
                      pre_transformer=pre_transformer, dtype=dtype)
        if unet_type == "cfg":
            kwargs.update(
                context_embedding_features=conditioning_features,
                context_embedding_max_length=context_embedding_max_length)
        self.unet = XUNet1d(type=unet_type, **kwargs)

    def embed_conditioning(self, sequences: torch.Tensor) -> torch.Tensor:
        """(b, n) conditioning scalars -> (b, n, features): per-scalar
        Linear(1, d) + GELU, concatenated with (or added to) a Fourier
        position code."""
        x = gelu(self.fc1(sequences.float()[..., None]))
        if self.pos_emb_fourier:
            pe = positional_encoding_1d(x.shape[1], self.embed_dim_position,
                                        dtype=x.dtype, device=x.device)
            pe = pe[None].expand(x.shape[0], -1, -1)
            x = x + pe if self.pos_emb_fourier_add else torch.cat(
                [x, pe], dim=-1)
        return x

    def diffusion_target(self, output: torch.Tensor) -> torch.Tensor:
        """What the loss of ``output`` diffuses, and what its noise is
        shaped like."""
        return output

    def forward(self, sequences: torch.Tensor, output: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training loss (float32 scalar).  ``sequences`` (b, n)
        conditioning scalars, ``output`` (b, L, pred_dim) channels-last
        diffusion target.  The sigmas (b,) and noise (like ``output``) are
        drawn from ``generator`` on the target's device unless handed in.

        As in the reference, QM models train with no CFG dropout
        (embedding_mask_proba 0): one UNet pass at embedding scale 1."""
        emb = self.embed_conditioning(sequences)
        if self.unet_type == "cfg":
            def net(xn, t):
                return self.unet(xn, t, embedding=emb)
        else:
            def net(xn, t):
                return self.unet(xn, t)
        return self.objective.loss_from_draws(
            net, output.float(), self.sigma_distribution, generator,
            sigmas=sigmas, noise=noise)

    def denoise(self, x: torch.Tensor, sigmas: torch.Tensor,
                embedding: Optional[torch.Tensor],
                cond_scale: float = 1.0) -> torch.Tensor:
        """One preconditioned denoise evaluation — the sampler's closure."""
        if self.unet_type == "cfg":
            def net(xn, t):
                return self.unet(xn, t, embedding=embedding,
                                 embedding_scale=cond_scale)
        else:
            def net(xn, t):
                return self.unet(xn, t)
        return self.objective.denoise(net, x, sigmas)


class QMDiffusion(QMDiffusionBase):
    """Inverse generative model: 12 properties -> one-hot SMILES (notebook
    preset pred_dim 22, channels 128, max_length 32, pre_transformer 2,
    patch_size 1, attentions (4, 4): 90,965,554 parameters)."""

    def __init__(self, *, patch_size: int = 1, pre_transformer: int = 2,
                 attentions: Sequence[int] = (4, 4), **kwargs):
        super().__init__(patch_size=patch_size,
                         pre_transformer=pre_transformer,
                         attentions=attentions, **kwargs)


class QMDiffusionForward(QMDiffusionBase):
    """Forward model: tokenized SMILES -> property track (notebook preset
    pred_dim 1, channels 64, max_length 64, patch_size 4, attentions (2, 2),
    context 64 tokens: 18,322,684 parameters)."""

    def __init__(self, *, patch_size: int = 4, pre_transformer: int = 0,
                 attentions: Sequence[int] = (2, 2), **kwargs):
        super().__init__(patch_size=patch_size,
                         pre_transformer=pre_transformer,
                         attentions=attentions, **kwargs)


def from_config(cls, config: Any, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None,
                generator: Optional[torch.Generator] = None
                ) -> QMDiffusionBase:
    """Build a QM model from a ``QMDiffusionConfig`` preset (the JAX
    package's framework-neutral ``core/config.py``, e.g.
    ``inverse_diffusion_qm9(22)`` or ``forward_diffusion_qm9()``; read by
    attribute, so the port does not import that package) on ``device`` --
    the card ("cuda") unless the caller names another, so without a card
    the default raises and a CPU run asks for ``device="cpu"`` -- its
    parameters drawn from ``generator`` (a CPU generator; torch's global RNG
    when None)."""
    model = cls(
        max_length=config.max_length, channels=config.channels,
        pred_dim=config.pred_dim, unet_type=config.unet_type,
        pos_emb_fourier=config.pos_emb_fourier,
        pos_emb_fourier_add=config.pos_emb_fourier_add,
        text_embed_dim=config.text_embed_dim,
        embed_dim_position=config.embed_dim_position,
        context_embedding_max_length=config.context_embedding_max_length,
        patch_size=config.patch_size, num_blocks=config.num_blocks,
        attentions=config.attentions, pre_transformer=config.pre_transformer,
        sigma_data=config.diffusion.sigma_data,
        sigma_mean=config.diffusion.sigma_mean,
        sigma_std=config.diffusion.sigma_std,
        dynamic_threshold=config.diffusion.dynamic_threshold, dtype=dtype)
    if generator is not None:
        init_parameters(model, generator)
    return model.to("cuda" if device is None else device)


@torch.no_grad()
def sample(model: QMDiffusionBase, sequences: torch.Tensor,
           generator: Optional[torch.Generator] = None, *,
           num_steps: int = 100, cond_scale: float = 1.0, clamp: bool = False,
           sigma_min: float = 1e-3, sigma_max: float = 9.0, rho: float = 3.0,
           noise: Optional[torch.Tensor] = None,
           step_noise: Optional[torch.Tensor] = None,
           rows: Optional[slice] = None) -> torch.Tensor:
    """ADPM2 (rho 1) sampling over a Karras(sigma_min, sigma_max, rho)
    schedule — the serving path.  ``sequences`` (b, 12) on the model's
    device; returns (b, max_length, pred_dim) float32, channels-last.

    The initial ``noise`` (b, max_length, pred_dim) and the per-step
    ``step_noise`` (num_steps - 1, b, max_length, pred_dim) are drawn from
    ``generator`` (on the model's device) unless given.  ``rows``: sample
    only those rows of the batch, on the whole batch's draws (a rank's
    share of a request over a data mesh): the same rows as the whole call
    gives, up to the order of the sums."""
    device = sequences.device
    shape = (sequences.shape[0], model.max_length, model.pred_dim)
    if noise is None:
        if generator is None:
            raise ValueError("sample needs a generator or explicit noise")
        noise = torch.randn(shape, generator=generator, device=device)
    if rows is not None:
        if step_noise is None:      # drawn as the sampler draws each step's
            step_noise = torch.stack([
                torch.randn(shape, generator=generator, device=device)
                for _ in range(num_steps - 1)] or [noise[:0]])
        sequences, noise, step_noise = (sequences[rows], noise[rows],
                                        step_noise[:, rows])
    emb = model.embed_conditioning(sequences)
    sigmas = karras_schedule(num_steps, sigma_min, sigma_max, rho)

    def denoise(x, s):
        return model.denoise(x, s, emb, cond_scale)

    return run_sampler(denoise, noise.float(), sigmas, num_steps,
                       sampler="adpm2", clamp=clamp, objective_alias="k",
                       step_noise=step_noise, generator=generator, rho=1.0)


@torch.no_grad()
def inpaint(model: QMDiffusionBase, sequences: torch.Tensor,
            source: torch.Tensor, mask: torch.Tensor,
            generator: Optional[torch.Generator] = None, *,
            num_steps: int = 100, num_resamples: int = 1,
            cond_scale: float = 7.5, sigma_min: float = 1e-3,
            sigma_max: float = 9.0, rho: float = 3.0,
            noise: Optional[torch.Tensor] = None,
            source_noise: Optional[torch.Tensor] = None,
            step_noise: Optional[torch.Tensor] = None,
            renoise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RePaint-style masked inpainting under property conditioning:
    ``source`` and ``mask`` (b, max_length, pred_dim) channels-last on the
    model's device, mask True = keep from ``source``.  ADPM2 (rho 1) over
    the Karras(sigma_min, sigma_max, rho) schedule, each step
    ``num_resamples`` times (``diffusion.samplers.inpaint_adpm2``, whose
    draws ``noise``, ``source_noise``, ``step_noise`` and ``renoise`` are
    taken as given or drawn from ``generator``).  Returns float32."""
    emb = model.embed_conditioning(sequences)
    sigmas = karras_schedule(num_steps, sigma_min, sigma_max, rho)

    def denoise(x, s):
        return model.denoise(x, s, emb, cond_scale)

    return inpaint_adpm2(denoise, source.float(), mask, sigmas, num_steps,
                         num_resamples, noise=noise, source_noise=source_noise,
                         step_noise=step_noise, renoise=renoise,
                         generator=generator, rho=1.0)
