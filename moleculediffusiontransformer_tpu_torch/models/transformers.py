"""The paper's inverse autoregressive transformer (port of
`models/transformers.py`: ``cross_entropy_mean``, the decoder base,
``MoleculeTransformerSequence``, ``generate_sequence`` and
``forward_with_cond_scale``).

``MoleculeTransformerSequence`` is a token AR decoder with property
cross-attention, trained with cross entropy and conditioning dropout.
``generate_sequence`` decodes position by position against fixed-size KV
caches with batched classifier-free guidance: the conditioned and the null
half run as one doubled batch.  No hand-written kernel lies on this path in
either package: its attention is plain multi-query math at n = 1 and at most
65 keys of 16 features.

Module and parameter names are the reference torch keys (``layers.0.0`` self
attention, ``layers.0.1`` cross attention, ``layers.0.2`` the feed-forward
Sequential), so ``nn.jax_import.state_dict_from_jax_params`` loads the JAX
package's parameters with ``strict=True``.

The other decoders (Internaldim, the continuous ``MoleculeTransformer``, the
encoder, the GPT models) are not ported yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.embeddings import positional_encoding_1d
from ..nn.primitives import Dense, Embed, gelu, init_parameters
from ..nn.transformer_blocks import (LNGamma, MQAttention, gumbel_sample,
                                     prob_mask_like, top_k_filter)

Uniforms = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: Optional[int] = None) -> torch.Tensor:
    """``F.cross_entropy`` with mean reduction over (b, n, vocab) logits, in
    float32; with ``ignore_index`` the mean is over the labels that are
    kept (at least 1)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if ignore_index is None:
        return nll.mean()
    keep = labels != ignore_index
    return (nll * keep).sum() / keep.sum().clamp(min=1)


class _GELU(nn.Module):
    """The exact (erf) GELU as a module, for the feed-forward Sequential."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class _DecoderBase(nn.Module):
    """The layers, the conditioning head and the cached decode shared by the
    AR decoders.  Subclasses add ``fc1``, ``init_norm``, ``final_norm``,
    ``to_logits`` and their token embedding."""

    def __init__(self, dim: int = 128, depth: int = 12, logits_dim: int = 32,
                 dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 text_embed_dim: Optional[int] = None,
                 cond_drop_prob: float = 0.25, max_text_len: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.depth, self.logits_dim = dim, depth, logits_dim
        self.dim_head, self.heads, self.ff_mult = dim_head, heads, ff_mult
        self.text_embed_dim = text_embed_dim
        self.cond_drop_prob, self.max_text_len = cond_drop_prob, max_text_len
        self.dtype = dtype

    def _make_layers(self) -> None:
        kw = dict(dim_head=self.dim_head, heads=self.heads, dtype=self.dtype)
        hidden = int(self.dim * self.ff_mult)
        self.layers = nn.ModuleList([nn.ModuleList([
            MQAttention(self.dim, causal=True, **kw),
            MQAttention(self.dim, context_dim=self.text_embed_dim, **kw),
            # parti's FeedForward: LN -> Linear -> GELU -> LN -> Linear
            nn.Sequential(
                LNGamma(self.dim, dtype=self.dtype),
                Dense(self.dim, hidden, bias=False, dtype=self.dtype),
                _GELU(), LNGamma(hidden, dtype=self.dtype),
                Dense(hidden, self.dim, bias=False, dtype=self.dtype)),
        ]) for _ in range(self.depth)])

    def embed_conditioning(self, sequences: torch.Tensor) -> torch.Tensor:
        """fc1 + GELU + the additive Fourier position code: (b, m) property
        values -> (b, m, text_embed_dim)."""
        x = gelu(self.fc1(sequences.float()[..., None]))
        pe = positional_encoding_1d(x.shape[1], self.text_embed_dim,
                                    dtype=x.dtype, device=x.device)
        return x + pe[None]

    def _text_mask(self, cond: torch.Tensor,
                   text_mask: Optional[torch.Tensor], cond_drop_prob: float,
                   generator: Optional[torch.Generator],
                   keep: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clip the conditioning to ``max_text_len`` and drop it for the rows
        whose ``keep`` is False: ``keep`` (b,) is handed in, or drawn from
        ``generator`` with probability 1 - ``cond_drop_prob``."""
        b = cond.shape[0]
        if text_mask is None:
            text_mask = torch.ones(cond.shape[:2], dtype=torch.bool,
                                   device=cond.device)
        cond = cond[:, :self.max_text_len]
        text_mask = text_mask[:, :self.max_text_len]
        if cond_drop_prob > 0:
            if keep is None:
                if generator is None and cond_drop_prob < 1:
                    raise ValueError("cond_drop_prob > 0 needs a generator "
                                     "or a keep mask")
                keep = prob_mask_like((b,), 1 - cond_drop_prob,
                                      generator=generator,
                                      device=cond.device)
            text_mask = keep.to(cond.device)[:, None] & text_mask
        return cond, text_mask

    def _trunk(self, x: torch.Tensor, cond: torch.Tensor,
               text_mask: torch.Tensor) -> torch.Tensor:
        x = self.init_norm(x)
        for attn, cross, ff in self.layers:
            x = attn(x) + x
            x = cross(x, context=cond, context_mask=text_mask) + x
            x = ff(x) + x
        return self.to_logits(self.final_norm(x))

    # ---- cached decode ----------------------------------------------------

    def cross_kv(self, cond: torch.Tensor) -> List[torch.Tensor]:
        """Every layer's cross-attention KV, computed once a generation."""
        return [cross.kv(cond) for _, cross, _ in self.layers]

    def init_cache(self, batch: int, total_len: int,
                   device=None) -> List[torch.Tensor]:
        device = self.to_logits.weight.device if device is None else device
        return [torch.zeros(batch, total_len, self.dim_head,
                            dtype=self.dtype, device=device)
                for _ in range(self.depth)]

    def decode_step(self, x_t: torch.Tensor, pos: int,
                    cross_kvs: List[torch.Tensor],
                    caches: List[torch.Tensor], text_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One position through all layers against the KV caches, which are
        written in place.  ``x_t`` (b, 1, dim) is already embedded and
        positioned.  Returns ((b, logits_dim) logits, the caches)."""
        x = self.init_norm(x_t)
        for (attn, cross, ff), cross_kv, cache in zip(self.layers, cross_kvs,
                                                      caches):
            x = attn.step(x, cache, pos)[0] + x
            x = cross.cross_step(x, cross_kv, text_mask) + x
            x = ff(x) + x
        return self.to_logits(self.final_norm(x))[:, 0], caches


class MoleculeTransformerSequence(_DecoderBase):
    """Token-id AR decoder with property cross-attention: the paper's inverse
    transformer.  ``device=None`` builds on the card (and raises where there
    is none); a CPU run asks for ``device="cpu"``.  ``generator`` seeds the
    weights."""

    def __init__(self, *, device=None,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(**kw)
        self.fc1 = Dense(1, self.text_embed_dim, dtype=self.dtype)
        self.start_token = nn.Parameter(torch.empty(self.dim))
        self.init_norm = LNGamma(self.dim, dtype=self.dtype)
        self._make_layers()
        self.final_norm = LNGamma(self.dim, dtype=self.dtype)
        self.to_logits = Dense(self.dim, self.logits_dim, bias=False,
                               dtype=self.dtype)
        self.token_embed = Embed(self.logits_dim, self.dim, dtype=self.dtype)
        with torch.no_grad():
            self.start_token.normal_(0.0, 1.0, generator=generator)
        if generator is not None:
            init_parameters(self, generator)
        self.to("cuda" if device is None else device)

    def embed_tokens(self, output_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embed(output_ids)
        pe = positional_encoding_1d(x.shape[1], self.dim, dtype=x.dtype,
                                    device=x.device)
        return x + pe[None]

    def forward(self, sequences: torch.Tensor, output_ids: torch.Tensor, *,
                text_mask: Optional[torch.Tensor] = None,
                cond_drop_prob: Optional[float] = None,
                return_loss: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sequences (b, m) property values, output_ids (b, n) token ids ->
        (b, n, logits_dim) logits, or with ``return_loss`` the next-token
        cross entropy.  The conditioning is dropped for a row with
        probability ``cond_drop_prob`` (the model's own unless given): the
        keep mask (b,) is drawn from ``generator`` or handed in."""
        cond_drop_prob = (self.cond_drop_prob if cond_drop_prob is None
                          else cond_drop_prob)
        cond = self.embed_conditioning(sequences)
        x = self.embed_tokens(output_ids)
        cond, text_mask = self._text_mask(cond, text_mask, cond_drop_prob,
                                          generator, keep)
        logits = self._trunk(x, cond, text_mask)
        if not return_loss:
            return logits
        return cross_entropy_mean(logits[:, :-1], output_ids[:, 1:])


# ------------------------------------------------------------- generation --

@torch.no_grad()
def generate_sequence(model: MoleculeTransformerSequence,
                      sequences: torch.Tensor,
                      start_ids: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, *,
                      uniforms: Optional[Uniforms] = None,
                      tokens_to_generate: int = 32, cond_scale: float = 3.0,
                      filter_thres: float = 0.9, temperature: float = 1.0,
                      return_logits: bool = False):
    """KV-cached autoregressive generation with batched CFG.  sequences
    (b, m) property values; start_ids (b, T0) the prompt, or ``None`` for one
    uniformly drawn start token a row (from ``generator``).  Returns token
    ids (b, T0 + tokens_to_generate) on the model's device.

    Per position: the logits of the conditioned and the null half of one
    doubled batch are blended ``null + (cond - null) * cond_scale``, filtered
    to the top ``1 - filter_thres`` of the vocabulary and sampled by
    Gumbel-max; a position inside the prompt keeps its token.  The uniforms
    of each step, (b, logits_dim), come from ``generator``, or from
    ``uniforms``: a (total - 1, b, logits_dim) tensor or a callable of the
    step.  With ``return_logits`` the blended logits of every step,
    (total - 1, b, logits_dim) float32, are returned beside the ids."""
    device = model.to_logits.weight.device
    b = sequences.shape[0]
    if start_ids is None:
        start_ids = torch.randint(
            0, model.logits_dim, (b, 1), generator=generator,
            device=device if generator is None else generator.device)
    start_ids = start_ids.to(device)
    t0 = start_ids.shape[1]
    total = t0 + tokens_to_generate

    cond = model.embed_conditioning(sequences.to(device))
    cond = cond[:, :model.max_text_len]
    n_ctx = cond.shape[1]
    # conditioned half: every context position kept; null half: none
    text_mask2 = torch.cat([
        torch.ones(b, n_ctx, dtype=torch.bool, device=device),
        torch.zeros(b, n_ctx, dtype=torch.bool, device=device)])
    cross_kvs = model.cross_kv(torch.cat([cond, cond]))
    caches = model.init_cache(2 * b, total, device)

    ids = torch.zeros(b, total, dtype=start_ids.dtype, device=device)
    ids[:, :t0] = start_ids
    # float32, as in the JAX package: the sum with the embedding is rounded
    # only by the first norm
    pe = positional_encoding_1d(total, model.dim, device=device)
    table = model.token_embed.weight.to(model.dtype)
    kept = [] if return_logits else None
    for pos in range(total - 1):
        token = ids[:, pos]
        x_t = (table[token] + pe[pos])[:, None]
        logits2, caches = model.decode_step(
            torch.cat([x_t, x_t]), pos, cross_kvs, caches, text_mask2)
        logits_c, logits_n = logits2[:b], logits2[b:]
        logits = (logits_n + (logits_c - logits_n) * cond_scale).float()
        if kept is not None:
            kept.append(logits)
        if pos + 1 < t0:        # inside the prompt: the token stays
            continue
        if uniforms is None:
            u = None
        elif callable(uniforms):
            u = uniforms(pos)
        else:
            u = uniforms[pos]
        ids[:, pos + 1] = gumbel_sample(
            top_k_filter(logits, filter_thres), temperature,
            generator=generator, uniforms=u).to(ids.dtype)
    if return_logits:
        return ids, torch.stack(kept)
    return ids


def forward_with_cond_scale(model: MoleculeTransformerSequence,
                            sequences: torch.Tensor, output: torch.Tensor, *,
                            cond_scale: float = 3.0, **kwargs
                            ) -> torch.Tensor:
    """Uncached CFG logits: ``null + (cond - null) * cond_scale``, the null
    pass with every context position masked.  For scoring and for checks of
    the cached path; generation uses ``generate_sequence``."""
    logits = model(sequences, output, cond_drop_prob=0.0, **kwargs)
    if cond_scale == 1:
        return logits
    b = sequences.shape[0]
    null_mask = torch.zeros(b, min(sequences.shape[1], model.max_text_len),
                            dtype=torch.bool, device=logits.device)
    null_logits = model(sequences, output, cond_drop_prob=0.0,
                        text_mask=null_mask, **kwargs)
    return null_logits + (logits - null_logits) * cond_scale
