"""The transformer model zoo (port of `models/transformers.py`): the
paper's inverse autoregressive transformer, its Internaldim variant, the
continuous-vector decoder, the forward property transformer and the GPT
family, with their cached generators.

* ``MoleculeTransformerSequence``: token AR decoder + property
  cross-attention (``generate_sequence``);
* ``MoleculeTransformerSequenceInternaldim``: the same with a separate token
  embedding width and ``AttentionQKV`` (``generate_sequence``);
* ``MoleculeTransformer``: AR decoder over continuous vectors, MSE loss
  (``generate_vectors``);
* ``MoleculeTransformerSequenceEncoder``: the bidirectional forward
  predictor;
* ``MoleculeTransformerGPT``: the unconditional GPT (causal
  ``AttentionQKV``, optionally with GCN layers over the attention; a dense,
  FF-CNN or MoE feed-forward; additive or concatenated positions; BERT-style
  masking) (``generate_gpt``);
* ``MoleculeTransformerGPTPyTorch``: the GPT on torch-MHA layers
  (``generate_gpt_mha``).

``MoleculeTransformerSequence`` is a token AR decoder with property
cross-attention, trained with cross entropy and conditioning dropout.
``generate_sequence`` decodes position by position against fixed-size KV
caches with batched classifier-free guidance: the conditioned and the null
half run as one doubled batch.  No hand-written kernel lies on this path in
either package: its attention is plain multi-query math at n = 1 and at most
65 keys of 16 features.

Module and parameter names are the reference torch keys (``layers.0.0`` self
attention, ``layers.0.1`` cross attention, ``layers.0.2`` the feed-forward
Sequential; in the GPT ``layers.0.1`` is the feed-forward and
``layers.0.1.moe`` the MoE), so ``nn.jax_import.state_dict_from_jax_params``
loads the JAX package's parameters with ``strict=True``.  The GPTs keep the
reference's vestigial ``fc1``, which their forward never uses.

No hand-written kernel lies on any of these paths, in either package: the
attention is plain math at these widths (the JAX package's is XLA, with MXU
packing that computes the same).  Every entry point builds on the card
unless the caller names a device, and every draw comes from a
``torch.Generator`` or is handed in.

``MoleculeTransformerSequenceEncoder`` is the bidirectional forward
predictor: token ids (b, L) in, (b, 1, 12) property logits out at the
notebook preset (``from_encoder_config``).  Its attention, ``TorchMHA``, is
torch's ``nn.MultiheadAttention`` math written out as the JAX package writes
it: plain products and a float32 softmax, masked with the finite
``NEG_INF``, so a row whose keys are all padding attends uniformly (no
hand-written kernel lies on this path in either package).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.embeddings import positional_encoding_1d
from ..nn.moe import MoEFeedForward
from ..nn.primitives import Dense, Embed, default_init, gelu, init_parameters
from ..nn.transformer_blocks import (NEG_INF, AttentionQKV, FeedForwardCNN,
                                     LNGamma, MQAttention, decode_loop,
                                     feed_forward_parti, gumbel_sample,
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


def _build(model: nn.Module, device, generator: Optional[torch.Generator]
           ) -> None:
    """Seed ``model``'s weights from ``generator`` and put it on ``device``:
    the card unless the caller names another."""
    if generator is not None:
        init_parameters(model, generator)
    model.to("cuda" if device is None else device)


def _step_uniforms(uniforms, step: int) -> Optional[torch.Tensor]:
    """Step ``step``'s uniforms: a row of a tensor, a callable's value, or
    None (drawn from the generator)."""
    if uniforms is None:
        return None
    return uniforms(step) if callable(uniforms) else uniforms[step]


def _sample_next(logits: torch.Tensor, filter_thres: float,
                 temperature: float, use_gumbel_sample: bool,
                 generator: Optional[torch.Generator],
                 uniforms: Optional[torch.Tensor]) -> torch.Tensor:
    """Top-k filtered Gumbel-max sampling, or the argmax."""
    if not use_gumbel_sample:
        return torch.argmax(logits, dim=-1)
    return gumbel_sample(top_k_filter(logits, filter_thres), temperature,
                         generator=generator, uniforms=uniforms)


def _init_caches(model: nn.Module, batch: int, total_len: int,
                 device=None) -> List:
    """The zero cache of each layer's self-attention (its first module), on
    the model's device unless ``device`` names another."""
    device = model.to_logits.weight.device if device is None else device
    return [layer[0].init_cache(batch, total_len, device)
            for layer in model.layers]


class _DecoderBase(nn.Module):
    """The layers, the conditioning head and the cached decode shared by the
    conditioned AR decoders.  The attention is ``MQAttention``, or
    ``AttentionQKV`` where a subclass sets ``_attention_cls``; each makes
    its own cache.  Subclasses add ``fc1``, ``init_norm``, ``final_norm``,
    ``to_logits`` and their token embedding."""

    _attention_cls = MQAttention
    one_kv_head = True

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
        attention = self._attention_cls
        if attention is AttentionQKV:
            kw["one_kv_head"] = self.one_kv_head
        self.layers = nn.ModuleList([nn.ModuleList([
            attention(self.dim, causal=True, **kw),
            attention(self.dim, context_dim=self.text_embed_dim, **kw),
            feed_forward_parti(self.dim, self.ff_mult, dtype=self.dtype),
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

    def cross_kv(self, cond: torch.Tensor) -> List[Any]:
        """Every layer's cross-attention KV, computed once a generation."""
        return [cross.kv(cond) for _, cross, _ in self.layers]

    def init_cache(self, batch: int, total_len: int, device=None) -> List:
        """Every layer's zero self-attention KV cache."""
        return _init_caches(self, batch, total_len, device)

    def project_token(self, x: torch.Tensor) -> torch.Tensor:
        """A token's embedding plus its position code, (b, 1, width of
        ``token_embed``), as the layers take it: unchanged here."""
        return x

    def decode_step(self, x_t: torch.Tensor, pos: Union[int, torch.Tensor],
                    cross_kvs: List, caches: List, text_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, List]:
        """One position through all layers against the KV caches, which are
        written in place.  ``x_t`` (b, 1, dim) is already embedded and
        positioned; ``pos`` an ``int`` or a 0-d integer tensor on the
        device (``MQAttention.step``).  Returns ((b, logits_dim) logits, the
        caches)."""
        x = self.init_norm(x_t)
        for (attn, cross, ff), cross_kv, cache in zip(self.layers, cross_kvs,
                                                      caches):
            x = attn.step(x, cache, pos)[0] + x
            x = cross.cross_step(x, cross_kv, text_mask) + x
            x = ff(x) + x
        return self.to_logits(self.final_norm(x))[:, 0], caches

    def decode_context(self, sequences: torch.Tensor, total: int) -> Dict:
        """What every decode step of one CFG generation reads: the doubled
        batch's cross-attention KV and text mask (the conditioned half keeps
        every property position, the null half none), the token table and
        the position code of ``total`` positions."""
        device = self.to_logits.weight.device
        cond = self.embed_conditioning(sequences.to(device))
        cond = cond[:, :self.max_text_len]
        b, n_ctx = cond.shape[:2]
        text_mask2 = torch.cat([
            torch.ones(b, n_ctx, dtype=torch.bool, device=device),
            torch.zeros(b, n_ctx, dtype=torch.bool, device=device)])
        # float32, as in the JAX package: the sum with the embedding is
        # rounded only by the first norm (the Internaldim variant's by
        # ``to_dim``)
        table = self.token_embed.weight.to(self.dtype)
        return dict(cross_kvs=self.cross_kv(torch.cat([cond, cond])),
                    text_mask=text_mask2, table=table,
                    pe=positional_encoding_1d(total, table.shape[1],
                                              device=device))

    def decode_token(self, token: torch.Tensor, pos: Union[int, torch.Tensor],
                     context: Dict, caches: List) -> torch.Tensor:
        """One position of a CFG generation: token (b,) ids at ``pos`` (an
        ``int`` or a 0-d tensor on the device), ``context`` from
        :meth:`decode_context`, the doubled batch's caches written in place.
        Returns the (2b, logits_dim) logits, the conditioned half first."""
        pe = context["pe"]
        pe_t = (pe[pos] if not isinstance(pos, torch.Tensor)
                else pe.index_select(0, pos.reshape(1))[0])
        x_t = self.project_token((context["table"][token] + pe_t)[:, None])
        logits2, _ = self.decode_step(torch.cat([x_t, x_t]), pos,
                                      context["cross_kvs"], caches,
                                      context["text_mask"])
        return logits2


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
        _build(self, device, generator)

    def embed_tokens(self, output_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embed(output_ids)
        pe = positional_encoding_1d(x.shape[1], self.dim, dtype=x.dtype,
                                    device=x.device)
        return x + pe[None]


class MoleculeTransformerSequenceInternaldim(_DecoderBase):
    """The Sequence decoder with a token embedding of its own width
    (``embed_dim``, a vocabulary of ``max_tokens``) projected to ``dim`` by
    ``to_dim``, and ``AttentionQKV`` layers (one KV head unless
    ``one_kv_head=False``).  On the card unless ``device`` names another;
    weights from ``generator``."""

    _attention_cls = AttentionQKV

    def __init__(self, *, max_tokens: int = 32, embed_dim: int = 16,
                 one_kv_head: bool = True, device=None,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(**kw)
        self.max_tokens, self.embed_dim = max_tokens, embed_dim
        self.one_kv_head = one_kv_head
        self.token_embed = Embed(max_tokens, embed_dim, dtype=self.dtype)
        self.to_dim = Dense(embed_dim, self.dim, bias=False, dtype=self.dtype)
        self.fc1 = Dense(1, self.text_embed_dim, dtype=self.dtype)
        self.start_token = nn.Parameter(torch.empty(self.dim))
        self.init_norm = LNGamma(self.dim, dtype=self.dtype)
        self._make_layers()
        self.final_norm = LNGamma(self.dim, dtype=self.dtype)
        self.to_logits = Dense(self.dim, self.logits_dim, bias=False,
                               dtype=self.dtype)
        with torch.no_grad():
            self.start_token.normal_(0.0, 1.0, generator=generator)
        _build(self, device, generator)

    def embed_tokens(self, output_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embed(output_ids)
        pe = positional_encoding_1d(x.shape[1], self.embed_dim, dtype=x.dtype,
                                    device=x.device)
        return self.to_dim(x + pe[None])

    def project_token(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_dim(x)


class MoleculeTransformer(_DecoderBase):
    """AR decoder over continuous vectors (b, L, logits_dim) with an MSE
    loss: each input vector is joined with a ``pos_fourier_graph_dim``
    Fourier position code on the channels, projected by ``to_dim`` and
    preceded by the learned ``start_token``.  On the card unless ``device``
    names another; weights from ``generator``."""

    def __init__(self, *, pos_fourier_graph_dim: int = 32, device=None,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(**kw)
        self.pos_fourier_graph_dim = pos_fourier_graph_dim
        self.fc1 = Dense(1, self.text_embed_dim, dtype=self.dtype)
        self.start_token = nn.Parameter(torch.empty(self.dim))
        self.init_norm = LNGamma(self.dim, dtype=self.dtype)
        self._make_layers()
        self.final_norm = LNGamma(self.dim, dtype=self.dtype)
        self.to_logits = Dense(self.dim, self.logits_dim, bias=False,
                               dtype=self.dtype)
        self.to_dim = Dense(self.logits_dim + pos_fourier_graph_dim, self.dim,
                            bias=False, dtype=self.dtype)
        with torch.no_grad():
            self.start_token.normal_(0.0, 1.0, generator=generator)
        _build(self, device, generator)

    def _project(self, vectors: torch.Tensor,
                 pe: torch.Tensor) -> torch.Tensor:
        """``to_dim`` of the vectors (rounded to the compute dtype) joined
        with their position codes (in the vectors' dtype)."""
        v = vectors.to(self.dtype).to(torch.promote_types(self.dtype,
                                                          pe.dtype))
        return self.to_dim(torch.cat([v, pe.to(v.dtype)], dim=-1))

    def embed_vectors(self, output: torch.Tensor) -> torch.Tensor:
        """(b, L, logits_dim) -> (b, L + 1, dim), the start token first."""
        b, length, _ = output.shape
        pe = positional_encoding_1d(length, self.pos_fourier_graph_dim,
                                    dtype=output.dtype, device=output.device)
        x = self._project(output, pe[None].expand(b, length, -1))
        start = self.start_token.to(x.dtype).expand(b, 1, self.dim)
        return torch.cat([start, x], dim=1)

    def forward(self, sequences: torch.Tensor, output: torch.Tensor, *,
                text_mask: Optional[torch.Tensor] = None,
                cond_drop_prob: Optional[float] = None,
                return_loss: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sequences (b, m), output (b, L, logits_dim) -> (b, L + 1,
        logits_dim), or with ``return_loss`` the MSE of the next position's
        prediction against the first ``logits_dim`` channels of the embedded
        stream, shifted (the reference's target, which the parameters reach
        too).  Conditioning dropout as in the Sequence decoder."""
        cond_drop_prob = (self.cond_drop_prob if cond_drop_prob is None
                          else cond_drop_prob)
        cond = self.embed_conditioning(sequences)
        x = self.embed_vectors(output)
        if return_loss:
            x, target = x[:, :-1], x[:, 1:, :self.logits_dim]
        cond, text_mask = self._text_mask(cond, text_mask, cond_drop_prob,
                                          generator, keep)
        logits = self._trunk(x, cond, text_mask)
        if not return_loss:
            return logits
        return (logits - target).float().square().mean()


# ------------------------------------------------------------- generation --

@torch.no_grad()
def generate_sequence(model: _DecoderBase, sequences: torch.Tensor,
                      start_ids: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, *,
                      uniforms: Optional[Uniforms] = None,
                      tokens_to_generate: int = 32, cond_scale: float = 3.0,
                      filter_thres: float = 0.9, temperature: float = 1.0,
                      return_logits: bool = False):
    """KV-cached autoregressive generation with batched CFG, for the
    Sequence decoder and its Internaldim variant.  sequences (b, m) property
    values; start_ids (b, T0) the prompt, or ``None`` for one
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

    context = model.decode_context(sequences, total)
    caches = model.init_cache(2 * b, total, device)
    ids = torch.zeros(b, total, dtype=start_ids.dtype, device=device)
    ids[:, :t0] = start_ids
    return decode_loop(
        lambda token, pos: model.decode_token(token, pos, context, caches),
        ids, t0, cond_scale=cond_scale, filter_thres=filter_thres,
        temperature=temperature, generator=generator, uniforms=uniforms,
        return_logits=return_logits)


@torch.no_grad()
def generate_vectors(model: MoleculeTransformer, sequences: torch.Tensor, *,
                     tokens_to_generate: int = 32,
                     cond_scale: float = 3.0) -> torch.Tensor:
    """KV-cached generation for the continuous ``MoleculeTransformer``: each
    step's CFG-blended output vector ``null + (cond - null) * cond_scale``
    (one doubled batch) is fed back as the next input; nothing is sampled.
    Returns (b, tokens_to_generate, logits_dim) float32 on the model's
    device.  (The reference's ``generate`` ignores its ``cond_scale`` and
    runs at 3, this default.)"""
    device = model.to_logits.weight.device
    b = sequences.shape[0]
    cond = model.embed_conditioning(sequences.to(device))
    cond = cond[:, :model.max_text_len]
    n_ctx = cond.shape[1]
    text_mask2 = torch.cat([
        torch.ones(b, n_ctx, dtype=torch.bool, device=device),
        torch.zeros(b, n_ctx, dtype=torch.bool, device=device)])
    cross_kvs = model.cross_kv(torch.cat([cond, cond]))
    caches = model.init_cache(2 * b, tokens_to_generate, device)
    out = torch.zeros(b, tokens_to_generate, model.logits_dim,
                      dtype=torch.float32, device=device)
    pe = positional_encoding_1d(max(tokens_to_generate - 1, 1),
                                model.pos_fourier_graph_dim, device=device)
    start = model.start_token.to(model.dtype).expand(b, 1, model.dim)
    for pos in range(tokens_to_generate):
        if pos == 0:
            x_t = start
        else:
            # the previous vector, as the forward embeds it
            x_t = model._project(out[:, pos - 1:pos],
                                 pe[pos - 1].expand(b, 1, -1))
        logits2, caches = model.decode_step(
            torch.cat([x_t, x_t]), pos, cross_kvs, caches, text_mask2)
        logits_c, logits_n = logits2[:b], logits2[b:]
        out[:, pos] = (logits_n + (logits_c - logits_n) * cond_scale).float()
    return out


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


# ------------------------------------------------------- forward encoder --

class TorchMHA(nn.Module):
    """torch ``nn.MultiheadAttention`` (batch first) as the JAX package
    computes it: a fused QKV in-projection ``in_proj_weight`` (3d, d) and
    ``in_proj_bias`` (3d,), then ``out_proj``; ``key_padding_mask`` (b, m)
    True = masked, and an optional causal mask.

    The in-projection runs in ``dtype`` and its float32 bias lifts q, k and
    v to float32 (JAX's type promotion); the scores and their softmax are
    float32, the probabilities are rounded to ``dtype`` before the float32
    product with v, whose result is rounded to ``dtype``.  Masked scores are
    the finite ``NEG_INF``: a row with every key masked gets a uniform
    softmax, as in JAX, where ``scaled_dot_product_attention`` would give
    NaN."""

    def __init__(self, dim: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.causal, self.dtype = dim, heads, causal, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Dense(dim, dim, dtype=dtype)
        default_init(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform in-projection and a zero bias (torch's and JAX's
        init); ``out_proj`` resets itself."""
        bound = math.sqrt(6.0 / (self.dim + 3 * self.dim))
        with torch.no_grad():
            self.in_proj_weight.uniform_(-bound, bound, generator=generator)
            self.in_proj_bias.zero_()

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        qkv = (F.linear(x.to(self.dtype), self.in_proj_weight.to(self.dtype))
               .float() + self.in_proj_bias.float())
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        sim = torch.matmul(q, k.transpose(-1, -2)) * (d // h) ** -0.5
        if key_padding_mask is not None:
            sim = sim.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        if self.causal:
            causal = torch.ones(n, n, dtype=torch.bool,
                                device=x.device).triu(1)
            sim = sim.masked_fill(causal, NEG_INF)
        attn = sim.softmax(dim=-1).to(self.dtype).float()
        out = torch.matmul(attn, v).to(self.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class MoleculeTransformerSequenceEncoder(nn.Module):
    """Bidirectional forward property predictor: token embedding + Fourier
    position code -> ``to_dim`` -> ``init_norm`` -> depth x (MHA with the
    key-padding mask + residual, then LN -> Linear -> GELU -> LN -> Linear +
    residual) -> ``final_norm`` -> ``to_logits`` -> the length-axis
    projection ``to_logits_dim_length``.  ids (b, L) -> (b, logits_dim,
    logits_dim_length) logits, or (b, L, logits_dim) without the length
    projection.  When ``max_length`` is set the sequence is cut to it and
    the keys equal to ``padding_token`` are masked.  No dropout (the JAX
    model has none either).

    ``device=None`` builds on the card (and raises where there is none); a
    CPU run asks for ``device="cpu"``.  ``generator`` seeds the weights."""

    def __init__(self, dim: int = 256, depth: int = 6, logits_dim: int = 32,
                 logits_dim_length: Optional[int] = None,
                 max_length: Optional[int] = None, max_tokens: int = 32,
                 heads: int = 8, ff_mult: int = 4, embed_dim: int = 16,
                 padding_token: int = 0, dtype: torch.dtype = torch.float32,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if logits_dim_length is not None and max_length is None:
            raise ValueError("max_length and logits_dim_length must be set "
                             "together")
        self.dim, self.depth, self.logits_dim = dim, depth, logits_dim
        self.logits_dim_length, self.max_length = logits_dim_length, max_length
        self.embed_dim, self.padding_token = embed_dim, padding_token
        self.dtype = dtype
        self.init_norm = LNGamma(dim, dtype=dtype)
        self.layers = nn.ModuleList([nn.ModuleList([
            TorchMHA(dim, heads, dtype=dtype),
            feed_forward_parti(dim, ff_mult, dtype=dtype),
        ]) for _ in range(depth)])
        self.final_norm = LNGamma(dim, dtype=dtype)
        self.token_embed = Embed(max_tokens, embed_dim, dtype=dtype)
        self.to_dim = Dense(embed_dim, dim, bias=False, dtype=dtype)
        self.to_logits = Dense(dim, logits_dim, bias=False, dtype=dtype)
        if logits_dim_length is not None:
            self.to_logits_dim_length = Dense(max_length, logits_dim_length,
                                              bias=False, dtype=dtype)
        _build(self, device, generator)

    def forward(self, input_sequence: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """ids (b, L) -> logits; ``text_mask`` (b, L) True = masked, by
        default the padding tokens when ``max_length`` is set.  With
        ``return_hidden`` the (b, L, dim) output of ``final_norm``."""
        x = self.token_embed(input_sequence)
        pe = positional_encoding_1d(x.shape[1], self.embed_dim, dtype=x.dtype,
                                    device=x.device)
        x = self.to_dim(x + pe[None])
        if self.max_length is not None:
            if text_mask is None:
                text_mask = input_sequence == self.padding_token
            x = x[:, :self.max_length]
            text_mask = text_mask[:, :self.max_length]
        x = self.init_norm(x)
        for attn, ff in self.layers:
            x = attn(x, key_padding_mask=text_mask) + x
            x = ff(x) + x
        x = self.final_norm(x)
        if return_hidden:
            return x
        logits = self.to_logits(x)
        if self.logits_dim_length is not None:
            logits = self.to_logits_dim_length(logits.transpose(1, 2))
        return logits


def from_encoder_config(config: Any, vocab_size: Optional[int] = None,
                        device=None, dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None
                        ) -> MoleculeTransformerSequenceEncoder:
    """The forward encoder from an ``EncoderConfig`` (the JAX package's
    ``core/config.py``, e.g. ``forward_transformer_qm9()``; read by
    attribute, so the port imports nothing of that package), mapped as the
    JAX package's ``train/recipes.py`` maps it: ``max_tokens`` is
    ``vocab_size`` when given, else the config's.  On the card unless
    ``device`` names another; weights from ``generator``."""
    return MoleculeTransformerSequenceEncoder(
        dim=config.dim, depth=config.depth, heads=config.heads,
        ff_mult=config.ff_mult, logits_dim=config.logits_dim,
        logits_dim_length=config.logits_dim_length,
        max_length=config.max_length,
        max_tokens=vocab_size or config.max_tokens,
        embed_dim=config.embed_dim, padding_token=config.padding_token,
        dtype=dtype, device=device, generator=generator)


# -------------------------------------------------------------- the GPTs --

class _GPTBase(nn.Module):
    """Token embedding with additive or concatenated Fourier positions,
    ``to_dim``, the vestigial ``fc1`` and the norms and logits head of both
    GPTs; subclasses make ``layers``."""

    def __init__(self, dim: int, depth: int, max_tokens: int,
                 logits_dim: int, embed_dim: int, text_embed_dim: int,
                 concat_pos_encoding: bool,
                 pos_fourier_graph_dim: Optional[int], dtype: torch.dtype):
        super().__init__()
        if concat_pos_encoding and pos_fourier_graph_dim is None:
            raise ValueError("concat_pos_encoding needs "
                             "pos_fourier_graph_dim")
        self.dim, self.depth, self.logits_dim = dim, depth, logits_dim
        self.embed_dim, self.dtype = embed_dim, dtype
        self.concat_pos_encoding = concat_pos_encoding
        self.pos_dim = (pos_fourier_graph_dim if concat_pos_encoding
                        else embed_dim)
        self.token_embed = Embed(max_tokens, embed_dim, dtype=dtype)
        self.to_dim = Dense(
            embed_dim + (self.pos_dim if concat_pos_encoding else 0), dim,
            bias=False, dtype=dtype)
        # the reference's fc1, which its forward never uses either
        self.fc1 = Dense(1, text_embed_dim, dtype=dtype)
        self.init_norm = LNGamma(dim, dtype=dtype)
        self.final_norm = LNGamma(dim, dtype=dtype)
        self.to_logits = Dense(dim, logits_dim, bias=False, dtype=dtype)

    def _position(self, x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
        """``to_dim`` of token embeddings x (b, n, embed_dim) with their
        position codes pe (n, pos_dim), in the compute dtype."""
        pe = pe[None].expand(x.shape[0], *pe.shape)
        x = torch.cat([x, pe], dim=-1) if self.concat_pos_encoding \
            else x + pe
        return self.to_dim(x)

    def embed_tokens(self, output_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embed(output_ids)
        return self._position(x, positional_encoding_1d(
            x.shape[1], self.pos_dim, dtype=x.dtype, device=x.device))

    def moe_aux_losses(self) -> List[torch.Tensor]:
        """The load-balance loss of each MoE layer's last forward (none for
        a dense model)."""
        return [m.aux_loss for m in self.modules()
                if isinstance(m, MoEFeedForward) and m.aux_loss is not None]

    def _loss(self, logits: torch.Tensor, output_ids: torch.Tensor,
              ignore_padding_zeros: bool) -> torch.Tensor:
        return cross_entropy_mean(
            logits[:, :-1], output_ids[:, 1:],
            ignore_index=0 if ignore_padding_zeros else None)


class _MoEBlock(nn.Module):
    """The GPT's MoE feed-forward: the pre-norm ``0`` and the experts
    ``moe``."""

    def __init__(self, dim: int, moe: MoEFeedForward, dtype: torch.dtype):
        super().__init__()
        self.add_module("0", LNGamma(dim, dtype=dtype))
        self.moe = moe

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.moe(getattr(self, "0")(x))


class MoleculeTransformerGPT(_GPTBase):
    """The unconditional multi-task GPT: ``depth`` x (causal
    ``AttentionQKV`` + residual, feed-forward + residual) between the
    embedding and the logits.  The feed-forward is parti's, the FF-CNN one
    (``ff_conv_kernel`` / ``ff_inner_conv_kernel`` / ``ff_glu``) or a MoE of
    ``ff_num_experts`` (top ``ff_expert_top_k``); ``gnn_layers`` adds GCN
    message passing over each attention matrix (with ``use_null_kv=False``,
    square attention).  ``forward`` masks ``mask_prob`` of the positions
    (never the first) as keys, BERT-style, from normals handed in
    (``mask_normals``, (b, n)) or drawn from ``generator``; the loss skips
    the label 0 with ``ignore_padding_zeros``.  After a forward of a MoE
    model, ``moe_aux_losses()`` gives each layer's load-balance loss.

    On the card unless ``device`` names another; weights from
    ``generator``."""

    def __init__(self, dim: int = 128, depth: int = 12, max_tokens: int = 32,
                 logits_dim: int = 32, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, embed_dim: int = 16,
                 text_embed_dim: int = 16, max_text_len: int = 128,
                 one_kv_head: bool = True, concat_pos_encoding: bool = False,
                 pos_fourier_graph_dim: Optional[int] = None,
                 use_null_kv: bool = True, ff_conv_kernel: int = 0,
                 ff_inner_conv_kernel: int = 0, ff_glu: bool = False,
                 ff_num_experts: int = 0, ff_expert_top_k: int = 2,
                 ff_expert_capacity_factor: float = 1.25,
                 gnn_layers: int = 0, gnn_att_threshold_min: float = 0.0,
                 gnn_att_threshold_max: float = 1.0,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim, depth, max_tokens, logits_dim, embed_dim,
                         text_embed_dim, concat_pos_encoding,
                         pos_fourier_graph_dim, dtype)
        if ff_num_experts > 0 and (ff_conv_kernel or ff_inner_conv_kernel):
            raise ValueError("MoE FF and FF-CNN are mutually exclusive")
        self.dim_head, self.max_text_len = dim_head, max_text_len

        def ff() -> nn.Module:
            if ff_num_experts > 0:
                return _MoEBlock(dim, MoEFeedForward(
                    dim, ff_num_experts, mult=ff_mult, top_k=ff_expert_top_k,
                    capacity_factor=ff_expert_capacity_factor, dtype=dtype),
                    dtype)
            if ff_conv_kernel == 0 and ff_inner_conv_kernel == 0:
                return feed_forward_parti(dim, ff_mult, dtype=dtype)
            return FeedForwardCNN(dim, mult=ff_mult, glu=ff_glu,
                                  conv_kernel_ff=ff_conv_kernel,
                                  ff_inner_conv=ff_inner_conv_kernel,
                                  dtype=dtype)

        self.layers = nn.ModuleList([nn.ModuleList([
            AttentionQKV(dim, causal=True, one_kv_head=one_kv_head,
                         dim_head=dim_head, heads=heads,
                         use_null_kv=use_null_kv, gnn_layers=gnn_layers,
                         gnn_att_threshold_min=gnn_att_threshold_min,
                         gnn_att_threshold_max=gnn_att_threshold_max,
                         dtype=dtype),
            ff()]) for _ in range(depth)])
        _build(self, device, generator)

    def _bert_mask(self, b: int, n: int, mask_prob: float,
                   generator: Optional[torch.Generator],
                   normals: Optional[torch.Tensor],
                   device) -> torch.Tensor:
        """The keys kept (b, n): all but the ``min(n * mask_prob, n - 1)``
        positions with the largest normals, the first never masked."""
        if normals is None:
            if generator is None:
                raise ValueError("mask_prob > 0 needs mask_normals or a "
                                 "generator")
            normals = torch.randn(b, n, generator=generator,
                                  device=generator.device)
        rand = normals.to(device=device, dtype=torch.float32).clone()
        rand[:, 0] = NEG_INF
        num_mask = min(int(n * mask_prob), n - 1)
        drop = torch.zeros(b, n, dtype=torch.bool, device=device)
        drop.scatter_(1, torch.topk(rand, num_mask, dim=-1).indices, True)
        return ~drop

    def forward(self, output_ids: torch.Tensor, *, return_loss: bool = False,
                ignore_padding_zeros: bool = False, mask_prob: float = 0.0,
                context_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids (b, n) -> (b, n, logits_dim) logits, or with ``return_loss``
        the next-token cross entropy.  ``context_mask`` (b, n), True =
        keep, masks keys; ``mask_prob`` replaces it by the BERT mask."""
        x = self.init_norm(self.embed_tokens(output_ids))
        if mask_prob > 0.0:
            b, n = output_ids.shape
            context_mask = self._bert_mask(b, n, mask_prob, generator,
                                           mask_normals, x.device)
        for attn, ff in self.layers:
            x = attn(x, context_mask=context_mask) + x
            x = ff(x) + x
        logits = self.to_logits(self.final_norm(x))
        if not return_loss:
            return logits
        return self._loss(logits, output_ids, ignore_padding_zeros)

    def init_cache(self, batch: int, total_len: int,
                   device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's zero (k, v) cache."""
        return _init_caches(self, batch, total_len, device)

    def decode_step(self, token_t: torch.Tensor, pos: int, caches: List,
                    pe: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List]:
        """One position: token ids (b,) at ``pos`` through every layer
        against the (k, v) caches, written in place; ``pe`` is the position
        code table of the caches' length in the compute dtype (made here
        when None).  Returns ((b, logits_dim) logits, the caches)."""
        x = self.token_embed(token_t)[:, None]
        if pe is None:
            pe = positional_encoding_1d(caches[0][0].shape[1], self.pos_dim,
                                        dtype=x.dtype, device=x.device)
        x = self.init_norm(self._position(x, pe[pos:pos + 1]))
        for (attn, ff), cache in zip(self.layers, caches):
            x = attn.step(x, cache, pos)[0] + x
            x = ff(x) + x
        return self.to_logits(self.final_norm(x))[:, 0], caches


@torch.no_grad()
def generate_gpt(model: MoleculeTransformerGPT, start_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 uniforms: Optional[Uniforms] = None,
                 tokens_to_generate: int = 32, filter_thres: float = 0.9,
                 temperature: float = 1.0, use_gumbel_sample: bool = True,
                 return_logits: bool = False):
    """KV-cached generation for ``MoleculeTransformerGPT``: start_ids (b, T0)
    -> ids (b, T0 + tokens_to_generate) on the model's device.  Each step's
    logits are top-k filtered and sampled by Gumbel-max (or the argmax
    without ``use_gumbel_sample``); a position inside the prompt keeps its
    token.  The uniforms (b, logits_dim) of step ``pos`` come from
    ``generator`` or ``uniforms`` (a (total - 1, b, logits_dim) tensor or a
    callable); ``return_logits`` adds every step's float32 logits."""
    device = model.to_logits.weight.device
    start_ids = start_ids.to(device)
    b, t0 = start_ids.shape
    total = t0 + tokens_to_generate
    caches = model.init_cache(b, total, device)
    ids = torch.zeros(b, total, dtype=start_ids.dtype, device=device)
    ids[:, :t0] = start_ids
    pe = positional_encoding_1d(total, model.pos_dim, dtype=model.dtype,
                                device=device)
    kept = [] if return_logits else None
    for pos in range(total - 1):
        logits, caches = model.decode_step(ids[:, pos], pos, caches, pe)
        logits = logits.float()
        if kept is not None:
            kept.append(logits)
        if pos + 1 < t0:
            continue
        ids[:, pos + 1] = _sample_next(
            logits, filter_thres, temperature, use_gumbel_sample, generator,
            _step_uniforms(uniforms, pos)).to(ids.dtype)
    if return_logits:
        return ids, torch.stack(kept)
    return ids


class MoleculeTransformerGPTPyTorch(_GPTBase):
    """The GPT on fused-QKV multi-head attention (``TorchMHA``) with parti's
    feed-forward.  ``causal=True`` masks the future; the reference passes
    ``is_causal=True`` without a mask, which torch ignores, so
    ``causal=False`` reproduces the reference's non-causal model (the JAX
    package's recorded deviation, mirrored).  On the card unless ``device``
    names another; weights from ``generator``."""

    def __init__(self, dim: int = 128, depth: int = 12, max_tokens: int = 32,
                 logits_dim: int = 32, heads: int = 8, ff_mult: int = 4,
                 embed_dim: int = 16, text_embed_dim: int = 16,
                 concat_pos_encoding: bool = False,
                 pos_fourier_graph_dim: Optional[int] = None,
                 causal: bool = True, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(dim, depth, max_tokens, logits_dim, embed_dim,
                         text_embed_dim, concat_pos_encoding,
                         pos_fourier_graph_dim, dtype)
        self.layers = nn.ModuleList([nn.ModuleList([
            TorchMHA(dim, heads, causal=causal, dtype=dtype),
            feed_forward_parti(dim, ff_mult, dtype=dtype),
        ]) for _ in range(depth)])
        _build(self, device, generator)

    def forward(self, output_ids: torch.Tensor, *, return_loss: bool = False,
                ignore_padding_zeros: bool = False) -> torch.Tensor:
        x = self.init_norm(self.embed_tokens(output_ids))
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        logits = self.to_logits(self.final_norm(x))
        if not return_loss:
            return logits
        return self._loss(logits, output_ids, ignore_padding_zeros)


@torch.no_grad()
def generate_gpt_mha(model: MoleculeTransformerGPTPyTorch,
                     start_ids: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *,
                     uniforms: Optional[Uniforms] = None,
                     tokens_to_generate: int = 32, filter_thres: float = 0.9,
                     temperature: float = 1.0,
                     use_gumbel_sample: bool = True) -> torch.Tensor:
    """Generation for the MHA GPT, which has no per-position cache: each
    step runs the full forward over the fixed (b, T0 + tokens_to_generate)
    buffer (zeros past the prompt and the tokens so far) and samples the
    next token from the logits at the step's position.  The uniforms of
    step s (b, logits_dim) come from ``generator`` or ``uniforms``
    (a (tokens_to_generate, b, logits_dim) tensor or a callable)."""
    device = model.to_logits.weight.device
    start_ids = start_ids.to(device)
    b, t0 = start_ids.shape
    total = t0 + tokens_to_generate
    ids = torch.zeros(b, total, dtype=start_ids.dtype, device=device)
    ids[:, :t0] = start_ids
    for step, pos in enumerate(range(t0 - 1, total - 1)):
        logits = model(ids)[:, pos].float()
        ids[:, pos + 1] = _sample_next(
            logits, filter_thres, temperature, use_gumbel_sample, generator,
            _step_uniforms(uniforms, step)).to(ids.dtype)
    return ids
