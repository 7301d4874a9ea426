"""The 1-D denoiser UNet and its variants (port of `nn/unet.py`): the base
``UNet1d``, ``UNetCFG1d`` (classifier-free guidance, with the training-time
conditioning dropout ``embedding_mask_proba``), ``UNetNCCA1d`` (noise-channel
conditioning augmentation) and ``UNetAll1d`` (CFG with the NCCA embedder's
parameters), built by ``XUNet1d``.

Channels-last (b, L, C).  Classifier-free guidance runs as one
doubled-batch forward, ``[conditioned; null]``, blended as
``out_masked + (out - out_masked) * scale``: exact, because every layer is
per-sample.  Submodule names are the reference's, so ``state_dict`` keys
match the JAX package's export.

The variants' draws (the dropout's keep mask, the NCCA noise) are handed in
or drawn from a ``torch.Generator``, never from torch's global generator.

Each down and up block runs its ResnetBlock1d's as modules by default, or,
with ``ops.resnet_fusion.enable_resnet_fusion()``, as one kernel run
(``_resnet_run``, as the JAX package routes it; the bottleneck's blocks and
the Patcher/Unpatcher stay modules there too).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops import resnet_fusion as rf
from ..ops import transformer_fusion as tf
from .attention import Transformer1d
from .blocks import (Patcher, ResnetBlock1d, Unpatcher, downsample1d,
                     upsample1d)
from .embeddings import (FixedEmbedding, NumberEmbedder,
                         time_positional_embedding)
from .primitives import Dense


def _attention_kwargs(heads, features, multiplier, use_rel_pos,
                      rel_pos_num_buckets, rel_pos_max_distance):
    return dict(num_heads=heads, head_features=features,
                multiplier=multiplier, use_rel_pos=use_rel_pos,
                rel_pos_num_buckets=rel_pos_num_buckets,
                rel_pos_max_distance=rel_pos_max_distance)


def _resnet_run(mod: nn.Module, x: torch.Tensor,
                mapping: Optional[torch.Tensor], *, collect: bool = False,
                skips: Optional[List[torch.Tensor]] = None,
                skip_scale: float = 1.0):
    """The ``blocks`` run of a down or up block (the JAX ``_resnet_run``):
    the modules by default, the resnet-run kernel when
    ``rf.enable_resnet_fusion()`` is on and it takes the run.  An up block
    pops one skip per block, last pushed first.  Returns (x, every block's
    output when ``collect``)."""
    blocks = list(mod.blocks)
    skip_list = None
    if skips is not None:
        skip_list = [skips.pop() for _ in blocks]
    if rf.resnet_fusion_enabled() and rf.fusable(x, blocks, mod.num_groups):
        if any(isinstance(p, DTensor) or getattr(m, "seq_axis", None)
               for blk in blocks for m in blk.modules()
               for p in m.parameters(recurse=False)):
            # the kernel takes whole weights and a whole sequence
            raise ValueError("the resnet-run kernel (enable_resnet_fusion) "
                             "does not run under tensor or sequence "
                             "parallelism: switch it off")
        # the kernel reads dense (b, L, C) rows; a conv's channels-last
        # output is a transposed view
        return rf.resnet_stack(
            blocks, mod.resnet_weights.get(blocks, x.dtype), x.contiguous(),
            mapping if blocks[0].use_mapping else None, skip_list,
            groups=mod.num_groups, skip_scale=skip_scale, collect=collect)
    out, outs = rf.resnet_stack_composition(blocks, x, mapping, skip_list,
                                            skip_scale=skip_scale)
    return out, (outs if collect else [])


class DownsampleBlock1d(nn.Module):
    """Downsample conv -> [context channel concat] -> [pre_transformer
    self-attention] -> N ResnetBlocks -> [cross-attention transformer],
    collecting skips (pre-downsample layout, as the UNet uses it)."""

    def __init__(self, in_channels: int, out_channels: int, factor: int,
                 num_groups: int, num_layers: int, kernel_multiplier: int = 2,
                 use_skip: bool = False, context_channels: int = 0,
                 num_transformer_blocks: int = 0,
                 attention_heads: Optional[int] = None,
                 attention_features: Optional[int] = None,
                 attention_multiplier: Optional[int] = None,
                 attention_use_rel_pos: bool = False,
                 attention_rel_pos_num_buckets: Optional[int] = None,
                 attention_rel_pos_max_distance: Optional[int] = None,
                 context_mapping_features: Optional[int] = None,
                 context_embedding_features: Optional[int] = None,
                 pre_transformer: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_skip = use_skip
        self.context_channels = context_channels
        self.num_groups = num_groups
        self.resnet_weights = rf.WeightCache()
        attn = _attention_kwargs(attention_heads, attention_features,
                                 attention_multiplier, attention_use_rel_pos,
                                 attention_rel_pos_num_buckets,
                                 attention_rel_pos_max_distance)
        ch = out_channels
        self.downsample = downsample1d(in_channels, out_channels, factor,
                                       kernel_multiplier, dtype=dtype)
        self.pre_transformer_block = (
            Transformer1d(pre_transformer, ch, dtype=dtype, **attn)
            if pre_transformer > 0 else None)
        self.blocks = nn.ModuleList([
            ResnetBlock1d(ch + context_channels if i == 0 else ch, ch,
                          num_groups=num_groups,
                          context_mapping_features=context_mapping_features,
                          dtype=dtype)
            for i in range(num_layers)])
        self.transformer = (
            Transformer1d(num_transformer_blocks, ch,
                          context_features=context_embedding_features,
                          dtype=dtype, **attn)
            if num_transformer_blocks > 0 else None)

    def forward(self, x: torch.Tensor, *,
                mapping: Optional[torch.Tensor] = None,
                channels: Optional[torch.Tensor] = None,
                embedding: Optional[torch.Tensor] = None):
        x = self.downsample(x)
        if self.context_channels > 0 and channels is not None:
            x = torch.cat([x, channels.to(x.dtype)], dim=-1)
        skips: List[torch.Tensor] = []
        if self.pre_transformer_block is not None:
            x = self.pre_transformer_block(x)
            if self.use_skip:
                skips.append(x)
        x, block_outs = _resnet_run(self, x, mapping, collect=self.use_skip)
        skips.extend(block_outs)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding)
            if self.use_skip:
                skips.append(x)
        return (x, skips) if self.use_skip else x


class UpsampleBlock1d(nn.Module):
    """N ResnetBlocks with skip-concat -> [pre_transformer] -> [cross-
    attention transformer] -> upsample (post-upsample layout, as the UNet
    uses it)."""

    def __init__(self, in_channels: int, out_channels: int, factor: int,
                 num_layers: int, num_groups: int, use_nearest: bool = False,
                 use_skip: bool = False, skip_channels: int = 0,
                 use_skip_scale: bool = False,
                 num_transformer_blocks: int = 0,
                 attention_heads: Optional[int] = None,
                 attention_features: Optional[int] = None,
                 attention_multiplier: Optional[int] = None,
                 attention_use_rel_pos: bool = False,
                 attention_rel_pos_num_buckets: Optional[int] = None,
                 attention_rel_pos_max_distance: Optional[int] = None,
                 context_mapping_features: Optional[int] = None,
                 context_embedding_features: Optional[int] = None,
                 pre_transformer: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_skip = use_skip
        self.skip_scale = 2 ** -0.5 if use_skip_scale else 1.0
        self.num_groups = num_groups
        self.resnet_weights = rf.WeightCache()
        attn = _attention_kwargs(attention_heads, attention_features,
                                 attention_multiplier, attention_use_rel_pos,
                                 attention_rel_pos_num_buckets,
                                 attention_rel_pos_max_distance)
        ch = in_channels
        self.blocks = nn.ModuleList([
            ResnetBlock1d(ch + skip_channels if use_skip else ch, ch,
                          num_groups=num_groups,
                          context_mapping_features=context_mapping_features,
                          dtype=dtype)
            for _ in range(num_layers)])
        self.pre_transformer_block = (
            Transformer1d(pre_transformer, ch, dtype=dtype, **attn)
            if pre_transformer > 0 else None)
        self.transformer = (
            Transformer1d(num_transformer_blocks, ch,
                          context_features=context_embedding_features,
                          dtype=dtype, **attn)
            if num_transformer_blocks > 0 else None)
        self.upsample = upsample1d(in_channels, out_channels, factor,
                                   use_nearest, dtype=dtype)

    def forward(self, x: torch.Tensor, *,
                skips: Optional[List[torch.Tensor]] = None,
                mapping: Optional[torch.Tensor] = None,
                embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, _ = _resnet_run(self, x, mapping, skips=skips,
                           skip_scale=self.skip_scale)
        if self.pre_transformer_block is not None:
            x = self.pre_transformer_block(x)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding)
        return self.upsample(x)


class BottleneckBlock1d(nn.Module):
    """Resnet -> [cross-attention transformer] -> Resnet."""

    def __init__(self, channels: int, num_groups: int,
                 num_transformer_blocks: int = 0,
                 attention_heads: Optional[int] = None,
                 attention_features: Optional[int] = None,
                 attention_multiplier: Optional[int] = None,
                 attention_use_rel_pos: bool = False,
                 attention_rel_pos_num_buckets: Optional[int] = None,
                 attention_rel_pos_max_distance: Optional[int] = None,
                 context_mapping_features: Optional[int] = None,
                 context_embedding_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pre_block = ResnetBlock1d(
            channels, channels, num_groups=num_groups,
            context_mapping_features=context_mapping_features, dtype=dtype)
        self.transformer = (
            Transformer1d(num_transformer_blocks, channels,
                          context_features=context_embedding_features,
                          dtype=dtype,
                          **_attention_kwargs(attention_heads,
                                              attention_features,
                                              attention_multiplier,
                                              attention_use_rel_pos,
                                              attention_rel_pos_num_buckets,
                                              attention_rel_pos_max_distance))
            if num_transformer_blocks > 0 else None)
        self.post_block = ResnetBlock1d(
            channels, channels, num_groups=num_groups,
            context_mapping_features=context_mapping_features, dtype=dtype)

    def forward(self, x: torch.Tensor, *,
                mapping: Optional[torch.Tensor] = None,
                embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.pre_block(x, mapping)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding)
        return self.post_block(x, mapping)


class UNet1d(nn.Module):
    """The full 1-D denoiser: Patcher -> L x DownsampleBlock -> Bottleneck ->
    L x UpsampleBlock -> long skip -> Unpatcher, FiLM-conditioned on a
    time(+features) mapping, cross-attending to ``embedding``.

    x (b, L, in_channels); embedding (b, n_ctx, context_embedding_features);
    the entries of ``channels_list`` (b, L_i, context_channels[i])."""

    def __init__(self, in_channels: int, channels: int,
                 multipliers: Sequence[int], factors: Sequence[int],
                 num_blocks: Sequence[int], attentions: Sequence[int],
                 patch_size: int = 1, resnet_groups: int = 8,
                 use_context_time: bool = True,
                 kernel_multiplier_downsample: int = 2,
                 use_nearest_upsample: bool = False,
                 use_skip_scale: bool = True,
                 out_channels: Optional[int] = None,
                 context_features: Optional[int] = None,
                 context_features_multiplier: int = 4,
                 context_channels: Sequence[int] = (),
                 context_embedding_features: Optional[int] = None,
                 attention_heads: Optional[int] = None,
                 attention_features: Optional[int] = None,
                 attention_multiplier: Optional[int] = None,
                 attention_use_rel_pos: bool = False,
                 attention_rel_pos_max_distance: Optional[int] = None,
                 attention_rel_pos_num_buckets: Optional[int] = None,
                 pre_transformer: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_layers = len(multipliers) - 1
        assert (len(factors) == num_layers and len(attentions) >= num_layers
                and len(num_blocks) == num_layers)
        self.num_layers = num_layers
        self.patch_size, self.factors = patch_size, tuple(factors)
        self.use_context_time = use_context_time
        self.context_features = context_features
        self.use_mapping = use_context_time or context_features is not None
        ctx = list(context_channels)
        self.context_channels = ctx + [0] * (num_layers + 1 - len(ctx))
        self.dtype = dtype
        out_channels = out_channels or in_channels
        cmf = channels * context_features_multiplier
        mapping_features = cmf if self.use_mapping else None
        attn = dict(attention_heads=attention_heads,
                    attention_features=attention_features,
                    attention_multiplier=attention_multiplier,
                    attention_use_rel_pos=attention_use_rel_pos,
                    attention_rel_pos_num_buckets=attention_rel_pos_num_buckets,
                    attention_rel_pos_max_distance=(
                        attention_rel_pos_max_distance))

        if use_context_time:
            self.to_time = nn.Sequential(
                time_positional_embedding(channels, cmf, dtype=dtype),
                nn.GELU())
        if context_features is not None:
            self.to_features = nn.Sequential(
                Dense(context_features, cmf, dtype=dtype), nn.GELU())
        if self.use_mapping:
            self.to_mapping = nn.Sequential(
                Dense(cmf, cmf, dtype=dtype), nn.GELU(),
                Dense(cmf, cmf, dtype=dtype), nn.GELU())

        self.to_in = Patcher(in_channels + self.context_channels[0],
                             channels * multipliers[0], patch_size,
                             context_mapping_features=mapping_features,
                             dtype=dtype)
        self.downsamples = nn.ModuleList([
            DownsampleBlock1d(
                in_channels=channels * multipliers[i],
                out_channels=channels * multipliers[i + 1],
                factor=factors[i],
                kernel_multiplier=kernel_multiplier_downsample,
                num_groups=resnet_groups, num_layers=num_blocks[i],
                use_skip=True, context_channels=self.context_channels[i + 1],
                num_transformer_blocks=attentions[i],
                context_mapping_features=mapping_features,
                context_embedding_features=context_embedding_features,
                pre_transformer=pre_transformer, dtype=dtype, **attn)
            for i in range(num_layers)])
        self.bottleneck = BottleneckBlock1d(
            channels=channels * multipliers[-1], num_groups=resnet_groups,
            num_transformer_blocks=attentions[-1],
            context_mapping_features=mapping_features,
            context_embedding_features=context_embedding_features,
            dtype=dtype, **attn)
        self.upsamples = nn.ModuleList([
            UpsampleBlock1d(
                in_channels=channels * multipliers[i + 1],
                out_channels=channels * multipliers[i],
                factor=factors[i],
                num_layers=num_blocks[i] + (1 if attentions[i] else 0),
                num_groups=resnet_groups,
                use_nearest=use_nearest_upsample,
                use_skip_scale=use_skip_scale, use_skip=True,
                skip_channels=channels * multipliers[i + 1],
                num_transformer_blocks=attentions[i],
                context_mapping_features=mapping_features,
                context_embedding_features=context_embedding_features,
                pre_transformer=pre_transformer, dtype=dtype, **attn)
            for i in reversed(range(num_layers))])
        self.to_out = Unpatcher(channels * multipliers[0], out_channels,
                                patch_size,
                                context_mapping_features=mapping_features,
                                dtype=dtype)

    def _get_channels(self, channels_list, layer: int):
        """Context channels for ``layer``; ``channels_list`` holds entries
        only for the layers with nonzero context_channels, in order."""
        ctx = self.context_channels
        if ctx[layer] == 0:
            return None
        assert channels_list is not None, "Missing context"
        channels = channels_list[sum(c > 0 for c in ctx[:layer])]
        assert channels.shape[-1] == ctx[layer], (
            f"Expected context with {ctx[layer]} channels for layer {layer}")
        return channels

    def _get_mapping(self, time, features):
        """Time (+ feature) context -> the FiLM mapping vector."""
        if not self.use_mapping:
            return None
        items = []
        if self.use_context_time:
            assert time is not None, \
                "use_context_time=True but no time features provided"
            items.append(self.to_time(time))
        if self.context_features is not None:
            assert features is not None, \
                "context_features exists but no features provided"
            items.append(self.to_features(features))
        return self.to_mapping(sum(items))

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None,
                *, features: Optional[torch.Tensor] = None,
                channels_list: Optional[Sequence[torch.Tensor]] = None,
                embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.unet_forward(x, time, features=features,
                                 channels_list=channels_list,
                                 embedding=embedding)

    def unet_forward(self, x: torch.Tensor,
                     time: Optional[torch.Tensor] = None, *,
                     features: Optional[torch.Tensor] = None,
                     channels_list: Optional[Sequence[torch.Tensor]] = None,
                     embedding: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        total_factor = self.patch_size
        for f in self.factors:
            total_factor *= f
        assert x.shape[1] % total_factor == 0, (
            f"sequence length {x.shape[1]} must be divisible by patch_size x "
            f"prod(factors) = {total_factor}")
        channels = self._get_channels(channels_list, layer=0)
        if channels is not None:
            x = torch.cat([x, channels.to(x.dtype)], dim=-1)
        mapping = self._get_mapping(time, features)

        x = self.to_in(x, mapping)
        skips_list: List[Any] = [x]
        for i, down in enumerate(self.downsamples):
            x, skips = down(x, mapping=mapping,
                            channels=self._get_channels(channels_list, i + 1),
                            embedding=embedding)
            skips_list.append(skips)
        x = self.bottleneck(x, mapping=mapping, embedding=embedding)
        for up in self.upsamples:
            x = up(x, skips=skips_list.pop(), mapping=mapping,
                   embedding=embedding)
        x = x + skips_list.pop()
        return self.to_out(x, mapping)


def cfg_forward(unet_apply, x: torch.Tensor, time: torch.Tensor,
                embedding: torch.Tensor, fixed_embedding: torch.Tensor,
                embedding_scale: float = 1.0, **kwargs) -> torch.Tensor:
    """Batched classifier-free guidance: one doubled-batch forward, ordered
    [conditioned; null]; ``embedding_scale == 1.0`` is one plain pass."""
    if embedding_scale == 1.0:
        return unet_apply(x, time, embedding=embedding, **kwargs)
    b = x.shape[0]
    kwargs2 = {}
    for k, v in kwargs.items():
        if k == "channels_list" and v is not None:
            kwargs2[k] = [torch.cat([c, c], dim=0) for c in v]
        elif isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == b:
            kwargs2[k] = torch.cat([v, v], dim=0)
        else:
            kwargs2[k] = v
    embedding2 = torch.cat([embedding, fixed_embedding], dim=0)
    # the null half's context rows are one FixedEmbedding table: flag the
    # doubled context, so that with the shared-KV switch on the stacks run
    # that half against the table (tf.null_half_table)
    with tf.cfg_uniform_null_half(embedding2, fixed_embedding):
        out2 = unet_apply(torch.cat([x, x], dim=0),
                          torch.cat([time, time], dim=0),
                          embedding=embedding2, **kwargs2)
    out, out_masked = out2[:b], out2[b:]
    return out_masked + (out - out_masked) * embedding_scale


def _keep_mask(keep: Optional[torch.Tensor], proba: float, batch: int,
               generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """The conditioning dropout's (b, 1, 1) keep mask: ``keep`` as handed in
    (any shape of b elements), or True where a uniform from ``generator`` is
    at least ``proba`` (JAX's ``bernoulli(proba)`` marks the dropped rows)."""
    if keep is None:
        if generator is None:
            raise ValueError("embedding_mask_proba > 0 needs a keep mask "
                             "(embedding_keep=) or a generator")
        u = torch.rand(batch, generator=generator, device=generator.device)
        keep = u >= proba
    return keep.to(device=device, dtype=torch.bool).reshape(batch, 1, 1)


class UNetCFG1d(UNet1d):
    """UNet1d with classifier-free guidance; the null conditioning is a
    learned positional table of the live embedding's shape.

    ``embedding_mask_proba > 0`` (the training-time conditioning dropout)
    replaces a row's embedding by the null table where its keep mask is
    False: ``embedding_keep`` (b, 1, 1) is handed in, or drawn from
    ``generator`` with probability ``1 - embedding_mask_proba``."""

    def __init__(self, *, context_embedding_max_length: int, **kwargs):
        super().__init__(**kwargs)
        self.fixed_embedding = FixedEmbedding(
            context_embedding_max_length, kwargs["context_embedding_features"],
            dtype=self.dtype)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None,
                *, embedding: torch.Tensor, embedding_scale: float = 1.0,
                embedding_mask_proba: float = 0.0,
                embedding_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                **kwargs) -> torch.Tensor:
        fixed = self.fixed_embedding(embedding)
        if embedding_mask_proba > 0.0:
            keep = _keep_mask(embedding_keep, embedding_mask_proba,
                              embedding.shape[0], generator, embedding.device)
            embedding = torch.where(keep, embedding, fixed)
        return cfg_forward(self.unet_forward, x, time, embedding, fixed,
                           embedding_scale=embedding_scale, **kwargs)


class UNetNCCA1d(UNet1d):
    """UNet1d with noise-channel conditioning augmentation: each item of
    ``channels_list`` becomes ``noise * s + item * (1 - s)`` with ``s =
    channels_scale * channels_augmentation`` (per row and item), and the raw
    ``channels_scale`` is embedded (``embedder``, a NumberEmbedder; the
    reference embeds the scale before the augmentation gates it) and summed
    over the items into the UNet's ``features``.  The noise, one standard
    normal like each item, is handed in (``channels_noise``) or drawn from
    ``generator``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.embedder = NumberEmbedder(self.context_features,
                                       dtype=self.dtype)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None,
                *, channels_list: Sequence[torch.Tensor],
                channels_augmentation: Any = False,
                channels_scale: Any = 0.0,
                channels_noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                **kwargs) -> torch.Tensor:
        b, n = x.shape[0], len(channels_list)
        if channels_noise is None and generator is None:
            raise ValueError("UNetNCCA1d needs channels_noise or a generator")
        aug = torch.as_tensor(channels_augmentation, dtype=x.dtype,
                              device=x.device).expand(b, n)
        raw_scale = torch.as_tensor(channels_scale, dtype=x.dtype,
                                    device=x.device).expand(b, n)
        scale = raw_scale * aug
        out_channels_list = []
        for i, item in enumerate(channels_list):
            s = scale[:, i].reshape(-1, 1, 1)
            if channels_noise is None:
                noise = torch.randn(item.shape, generator=generator,
                                    dtype=item.dtype, device=item.device)
            else:
                noise = channels_noise[i].to(item.device, item.dtype)
            out_channels_list.append(noise * s + item * (1 - s))
        features = self.embedder(raw_scale).sum(dim=1)
        return self.unet_forward(x, time, channels_list=out_channels_list,
                                 features=features, **kwargs)


class UNetAll1d(UNetCFG1d):
    """CFG with the NCCA embedder's parameters: the reference's class
    inherits both, so with ``context_features`` it owns ``embedder`` (which
    its forward never uses; kept so that checkpoints load), and it runs the
    CFG forward."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.context_features is not None:
            self.embedder = NumberEmbedder(self.context_features,
                                           dtype=self.dtype)


def XUNet1d(type: str = "base", **kwargs) -> UNet1d:
    """Factory mirroring the reference's ``XUNet1d``: "base", "cfg", "ncca"
    or "all"."""
    if type == "base":
        kwargs.pop("context_embedding_max_length", None)
        return UNet1d(**kwargs)
    if type == "all":
        return UNetAll1d(**kwargs)
    if type == "cfg":
        return UNetCFG1d(**kwargs)
    if type == "ncca":
        return UNetNCCA1d(**kwargs)
    raise ValueError(f"Unknown XUNet1d type: {type}")
