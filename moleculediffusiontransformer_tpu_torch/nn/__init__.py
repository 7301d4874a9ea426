"""Neural-network modules of the port, channels-last (b, L, C): the 1-D
UNet zoo and its blocks, the transformer blocks, the audio codecs and the
autoencoder.

The names the JAX package's ``nn`` exports are exported here too, each
imported from its module on first use (``ops`` imports ``nn.primitives``,
and ``nn.unet`` imports ``ops``: an eager import here would be a cycle)."""
import importlib

_EXPORTS = {
    "primitives": ("Conv1d", "ConvTranspose1d", "Dense", "Embed", "GroupNorm",
                   "LayerNorm", "gelu", "patchify", "silu", "unpatchify"),
    "embeddings": ("FixedEmbedding", "LearnedPositionalEmbedding",
                   "NumberEmbedder", "positional_encoding_1d",
                   "positional_encoding_2d", "positional_encoding_3d",
                   "sinusoidal_embedding", "time_positional_embedding"),
    "blocks": ("ConditionedSequential", "ConvBlock1d", "MappingToScaleShift",
               "Patcher", "ResnetBlock1d", "Unpatcher", "downsample1d",
               "upsample1d"),
    "attention": ("Attention", "AttentionBase", "RelativePositionBias",
                  "Transformer1d", "TransformerBlock", "feed_forward"),
    "unet": ("BottleneckBlock1d", "DownsampleBlock1d", "UNet1d", "UNetAll1d",
             "UNetCFG1d", "UNetNCCA1d", "UpsampleBlock1d", "XUNet1d",
             "cfg_forward"),
    "jax_import": ("state_dict_from_jax_params",),
    "transformer_blocks": ("AttentionQKV", "CausalDSConv", "FeedForwardCNN",
                           "GCNLayer", "GLU", "GraphConvLayers", "LNGamma",
                           "MQAttention", "RelPosBias2d", "gumbel_sample",
                           "prob_mask_like", "top_k_filter"),
    "moe": ("MoEFeedForward", "moe_capacity"),
    "dsp": ("downsample", "resample", "upsample"),
    "stft": ("STFT",),
    "autoencoder": ("AutoEncoder1d", "Decoder1d", "Encoder1d",
                    "TanhBottleneck"),
    "text": ("T5Embedder",),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__),
                   name)
