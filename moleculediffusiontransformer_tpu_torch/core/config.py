"""Structured configuration: the port's own copy of the JAX package's
`core/config.py` (dataclasses only, no JAX in either), so that a config
means the same thing in both packages.  ``tests/test_torch_data_copies.py``
holds every field, default and preset equal to the original.

The reference has no config system -- hyperparameters are literal kwargs in
notebooks (see SURVEY.md §5).  Here each model family gets a frozen
dataclass, and the four shipped-notebook presets are provided as named
constructors so a reference user can find their exact configuration by
name.

Preset provenance:
  * ``forward_diffusion_qm9``  — `Forward_Diffusion.ipynb` cell 50 and
    `MoleculeDiffusion/generative.py:69-83`.
  * ``inverse_diffusion_qm9``  — `Inverse_Diffusion.ipynb` cell 61 and
    `generative.py:761-776`.
  * ``inverse_transformer_qm9``— `Inverse_Transformer.ipynb` cell 46.
  * ``forward_transformer_qm9``— `Forward_Transformer.ipynb` cell 57.

``TrainConfig`` keeps every field of the original.  ``param_sharding=
"fsdp"`` and ``fsdp_min_elements`` shard the model and the Adam moments
over the ranks of a process group (``parallel/fsdp.py``);
``checkpoint_backend="orbax"`` is JAX-only and refused by
``train.trainer.train_diffusion``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class UNet1dConfig:
    """Config of the 1-D denoiser UNet (reference `modules.py:934-1180`)."""
    in_channels: int
    channels: int
    multipliers: Tuple[int, ...]
    factors: Tuple[int, ...]
    num_blocks: Tuple[int, ...]
    attentions: Tuple[int, ...]
    patch_size: int = 1
    resnet_groups: int = 8
    kernel_multiplier_downsample: int = 2
    use_nearest_upsample: bool = False
    use_skip_scale: bool = True
    use_context_time: bool = True
    out_channels: Optional[int] = None
    context_features: Optional[int] = None
    context_features_multiplier: int = 4
    context_channels: Tuple[int, ...] = ()
    context_embedding_features: Optional[int] = None
    attention_heads: Optional[int] = None
    attention_features: Optional[int] = None
    attention_multiplier: Optional[int] = None
    attention_use_rel_pos: bool = False
    attention_rel_pos_max_distance: Optional[int] = None
    attention_rel_pos_num_buckets: Optional[int] = None
    pre_transformer: int = 0
    use_stft: bool = False
    use_stft_context: bool = False
    stft_num_fft: Optional[int] = None
    stft_hop_length: Optional[int] = None
    stft_use_complex: bool = False

    @property
    def num_layers(self) -> int:
        return len(self.multipliers) - 1

    def replace(self, **kw) -> "UNet1dConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DiffusionConfig:
    """K-diffusion training config (reference `diffusion.py:170-239`)."""
    objective: str = "k"            # "v" | "k" | "vk"
    sigma_data: float = 0.1
    sigma_distribution: str = "lognormal"  # "lognormal" | "uniform" | "vk"
    sigma_mean: float = -1.2
    sigma_std: float = 1.2
    dynamic_threshold: float = 0.0


@dataclass(frozen=True)
class SamplingConfig:
    """ADPM2 + Karras schedule defaults (reference `generative.py:857-860`)."""
    sampler: str = "adpm2"          # "adpm2" | "aeuler" | "karras" | "v"
    num_steps: int = 100
    sigma_min: float = 1e-3
    sigma_max: float = 9.0
    rho: float = 3.0
    adpm2_rho: float = 1.0
    clamp: bool = False
    cond_scale: float = 1.0


@dataclass(frozen=True)
class QMDiffusionConfig:
    """Task-layer diffusion model config (reference `generative.py:31-225,718-914`)."""
    max_length: int = 1024
    channels: int = 128
    pred_dim: int = 1
    unet_type: str = "cfg"          # "cfg" | "base"
    pos_emb_fourier: bool = True
    pos_emb_fourier_add: bool = False
    text_embed_dim: int = 1024
    embed_dim_position: int = 64
    context_embedding_max_length: int = 32
    pre_transformer: int = 0        # 2 for the inverse model, 0 for forward
    patch_size: int = 4             # 4 forward / 1 inverse (cfg); 8 (base)
    num_blocks: Tuple[int, ...] = (3, 3)
    attentions: Tuple[int, ...] = (2, 2)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)

    @property
    def conditioning_features(self) -> int:
        if self.pos_emb_fourier and not self.pos_emb_fourier_add:
            return self.text_embed_dim + self.embed_dim_position
        return self.text_embed_dim


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    grad_clip_norm: float = 0.5
    batch_size: int = 1024
    epochs: int = 300
    print_loss_every: int = 10
    # In-epoch eval + checkpoint cadence (reference semantics: eval/save
    # every `print_loss` steps INSIDE the epoch, `generative.py:1139-1172`).
    # None = end-of-epoch only.
    eval_every_steps: Optional[int] = None
    # End-of-epoch checkpoint cadence: save every Nth epoch (the final
    # epoch of the run always saves so resume is exact).
    checkpoint_every_epochs: int = 1
    seed: int = 0
    # Split each batch into this many sequential micro-batches (grads
    # averaged before the single optimizer update): memory, not the update.
    accumulation_steps: int = 1
    # Run one micro-batch's forward and backward before the first step and
    # raise if its peak memory, with the optimizer state, would pass a
    # margin of the card's memory.  Only reports on the CPU.
    preflight_memory_check: bool = True
    # Host->device input lookahead (data/prefetch.py): assemble batches on
    # a worker thread and keep this many device batches in flight ahead of
    # the train step.  0 disables (synchronous feed).
    prefetch: int = 2
    # Checkpoint tier: "msgpack" (the port's single-file exact resume,
    # ``step_{N}.pt``) or "orbax" (JAX-only: refused by the port).
    checkpoint_backend: str = "msgpack"
    # Param/optimizer placement: "replicated" or "fsdp" (params and Adam
    # moments sharded over the ranks of the process group, FSDP2,
    # parallel/fsdp.py).
    param_sharding: str = "replicated"
    # FSDP only: parameters smaller than this stay whole on every rank.
    fsdp_min_elements: int = 16384
    # Learning-rate schedule: "constant" (reference parity — the notebooks
    # train fixed-LR Adam, `generative.py:1130-1134`) or "cosine"
    # (warmup + cosine decay to learning_rate * lr_min_ratio over
    # lr_decay_steps, after lr_warmup_steps of linear warmup from 0).
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_decay_steps: Optional[int] = None
    lr_min_ratio: float = 0.0


def forward_diffusion_qm9() -> QMDiffusionConfig:
    """QMDiffusionForward notebook preset: 18,322,684 params."""
    return QMDiffusionConfig(
        max_length=64, channels=64, pred_dim=1, unet_type="cfg",
        text_embed_dim=64, embed_dim_position=64,
        context_embedding_max_length=64,
        pre_transformer=0, patch_size=4,
        num_blocks=(3, 3), attentions=(2, 2),
    )


def inverse_diffusion_qm9(vocab_size: int = 22) -> QMDiffusionConfig:
    """QMDiffusion (inverse) notebook preset: 90,965,554 params at vocab 22."""
    return QMDiffusionConfig(
        max_length=32, channels=128, pred_dim=vocab_size, unet_type="cfg",
        text_embed_dim=64, embed_dim_position=64,
        context_embedding_max_length=12,
        pre_transformer=2, patch_size=1,
        num_blocks=(3, 3), attentions=(4, 4),
    )


@dataclass(frozen=True)
class TransformerConfig:
    """MoleculeTransformer* config (reference `transformer.py:543-1107`)."""
    dim: int = 128
    depth: int = 12
    logits_dim: int = 32
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    dropout: float = 0.0
    text_embed_dim: Optional[int] = None
    cond_drop_prob: float = 0.25
    max_text_len: int = 128
    embed_dim: int = 16             # SequenceInternaldim / GPT input embedding
    max_tokens: int = 32
    one_kv_head: bool = True


def inverse_transformer_qm9() -> TransformerConfig:
    """MoleculeTransformerSequence notebook preset: 2,407,712 params."""
    return TransformerConfig(dim=128, depth=12, heads=8, dim_head=16,
                             logits_dim=24, text_embed_dim=16, max_text_len=12)


@dataclass(frozen=True)
class EncoderConfig:
    """MoleculeTransformerSequenceEncoder config (reference `transformer.py:1125-1246`)."""
    dim: int = 256
    depth: int = 6
    heads: int = 16
    ff_mult: int = 4
    dropout: float = 0.0
    logits_dim: int = 12
    logits_dim_length: Optional[int] = 1
    max_length: Optional[int] = 64
    max_tokens: int = 32
    embed_dim: int = 16
    padding_token: int = 0


def forward_transformer_qm9() -> EncoderConfig:
    """Forward property-predictor notebook preset
    (Forward_Transformer.ipynb cell 57): 3,162,496 params; output
    (b, 1, 12) — one logits channel projected onto 12 property slots."""
    return EncoderConfig(dim=256, depth=6, heads=16, ff_mult=2,
                         logits_dim=1, logits_dim_length=12, max_length=64,
                         max_tokens=24, embed_dim=16, dropout=0.1)
