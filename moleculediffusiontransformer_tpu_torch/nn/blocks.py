"""Convolutional blocks of the 1-D UNet (port of `nn/blocks.py`).

Channels-last throughout; attribute names are the reference's torch names,
so ``state_dict`` keys match the JAX package's export one to one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .primitives import (Conv1d, ConvTranspose1d, Dense, GroupNorm, patchify,
                         silu, unpatchify)


def downsample1d(in_channels: int, out_channels: int, factor: int,
                 kernel_multiplier: int = 2,
                 dtype: torch.dtype = torch.float32) -> Conv1d:
    """Strided-conv downsampling: kernel factor*mult+1, stride factor."""
    assert kernel_multiplier % 2 == 0, "Kernel multiplier must be even"
    return Conv1d(in_channels, out_channels,
                  kernel_size=factor * kernel_multiplier + 1, stride=factor,
                  padding=factor * (kernel_multiplier // 2), dtype=dtype)


class _NearestUpsample(nn.Module):
    """Length-axis nearest repeat (the reference's ``nn.Upsample``)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, self.factor, dim=1)


def upsample1d(in_channels: int, out_channels: int, factor: int,
               use_nearest: bool = False,
               dtype: torch.dtype = torch.float32) -> nn.Module:
    """Upsampling: transposed conv (kernel 2f, stride f, padding
    f//2 + f%2, output_padding f%2) by default, or nearest-repeat + conv."""
    if factor == 1:
        return Conv1d(in_channels, out_channels, kernel_size=3, padding=1,
                      dtype=dtype)
    if use_nearest:
        return nn.Sequential(
            _NearestUpsample(factor),
            Conv1d(in_channels, out_channels, kernel_size=3, padding=1,
                   dtype=dtype))
    return ConvTranspose1d(in_channels, out_channels, kernel_size=factor * 2,
                           stride=factor, padding=factor // 2 + factor % 2,
                           output_padding=factor % 2, dtype=dtype)


class ConvBlock1d(nn.Module):
    """GroupNorm -> (FiLM scale-shift) -> SiLU -> Conv1d (k 3, padding 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groupnorm = GroupNorm(num_groups, in_channels, dtype=dtype)
        self.project = Conv1d(in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return self.project(silu(x))


class MappingToScaleShift(nn.Module):
    """FiLM head: mapping (b, features) -> (scale, shift), each
    (b, 1, channels)."""

    def __init__(self, features: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.to_scale_shift = nn.Sequential(
            nn.SiLU(), Dense(features, channels * 2, dtype=dtype))

    def forward(self, mapping: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ss = self.to_scale_shift(mapping)[:, None, :]
        scale, shift = ss.chunk(2, dim=-1)
        return scale, shift


class ResnetBlock1d(nn.Module):
    """Two ConvBlocks with FiLM conditioning from ``mapping`` plus a 1x1
    skip projection when the width changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 8,
                 context_mapping_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_mapping = context_mapping_features is not None
        self.block1 = ConvBlock1d(in_channels, out_channels,
                                  num_groups=num_groups, dtype=dtype)
        if self.use_mapping:
            self.to_scale_shift = MappingToScaleShift(
                context_mapping_features, out_channels, dtype=dtype)
        self.block2 = ConvBlock1d(out_channels, out_channels,
                                  num_groups=num_groups, dtype=dtype)
        if in_channels != out_channels:
            self.to_out = Conv1d(in_channels, out_channels, kernel_size=1,
                                 padding=0, dtype=dtype)
        else:
            self.to_out = None

    def forward(self, x: torch.Tensor,
                mapping: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert not (self.use_mapping ^ (mapping is not None)), \
            "context mapping required iff use_mapping"
        h = self.block1(x)
        scale_shift = self.to_scale_shift(mapping) if self.use_mapping \
            else None
        h = self.block2(h, scale_shift=scale_shift)
        if self.to_out is not None:
            x = self.to_out(x)
        return h + x


class Patcher(nn.Module):
    """ResnetBlock (GroupNorm(1)) then length->channel patchify:
    (b, L*p, c_in) -> (b, L, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert out_channels % patch_size == 0, \
            f"out_channels must be divisible by patch_size ({patch_size})"
        self.patch_size = patch_size
        self.block = ResnetBlock1d(
            in_channels, out_channels // patch_size, num_groups=1,
            context_mapping_features=context_mapping_features, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mapping: Optional[torch.Tensor] = None) -> torch.Tensor:
        return patchify(self.block(x, mapping), self.patch_size)


class Unpatcher(nn.Module):
    """Channel->length unpatchify then ResnetBlock (GroupNorm(1)):
    (b, L, c_in) -> (b, L*p, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert in_channels % patch_size == 0, \
            f"in_channels must be divisible by patch_size ({patch_size})"
        self.patch_size = patch_size
        self.block = ResnetBlock1d(
            in_channels // patch_size, out_channels, num_groups=1,
            context_mapping_features=context_mapping_features, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mapping: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.block(unpatchify(x, self.patch_size), mapping)


class ConditionedSequential(nn.Module):
    """Sequential whose modules all take ``(x, mapping)``."""

    def __init__(self, *modules: nn.Module):
        super().__init__()
        self.modules_list = nn.ModuleList(modules)

    def forward(self, x: torch.Tensor,
                mapping: Optional[torch.Tensor] = None) -> torch.Tensor:
        for module in self.modules_list:
            x = module(x, mapping)
        return x
