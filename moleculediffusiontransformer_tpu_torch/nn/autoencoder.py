"""Convolutional encoder, decoder and autoencoder (port of
`nn/autoencoder.py`; reference `modules.py:1482-1684`), the latent side of
the diffusion autoencoder.  Channels-last (b, L, C); submodule names are
the JAX package's (``to_in``, ``downsamples.i``, ``upsamples.i``,
``to_out``), so its params load with ``strict=True``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .blocks import Patcher, Unpatcher
from .primitives import Conv1d
from .unet import DownsampleBlock1d, UpsampleBlock1d

Output = Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]


class TanhBottleneck(nn.Module):
    """A concrete bottleneck: tanh of the latent (the reference ships only
    the abstract base, `modules.py:1482-1486`)."""

    def forward(self, x: torch.Tensor, with_info: bool = False) -> Output:
        out = torch.tanh(x)
        return (out, {}) if with_info else out


class Encoder1d(nn.Module):
    """Patcher -> one DownsampleBlock1d a layer -> [1x1 out conv] ->
    bottlenecks (reference `modules.py:1489-1559`)."""

    def __init__(self, in_channels: int, channels: int,
                 multipliers: Sequence[int], factors: Sequence[int],
                 num_blocks: Sequence[int], patch_size: int = 1,
                 resnet_groups: int = 8, out_channels: Optional[int] = None,
                 bottlenecks: Sequence[nn.Module] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_layers = len(multipliers) - 1
        assert len(factors) == num_layers and len(num_blocks) == num_layers
        self.channels, self.multipliers = channels, tuple(multipliers)
        self.factors, self.patch_size = tuple(factors), patch_size
        self.out_channels = out_channels
        self.to_in = Patcher(in_channels, channels * multipliers[0],
                             patch_size, dtype=dtype)
        self.downsamples = nn.ModuleList([
            DownsampleBlock1d(
                in_channels=channels * multipliers[i],
                out_channels=channels * multipliers[i + 1],
                factor=factors[i], num_groups=resnet_groups,
                num_layers=num_blocks[i], dtype=dtype)
            for i in range(num_layers)])
        self.to_out = (Conv1d(channels * multipliers[-1], out_channels,
                              kernel_size=1, padding=0, dtype=dtype)
                       if out_channels is not None else None)
        self.bottlenecks = nn.ModuleList(bottlenecks)

    @property
    def downsample_factor(self) -> int:
        f = self.patch_size
        for x in self.factors:
            f *= x
        return f

    @property
    def encoded_channels(self) -> int:
        return (self.out_channels if self.out_channels is not None
                else self.channels * self.multipliers[-1])

    def forward(self, x: torch.Tensor, with_info: bool = False) -> Output:
        xs = [x]
        x = self.to_in(x)
        xs.append(x)
        for down in self.downsamples:
            x = down(x)
            xs.append(x)
        if self.to_out is not None:
            x = self.to_out(x)
        xs.append(x)
        info: Dict[str, Any] = dict(xs=xs)
        for bottleneck in self.bottlenecks:
            x, info_b = bottleneck(x, with_info=True)
            info.update({f"bottleneck_{k}": v for k, v in info_b.items()})
        return (x, info) if with_info else x


class Decoder1d(nn.Module):
    """[1x1 in conv] -> one UpsampleBlock1d a layer -> Unpatcher
    (reference `modules.py:1562-1623`)."""

    def __init__(self, out_channels: int, channels: int,
                 multipliers: Sequence[int], factors: Sequence[int],
                 num_blocks: Sequence[int], patch_size: int = 1,
                 resnet_groups: int = 8, in_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_layers = len(multipliers) - 1
        assert len(factors) == num_layers and len(num_blocks) == num_layers
        self.to_in = (Conv1d(in_channels, channels * multipliers[0],
                             kernel_size=1, padding=0, dtype=dtype)
                      if in_channels is not None else None)
        self.upsamples = nn.ModuleList([
            UpsampleBlock1d(
                in_channels=channels * multipliers[i],
                out_channels=channels * multipliers[i + 1],
                factor=factors[i], num_groups=resnet_groups,
                num_layers=num_blocks[i], dtype=dtype)
            for i in range(num_layers)])
        self.to_out = Unpatcher(channels * multipliers[-1], out_channels,
                                patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor, with_info: bool = False) -> Output:
        xs = [x]
        if self.to_in is not None:
            x = self.to_in(x)
        xs.append(x)
        for up in self.upsamples:
            x = up(x)
            xs.append(x)
        x = self.to_out(x)
        xs.append(x)
        return (x, dict(xs=xs)) if with_info else x


class AutoEncoder1d(nn.Module):
    """Encoder + mirrored decoder (reference `modules.py:1626-1684`)."""

    def __init__(self, in_channels: int, channels: int,
                 multipliers: Sequence[int], factors: Sequence[int],
                 num_blocks: Sequence[int], patch_size: int = 1,
                 resnet_groups: int = 8, out_channels: Optional[int] = None,
                 bottleneck_channels: Optional[int] = None,
                 bottlenecks: Sequence[nn.Module] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = Encoder1d(
            in_channels=in_channels, out_channels=bottleneck_channels,
            channels=channels, multipliers=multipliers, factors=factors,
            num_blocks=num_blocks, patch_size=patch_size,
            resnet_groups=resnet_groups, bottlenecks=bottlenecks,
            dtype=dtype)
        self.decoder = Decoder1d(
            in_channels=bottleneck_channels,
            out_channels=(out_channels if out_channels is not None
                          else in_channels),
            channels=channels, multipliers=tuple(multipliers)[::-1],
            factors=tuple(factors)[::-1], num_blocks=tuple(num_blocks)[::-1],
            patch_size=patch_size, resnet_groups=resnet_groups, dtype=dtype)

    def forward(self, x: torch.Tensor, with_info: bool = False) -> Output:
        z, info_e = self.encoder(x, with_info=True)
        y, info_d = self.decoder(z, with_info=True)
        info = {"latent": z,
                **{f"encoder_{k}": v for k, v in info_e.items()},
                **{f"decoder_{k}": v for k, v in info_d.items()}}
        return (y, info) if with_info else y

    def encode(self, x: torch.Tensor, with_info: bool = False) -> Output:
        return self.encoder(x, with_info=with_info)

    def decode(self, z: torch.Tensor, with_info: bool = False) -> Output:
        return self.decoder(z, with_info=with_info)
