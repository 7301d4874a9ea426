"""Windowed-sinc resampling along the length axis (port of `nn/dsp.py`;
reference `utils.py:95-130`, of torchaudio's lineage), channels-last.

The sinc kernel bank is computed on the host with numpy, exactly as the JAX
package computes it (static for given factors), and applied as one strided
``F.conv1d`` with the channels folded into the batch: each channel is
resampled on its own, the ``factor_out`` output phases interleaved.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_kernels(factor_in: int, factor_out: int, rolloff: float = 0.99,
                  lowpass_filter_width: int = 6) -> Tuple[np.ndarray, int]:
    """The kernel bank (factor_out, 1, kw), torch's conv layout, and the
    left pad width, as the reference builds them."""
    base_factor = min(factor_in, factor_out) * rolloff
    width = math.ceil(lowpass_filter_width * factor_in / base_factor)
    idx = np.arange(-width, width + factor_in, dtype=np.float64)[None, None] \
        / factor_in
    t = (np.arange(0, -factor_out, step=-1,
                   dtype=np.float64)[:, None, None] / factor_out + idx)
    t = np.clip(t * base_factor, -lowpass_filter_width,
                lowpass_filter_width) * math.pi
    window = np.cos(t / lowpass_filter_width / 2) ** 2
    scale = base_factor / factor_in
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    return (kernels * window * scale).astype(np.float32), width


def resample(x: torch.Tensor, factor_in: int, factor_out: int,
             rolloff: float = 0.99,
             lowpass_filter_width: int = 6) -> torch.Tensor:
    """Sinc-interpolation resampling of (b, L, C) along L, to
    ``int(factor_out * L / factor_in)`` samples, computed in x's dtype."""
    b, length, c = x.shape
    length_target = int(factor_out * length / factor_in)
    kernels, width = _sinc_kernels(factor_in, factor_out, rolloff,
                                   lowpass_filter_width)
    weight = torch.from_numpy(kernels).to(device=x.device, dtype=x.dtype)
    mono = x.transpose(1, 2).reshape(b * c, 1, length)
    mono = F.pad(mono, (width, width + factor_in))
    out = F.conv1d(mono, weight, stride=factor_in)     # (b*c, factor_out, l)
    out = out.transpose(1, 2).reshape(b * c, -1)[:, :length_target]
    return out.reshape(b, c, length_target).transpose(1, 2)


def downsample(x: torch.Tensor, factor: int, **kwargs) -> torch.Tensor:
    return resample(x, factor_in=factor, factor_out=1, **kwargs)


def upsample(x: torch.Tensor, factor: int, **kwargs) -> torch.Tensor:
    return resample(x, factor_in=1, factor_out=factor, **kwargs)
