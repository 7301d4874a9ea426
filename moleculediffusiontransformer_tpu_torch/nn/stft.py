"""STFT / inverse-STFT codec (port of `nn/stft.py`; reference
`modules.py:1389-1472`), on ``torch.fft.rfft`` / ``irfft``.

The JAX definition, kept as it is: center framing with reflect padding of
``n_fft // 2``, a Hann window (zero-padded to ``n_fft`` when shorter), the
spectrum scaled by ``n_fft ** -0.5`` (torch's ``normalized=True``), onesided.
The inverse is the least-squares one: the overlap-add of the windowed frames
divided by the window-square envelope, floored at 1e-11.  ``torch.istft`` is
not used: its envelope check and padding differ.  Overlap-adds are
``F.fold``, which gathers and so sums in a fixed order on the card.

Waves are channels-last (b, L, C); spectrograms (b, C, F, T), as the
reference lays them out.  Computed in float32 whatever the input's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.utils import closest_power_2


def _hann(window_length: int, n_fft: int) -> np.ndarray:
    w = np.hanning(window_length + 1)[:-1].astype(np.float32)
    if window_length < n_fft:
        pad = (n_fft - window_length) // 2
        w = np.pad(w, (pad, n_fft - window_length - pad))
    return w


class STFT:
    """Stateless STFT helper (no learnable parameters)."""

    def __init__(self, num_fft: int = 1023, hop_length: Optional[int] = 256,
                 window_length: Optional[int] = None,
                 length: Optional[int] = None, use_complex: bool = False):
        self.num_fft = num_fft
        self.hop_length = hop_length if hop_length is not None \
            else num_fft // 4
        self.window_length = window_length if window_length is not None \
            else num_fft
        self.length = length
        self.use_complex = use_complex
        self.window = torch.from_numpy(_hann(self.window_length, num_fft))

    @property
    def freq_bins(self) -> int:
        return self.num_fft // 2 + 1

    def _window(self, device: torch.device) -> torch.Tensor:
        if self.window.device != device:
            self.window = self.window.to(device)
        return self.window

    def _overlap_add(self, frames: torch.Tensor, t: int) -> torch.Tensor:
        """(n, T, n_fft) frames -> (n, n_fft + hop (T - 1)) sums."""
        total = self.num_fft + self.hop_length * (t - 1)
        out = F.fold(frames.transpose(1, 2), output_size=(1, total),
                     kernel_size=(1, self.num_fft),
                     stride=(1, self.hop_length))
        return out.reshape(frames.shape[0], total)

    def encode(self, wave: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """wave (b, L, C) -> (stft_a, stft_b), each (b, C, F, T):
        magnitude and phase, or real and imaginary parts with
        ``use_complex``."""
        b, length, c = wave.shape
        n_fft, pad = self.num_fft, self.num_fft // 2
        flat = wave.float().transpose(1, 2).reshape(b * c, 1, length)
        flat = F.pad(flat, (pad, pad), mode="reflect")[:, 0]
        frames = flat.unfold(1, n_fft, self.hop_length)  # (n, T, n_fft)
        frames = frames * self._window(wave.device)
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1) * (n_fft ** -0.5)
        spec = spec.transpose(1, 2)                       # (n, F, T)
        if self.use_complex:
            a, bb = spec.real, spec.imag
        else:
            a, bb = spec.abs(), spec.angle()
        shape = (b, c, self.freq_bins, spec.shape[-1])
        return a.reshape(shape), bb.reshape(shape)

    def decode(self, stft_a: torch.Tensor,
               stft_b: torch.Tensor) -> torch.Tensor:
        """A (b, C, F, T) pair -> wave (b, L, C), L = ``length`` or the
        power of two nearest T * hop."""
        b, c, f, t = stft_a.shape
        length = self.length if self.length is not None else \
            closest_power_2(t * self.hop_length)
        a, bb = stft_a.float(), stft_b.float()
        if self.use_complex:
            spec = torch.complex(a, bb)
        else:
            spec = torch.complex(a * torch.cos(bb), a * torch.sin(bb))
        spec = spec.reshape(b * c, f, t) * (self.num_fft ** 0.5)
        frames = torch.fft.irfft(spec.transpose(1, 2), n=self.num_fft,
                                 dim=-1)                  # (n, T, n_fft)
        window = self._window(frames.device)
        wave = self._overlap_add(frames * window, t)
        env = self._overlap_add(
            (window * window).expand(1, t, self.num_fft), t)
        wave = wave / env.clamp(min=1e-11)
        pad = self.num_fft // 2
        wave = wave[:, pad:pad + length]
        return wave.reshape(b, c, -1).transpose(1, 2)

    def encode1d(self, wave: torch.Tensor, stacked: bool = True
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(b, L, C) -> (b, T, 2 C F), the channels-last flattened codec
        (reference `modules.py:1459-1465` in this layout), or its two
        (b, T, C F) halves."""
        a, bb = self.encode(wave)
        b_, c, f, t = a.shape
        out_a = a.reshape(b_, c * f, t).transpose(1, 2)
        out_b = bb.reshape(b_, c * f, t).transpose(1, 2)
        if stacked:
            return torch.cat([out_a, out_b], dim=-1)
        return out_a, out_b

    def decode1d(self, stft_pair: torch.Tensor) -> torch.Tensor:
        """(b, T, 2 C F) -> wave (b, L, C)."""
        f = self.freq_bins
        b, t, two_cf = stft_pair.shape
        cf = two_cf // 2
        c = cf // f
        a = stft_pair[..., :cf].transpose(1, 2).reshape(b, c, f, t)
        bb = stft_pair[..., cf:].transpose(1, 2).reshape(b, c, f, t)
        return self.decode(a, bb)
