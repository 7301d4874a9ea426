"""Time / position / number embeddings (port of `nn/embeddings.py`): the
random-Fourier sigma embedding, the CFG null table, the sinusoidal integer
embedding, ``NumberEmbedder`` (scalars through the sigma embedding, the NCCA
UNet's noise-scale features) and the non-learned 1-D, 2-D and 3-D Fourier
position codes, computed host-side in numpy float32 as the JAX package
computes them (the 1-D code is kept on its device once made)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .primitives import Dense, Embed, default_init, whole


def sinusoidal_embedding(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Log-spaced sin/cos embedding of integers (b,) -> (b, dim) float32."""
    half_dim = dim // 2
    emb = math.log(10000) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=x.device) * -emb)
    emb = x[:, None].float() * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class LearnedPositionalEmbedding(nn.Module):
    """Random-Fourier embedding for continuous time/sigma:
    ``[x, sin(2 pi w x), cos(2 pi w x)]``; ``weights`` (dim/2,), N(0, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.empty(dim // 2))
        default_init(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weights.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        freqs = x * self.weights[None, :].float() * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def time_positional_embedding(dim: int, out_features: int,
                              dtype: torch.dtype = torch.float32
                              ) -> nn.Sequential:
    """The reference ``TimePositionalEmbedding``: Sequential(learned Fourier
    embedding, Linear(dim + 1, out)) — children ``0`` / ``1``."""
    return nn.Sequential(LearnedPositionalEmbedding(dim),
                         Dense(dim + 1, out_features, dtype=dtype))


class FixedEmbedding(nn.Module):
    """Learned positional table — the CFG "null" conditioning.  The output
    depends only on the input's (batch, length), never its values."""

    def __init__(self, max_length: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_length = max_length
        self.embedding = Embed(max_length, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, length = x.shape[0], x.shape[1]
        assert length <= self.max_length, "sequence length > max_length"
        emb = whole(self.embedding.weight)[:length].to(self.embedding.dtype)
        return emb[None].expand(batch, length, emb.shape[-1])


class NumberEmbedder(nn.Module):
    """Scalars of any shape -> shape + (features,): each through the
    random-Fourier embedding and a Dense (``embedding.0`` / ``embedding.1``,
    the reference's names)."""

    def __init__(self, features: int, dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.embedding = time_positional_embedding(dim, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return self.embedding(x.reshape(-1)).reshape(*x.shape, self.features)


def _fourier_inv_freq(channels: int) -> np.ndarray:
    return 1.0 / (10000 ** (np.arange(0, channels, 2, dtype=np.float32)
                            / channels))


def _fourier(n: int, inv_freq: np.ndarray) -> np.ndarray:
    """[sin(w x) ..., cos(w x) ...] at positions 0 .. n - 1."""
    s = np.einsum("i,j->ij", np.arange(n, dtype=np.float32), inv_freq)
    return np.concatenate([np.sin(s), np.cos(s)], axis=-1)


def _to_torch(a: np.ndarray, dtype: torch.dtype,
              device: Optional[torch.device]) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def positional_encoding_1d(length: int, channels: int,
                           dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """Non-learned sinusoidal 1-D positional encoding, (length, channels):
    ``[sin(w0 x) ... sin(wn x), cos(w0 x) ... cos(wn x)]``, zero-padded and
    truncated to ``channels``.  Computed in numpy float32, as the JAX
    package does, and copied to ``device`` once: the float32 code is kept
    there (read-only) and handed to every later call, so that a model's
    forward makes no copy from the host, and a program traced by
    ``torch.export`` holds the code as a device constant."""
    key = (length, channels, torch.device(device or "cpu"))
    code = _POSITION_CODES.get(key)
    if code is None:
        ch = int(np.ceil(channels / 2) * 2)
        emb = _fourier(length, _fourier_inv_freq(ch))
        out = np.zeros((length, ch), dtype=np.float32)
        out[:, :emb.shape[1]] = emb
        code = _to_torch(out[:, :channels], torch.float32, device)
        if not torch.compiler.is_compiling():    # a traced value is fake
            _POSITION_CODES[key] = code
    return code.to(dtype)


_POSITION_CODES: dict = {}


def positional_encoding_2d(nx: int, ny: int, channels: int,
                           dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """(nx, ny, channels) sinusoidal 2-D encoding: the x code in the first
    quarter-rounded half of the channels, the y code in the second."""
    ch = int(np.ceil(channels / 4) * 2)
    inv_freq = _fourier_inv_freq(ch)
    out = np.zeros((nx, ny, ch * 2), dtype=np.float32)
    out[:, :, :ch] = _fourier(nx, inv_freq)[:, None, :]
    out[:, :, ch:2 * ch] = _fourier(ny, inv_freq)[None, :, :]
    return _to_torch(out[:, :, :channels], dtype, device)


def positional_encoding_3d(nx: int, ny: int, nz: int, channels: int,
                           dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """(nx, ny, nz, channels) sinusoidal 3-D encoding: x, y and z codes in
    three equal, even runs of channels."""
    ch = int(np.ceil(channels / 6) * 2)
    if ch % 2:
        ch += 1
    inv_freq = _fourier_inv_freq(ch)
    out = np.zeros((nx, ny, nz, ch * 3), dtype=np.float32)
    out[..., :ch] = _fourier(nx, inv_freq)[:, None, None, :]
    out[..., ch:2 * ch] = _fourier(ny, inv_freq)[None, :, None, :]
    out[..., 2 * ch:] = _fourier(nz, inv_freq)[None, None, :, :]
    return _to_torch(out[..., :channels], dtype, device)
