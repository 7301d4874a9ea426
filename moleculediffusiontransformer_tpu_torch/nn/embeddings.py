"""Time / position embeddings of the denoiser (port of `nn/embeddings.py`):
the random-Fourier sigma embedding, the CFG null table and the non-learned
1-D Fourier code of the conditioning head."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .primitives import Dense, Embed


class LearnedPositionalEmbedding(nn.Module):
    """Random-Fourier embedding for continuous time/sigma:
    ``[x, sin(2 pi w x), cos(2 pi w x)]``; ``weights`` (dim/2,), N(0, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.empty(dim // 2))
        self.reset_parameters()

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
        emb = self.embedding.weight[:length].to(self.embedding.dtype)
        return emb[None].expand(batch, length, emb.shape[-1])


def positional_encoding_1d(length: int, channels: int,
                           dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """Non-learned sinusoidal 1-D positional encoding, (length, channels):
    ``[sin(w0 x) ... sin(wn x), cos(w0 x) ... cos(wn x)]``, zero-padded and
    truncated to ``channels``.  Computed in numpy float32, as the JAX
    package does."""
    ch = int(np.ceil(channels / 2) * 2)
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float32) / ch))
    pos = np.arange(length, dtype=np.float32)
    sin_inp = np.einsum("i,j->ij", pos, inv_freq)
    emb = np.concatenate([np.sin(sin_inp), np.cos(sin_inp)], axis=-1)
    out = np.zeros((length, ch), dtype=np.float32)
    out[:, :emb.shape[1]] = emb
    return torch.from_numpy(out[:, :channels].copy()).to(
        device=device, dtype=dtype)
