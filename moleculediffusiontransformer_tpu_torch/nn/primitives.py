"""Low-level NN primitives, channels-last (port of `nn/primitives.py`).

Every module takes and returns ``(batch, length, channels)`` tensors, like its
JAX twin.  Parameters are stored in float32 under the reference torch names
and layouts (``weight`` (out, in[, k]) for linears and convs, ``weight``
(in, out, k) for transposed convs, ``weight``/``bias`` for norms, ``weight``
for embedding tables); ``dtype`` is the compute dtype, to which inputs and
weights are cast at use, as the JAX modules do.  Norm statistics are always
float32.

Over a mesh (``parallel/``): a parameter that tensor parallelism shards is a
``DTensor`` shard, and a product on it runs as ``parallel.tp.product``; a
module whose ``seq_axis`` is set (sequence parallelism, ``parallel/sp.py``)
holds its rows' slice of the length, and a conv with a window across it or a
norm over it runs as ``parallel.sp`` has it.  Both are imported on first use.

Init matches torch's defaults (and the JAX package's): U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for linear/conv weights and biases, N(0, 1) for embedding
tables.  Every module's ``reset_parameters`` takes an optional
``torch.Generator``; :func:`init_parameters` re-initialises a whole tree from
one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — torch's default, and the JAX package's ``gelu``."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p``, or the whole tensor of a tensor-parallel shard."""
    if isinstance(p, DTensor):
        from ..parallel import tp
        return tp.full(p)
    return p


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every primitive in ``module`` from ``generator``, in
    module order (deterministic for a given seed and architecture)."""
    package = __name__.split(".")[0]
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None and type(m).__module__.startswith(package):
            reset(generator)


class Dense(nn.Module):
    """Linear layer; ``weight`` (out, in), ``bias`` (out,).  Computes in
    ``dtype`` (JAX: dot in dtype, then + bias in dtype)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.weight, DTensor):
            from ..parallel import tp
            return tp.product(self, x, F.linear)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Conv1d(nn.Module):
    """1-D convolution over (b, L, C) with torch padding semantics;
    ``weight`` (out, in, k)."""

    seq_axis = None

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.kernel_size = in_channels, kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.in_channels * self.kernel_size)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq_axis is not None and self.kernel_size + self.stride > 2:
            from ..parallel import sp
            return sp.conv1d(self, x)
        if isinstance(self.weight, DTensor):
            from ..parallel import tp
            return tp.product(self, x, lambda xx, w: F.conv1d(
                xx.transpose(1, 2), w, stride=self.stride,
                padding=self.padding).transpose(1, 2))
        y = F.conv1d(x.to(self.dtype).transpose(1, 2),
                     self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution matching torch ``ConvTranspose1d``;
    ``weight`` (in, out, k) — the JAX ``tkernel`` in torch layout."""

    seq_axis = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels, self.kernel_size = out_channels, kernel_size
        self.stride, self.padding = stride, padding
        self.output_padding, self.dtype = output_padding, dtype
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # torch's fan_in for a (in, out, k) transposed-conv weight is out * k
        bound = 1.0 / math.sqrt(self.out_channels * self.kernel_size)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq_axis is not None:
            from ..parallel import sp
            return sp.conv_transpose1d(self, x)
        if isinstance(self.weight, DTensor):
            from ..parallel import tp
            return tp.product(self, x, lambda xx, w: F.conv_transpose1d(
                xx.transpose(1, 2), w, stride=self.stride,
                padding=self.padding,
                output_padding=self.output_padding).transpose(1, 2))
        y = F.conv_transpose1d(x.to(self.dtype).transpose(1, 2),
                               self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=self.stride,
                               padding=self.padding,
                               output_padding=self.output_padding)
        return y.transpose(1, 2)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, seq_axis=None) -> torch.Tensor:
    """Channels-last GroupNorm in float32 (biased variance, contiguous
    channel groups); returns float32.  With ``seq_axis`` (a
    ``parallel.collectives.Axis``: x holds this rank's slice of the length)
    each statistic is the sum of the ranks' sums, in two passes as here."""
    b, length, c = x.shape
    xf = x.float().reshape(b, length, num_groups, c // num_groups)
    if seq_axis is None:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        from ..parallel import sp
        mean, var = sp.group_stats(xf, seq_axis)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, length, c)
    return xn * weight.float() + bias.float()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32; returns float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()


class GroupNorm(nn.Module):
    """Group normalization over (b, L, C), fp32 stats, torch-exact
    (default eps 1e-5; Transformer1d uses 1e-6)."""

    seq_axis = None

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert num_channels % num_groups == 0, (
            f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, self.seq_axis).to(self.dtype)


class LayerNorm(nn.Module):
    """Layer norm over the last axis, fp32 stats, eps 1e-5."""

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps).to(self.dtype)


class Embed(nn.Module):
    """Embedding table ``weight`` (num, features), N(0, 1) init."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return whole(self.weight)[ids].to(self.dtype)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(b, L*p, c) -> (b, L, c*p); channel index = c*p + within-patch offset
    (the reference's ``b c (l p) -> b (c p) l``)."""
    b, lp, c = x.shape
    p = patch_size
    return x.reshape(b, lp // p, p, c).transpose(2, 3).reshape(
        b, lp // p, c * p)


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(b, L, c*p) -> (b, L*p, c): inverse of :func:`patchify`."""
    b, length, cp = x.shape
    p = patch_size
    return x.reshape(b, length, cp // p, p).transpose(2, 3).reshape(
        b, length * p, cp // p)
