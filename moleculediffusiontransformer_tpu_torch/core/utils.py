"""Small helpers of the port (counterpart of `core/utils.py`).

Only ``count_parameters`` and ``closest_power_2`` are ported: the
reference's prefix-routed kwargs helpers configure modules the port builds
from explicit arguments.
"""
from __future__ import annotations

import math
from typing import Iterable, Union

import torch


def count_parameters(params: Union[torch.nn.Module, Iterable[torch.Tensor]],
                     verbose: bool = True) -> int:
    """Total number of scalars in a module's parameters (or in an iterable
    of tensors), as the JAX package counts the leaves of a parameter tree
    (analog of reference `utils.py:18-26`)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    total = sum(int(p.numel()) for p in params)
    if verbose:
        print("-" * 100)
        print(f"Total parameters: {total} trainable parameters: {total}")
        print("-" * 100)
    return total


def closest_power_2(x: float) -> int:
    """Nearest power of two to ``x`` (reference `utils.py:58-62`); a tie
    goes to the smaller."""
    exponent = math.log2(x)
    candidates = (math.floor(exponent), math.ceil(exponent))
    exponent_closest = min(candidates, key=lambda z: abs(x - 2 ** z))
    return 2 ** int(exponent_closest)
