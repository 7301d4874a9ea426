"""Small helpers of the port (counterpart of `core/utils.py`).

Only ``count_parameters`` is ported: the reference's prefix-routed kwargs
helpers configure modules the port builds from explicit arguments.
"""
from __future__ import annotations

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
