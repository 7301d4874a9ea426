"""Load the JAX package's parameters into the port (counterpart of
`nn/torch_import.py::params_to_state_dict`, reimplemented with numpy so the
port never imports the JAX package's ``nn``).

A flax param tree is nested dicts keyed by module names in which torch
Sequential/ModuleList indices are merged into the name (``to_in_0``,
``blocks_1``, ``layers_0_2_1``); leaves are ``kernel``/``tkernel``/
``scale``/``embedding``/``bias``/``weights``, or a torch name kept as it is
(``in_proj_weight``, ``gamma``).  The torch key splits the trailing index
tokens back out (``to_in.0``, ``layers.0.2.1``) and names the leaf as torch
does; conv and linear kernels and the attention's fused in-projection go
back to torch layout.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax leaf name -> torch leaf name
_LEAF_NAMES = {"kernel": "weight", "tkernel": "weight", "scale": "weight",
               "embedding": "weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def torch_key(path: Tuple[str, ...]) -> str:
    """``('downsamples_0', 'blocks_1', 'block1', 'project', 'weight')`` ->
    ``'downsamples.0.blocks.1.block1.project.weight'``.  Digits inside an
    attribute name without '_' (``block1``) stay put."""
    segs: List[str] = []
    for seg in path:
        tokens = seg.split("_")
        i = len(tokens)
        while i > 1 and tokens[i - 1].isdigit():
            i -= 1
        segs.append("_".join(tokens[:i]))
        segs.extend(tokens[i:])
    return ".".join(segs)


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 3:                 # conv (k, in, out) -> (out, in, k)
            return np.transpose(value, (2, 1, 0))
        return np.transpose(value, (1, 0))  # linear (in, out) -> (out, in)
    if leaf == "tkernel":                  # convT (k, in, out) -> (in, out, k)
        return np.transpose(value, (1, 2, 0))
    if leaf == "in_proj_weight":           # torch MHA (d, 3d) -> (3d, d)
        return np.transpose(value, (1, 0))
    return value


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays) -> the port's ``state_dict``
    (float32 CPU tensors in torch layouts)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        leaf = path[-1]
        key = torch_key(path[:-1] + (_LEAF_NAMES.get(leaf, leaf),))
        if key in out:
            raise KeyError(f"two JAX params map to the torch key {key!r}")
        arr = np.ascontiguousarray(
            _to_torch_layout(leaf, np.asarray(value, dtype=np.float32)))
        out[key] = torch.tensor(arr)
    return out
