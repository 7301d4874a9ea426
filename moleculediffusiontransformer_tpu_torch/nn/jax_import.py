"""Load the JAX package's parameters into the port (counterpart of
`nn/torch_import.py::params_to_state_dict`, reimplemented with numpy so the
port never imports the JAX package's ``nn``).

A flax param tree is nested dicts keyed by module names in which torch
Sequential/ModuleList indices are merged into the name (``to_in_0``,
``blocks_1``, ``layers_0_2_1``); leaves are ``kernel``/``tkernel``/
``scale``/``embedding``/``bias``/``weights``, or a name kept as it is
(``in_proj_weight``, ``gamma``, ``null_k``, ``pos_bias``, the MoE's
``router``, ``w_in`` and ``w_out``).  The torch key splits the index tokens
back out (``to_in.0``, ``layers.0.2.1``, ``layers.0.1.moe``) and names the
leaf as torch does; conv and linear kernels (a depthwise conv's (k, 1, c)
too, to (c, 1, k)) and the attention's fused in-projection go back to torch
layout.  Every other leaf keeps its layout: the MoE's stacked (E, d, h) and
(E, h, d) experts and its (d, E) router, and the ``Embed`` tables
(``relative_attention_bias``).
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
    ``'downsamples.0.blocks.1.block1.project.weight'``.  Every '_'-token
    that is all digits is an index of its own; the tokens between are one
    attribute name (``layers_0_1_moe`` -> ``layers.0.1.moe``, the GPT's MoE
    feed-forward).  Digits inside an attribute name without '_'
    (``block1``) stay put."""
    segs: List[str] = []
    for seg in path:
        name: List[str] = []
        for token in seg.split("_"):
            if not token.isdigit():
                name.append(token)
                continue
            if name:
                segs.append("_".join(name))
                name = []
            segs.append(token)
        if name:
            segs.append("_".join(name))
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
