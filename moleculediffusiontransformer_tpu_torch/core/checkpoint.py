"""Checkpoint / resume (torch-native counterpart of `core/checkpoint.py`).

The reference saves a bare ``model.state_dict()`` and never persists the
optimizer (`generative.py:582-584,1168-1172`).  Here a checkpoint is one
``torch.save`` file holding the model's ``state_dict()``, the optimizer's
``AdamState`` (``mu`` and ``nu`` keyed by parameter name, so that a
reordered ``parameters()`` cannot misassign them, and ``count``, the lr
schedule's position), ``TrainState.step`` and ``TrainState.epoch`` (the
epochs completed), so resume is exact and its epochs keep their labels.
Step checkpoints are ``step_{N}.pt`` under a directory.

A restore lands on the model's device, whatever device saved the file.  A
model trained with FSDP (``parallel/fsdp.py``) is saved whole: its shards
and its moments' are gathered (a collective, on every rank), so the file is
the same however the model was trained and loads into any of them.  The
JAX package's second tier, ``core/checkpoint_orbax.py``, is JAX-only and
has no counterpart.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

FORMAT = "moleculediffusiontransformer_tpu_torch.checkpoint/1"


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a sharded tensor's full value (gathered: a collective)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def checkpoint_state(model: torch.nn.Module, state: Any = None) -> Dict:
    """What a checkpoint holds: the model's ``state_dict()`` and, when a
    ``train.trainer.TrainState`` is given, its Adam moments keyed by
    parameter name, their count, the step and the epochs completed; sharded
    tensors whole (every rank of their mesh calls this)."""
    out: Dict[str, Any] = {"format": FORMAT, "model": {
        k: _whole(v) for k, v in model.state_dict().items()}}
    if state is not None:
        names = [n for n, _ in model.named_parameters()]
        adam = state.opt_state
        out["adam"] = {"mu": dict(zip(names, map(_whole, adam.mu))),
                       "nu": dict(zip(names, map(_whole, adam.nu))),
                       "count": int(adam.count)}
        out["step"] = int(state.step)
        out["epoch"] = int(state.epoch)
    return out


def save_checkpoint(path: str, state: Dict) -> str:
    """Write ``state`` (a ``checkpoint_state`` dict) to ``path``: written
    beside it first, then renamed over it, so a reader never sees half a
    file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(state, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device: Optional[torch.device] = None
                    ) -> Dict:
    """The dict a port checkpoint holds, its tensors on ``device``; raises
    ``ValueError`` for a file that is not one."""
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if not (isinstance(ckpt, dict) and ckpt.get("format") == FORMAT):
        raise ValueError(f"{path} is not a checkpoint of this package")
    return ckpt


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model weights a file holds, on the CPU: a checkpoint of this
    package, or a reference-layout state dict -- a ``.pt``/``.pth`` file of
    tensors (the reference's checkpoints, README.md:44-60) or the
    ``.npz``/``.pt`` that an ``export-torch`` writes.  A JAX msgpack file
    itself cannot be read here: it crosses through the JAX package's
    ``export-torch``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    if not path.endswith((".pt", ".pth")):
        raise ValueError(
            f"{path}: expected a .pt/.pth or .npz file; a JAX msgpack "
            f"checkpoint crosses through `python -m "
            f"moleculediffusiontransformer_tpu export-torch --checkpoint "
            f"{path} --out model.npz`")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and sd.get("format") == FORMAT:
        sd = sd["model"]
    return sd


def restore_checkpoint(path: str, model: torch.nn.Module,
                       state: Any = None) -> Dict:
    """Load a checkpoint into ``model`` (strict keys) and, when given, into
    ``state`` (a ``TrainState``: Adam moments by parameter name, count,
    step, epochs completed), everything on the model's device.  Returns
    the checkpoint."""
    device = next(model.parameters()).device
    ckpt = load_checkpoint(path, device)
    model.load_state_dict(ckpt["model"], strict=True)
    if state is not None:
        if "adam" not in ckpt:
            raise ValueError(f"{path} holds no optimizer state to resume")
        names = [n for n, _ in model.named_parameters()]
        adam = ckpt["adam"]
        if set(adam["mu"]) != set(names) or set(adam["nu"]) != set(names):
            raise ValueError(f"{path}: the Adam moments name other "
                             f"parameters than the model's")
        state.opt_state.mu = [adam["mu"][n] for n in names]
        state.opt_state.nu = [adam["nu"][n] for n in names]
        state.opt_state.count = int(adam["count"])
        state.step = int(ckpt["step"])
        state.epoch = int(ckpt["epoch"])
    return ckpt


_STEP_RE = re.compile(r"step_(\d+)\.pt$")


def save_step_checkpoint(directory: str, state: Dict, step: int,
                         keep: int = 3) -> str:
    """Save ``step_{N}.pt`` under ``directory`` and prune all but the
    ``keep`` newest."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    save_checkpoint(path, state)
    steps = sorted(all_checkpoint_steps(directory))
    for old in steps[:-keep]:
        os.remove(os.path.join(directory, f"step_{old}.pt"))
    return path


def all_checkpoint_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.search(name)
        if m:
            out.append(int(m.group(1)))
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = all_checkpoint_steps(directory)
    if not steps:
        return None
    return os.path.join(directory, f"step_{max(steps)}.pt")
