"""Shared plumbing for the PyTorch port's example scripts (the counterpart
of ``examples/common.py``): the same flags plus ``--device``, and the QM9
data through the port's own ``data/qm9.py``."""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", default=None,
                   help="path to qm9_.csv (reference dataset); synthetic "
                        "stand-in when omitted")
    p.add_argument("--rows", type=int, default=None,
                   help="cap dataset rows (full CSV when omitted)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="scale the model down for smoke runs")
    add_device_flag(p)
    return p


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")


def load_dataset(args, mode: str, max_length=None):
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        load_qm9, prepare_qm9, synthetic_qm9)
    if args.csv:
        smiles, props = load_qm9(args.csv, max_rows=args.rows)
    else:
        # chemically_valid: valence-correct molecules so the printed
        # validity/novelty numbers carry meaning (design/valence.py)
        smiles, props = synthetic_qm9(n=args.rows or 2048, seed=args.seed,
                                      chemically_valid=True)
        print("NOTE: using the synthetic QM9 stand-in (pass --csv for the "
              "real dataset)")
    return prepare_qm9(smiles, props, mode=mode, max_length=max_length)


def epoch_iterator(data, batch_size: int, seed: int):
    from moleculediffusiontransformer_tpu_torch.data.qm9 import \
        batch_iterator

    def make():
        return batch_iterator(data.X_train, data.y_train, batch_size,
                              rng=np.random.RandomState(seed))
    return make


def eval_generator(seed: int, device) -> torch.Generator:
    """The eval's draws: a generator on ``device`` seeded with ``seed`` +
    7, fresh for every eval, as the JAX examples pass one
    ``PRNGKey(seed + 7)`` to every eval."""
    return torch.Generator(device=device).manual_seed(seed + 7)


def final(logger) -> dict:
    """Print the run's last metrics record as the JAX examples do, and
    return it."""
    last = logger.history[-1] if logger.history else {}
    print("final:", last or "(no metrics)")
    return last
