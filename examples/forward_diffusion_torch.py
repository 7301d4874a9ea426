"""Forward diffusion on the PyTorch port: tokenized SMILES -> 12 QM9
properties (the counterpart of ``examples/forward_diffusion.py``).

The rebuild of `Forward_Diffusion.ipynb`: notebook preset (channels 64,
pred_dim 1, max_length 64, patch 4 => 18,322,684 params), properties padded
onto a 64-long track with the SMILES ids as conditioning
(reference `train_loop_forward`, `generative.py:488-588`), an R² eval of 16
samples at 32 steps after every epoch.  Runs on the card unless
``--device cpu``.

  python examples/forward_diffusion_torch.py --csv qm9_.csv --epochs 100
  python examples/forward_diffusion_torch.py --tiny --epochs 2 --device cpu
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from common_torch import (base_parser, eval_generator,  # noqa: E402
                          final, load_dataset)

MAX_LENGTH = 64
EVAL_SAMPLES, EVAL_STEPS = 16, 32   # the online eval's, as in JAX


def build_model(tiny: bool, device, seed: int = 0):
    """The example's model: the recipes' notebook preset, or under
    ``--tiny`` the JAX example's tiny model, its weights seeded with
    ``seed``."""
    from moleculediffusiontransformer_tpu_torch.train import recipes
    return recipes.build_model("forward_diffusion", None,
                               "tiny" if tiny else "notebook",
                               device=device, seed=seed)


def pad_props(y: np.ndarray) -> np.ndarray:
    """properties (b, 12) -> diffusion track (b, 64, 1)
    (reference `generative.py:525-533`)."""
    track = np.zeros((y.shape[0], MAX_LENGTH, 1), np.float32)
    track[:, :y.shape[1], 0] = y
    return track


def epoch_batches(data, batch_size: int, seed: int):
    """An epoch's (conditioning, target) batches: the SMILES ids and the
    padded track (the trainer swaps them in with ``swap_xy``)."""
    from moleculediffusiontransformer_tpu_torch.data.qm9 import \
        batch_iterator

    def make_iter():
        for X, y in batch_iterator(data.X_train, data.y_train, batch_size,
                                   rng=np.random.RandomState(seed)):
            yield X, pad_props(y)   # (conditioning, target) with swap_xy
    return make_iter


def build_parser():
    return base_parser(__doc__)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.train.eval import \
        eval_forward_diffusion
    from moleculediffusiontransformer_tpu_torch.train.trainer import (
        MetricsLogger, train_diffusion)

    device = _device(args)
    data = load_dataset(args, mode="forward_diffusion", max_length=MAX_LENGTH)
    model = build_model(args.tiny, device, args.seed)
    config = TrainConfig(learning_rate=args.learning_rate,
                         batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed)

    def eval_fn(state):
        return eval_forward_diffusion(model, data.X_test, data.y_test,
                                      eval_generator(args.seed, device),
                                      num_samples=EVAL_SAMPLES,
                                      timesteps=EVAL_STEPS)

    _, logger = train_diffusion(
        model, epoch_batches(data, args.batch_size, args.seed), config,
        eval_fn=eval_fn, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, swap_xy=True,
        logger=MetricsLogger(path=args.checkpoint_dir
                             and f"{args.checkpoint_dir}/metrics.jsonl"))
    return final(logger)


if __name__ == "__main__":
    main()
