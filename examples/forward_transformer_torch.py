"""Forward transformer encoder on the PyTorch port: 12 QM9 properties from
tokenized SMILES (the counterpart of ``examples/forward_transformer.py``;
the rebuild of `Forward_Transformer.ipynb`; notebook preset: dim 256,
depth 6, heads 16, ff_mult 2, output (b, 1, 12) => 3,162,496 params).

Adam 1e-4 + clip 0.5 through ``make_encoder_train_step``, then after every
epoch ``eval_forward_transformer`` (R², MAE) and a ``step_N.pt``
checkpoint; ``--resume`` continues from the newest.  Runs on the card
unless ``--device cpu``.

  python examples/forward_transformer_torch.py --csv qm9_.csv --epochs 50
  python examples/forward_transformer_torch.py --tiny --epochs 2 --device cpu
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from common_torch import (base_parser, final,  # noqa: E402
                          load_dataset)

LEARNING_RATE = 1e-4      # the JAX example's, whatever --learning-rate says


def build_model(vocab: int, tiny: bool, device, seed: int = 0):
    """The example's model: the notebook preset at ``max_tokens = vocab``,
    or dim 32 x depth 2 with 4 heads under ``--tiny`` (the JAX example's),
    its weights seeded with ``seed``."""
    from moleculediffusiontransformer_tpu_torch.train import recipes
    return recipes.build_model("forward_transformer", vocab,
                               "tiny" if tiny else "notebook",
                               device=device, seed=seed)


def build_parser():
    return base_parser(__doc__)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, latest_checkpoint, restore_checkpoint,
        save_step_checkpoint)
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.data.qm9 import \
        batch_iterator
    from moleculediffusiontransformer_tpu_torch.train.eval import \
        eval_forward_transformer
    from moleculediffusiontransformer_tpu_torch.train.trainer import (
        MetricsLogger, TrainState, make_encoder_train_step, make_optimizer)

    device = _device(args)
    data = load_dataset(args, mode="transformer", max_length=64)
    model = build_model(data.vocab_size, args.tiny, device, args.seed)
    config = TrainConfig(learning_rate=LEARNING_RATE,
                         batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed)
    optimizer = make_optimizer(config)
    state = TrainState.create(model, optimizer)
    if args.resume and args.checkpoint_dir:
        ckpt = latest_checkpoint(args.checkpoint_dir)
        if ckpt:
            restore_checkpoint(ckpt, model, state)

    step_fn = make_encoder_train_step(model, optimizer)
    logger = MetricsLogger(path=args.checkpoint_dir
                           and f"{args.checkpoint_dir}/metrics.jsonl")
    t0 = time.time()
    for _ in range(config.epochs):
        for X, y in batch_iterator(data.X_train, data.y_train,
                                   config.batch_size,
                                   rng=np.random.RandomState(args.seed)):
            loss = step_fn(state, torch.as_tensor(X, dtype=torch.long,
                                                  device=device),
                           torch.as_tensor(y, device=device))
        metrics = eval_forward_transformer(model, data.X_test, data.y_test)
        logger.log(epoch=state.epoch, step=state.step, loss=float(loss),
                   elapsed_s=time.time() - t0, **metrics)
        state.epoch += 1
        if args.checkpoint_dir:
            save_step_checkpoint(args.checkpoint_dir,
                                 checkpoint_state(model, state), state.step)
    return final(logger)


if __name__ == "__main__":
    main()
