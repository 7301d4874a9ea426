"""Inverse transformer on the PyTorch port: property-conditioned
autoregressive SMILES generation (the counterpart of
``examples/inverse_transformer.py``; the rebuild of
`Inverse_Transformer.ipynb`; notebook preset: dim 128, depth 12, dim_head
16, logits_dim = vocab-with-delimiters => 2,407,712 params at vocab 24).

Adam 2e-4 + clip 0.5 through ``make_transformer_train_step``, then after
every epoch ``eval_inverse_transformer`` (4 samples, 63 tokens, 16 under
``--tiny``) and a ``step_N.pt`` checkpoint (``core/checkpoint.py``);
``--resume`` continues from the newest.  Runs on the card unless
``--device cpu``.

  python examples/inverse_transformer_torch.py --csv qm9_.csv --epochs 200
  python examples/inverse_transformer_torch.py --tiny --epochs 2 --device cpu
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


def build_model(vocab: int, tiny: bool, device, seed: int = 0):
    """The example's model: depth 12 x dim 128, or depth 2 x dim 32 under
    ``--tiny`` (the JAX example's), its weights seeded with ``seed``."""
    from moleculediffusiontransformer_tpu_torch.train import recipes
    return recipes.build_model("inverse_transformer", vocab,
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
        eval_inverse_transformer
    from moleculediffusiontransformer_tpu_torch.train.trainer import (
        MetricsLogger, TrainState, make_optimizer,
        make_transformer_train_step, step_generator)

    device = _device(args)
    data = load_dataset(args, mode="transformer", max_length=64)
    model = build_model(data.vocab_size, args.tiny, device, args.seed)
    config = TrainConfig(learning_rate=args.learning_rate,
                         batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed)
    optimizer = make_optimizer(config)
    state = TrainState.create(model, optimizer)
    if args.resume and args.checkpoint_dir:
        ckpt = latest_checkpoint(args.checkpoint_dir)
        if ckpt:
            restore_checkpoint(ckpt, model, state)

    step_fn = make_transformer_train_step(model, optimizer)
    logger = MetricsLogger(path=args.checkpoint_dir
                           and f"{args.checkpoint_dir}/metrics.jsonl")
    t0 = time.time()
    for _ in range(config.epochs):
        for X, y in batch_iterator(data.X_train, data.y_train,
                                   config.batch_size,
                                   rng=np.random.RandomState(args.seed)):
            loss = step_fn(state, torch.as_tensor(y, device=device),
                           torch.as_tensor(X, dtype=torch.long,
                                           device=device),
                           step_generator(config.seed + 1, state.step,
                                          device))
        metrics = eval_inverse_transformer(
            model, data.y_test, data.tokenizer, data.smiles,
            torch.Generator(device=device).manual_seed(state.epoch),
            num_samples=4, tokens_to_generate=16 if args.tiny else 63)
        logger.log(epoch=state.epoch, step=state.step, loss=float(loss),
                   elapsed_s=time.time() - t0, **metrics)
        state.epoch += 1
        if args.checkpoint_dir:
            save_step_checkpoint(args.checkpoint_dir,
                                 checkpoint_state(model, state), state.step)
    return final(logger)


if __name__ == "__main__":
    main()
