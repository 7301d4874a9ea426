"""Inverse diffusion on the PyTorch port: 12 QM9 properties -> SMILES
one-hot tracks (the counterpart of ``examples/inverse_diffusion.py``).

The rebuild of `Inverse_Diffusion.ipynb`: notebook preset (channels 128,
pred_dim = vocab, max_length 32, pre_transformer 2 => 90,965,554 params at
vocab 22), Adam 2e-4 + clip 0.5, online validity/novelty eval (4 samples,
32 steps), checkpoints with optimizer state (``step_N.pt``; ``--resume``
continues from the newest in ``--checkpoint-dir``, one that
``tools/quality_convergence_torch.py`` wrote included).  Runs on the card
unless ``--device cpu``.

  python examples/inverse_diffusion_torch.py --csv qm9_.csv --epochs 300
  python examples/inverse_diffusion_torch.py --tiny --epochs 2 --device cpu
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (base_parser, epoch_iterator,  # noqa: E402
                          eval_generator, final, load_dataset)

EVAL_SAMPLES, EVAL_STEPS = 4, 32    # the online eval's, as in JAX


def build_model(vocab: int, tiny: bool, device, seed: int = 0):
    """The example's model: the recipes' notebook preset, or under
    ``--tiny`` the JAX example's tiny model (channels 32, one pre-transformer
    layer), its weights seeded with ``seed``."""
    from moleculediffusiontransformer_tpu_torch.train import recipes
    return recipes.build_model("inverse_diffusion", vocab,
                               "tiny" if tiny else "notebook",
                               device=device, seed=seed)


def build_parser():
    return base_parser(__doc__)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.train.eval import \
        eval_inverse_diffusion
    from moleculediffusiontransformer_tpu_torch.train.trainer import (
        MetricsLogger, train_diffusion)

    device = _device(args)
    data = load_dataset(args, mode="inverse_diffusion", max_length=32)
    model = build_model(data.vocab_size, args.tiny, device, args.seed)
    config = TrainConfig(learning_rate=args.learning_rate,
                         batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed)

    def eval_fn(state):
        return eval_inverse_diffusion(
            model, data.y_test, data.tokenizer, data.smiles,
            eval_generator(args.seed, device), num_samples=EVAL_SAMPLES,
            timesteps=EVAL_STEPS)

    _, logger = train_diffusion(
        model, epoch_iterator(data, config.batch_size, args.seed), config,
        eval_fn=eval_fn, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        logger=MetricsLogger(path=args.checkpoint_dir
                             and f"{args.checkpoint_dir}/metrics.jsonl"))
    return final(logger)


if __name__ == "__main__":
    main()
