"""Per-task recipes: build, train, and evaluate any of the four notebook
models from a prepared QM9 dataset (port of `train/recipes.py`).

One shared implementation behind the package CLI
(``python -m moleculediffusiontransformer_tpu_torch``).  Each task mirrors
one reference notebook flow:

  * ``forward_diffusion``   — property regression by diffusion
    (`Forward_Diffusion.ipynb`; training loop `generative.py:525-533`)
  * ``inverse_diffusion``   — property-conditioned molecule diffusion
    (`Inverse_Diffusion.ipynb`; `generative.py:1090-1180`)
  * ``inverse_transformer`` — property-conditioned AR generation
    (`Inverse_Transformer.ipynb`; `generative.py:1302-1400`)
  * ``forward_transformer`` — single-pass property regression
    (`generative.py:1864-1913`)

Training follows the reference hyperparameters (Adam 2e-4 + grad-clip
0.5, `generative.py:1132`) through the port's train steps.
``preset="tiny"`` swaps CPU-feasible architectures for smoke runs and
tests; ``preset="notebook"`` is the reference scale.  Every model is built
on the card unless the caller names another device, its weights drawn
from a CPU generator seeded with ``seed``.

Not ported: ``init_example`` (shapes for JAX's init and export; the serving
export is ROADMAP.md item A8).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

TASKS = ("forward_diffusion", "inverse_diffusion",
         "inverse_transformer", "forward_transformer")

# task -> (batch, accumulation_steps) for NOTEBOOK-preset training on one
# 80 GB H100.  Batches follow the reference (diffusion 1024, transformer
# 256 — Inverse_Diffusion.ipynb cell 64, Forward_Transformer cell 60).
# The accumulation counts the JAX package chose for a TPU v5e's memory (2
# and 4) are re-derived for the card: accumulation is kept only where the
# float32 step's peak at the full batch would pass ~70% of the card, and
# ``chip_smoke.py`` phase 27 measures that peak (PERF.md).  Accumulation
# changes memory, not the update: the grads are averaged before the one
# Adam step.
PRODUCTION_BATCHES = {
    "forward_diffusion": (1024, 1),
    "inverse_diffusion": (1024, 1),
    "inverse_transformer": (256, 1),
    "forward_transformer": (256, 1),
}


def data_mode(task: str) -> str:
    """`prepare_qm9` mode for a task (the two transformer tasks share the
    start/end-delimited id layout, notebook cells 22-48)."""
    if task in ("inverse_transformer", "forward_transformer"):
        return "transformer"
    if task in ("forward_diffusion", "inverse_diffusion"):
        return task
    raise ValueError(f"unknown task: {task!r} (expected one of {TASKS})")


def build_model(task: str, vocab_size: Optional[int] = None,
                preset: str = "notebook", dtype: torch.dtype = torch.float32,
                device=None, seed: int = 0,
                init: bool = True) -> torch.nn.Module:
    """Construct the task's model at notebook (reference) or tiny scale, on
    ``device`` (the card when None), its weights from a CPU generator
    seeded with ``seed``.  ``init=False``, for a caller that loads a
    checkpoint into it next: the notebook diffusion models (91M, 18M) skip
    drawing weights that the checkpoint overwrites."""
    from ..core import config as cfg
    from ..models.qm_diffusion import (QMDiffusion, QMDiffusionForward,
                                       from_config)
    from ..models.transformers import (MoleculeTransformerSequence,
                                       MoleculeTransformerSequenceEncoder,
                                       from_encoder_config)
    from ..nn.primitives import init_parameters, seeded_build
    if preset not in ("notebook", "tiny"):
        raise ValueError(f"unknown preset: {preset!r}")
    tiny = preset == "tiny"
    generator = torch.Generator().manual_seed(seed)

    def tiny_qm(cls, **kw):
        with seeded_build(generator):
            model = cls(text_embed_dim=32, embed_dim_position=16,
                        multipliers=(1, 2), factors=(4,), num_blocks=(2,),
                        attentions=(1,), attention_heads=4,
                        attention_features=32, dtype=dtype, **kw)
        init_parameters(model, generator)
        return model.to("cuda" if device is None else device)

    if task == "forward_diffusion":
        if tiny:
            return tiny_qm(QMDiffusionForward, max_length=64, channels=32,
                           pred_dim=1, context_embedding_max_length=64,
                           patch_size=4)
        return from_config(QMDiffusionForward, cfg.forward_diffusion_qm9(),
                           dtype=dtype, device=device, generator=generator,
                           init=init)
    if task == "inverse_diffusion":
        vocab = vocab_size or 22
        if tiny:
            return tiny_qm(QMDiffusion, max_length=32, channels=32,
                           pred_dim=vocab, context_embedding_max_length=12,
                           pre_transformer=1, patch_size=1)
        return from_config(QMDiffusion, cfg.inverse_diffusion_qm9(vocab),
                           dtype=dtype, device=device, generator=generator,
                           init=init)
    if task == "inverse_transformer":
        t = cfg.inverse_transformer_qm9()
        dim, depth = (32, 2) if tiny else (t.dim, t.depth)
        return MoleculeTransformerSequence(
            dim=dim, depth=depth, logits_dim=vocab_size or t.logits_dim,
            dim_head=t.dim_head, heads=t.heads,
            text_embed_dim=t.text_embed_dim, max_text_len=t.max_text_len,
            dtype=dtype, device=device, generator=generator)
    if task == "forward_transformer":
        e = cfg.forward_transformer_qm9()
        if not tiny:
            return from_encoder_config(e, vocab_size, device=device,
                                       dtype=dtype, generator=generator)
        return MoleculeTransformerSequenceEncoder(
            dim=32, depth=2, heads=4, ff_mult=e.ff_mult,
            logits_dim=e.logits_dim, logits_dim_length=e.logits_dim_length,
            max_length=e.max_length, max_tokens=vocab_size or e.max_tokens,
            embed_dim=e.embed_dim, padding_token=e.padding_token,
            dtype=dtype, device=device, generator=generator)
    raise ValueError(f"unknown task: {task!r} (expected one of {TASKS})")


def load_params(path: Optional[str], task: str,
                model: torch.nn.Module) -> Tuple[torch.nn.Module, str]:
    """Load a checkpoint into ``model`` (on its device); returns the model
    and where its weights came from (its own random init when ``path`` is
    None).

    Reads the port's own checkpoints (``core/checkpoint.py``) and
    reference-layout state dicts: a ``.pt``/``.pth`` file of tensors (the
    reference's checkpoints, README.md:44-60) or the ``.npz``/``.pt`` that
    the JAX package's ``export-torch`` writes from its msgpack checkpoints.
    Their keys and layouts are the port's own (the JAX package's
    ``params_to_state_dict`` equals ``nn.jax_import.
    state_dict_from_jax_params``), so they load with ``strict=True``.  A
    msgpack file itself cannot be read here: convert it with ``python -m
    moleculediffusiontransformer_tpu export-torch``."""
    from ..core.checkpoint import read_state_dict
    if task not in TASKS:
        raise ValueError(f"unknown task: {task!r} (expected one of {TASKS})")
    if path is None:
        return model, "random-init (no checkpoint found)"
    model.load_state_dict(read_state_dict(path), strict=True)
    return model, path


# ----------------------------------------------------------- training -----

def _pad_props(y: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad the property vector into a (b, L, 1) diffusion track
    (reference `train_loop_forward` target layout, generative.py:525-533)."""
    track = np.zeros((y.shape[0], length, 1), np.float32)
    track[:, :y.shape[1], 0] = y
    return track


def train_task(task: str, model: torch.nn.Module, data, config,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               logger=None, mesh=None):
    """Train ``model`` in place on a prepared-QM9 split with the task's
    reference semantics; returns ``(TrainState, MetricsLogger)``.  Each
    epoch walks the training split in the order of a fresh
    ``RandomState(config.seed)``, as in the JAX package.  The diffusion
    tasks train over ``mesh`` when given (``train_diffusion``) and write
    the checkpoint tier ``config.checkpoint_backend`` names; the
    transformer tasks train on one card and write the single-file tier
    (``core/checkpoint.py``) whatever ``checkpoint_backend`` says, as the
    JAX package's do."""
    from ..core.checkpoint import (checkpoint_state, latest_checkpoint,
                                   restore_checkpoint, save_step_checkpoint)
    from ..data.qm9 import batch_iterator
    from .trainer import (MetricsLogger, TrainState, make_encoder_train_step,
                          make_optimizer, make_transformer_train_step,
                          step_generator, train_diffusion)

    def epoch_batches():
        return batch_iterator(data.X_train, data.y_train, config.batch_size,
                              rng=np.random.RandomState(config.seed))

    if task == "forward_diffusion":
        length = model.max_length

        def make_iter():
            for X, y in epoch_batches():
                yield X, _pad_props(y, length)

        return train_diffusion(model, make_iter, config, swap_xy=True,
                               checkpoint_dir=checkpoint_dir, resume=resume,
                               logger=logger, mesh=mesh)
    if task == "inverse_diffusion":
        return train_diffusion(model, epoch_batches, config,
                               checkpoint_dir=checkpoint_dir, resume=resume,
                               logger=logger, mesh=mesh)
    if task not in ("inverse_transformer", "forward_transformer"):
        raise ValueError(f"unknown task: {task!r} (expected one of {TASKS})")

    if config.param_sharding != "replicated" or (
            torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise ValueError(f"the {task} task trains on one card, as in the JAX "
                         f"package: run it in one process, unsharded")
    logger = logger or MetricsLogger()
    encoder = task == "forward_transformer"
    device = next(model.parameters()).device
    optimizer = make_optimizer(config)
    state = TrainState.create(model, optimizer)
    if resume and checkpoint_dir:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt:
            restore_checkpoint(ckpt, model, state)
    step_fn = (make_encoder_train_step(model, optimizer) if encoder
               else make_transformer_train_step(model, optimizer))
    for _ in range(config.epochs):
        for X, y in epoch_batches():
            ids = torch.as_tensor(X, dtype=torch.long, device=device)
            props = torch.as_tensor(y, device=device)
            if encoder:
                loss = step_fn(state, ids, props)
            else:
                loss = step_fn(state, props, ids, step_generator(
                    config.seed, state.step, device))
            if state.step % config.print_loss_every == 0:
                logger.log(step=state.step, epoch=state.epoch,
                           loss=float(loss))
        state.epoch += 1
    if checkpoint_dir:
        save_step_checkpoint(checkpoint_dir, checkpoint_state(model, state),
                             state.step)
    return state, logger


# --------------------------------------------------------- evaluation -----

def eval_task(task: str, model: torch.nn.Module, data,
              generator: Optional[torch.Generator] = None, *,
              timesteps: int = 100, num_rescore: int = 16,
              num_generate: int = 41, tokens_to_generate: int = 63) -> Dict:
    """Held-out evaluation with the task's notebook metric (R² for the
    forward directions, validity/novelty for the inverse); the samplers
    draw from ``generator`` (on the model's device)."""
    from .eval import (eval_forward_diffusion, eval_forward_transformer,
                       eval_inverse_diffusion, eval_inverse_transformer)
    if task == "forward_diffusion":
        return eval_forward_diffusion(
            model, data.X_test, data.y_test, generator,
            num_samples=num_rescore, timesteps=timesteps, cond_scale=1.0)
    if task == "inverse_diffusion":
        return eval_inverse_diffusion(
            model, data.y_test, data.tokenizer, data.smiles, generator,
            num_samples=num_generate, timesteps=timesteps, cond_scale=2.0)
    if task == "inverse_transformer":
        return eval_inverse_transformer(
            model, data.y_test, data.tokenizer, data.smiles, generator,
            num_samples=num_generate, tokens_to_generate=tokens_to_generate)
    if task == "forward_transformer":
        return eval_forward_transformer(model, data.X_test, data.y_test)
    raise ValueError(f"unknown task: {task!r} (expected one of {TASKS})")
