"""Online evaluation loops (port of `train/eval.py`): the reference's
sample_loop_* functions (`generative.py:590-659,1176-1295,1403-1533,
2009-2073`) without matplotlib; metrics come back as dicts.

Each runs on its model's device.  A JAX ``key`` becomes a
``torch.Generator`` plus the optional draws of the sampler beneath.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.preprocess import mean_absolute_error, r2_score
from ..data.tokenizer import CharTokenizer
from ..design.inverse_design import (_device, decode_one_hot,
                                     evaluate_generated,
                                     generate_from_conditioning_transformer)


def _fit(gt: np.ndarray, preds: np.ndarray) -> Dict:
    return {"r2": r2_score(gt.ravel(), preds.ravel()),
            "mae": mean_absolute_error(gt, preds)}


def eval_forward_diffusion(model, X_test: np.ndarray, y_test: np.ndarray,
                           generator: Optional[torch.Generator] = None, *,
                           num_samples: int = 16, timesteps: int = 100,
                           cond_scale: float = 1.0,
                           noise: Optional[torch.Tensor] = None,
                           step_noise: Optional[torch.Tensor] = None) -> Dict:
    """R² and MAE of diffusion-predicted properties on held-out data
    (reference `sample_loop_forward`, `generative.py:590-659`).  X_test =
    normalized token ids (the conditioning), y_test = scaled properties."""
    from ..models.qm_diffusion import sample
    cond = torch.tensor(np.asarray(X_test[:num_samples], np.float32),
                        device=_device(model))
    track = sample(model, cond, generator, num_steps=timesteps,
                   cond_scale=cond_scale, noise=noise, step_noise=step_noise)
    preds = track[:, :y_test.shape[1], 0].cpu().numpy()
    return _fit(y_test[:num_samples], preds)


def eval_inverse_diffusion(model, y_test: np.ndarray,
                           tokenizer: CharTokenizer,
                           training_smiles: Sequence[str],
                           generator: Optional[torch.Generator] = None, *,
                           num_samples: int = 4, timesteps: int = 64,
                           cond_scale: float = 1.0,
                           noise: Optional[torch.Tensor] = None,
                           step_noise: Optional[torch.Tensor] = None) -> Dict:
    """Sample molecules for held-out property targets; validity + novelty
    (reference `sample_loop_generative`, `generative.py:1176-1295`)."""
    from ..models.qm_diffusion import sample
    cond = torch.tensor(np.asarray(y_test[:num_samples], np.float32),
                        device=_device(model))
    out = sample(model, cond, generator, num_steps=timesteps,
                 cond_scale=cond_scale, noise=noise, step_noise=step_noise)
    smiles = decode_one_hot(out, tokenizer)
    rep = evaluate_generated(smiles, training_smiles)
    return {"validity_fraction": rep["validity_fraction"],
            "novelty_fraction": rep["novelty_fraction"],
            "num_valid": rep["num_valid"],
            "sample_smiles": smiles[:4]}


@torch.no_grad()
def eval_forward_transformer(model, X_test: np.ndarray, y_test: np.ndarray,
                             *, num_samples: int = 256) -> Dict:
    """R² and MAE of the encoder's property predictions (reference
    `sample_loop_forward_transformer`, `generative.py:2009-2073`)."""
    ids = torch.tensor(np.asarray(X_test[:num_samples]), dtype=torch.long,
                       device=_device(model))
    logits = model(ids)
    preds = logits.float().reshape(ids.shape[0], -1)[:, :y_test.shape[1]]
    return _fit(y_test[:num_samples], preds.cpu().numpy())


def eval_inverse_transformer(model, y_test: np.ndarray,
                             tokenizer: CharTokenizer,
                             training_smiles: Sequence[str],
                             generator: Optional[torch.Generator] = None, *,
                             num_samples: int = 8,
                             tokens_to_generate: int = 63,
                             cond_scale: float = 1.5,
                             start_char: str = "@", end_char: str = "$",
                             uniforms: Optional[torch.Tensor] = None) -> Dict:
    """Generate molecules with the AR transformer; validity + novelty
    (reference `sample_loop_transformer`, `generative.py:1403-1533`)."""
    rep = generate_from_conditioning_transformer(
        model, y_test[:num_samples], tokenizer, generator,
        tokens_to_generate=tokens_to_generate, cond_scale=cond_scale,
        start_char=start_char, end_char=end_char,
        training_smiles=training_smiles, uniforms=uniforms)
    return {"validity_fraction": rep["validity_fraction"],
            "novelty_fraction": rep["novelty_fraction"],
            "num_valid": rep["num_valid"],
            "sample_smiles": rep["smiles"][:4]}
