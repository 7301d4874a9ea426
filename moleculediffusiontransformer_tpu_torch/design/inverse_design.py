"""Inverse-design pipeline (port of `design/inverse_design.py`): generate ->
decode -> validate -> novelty -> re-score with a forward model.

Everything up to the argmax runs on the model's device -- the card unless
the model was built elsewhere -- and only the integer ids come back to the
host; tokenizer decode, validity and novelty run on the host.  A JAX
``key`` becomes a ``torch.Generator`` (on the model's device) plus the
optional draws of the sampler beneath, so that a test can feed the JAX
package's own draws: torch cannot reproduce threefry.  The models carry
their weights, so no function takes a ``variables`` argument.

Validity is RDKit's parse where RDKit imports, else the port's own copy of
the valence-aware checker (``design/valence.py``).  Not ported: the JAX
function's ``mesh`` (parallel serving), ``export``, ``serve``,
``http_serve`` and ``plots``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.preprocess import MinMaxScaler, mean_absolute_error, r2_score
from ..data.qm9 import is_novel
from ..data.tokenizer import (CharTokenizer, add_start_end_char,
                              one_hot_signed, pad_sequences,
                              remove_start_end_token_first)
from .valence import valence_smiles_valid

try:  # RDKit is the reference's validity oracle (`generative.py:947-994`)
    from rdkit import Chem  # type: ignore
    HAS_RDKIT = True
except ImportError:  # pragma: no cover
    Chem = None
    HAS_RDKIT = False


def smiles_is_valid(smi: str) -> bool:
    """Validity = RDKit parses it; without RDKit, the valence-aware checker
    (grammar, kekulization, Hückel, charge-adjusted valences)."""
    if HAS_RDKIT:
        return Chem.MolFromSmiles(smi) is not None
    return valence_smiles_valid(smi)


def canonicalize(smi: str) -> Optional[str]:
    if HAS_RDKIT:
        mol = Chem.MolFromSmiles(smi)
        return Chem.MolToSmiles(mol) if mol is not None else None
    return smi if smiles_is_valid(smi) else None


def decode_one_hot(samples, tokenizer: CharTokenizer) -> List[str]:
    """argmax over the token channels -> reverse tokenize.  ``samples``
    (b, L, vocab), a tensor (the argmax runs on its device) or an array."""
    if isinstance(samples, torch.Tensor):
        ids = samples.argmax(dim=-1).cpu().numpy()
    else:
        ids = np.argmax(np.asarray(samples), axis=-1)
    return tokenizer.decode(ids)


def evaluate_generated(smiles_list: Sequence[str],
                       training_smiles: Sequence[str]) -> Dict:
    """Validity + novelty counters (reference `generative.py:1249-1295`)."""
    valid = [s for s in smiles_list if smiles_is_valid(s)]
    novel = [s for s in valid if is_novel(training_smiles, s)]
    n = max(len(smiles_list), 1)
    return {
        "num_samples": len(smiles_list),
        "num_valid": len(valid),
        "num_novel": len(novel),
        "validity_fraction": len(valid) / n,
        "novelty_fraction": len(novel) / max(len(valid), 1),
        "valid_smiles": valid,
        "novel_smiles": novel,
    }


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _scaled(properties: np.ndarray, scaler: Optional[MinMaxScaler],
            device: torch.device) -> torch.Tensor:
    """Property targets (b, 12), scaled when ``scaler`` is given, as float32
    on ``device``."""
    props = np.asarray(properties, np.float32)
    if scaler is not None:
        props = scaler.transform(props)
    return torch.tensor(np.asarray(props, np.float32), device=device)


def _report(smiles: List[str], training_smiles: Sequence[str]) -> Dict:
    report = evaluate_generated(smiles, training_smiles)
    report["smiles"] = smiles
    return report


# ------------------------------------------------------------ forward API --

def predict_properties_from_smiles(
        model_forward, smiles: Sequence[str], tokenizer: CharTokenizer,
        scaler: MinMaxScaler, generator: Optional[torch.Generator] = None, *,
        max_length: int = 64, x_norm_factor: Optional[float] = None,
        timesteps: int = 100, cond_scale: float = 1.0,
        noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """Forward-diffusion property prediction (reference
    `generative.py:664-711`): tokenize -> pad(64) -> / the vocabulary size
    -> 100-step sample (``models.qm_diffusion.sample``, its draws from
    ``generator`` or given) -> the first 12 positions -> inverse scale.
    Returns physical-unit properties (b, 12)."""
    from ..models.qm_diffusion import sample
    ids = pad_sequences(tokenizer.texts_to_sequences(smiles), max_length)
    norm = (float(tokenizer.vocab_size) if x_norm_factor is None
            else x_norm_factor)
    cond = torch.tensor(ids, dtype=torch.float32,
                        device=_device(model_forward)) / norm
    track = sample(model_forward, cond, generator, num_steps=timesteps,
                   cond_scale=cond_scale, noise=noise, step_noise=step_noise)
    return scaler.inverse_transform(track[:, :12, 0].cpu().numpy())


@torch.no_grad()
def predict_properties_from_smiles_transformer(
        model_encoder, smiles: Sequence[str], tokenizer: CharTokenizer,
        scaler: MinMaxScaler, *, max_length: int = 64, start_char: str = "@",
        end_char: str = "$") -> np.ndarray:
    """Forward-transformer property prediction: one forward pass of the
    encoder over the delimited, padded ids (reference
    `generative.py:1864-1913`).  Returns physical-unit properties (b, 12)."""
    texts = add_start_end_char(list(smiles), start_char, end_char)
    ids = pad_sequences(tokenizer.texts_to_sequences(texts), max_length)
    logits = model_encoder(torch.tensor(ids, dtype=torch.long,
                                        device=_device(model_encoder)))
    props = logits.float().reshape(len(smiles), -1)[:, :12]
    return scaler.inverse_transform(props.cpu().numpy())


# ------------------------------------------------------------ inverse API --

def generate_from_conditioning(
        model, properties: np.ndarray, tokenizer: CharTokenizer,
        generator: Optional[torch.Generator] = None, *,
        scaler: Optional[MinMaxScaler] = None,
        training_smiles: Sequence[str] = (), cond_scale: float = 7.5,
        timesteps: int = 100, noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None) -> Dict:
    """Single-shot inverse design from a property vector (reference
    `generative.py:1662-1738`): scale -> sample -> argmax -> decode ->
    validity/novelty.  ``properties`` (b, 12) in physical units when
    ``scaler`` is given, else already scaled.  The report holds ``smiles``
    and ``raw_samples`` (b, L, vocab) beside ``evaluate_generated``'s
    counts."""
    from ..models.qm_diffusion import sample
    props = _scaled(properties, scaler, _device(model))
    out = sample(model, props, generator, num_steps=timesteps,
                 cond_scale=cond_scale, noise=noise, step_noise=step_noise)
    report = _report(decode_one_hot(out, tokenizer), training_smiles)
    report["raw_samples"] = out.cpu().numpy()
    return report


def inpaint_from_draft_and_conditioning(
        model, draft_smiles: str, properties: np.ndarray,
        fixed_positions: Sequence[int], tokenizer: CharTokenizer,
        generator: Optional[torch.Generator] = None, *,
        scaler: Optional[MinMaxScaler] = None, num_resamples: int = 1,
        cond_scale: float = 7.5, timesteps: int = 100,
        num_candidates: int = 4, training_smiles: Sequence[str] = (),
        noise: Optional[torch.Tensor] = None,
        source_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        renoise: Optional[torch.Tensor] = None) -> Dict:
    """Constrained design: keep ``fixed_positions`` of a draft molecule and
    regenerate the rest under property conditioning, ``num_candidates``
    times (reference `generative.py:1574-1660`; ``models.qm_diffusion.
    inpaint``, its draws from ``generator`` or given)."""
    from ..models.qm_diffusion import inpaint
    device = _device(model)
    props = _scaled(np.asarray(properties, np.float32).reshape(1, -1),
                    scaler, device).repeat(num_candidates, 1)
    ids = pad_sequences(tokenizer.texts_to_sequences([draft_smiles]),
                        model.max_length)
    source = torch.tensor(one_hot_signed(ids, model.pred_dim),
                          device=device).repeat(num_candidates, 1, 1)
    mask = torch.zeros(source.shape, dtype=torch.bool, device=device)
    mask[:, list(fixed_positions), :] = True              # True = keep
    out = inpaint(model, props, source, mask, generator,
                  num_steps=timesteps, num_resamples=num_resamples,
                  cond_scale=cond_scale, noise=noise,
                  source_noise=source_noise, step_noise=step_noise,
                  renoise=renoise)
    return _report(decode_one_hot(out, tokenizer), training_smiles)


def generate_from_conditioning_transformer(
        model, properties: np.ndarray, tokenizer: CharTokenizer,
        generator: Optional[torch.Generator] = None, *,
        scaler: Optional[MinMaxScaler] = None, tokens_to_generate: int = 63,
        cond_scale: float = 1.5, temperature: float = 1.0,
        filter_thres: float = 0.9, start_char: str = "@",
        end_char: str = "$", start_sequence: Optional[str] = None,
        training_smiles: Sequence[str] = (),
        uniforms: Optional[torch.Tensor] = None) -> Dict:
    """Inverse design with the AR transformer (reference
    `generative.py:1775-1860`): start from '@' (or a prompt), KV-cached CFG
    generation (``models.transformers.generate_sequence``, its uniforms from
    ``generator`` or given), strip the delimiters, validity/novelty."""
    from ..models.transformers import generate_sequence
    device = _device(model)
    props = _scaled(properties, scaler, device)
    start_text = start_char + (start_sequence or "")
    start_ids = torch.tensor(
        tokenizer.texts_to_sequences([start_text] * props.shape[0]),
        dtype=torch.long, device=device)
    out = generate_sequence(model, props, start_ids, generator,
                            uniforms=uniforms,
                            tokens_to_generate=tokens_to_generate,
                            cond_scale=cond_scale, temperature=temperature,
                            filter_thres=filter_thres)
    smiles = [remove_start_end_token_first(s, start_char, end_char)
              for s in tokenizer.decode(out.cpu().numpy())]
    return _report(smiles, training_smiles)


def rescore_generated(
        model_forward, smiles: Sequence[str], target_properties: np.ndarray,
        tokenizer: CharTokenizer, scaler: MinMaxScaler,
        generator: Optional[torch.Generator] = None, *,
        transformer_encoder=None, noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None) -> Dict:
    """Close the loop: re-predict the properties of generated molecules with
    a forward model -- the forward diffusion model, or
    ``transformer_encoder`` when given -- and compare them with the
    conditioning targets: per-molecule R², overall R² and MAE (reference
    `generative.py:1249-1284,1505-1529`)."""
    if transformer_encoder is not None:
        preds = predict_properties_from_smiles_transformer(
            transformer_encoder, smiles, tokenizer, scaler)
    else:
        preds = predict_properties_from_smiles(
            model_forward, smiles, tokenizer, scaler, generator, noise=noise,
            step_noise=step_noise)
    target = np.asarray(target_properties, np.float32)
    return {
        "predicted_properties": preds,
        "per_molecule_r2": [r2_score(target[i], preds[i])
                            for i in range(len(smiles))],
        "overall_r2": r2_score(target[:len(preds)].ravel(), preds.ravel()),
        "mae": mean_absolute_error(target[:len(preds)], preds),
    }
