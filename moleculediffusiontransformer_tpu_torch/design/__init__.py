"""Inverse-design pipeline of the port: generate -> decode -> validate ->
novelty -> re-score with a forward model."""
from .inverse_design import (HAS_RDKIT, canonicalize, decode_one_hot,
                             evaluate_generated,
                             generate_from_conditioning,
                             generate_from_conditioning_transformer,
                             inpaint_from_draft_and_conditioning,
                             predict_properties_from_smiles,
                             predict_properties_from_smiles_transformer,
                             rescore_generated, smiles_is_valid)
