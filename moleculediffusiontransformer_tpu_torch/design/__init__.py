"""Inverse-design pipeline of the port: generate -> decode -> validate ->
novelty -> re-score with a forward model; serving: exported artifacts
(``export``), ``ArtifactServer`` and its HTTP front end; and the optional
plots and molecule drawings (``plots``)."""
from .inverse_design import (HAS_RDKIT, canonicalize, decode_one_hot,
                             evaluate_generated,
                             generate_from_conditioning,
                             generate_from_conditioning_transformer,
                             inpaint_from_draft_and_conditioning,
                             predict_properties_from_smiles,
                             predict_properties_from_smiles_transformer,
                             rescore_generated, smiles_is_valid)
from .export import (export_encoder, export_generator, export_inpainter,
                     export_sampler, load_artifact, load_bundle,
                     save_artifact, variables_skeleton)
from .serve import ArtifactServer
from .http_serve import ServingError, make_httpd
from .plots import (draw_and_save, draw_and_save_set, joint_plot,
                    plot_loss_curve, plot_results_as_barchart,
                    view_difference)
