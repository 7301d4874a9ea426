"""Task-layer models of the port: QM9 diffusion (forward and inverse), the
transformers, the audio assemblies and the graph analogs."""
from .qm_diffusion import (QMDiffusion, QMDiffusionBase, QMDiffusionForward,
                           from_config, inpaint, sample)
from .transformers import (MoleculeTransformer, MoleculeTransformerGPT,
                           MoleculeTransformerSequence,
                           MoleculeTransformerSequenceEncoder,
                           MoleculeTransformerSequenceInternaldim,
                           MoleculeTransformerGPTPyTorch,
                           forward_with_cond_scale, generate_gpt,
                           generate_gpt_mha, generate_sequence,
                           generate_vectors)
from .audio import (AudioDiffusionAE, AudioDiffusionConditional,
                    AudioDiffusionModel, AudioDiffusionUpphaser,
                    AudioDiffusionUpsampler, AudioDiffusionVocoder,
                    DiffusionAE1d, DiffusionAR1d, DiffusionUpphaser1d,
                    DiffusionUpsampler1d, DiffusionVocoder1d, Model1d,
                    build_model1d, decode_ae, get_default_model_kwargs,
                    get_default_sampling_kwargs, sample_ar, sample_model1d,
                    sample_upsampler, sample_vocoder)
from .graph import (AnalogDiffusionFull, AnalogDiffusionSparse,
                    build_graph_model)
