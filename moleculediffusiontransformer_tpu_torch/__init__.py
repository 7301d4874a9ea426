"""moleculediffusiontransformer_tpu_torch — the PyTorch/CUDA port of
``moleculediffusiontransformer_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
(``nn/``, ``ops/``, ``diffusion/``, ``models/``) so every module has a
counterpart of the same name.  It imports ``torch`` and numpy, never ``jax``
or ``flax``.  Activations are channels-last ``(batch, length, channels)`` at
every public function, as in the JAX package; parameters use the reference
torch ``state_dict`` names, so ``nn.jax_import.state_dict_from_jax_params``
and reference checkpoints load with ``load_state_dict(strict=True)``.

Hand-written CUDA kernels live in ``csrc/`` and are compiled with ``nvcc`` on
first use (``ops/cuda_build.py``); importing the package builds nothing.
"""
__version__ = "0.1.0"
