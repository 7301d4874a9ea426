"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or loads a kernel at import: ``cuda_build`` compiles
``csrc/`` with nvcc on the first call that needs a kernel.

``ops.attention`` and ``ops.packed_attention`` are the functions, as in the
JAX package.  The function hides the module of the same name: reach that
(its launch counters, its plain version) with
``importlib.import_module("<package>.ops.attention")`` or
``from <package>.ops.attention import <name>``."""
from .attention import attention, packed_attention

__all__ = ["attention", "packed_attention"]
