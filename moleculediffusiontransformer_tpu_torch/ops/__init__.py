"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or loads a kernel at import: ``cuda_build`` compiles
``csrc/`` with nvcc on the first call that needs a kernel.

``ops.attention`` and ``ops.packed_attention`` are the functions, as in the
JAX package.  The function hides the module of the same name: reach that
(its launch counters, its plain version) with
``importlib.import_module("<package>.ops.attention")`` or
``from <package>.ops.attention import <name>``.

``kernel_switches`` sets both default-off kernel switches together for a
block, as an export with ``--fused`` or the serving bench wants them."""
import contextlib
from typing import Iterator

from .attention import attention, packed_attention

__all__ = ["attention", "kernel_switches", "packed_attention"]


@contextlib.contextmanager
def kernel_switches(on: bool = True) -> Iterator[None]:
    """Both default-off switches, the resnet-run kernel (K8,
    ``resnet_fusion.enable_resnet_fusion``) and the shared-KV null half of
    the stack kernel (``transformer_fusion.enable_sharedkv``), set to ``on``
    while active and put back as they were after (an unset shared-KV switch
    reads ``MDT_CFG_SHAREDKV`` again)."""
    from . import resnet_fusion, transformer_fusion
    saved = (resnet_fusion.resnet_fusion_enabled(),
             transformer_fusion._SHAREDKV)
    resnet_fusion.enable_resnet_fusion(on)
    transformer_fusion.enable_sharedkv(on)
    try:
        yield
    finally:
        resnet_fusion.enable_resnet_fusion(saved[0])
        transformer_fusion._SHAREDKV = saved[1]
