"""The Transformer1d stack kernel (``csrc/transformer1d_fwd.cu``) against its
plain PyTorch version on an NVIDIA card, at the stack shapes of the 91M
inverse QM9 model.  Marked ``cuda_hw``: every test skips without a CUDA
card (decided inside the fixture).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: 1e-4 in float32 with TF32 off (only the order of float32 sums
differs) and 2e-2 in bfloat16 on unit-scale inputs (the JAX fused-vs-
composition band, 0.016)."""
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.nn.attention import Transformer1d
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters
from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion as tf

pytestmark = pytest.mark.cuda_hw

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (L, C, layers, cross) of the flagship's stacks
STACKS = [(8, 256, 2, False), (8, 256, 4, True), (2, 512, 2, False),
          (2, 512, 4, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _stack(dev, length, c, layers, cross, dtype, batch=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mod = Transformer1d(layers, c, 8, 64, 2,
                        context_features=128 if cross else None, dtype=dtype)
    init_parameters(mod, gen)
    x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
    ctx = (torch.randn(batch, 12, 128, generator=gen).to(dev, dtype)
           if cross else None)
    return mod.to(dev), x, ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c,layers,cross", STACKS)
def test_kernel_matches_plain_version(cuda, length, c, layers, cross, dtype):
    mod, x, ctx = _stack(cuda, length, c, layers, cross, dtype)
    kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
    with torch.no_grad():
        before = tf.LAUNCHES
        out = tf.transformer1d_forward(mod.kernel_params(), x, ctx, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES == before + 1
        ref = tf.transformer1d_reference(mod.kernel_params(), x, ctx, **kw)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_module_dispatches_to_kernel(cuda):
    mod, x, ctx = _stack(cuda, 8, 256, 1, True, torch.float32, batch=4)
    with torch.no_grad():
        before = tf.LAUNCHES
        out = mod(x, ctx)
        assert tf.LAUNCHES == before + 1
        mod.disable_fusion = True
        composed = mod(x, ctx)
        assert tf.LAUNCHES == before + 1
    assert (out - composed).abs().max().item() <= TOL[torch.float32]


def test_kernel_refuses_what_it_does_not_take(cuda):
    mod, x, _ = _stack(cuda, 8, 256, 1, False, torch.float32, batch=4)
    kw = dict(num_layers=1, heads=8, head_dim=64, multiplier=2)
    params = mod.kernel_params()
    with pytest.raises(ValueError, match="contiguous"):
        tf.transformer1d_forward(params, x.transpose(0, 1), None, **kw)
    with pytest.raises(TypeError):
        tf.transformer1d_forward(params, x.half(), None, **kw)
    long = torch.zeros(2, tf.MAX_LENGTH + 1, 256, device=cuda)
    with pytest.raises(ValueError, match="L <="):
        tf.transformer1d_forward(params, long, None, **kw)
