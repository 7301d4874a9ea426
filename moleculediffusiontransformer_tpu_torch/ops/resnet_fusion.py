"""A UNet stage's run of ResnetBlock1d's as one hand-written CUDA kernel
chain (port of `ops/resnet_fusion.py`, kernel K8).

``resnet_stack_forward`` runs N blocks: per block [concat a skip times
``skip_scale``] -> GroupNorm(groups, eps 1e-5) -> SiLU -> k3 conv ->
GroupNorm -> [FiLM from the mapping] -> SiLU -> k3 conv -> + x (or + the 1x1
projection of a widened x), optionally keeping every block's output.  On a
CUDA tensor it launches ``csrc/resnet_fwd.cu`` (built on first use by
``ops.cuda_build``) or raises; on a CPU tensor it runs the plain version
``resnet_stack_reference``, the kernel's arithmetic in PyTorch.  The
rounding is the Pallas kernel's: each conv's and the projection's
(acc + bias) rounded to the compute dtype, GroupNorm, FiLM and SiLU in
float32 and rounded before each conv, ``h + x`` in the compute dtype.
Every product of the kernel (both convs of each block, each widening
block's projection, and one FiLM product for the whole run, over the
blocks' FiLM weights that ``kernel_weights`` lays out as one matrix) runs on
the tensor-core GEMM of ``csrc/gemm_tc.cuh``, bfloat16 in one pass and
float32 in three TF32 passes; ``tc_products`` says how many a call sends
there, and ``gemm_tc_launches`` counts them.

The call goes through the operator ``mdt_torch::resnet_run``
(``torch.library.custom_op``, with a fake for the outputs' shapes), so that
``torch.export`` records it as one node and a CUDA graph captures its
launch.

``resnet_stack`` is the run with gradients: the kernel forward and, as its
backward, autograd of the ``ResnetBlock1d`` composition recomputed — the
JAX ``custom_vjp`` differentiates its slow path the same way, and has no
backward kernel.

Off by default, as in the JAX package (``enable_resnet_fusion``); the UNet's
down and up blocks dispatch to it when it is on (``nn/unet.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..nn.blocks import ResnetBlock1d
from ..nn.primitives import group_norm, silu
from . import cuda_build
from .transformer_fusion import (_DTYPES, _mm, _on_cpu, _raise_on, _stream,
                                 recompute)

SOURCE = "resnet_fwd.cu"
EPS = 1e-5

# Kernel launches since import (or the last reset by the caller), one per
# wrapper call on a CUDA tensor.
RESNET_LAUNCHES = 0

_RESNET_ENABLED = False
_LIB: Optional[ctypes.CDLL] = None


def enable_resnet_fusion(on: bool = True) -> None:
    """Opt in to (or out of) the resnet-run kernel; off by default."""
    global _RESNET_ENABLED
    _RESNET_ENABLED = on


def resnet_fusion_enabled() -> bool:
    return _RESNET_ENABLED


def fusable(x: torch.Tensor, blocks: Sequence[ResnetBlock1d],
            groups: int) -> bool:
    """The JAX gate: k3 convs and channel counts that the groups divide."""
    if not blocks or x.shape[-1] % groups:
        return False
    for blk in blocks:
        conv1, conv2 = blk.block1.project, blk.block2.project
        if (conv1.kernel_size != 3 or conv2.kernel_size != 3
                or conv2.weight.shape[0] % groups):
            return False
    return True


def kernel_weights(blocks: Sequence[ResnetBlock1d],
                   dtype: torch.dtype) -> List[List[torch.Tensor]]:
    """Each block's weights in the JAX ``flatten_stack`` order: GroupNorm 1
    scale, bias; conv 1 W (C_out, 3*C_in) tap-major ([prev, cur, next]
    blocks of C_in columns), b; [FiLM W (2*C_out, C_m), b]; GroupNorm 2
    scale, bias; conv 2 W, b; [projection W (C_out, C_in), b].  Matrices in
    ``dtype``, vectors float32, all contiguous and detached.  The blocks'
    FiLM weights and biases are consecutive row blocks of one (n*2*C_out,
    C_m) matrix and one vector, so that the kernel computes every block's
    scale and shift in one product (``film_contiguous``)."""
    return kernel_layout(blocks, kernel_tensors(blocks, dtype))


def _block_params(blk: ResnetBlock1d) -> List[Optional[torch.Tensor]]:
    """The parameter behind each of a block's ``kernel_weights`` entries
    (None for the FiLM pair, whose entries are views of the run's FiLM
    matrix and vector)."""
    one, two = blk.block1, blk.block2
    ps = [one.groupnorm.weight, one.groupnorm.bias, one.project.weight,
          one.project.bias]
    if blk.use_mapping:
        ps += [None, None]
    ps += [two.groupnorm.weight, two.groupnorm.bias, two.project.weight,
           two.project.bias]
    if blk.to_out is not None:
        ps += [blk.to_out.weight, blk.to_out.bias]
    return ps


def kernel_tensors(blocks: Sequence[ResnetBlock1d], dtype: torch.dtype,
                   derived_only: bool = False) -> Dict[str, torch.Tensor]:
    """``kernel_weights`` as named tensors: ``"{i}.{j}"`` entry j of block
    i, except the FiLM pairs, which are ``"film.w"`` and ``"film.b"``, the
    whole matrix and vector.  ``derived_only``: only the entries that are
    not their parameter as it is (a serving program takes these as inputs,
    made once per load: ``design.export``)."""
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        denses = [blk.to_scale_shift.to_scale_shift[1] for blk in blocks
                  if blk.use_mapping]
        if denses:
            out["film.w"] = torch.cat([d.weight for d in denses]).to(dtype)
            out["film.b"] = torch.cat([d.bias for d in denses]).float()
        for i, blk in enumerate(blocks):
            for j, p in enumerate(_block_params(blk)):
                if p is None:
                    continue
                if p.dim() == 3:    # a conv's W as (C_out, 3*C_in), tap-major
                    w = p.permute(0, 2, 1).reshape(p.shape[0], -1).to(
                        dtype).contiguous()
                elif p.dtype == torch.float32 and p.is_contiguous():
                    if derived_only:
                        continue
                    w = p
                else:
                    w = p.float().contiguous()
                out[f"{i}.{j}"] = w.detach()
    return out


def kernel_layout(blocks: Sequence[ResnetBlock1d],
                  tensors: Dict[str, torch.Tensor]) -> List[List[torch.Tensor]]:
    """``kernel_tensors``' entries as ``kernel_weights``' lists, each FiLM
    pair a view of the one matrix and vector, an entry not given the
    parameter itself."""
    rows = [blk.to_scale_shift.to_scale_shift[1].weight.shape[0]
            for blk in blocks if blk.use_mapping]
    film = iter(zip(tensors["film.w"].split(rows),
                    tensors["film.b"].split(rows)) if rows else ())
    out = []
    for i, blk in enumerate(blocks):
        ws = [tensors.get(f"{i}.{j}", p)
              for j, p in enumerate(_block_params(blk))]
        if blk.use_mapping:
            ws[4:6] = next(film)
        out.append(ws)
    return out


def film_contiguous(weights: Sequence[Sequence[torch.Tensor]]) -> bool:
    """True when the blocks' FiLM weights and biases (entries 4 and 5 of each
    block) lie one after the other in memory, as ``kernel_weights`` lays
    them out: what the kernel's one FiLM product reads."""
    w0, b0 = weights[0][4], weights[0][5]
    return all(
        ws[4].data_ptr() == w0.data_ptr() + i * w0.numel() * w0.element_size()
        and ws[5].data_ptr() == b0.data_ptr() + i * b0.numel() * 4
        for i, ws in enumerate(weights))


def tc_products(weights: Sequence[Sequence[torch.Tensor]],
                film: bool) -> int:
    """Products a kernel call sends to the tensor cores, in either dtype:
    both convs of every block, the projection of each block that widens,
    and one FiLM product for the run."""
    return (sum(2 + (_split(ws, film)[5] is not None) for ws in weights)
            + int(film))


class WeightCache:
    """``kernel_weights`` of one run of blocks, rebuilt when a parameter is
    replaced or modified in place (as ``Transformer1d.kernel_params``)."""

    def __init__(self):
        self._key = None
        self._weights: List[List[torch.Tensor]] = []
        # set while a serving program is traced (``design.export``): the
        # run's ``kernel_tensors`` as the program's inputs, made once per load
        self.given: Optional[Dict[str, torch.Tensor]] = None

    def drop(self) -> None:
        """Forget the cached weights: the next ``get`` rebuilds them."""
        self._key = None

    def get(self, blocks: Sequence[ResnetBlock1d],
            dtype: torch.dtype) -> List[List[torch.Tensor]]:
        if self.given is not None:      # traced by ``design.export``
            return kernel_layout(blocks, self.given)
        key = (dtype, tuple((p.data_ptr(), p._version, p.device)
                            for blk in blocks for p in blk.parameters()))
        if key != self._key:
            self._weights, self._key = kernel_weights(blocks, dtype), key
        return self._weights


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _conv3(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k3, padding 1 conv as shifted-row im2col . W^T + b, float32: each
    sequence's ends see zeros."""
    zero = torch.zeros_like(v[:, :1])
    prev = torch.cat([zero, v[:, :-1]], dim=1)
    nxt = torch.cat([v[:, 1:], zero], dim=1)
    return _mm(torch.cat([prev, v, nxt], dim=-1), w) + b


def _split(ws: Sequence[torch.Tensor], film: bool):
    """One block's ABI entries -> (norm1, conv1, film, norm2, conv2, proj)."""
    it = iter(ws)
    take = lambda k: [next(it) for _ in range(k)]   # noqa: E731
    parts = (take(2), take(2), take(2) if film else None, take(2), take(2))
    rest = list(it)
    return (*parts, rest or None)


def resnet_stack_reference(weights: Sequence[Sequence[torch.Tensor]],
                           x: torch.Tensor, mapping: Optional[torch.Tensor],
                           skips: Optional[Sequence[Optional[torch.Tensor]]]
                           = None, *, groups: int = 8,
                           skip_scale: float = 1.0, collect: bool = False
                           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain version of the kernel.  ``weights``: ``kernel_weights``' list,
    one entry per block; x (b, L, C_in) in the compute dtype; mapping
    (b, C_m) or None; ``skips[i]`` (b, L, C_s) concatenated before block i,
    or None.  Returns (out (b, L, C_out), every block's output when
    ``collect``, else [])."""
    dt = x.dtype
    film = mapping is not None
    sm = silu(mapping.to(dt).float()).to(dt) if film else None
    scale = torch.tensor(skip_scale, dtype=dt)    # the JAX kernel's rounding
    outs = []
    for i, ws in enumerate(weights):
        skip = None if skips is None else skips[i]
        if skip is not None:
            x = torch.cat([x, skip.to(dt) * scale], dim=-1)
        n1, c1, fm, n2, c2, proj = _split(ws, film)
        h = silu(group_norm(x, *n1, num_groups=groups, eps=EPS)).to(dt)
        h = _conv3(h, *c1).to(dt)
        h32 = group_norm(h, *n2, num_groups=groups, eps=EPS)
        if film:
            ss = (_mm(sm, fm[0]) + fm[1])[:, None, :]
            c = h.shape[-1]
            h32 = h32 * (ss[..., :c] + 1.0) + ss[..., c:]
        h = _conv3(silu(h32).to(dt), *c2).to(dt)
        if proj is not None:
            x = (_mm(x, proj[0]) + proj[1]).to(dt)
        x = h + x
        outs.append(x)
    return x, (outs if collect else [])


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.rs_num_weights.argtypes = [_I, _P, _I, _I]
        lib.rs_num_weights.restype = _I
        lib.rs_workspace_bytes.argtypes = [_I, _P, _P] + [_I] * 5
        lib.rs_workspace_bytes.restype = ctypes.c_longlong
        lib.rs_forward.argtypes = ([_P] * 4 + [_I, _P, _I, _P,
                                               ctypes.c_longlong, _I, _P, _P]
                                   + [_I] * 5 + [ctypes.c_float] + [_I] * 2
                                   + [_P])
        lib.rs_forward.restype = _I
        lib.rs_error_string.argtypes = [_I]
        lib.rs_error_string.restype = ctypes.c_char_p
        lib.rs_gemm_tc_launches.argtypes = [_I]
        lib.rs_gemm_tc_launches.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def gemm_tc_launches(reset: bool = False) -> int:
    """Products the resnet-run kernel has sent to the tensor cores since its
    library was loaded or last reset (apart from the stack libraries'
    ``transformer_fusion.gemm_tc_launches``)."""
    return 0 if _LIB is None else _LIB.rs_gemm_tc_launches(int(reset))


def _check(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
           device: torch.device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"contiguous={t.is_contiguous()}")


def _chain(weights, x, mapping, skips, groups):
    """Check the run's shapes; returns (C_in per block after its concat,
    skip channels per block, C_out)."""
    film = mapping is not None
    cout = weights[0][2].shape[0]
    cin, skip_c, prev = [], [], x.shape[-1]
    for i, ws in enumerate(weights):
        skip = None if skips is None else skips[i]
        cs = 0 if skip is None else skip.shape[-1]
        n1, c1, fm, n2, c2, proj = _split(ws, film)
        c = prev + cs
        want = {"conv 1": (c1[0], (cout, 3 * c)),
                "conv 2": (c2[0], (cout, 3 * cout)),
                "GroupNorm 1": (n1[0], (c,)), "GroupNorm 2": (n2[0], (cout,))}
        if film:
            want["FiLM"] = (fm[0], (2 * cout, mapping.shape[-1]))
        if (proj is not None) != (c != cout):
            raise ValueError(f"block {i}: a projection is needed exactly "
                             f"when C_in {c} != C_out {cout}")
        if proj is not None:
            want["projection"] = (proj[0], (cout, c))
        for what, (w, shape) in want.items():
            if tuple(w.shape) != shape:
                raise ValueError(f"block {i}: {what} weight "
                                 f"{tuple(w.shape)}, expected {shape}")
        if c % groups or cout % groups:
            raise ValueError(f"block {i}: {groups} groups do not divide "
                             f"C_in {c} / C_out {cout}")
        cin.append(c)
        skip_c.append(cs)
        prev = cout
    return cin, skip_c, cout


def resnet_stack_forward(weights: Sequence[Sequence[torch.Tensor]],
                         x: torch.Tensor, mapping: Optional[torch.Tensor],
                         skips: Optional[Sequence[Optional[torch.Tensor]]]
                         = None, *, groups: int = 8,
                         skip_scale: float = 1.0, collect: bool = False
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run the blocks: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (arguments and result as ``resnet_stack_reference``);
    raises for anything the kernel does not take.  The call goes through
    the operator ``mdt_torch::resnet_run``."""
    skip_list = list(skips) if skips is not None else [None] * len(weights)
    _on_cpu(x, mapping, *skip_list)     # refuses other devices and mixes
    outs = torch.ops.mdt_torch.resnet_run(
        x, mapping, skip_list, [w for ws in weights for w in ws],
        [len(ws) for ws in weights], groups, float(skip_scale), collect)
    return outs[-1], (list(outs) if collect else [])


@torch.library.custom_op("mdt_torch::resnet_run", mutates_args=())
def resnet_run_op(x: torch.Tensor, mapping: Optional[torch.Tensor],
                  skips: List[Optional[torch.Tensor]],
                  weights: List[torch.Tensor], block_sizes: List[int],
                  groups: int, skip_scale: float,
                  collect: bool) -> List[torch.Tensor]:
    """K8 as a PyTorch operator (``torch.export`` records one node, a CUDA
    graph captures the launch): ``weights`` is ``kernel_weights``' list
    flattened, ``block_sizes`` the entries of each block.  Returns every
    block's output with ``collect``, else the last one alone.  On CUDA
    tensors it launches the kernel, on CPU tensors it runs the plain
    version."""
    it = iter(weights)
    nested = [[next(it) for _ in range(k)] for k in block_sizes]
    if _on_cpu(x, mapping, *skips):
        out, outs = resnet_stack_reference(nested, x, mapping, skips,
                                           groups=groups,
                                           skip_scale=skip_scale,
                                           collect=collect)
        return outs if collect else [out]
    return _launch(nested, x, mapping, skips, groups, skip_scale, collect)


@resnet_run_op.register_fake
def _resnet_run_fake(x, mapping, skips, weights, block_sizes, groups,
                     skip_scale, collect):
    shape = (*x.shape[:-1], weights[2].shape[0])   # C_out of conv 1
    return [x.new_empty(shape) for _ in range(len(block_sizes)
                                              if collect else 1)]


def _launch(weights, x, mapping, skip_list, groups, skip_scale, collect):
    """Launch K8 on CUDA tensors and count the launch in
    ``RESNET_LAUNCHES`` (here alone, where the kernel is enqueued: a traced
    call counts nothing, a CUDA graph's replays nothing either)."""
    global RESNET_LAUNCHES
    dt, dev = x.dtype, x.device
    if dt not in _DTYPES:
        raise TypeError(f"resnet kernel takes float32 or bfloat16, not {dt}")
    if x.dim() != 3 or len(skip_list) != len(weights) or not weights:
        raise ValueError(f"x must be (b, L, C) with one skip entry per "
                         f"block, got {tuple(x.shape)}, {len(skip_list)} "
                         f"skips for {len(weights)} blocks")
    b, length, _ = x.shape
    cin, skip_c, cout = _chain(weights, x, mapping, skip_list, groups)
    _check("x", x, x.shape, dt, dev)
    cm = 0
    if mapping is not None:
        cm = mapping.shape[-1]
        mapping = mapping.to(dt).contiguous()
        _check("mapping", mapping, (b, cm), dt, dev)
    skip_list = [None if s is None else s.to(dt).contiguous()
                 for s in skip_list]
    for i, s in enumerate(skip_list):
        if s is not None:
            _check(f"skip {i}", s, (b, length, skip_c[i]), dt, dev)
    flat = [w for ws in weights for w in ws]
    # up to ~50 weights a call, checked in one lean pass (the wrapper's host
    # time is most of a call's at the presets); _check words the refusal
    for w in flat:
        want = torch.float32 if w.dim() == 1 else dt
        if w.device != dev or w.dtype != want or not w.is_contiguous():
            _check("weight", w, w.shape, want, dev)
    if mapping is not None and not film_contiguous(weights):
        raise ValueError("the blocks' FiLM weights must be consecutive rows "
                         "of one matrix, as kernel_weights lays them out")

    lib = _library()
    n = len(weights)
    cin_a, skip_a = (ctypes.c_int * n)(*cin), (ctypes.c_int * n)(*skip_c)
    if lib.rs_num_weights(n, cin_a, cout, int(cm > 0)) != len(flat):
        raise ValueError(f"kernel expects another number of weights than "
                         f"{len(flat)}")
    nbytes = lib.rs_workspace_bytes(n, cin_a, skip_a, cout, b, length, cm,
                                    _DTYPES[dt])
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    outs = [torch.empty((b, length, cout), dtype=dt, device=dev)
            for _ in range(n if collect else 1)]
    wptrs = (ctypes.c_void_p * len(flat))(*[w.data_ptr() for w in flat])
    sptrs = (ctypes.c_void_p * n)(*[None if s is None else s.data_ptr()
                                    for s in skip_list])
    optrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    err = lib.rs_forward(
        x.data_ptr(), None if mapping is None else mapping.data_ptr(), sptrs,
        optrs, int(collect), wptrs, len(flat), work.data_ptr(), nbytes, n,
        cin_a, skip_a, cout, b, length, cm, groups, skip_scale, _DTYPES[dt],
        dev.index, _stream(x))
    _raise_on(err, "resnet stack kernel", lib, "rs_error_string")
    RESNET_LAUNCHES += 1
    return outs


# --------------------------------------------------------------------------
# the module composition, and the run with gradients
# --------------------------------------------------------------------------

def resnet_stack_composition(blocks: Sequence[ResnetBlock1d], x: torch.Tensor,
                             mapping: Optional[torch.Tensor],
                             skips: Optional[Sequence[torch.Tensor]] = None,
                             *, skip_scale: float = 1.0
                             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The blocks as modules (the JAX ``slow``): returns (out, every
    block's output)."""
    outs = []
    for i, blk in enumerate(blocks):
        if skips is not None and skips[i] is not None:
            x = torch.cat([x, skips[i] * skip_scale], dim=-1)
        x = blk(x, mapping)
        outs.append(x)
    return x, outs


def resnet_stack(blocks: Sequence[ResnetBlock1d],
                 weights: Sequence[Sequence[torch.Tensor]], x: torch.Tensor,
                 mapping: Optional[torch.Tensor],
                 skips: Optional[Sequence[torch.Tensor]] = None, *,
                 groups: int = 8, skip_scale: float = 1.0,
                 collect: bool = False
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``resnet_stack_forward`` with ``weights`` = ``kernel_weights(blocks)``
    and, under autograd, the gradients of ``resnet_stack_composition`` for
    x, the mapping, the skips and every block parameter."""
    n = len(blocks)
    skip_list = list(skips) if skips is not None else [None] * n
    kw = dict(groups=groups, skip_scale=skip_scale, collect=collect)

    def kernel(xx, mm, *ss):
        out, outs = resnet_stack_forward(weights, xx, mm, list(ss), **kw)
        return tuple(outs) if collect else out

    def composition(xx, mm, *ss):
        out, outs = resnet_stack_composition(blocks, xx, mm, list(ss),
                                             skip_scale=skip_scale)
        return tuple(outs) if collect else out

    params = [p for blk in blocks for p in blk.parameters()]
    res = recompute(kernel, composition, [x, mapping, *skip_list], params)
    if collect:
        return res[-1], list(res)
    return res, []
