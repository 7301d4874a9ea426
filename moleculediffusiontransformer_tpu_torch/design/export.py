"""Serving artifacts via ``torch.export`` (port of `design/export.py`).

An artifact is a ``.pt2`` file (``torch.export.save``) holding the program a
server calls, with a JSON header in its ``extra_files``: the artifact's kind,
the device it was exported on, its request inputs, the sampler or generator
settings it was exported with, and, when bundled, the tokenizer vocabulary,
the property scaler and the novelty corpus.  A serving host needs the file
and a checkpoint, and no model code (``design/serve.py``).

Every parameter and buffer of the model is an argument of the programs:
``call(variables, *inputs)`` with ``variables`` a dict keyed by the model's
``state_dict`` names.  The file holds no weights, and one export serves any
checkpoint of its architecture (``variables_skeleton`` rebuilds the dict from
the program's own input specs).

An artifact holds a main program and, by kind, programs that run less often
(``Artifact.programs``), so that a request does once what the live path
does once:

- ``prepare`` (once per load and per checkpoint): ``variables -> kernel
  weights``, each stack's ``kernel_params`` and, exported with K8's switch
  on, each resnet run's ``kernel_tensors`` (the weights cast to the compute
  dtype, K8's layout with its FiLM matrix), by module name -- what the live
  path caches.  The main program takes them as an input.
- ``context`` (once per request): what every decode step of the generator
  reads, ``(variables, sequences) -> context`` (the cross-attention KV, the
  text mask, the token table, the position code).

The main program, by kind:

- ``sampler`` and ``inpainter``: ONE classifier-free-guided denoise
  evaluation of a QM diffusion model, ``(variables, kernel_weights, x,
  sigmas, sequences) -> x0_hat``, the property embedding inside (a few
  small launches an evaluation).  The server runs the Karras schedule and
  ``diffusion/samplers.py``'s loop around it; the loop's name, steps, sigma
  range, rho, ``cond_scale`` (and ``num_resamples``) are in the header, as
  the JAX package bakes them into its program.  ``torch.export`` unrolls a
  Python loop: a 64-step request is 126 evaluations of ~1,400 launches,
  which would make a graph of ~175,000 nodes.
- ``generator``: ONE decode step of the AR transformer's CFG generation,
  ``(variables, context, token, pos, *caches) -> (logits2, *caches)``:
  the KV caches are explicit inputs and outputs, and ``pos`` is a 0-d tensor
  on the device (an ``int`` would make every position its own program).
  The server runs ``nn.transformer_blocks.decode_loop``, the loop of
  ``models.transformers.generate_sequence``.
- ``encoder``: the forward property transformer's whole forward,
  ``(variables, ids) -> logits``.

Export calls each program's body once on its example inputs before tracing
it: what the body keeps on the device (the position codes of
``nn.embeddings``) is then a device constant of the program.  A program
that would still copy a host constant at every call (a copy that a CUDA
graph cannot capture) is refused.

The hand-written kernels on these paths are PyTorch operators registered by
the port itself (``mdt_torch::t1d_forward``, ``mdt_torch::resnet_run``), so
an artifact captures them by default: the program names the operator, and
whichever process loads it with this package imported runs the kernel.  (The
JAX package exports the plain composition by default because a Mosaic custom
call is stable only within one Mosaic version; that reason is the TPU's.)

An artifact runs on the device type it was exported on (the program asserts
its tensors' device): every ``export_*`` takes ``device``, the card by
default, where the model must be -- the counterpart of JAX's
``platforms``.  Randomness is not inside the
program: the server draws it.

``export_sampler(mesh=)`` is the batch-parallel export (JAX's ``mesh=``):
the program is one rank's share, ``batch / n`` rows of an n-rank data
mesh, and the header records n and the global batch; ``ArtifactServer``
loads it only with a mesh of that size, and each rank serves its rows of
every request.  The other exporters have no mesh in JAX either.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

# a program names the kernels' operators: they must be registered to load it
from ..ops import resnet_fusion, transformer_fusion  # noqa: F401

__all__ = [
    "Artifact", "InputSpec", "export_sampler", "export_inpainter",
    "export_generator", "export_encoder", "variables_skeleton",
    "program_inputs", "save_artifact", "load_artifact", "load_bundle",
    "read_artifact", "serialize", "deserialize",
]

FORMAT = "moleculediffusiontransformer_tpu_torch.artifact/1"
HEADER = "mdtx_header.json"      # the header's name in the .pt2 extra_files
AUX = ("prepare", "context")   # the programs beside the main one
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "bool": torch.bool}


@dataclass(frozen=True)
class InputSpec:
    """One request input of an artifact: its fixed shape and dtype name."""
    shape: Tuple[int, ...]
    dtype: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclass
class Artifact:
    """An exported main program, its header (``kind``, ``device``,
    ``inputs`` and the kind's settings) and the kind's other programs by
    name (``AUX``)."""
    program: torch.export.ExportedProgram
    header: Dict[str, Any]
    programs: Dict[str, torch.export.ExportedProgram] = field(
        default_factory=dict)


class _Program(nn.Module):
    """``body`` with its parameters and buffers as call arguments: the body
    is not registered as a submodule, so that none of its weights is lifted
    into the exported program."""

    def __init__(self, body: nn.Module):
        super().__init__()
        object.__setattr__(self, "body", body)

    def forward(self, variables: Dict[str, torch.Tensor], *args):
        named = {f"model.{k}": v for k, v in variables.items()}
        return torch.func.functional_call(self.body, named, args)


def _kernel_holders(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """Each stack of ``model`` (``Transformer1d``, ``kernel_params``) and,
    with K8's switch on, each module of a resnet run (its ``resnet_weights``
    cache), by module name: the weights the live path caches."""
    out = []
    for name, mod in model.named_modules():
        cache = getattr(mod, "resnet_weights", None)
        if hasattr(mod, "given_kernel_params") or (
                isinstance(cache, resnet_fusion.WeightCache)
                and resnet_fusion.resnet_fusion_enabled()):
            out.append((name, mod))
    return out


class _Prepare(nn.Module):
    """``variables -> kernel weights`` by holder name (``_kernel_holders``):
    each stack's ``kernel_params`` and each run's ``kernel_tensors`` that
    are not their parameter as it is (the casts and K8's layout; the rest
    the main program reads from the variables)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        object.__setattr__(self, "holders", _kernel_holders(model))

    def forward(self) -> Dict[str, Dict[str, torch.Tensor]]:
        out = {}
        for name, mod in self.holders:
            if hasattr(mod, "given_kernel_params"):
                out[name] = mod.kernel_casts()
            else:
                out[name] = resnet_fusion.kernel_tensors(
                    list(mod.blocks), self.model.dtype, derived_only=True)
        return out


@contextlib.contextmanager
def _given(holders, weights: Dict[str, Dict[str, torch.Tensor]]):
    """While the main program is traced, each holder reads its kernel
    weights from the program's input ``weights``."""
    try:
        for name, mod in holders:
            if hasattr(mod, "given_kernel_params"):
                mod.given_kernel_params = weights.get(name, {})
            else:
                mod.resnet_weights.given = weights.get(name, {})
        yield
    finally:
        for _, mod in holders:
            if hasattr(mod, "given_kernel_params"):
                mod.given_kernel_params = None
            else:
                mod.resnet_weights.given = None


class _Denoise(nn.Module):
    """One CFG denoise evaluation of a QM diffusion model on the kernel
    weights ``prepare`` made: the sampler's closure of
    ``models.qm_diffusion.sample`` and ``inpaint``."""

    def __init__(self, model: nn.Module, cond_scale: float):
        super().__init__()
        self.model, self.cond_scale = model, cond_scale
        object.__setattr__(self, "holders", _kernel_holders(model))

    def forward(self, weights: Dict[str, Dict[str, torch.Tensor]],
                x: torch.Tensor, sigmas: torch.Tensor,
                sequences: torch.Tensor) -> torch.Tensor:
        with _given(self.holders, weights):
            emb = self.model.embed_conditioning(sequences)
            return self.model.denoise(x, sigmas, emb, self.cond_scale)


class _Context(nn.Module):
    def __init__(self, model: nn.Module, total: int):
        super().__init__()
        self.model, self.total = model, total

    def forward(self, sequences: torch.Tensor) -> Dict[str, Any]:
        return self.model.decode_context(sequences, self.total)


class _DecodeStep(nn.Module):
    """One position of ``generate_sequence``'s CFG decode: the caches are
    copied, written at ``pos`` and returned."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, context: Dict[str, Any], token: torch.Tensor,
                pos: torch.Tensor, *caches: torch.Tensor):
        caches = [c.clone() for c in caches]
        logits2 = self.model.decode_token(token, pos, context, caches)
        return (logits2, *caches)


class _Encode(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model(ids)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("mesh= is offered by export_sampler only: the JAX "
                         "package has no batch-parallel inpainter, "
                         "generator or encoder either")


def _export_device(model: nn.Module, device) -> torch.device:
    """The device an artifact is exported for: ``device`` (the card by
    default), where the model must already be; no copy, no fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"exporting for {device}: no CUDA device here")
    have = next(model.parameters()).device
    if have.type != device.type:
        raise ValueError(f"the model is on {have}: an artifact is exported "
                         f"on the device it serves on ({device}); move the "
                         f"model there or pass device=")
    return have


def _export(model: nn.Module, body: nn.Module, args: Sequence[Any]):
    """``body`` traced as a program of ``(variables, *args)``, after one
    call on them (see the module's docstring); returns (the program, its
    output on the example inputs)."""
    variables = {k: v.detach() for k, v in model.state_dict().items()}
    program_body = _Program(body)
    with torch.no_grad():
        out = program_body(variables, *args)
        program = torch.export.export(program_body, (variables, *args),
                                      strict=False)
    copies = [str(n.args[0]) for n in program.graph.nodes
              if n.target is torch.ops.aten.lift_fresh_copy.default]
    if copies:
        raise ValueError(f"the program copies the host constants {copies} "
                         f"at every call")
    # the example inputs hold the weights traced with: not part of the file
    program.example_inputs = None
    return program, out


def _spec(shape, dtype: str) -> Dict[str, Any]:
    return {"shape": [int(s) for s in shape], "dtype": dtype}


def _n_cond(model: nn.Module, num_conditioning: Optional[int],
            attr: str) -> int:
    return getattr(model, attr) if num_conditioning is None \
        else num_conditioning


def _export_denoise(model, device, kind: str, batch: int, cond_scale: float,
                    n_cond: int, settings: Dict[str, Any],
                    inputs: List[Dict[str, Any]]) -> Artifact:
    """The denoise program at ``batch`` rows (a rank's share of the request
    under a mesh), ``inputs`` the request's."""
    device = _export_device(model, device)
    shape = (batch, model.max_length, model.pred_dim)
    programs = {}
    with torch.no_grad():
        weights = _Prepare(model)()
    if any(weights.values()):
        programs["prepare"], weights = _export(model, _Prepare(model), ())
    else:                         # every weight is used as it is
        weights = {}
    program, _ = _export(model, _Denoise(model, cond_scale), (
        weights, torch.zeros(shape, device=device),
        torch.ones(batch, device=device),
        torch.zeros(batch, n_cond, device=device)))
    header = {"format": FORMAT, "kind": kind, "device": device.type,
              "inputs": inputs, "shape": list(shape[1:]),
              "sampler": dict(settings, cond_scale=cond_scale)}
    return Artifact(program, header, programs)


def export_sampler(model: nn.Module, *, batch: int, num_steps: int = 100,
                   cond_scale: float = 7.5, clamp: bool = False,
                   sigma_min: float = 1e-3, sigma_max: float = 9.0,
                   rho: float = 3.0, num_conditioning: Optional[int] = None,
                   mesh=None, device="cuda") -> Artifact:
    """Export the CFG sampler of a QM diffusion model on its device: the
    denoise program, with ADPM2 (rho 1) over the Karras(sigma_min,
    sigma_max, rho) schedule in ``num_steps`` steps and ``cond_scale`` in
    the header -- the live ``models.qm_diffusion.sample``.  The request is
    ``sequences`` (batch, num_conditioning) float32 property scalars
    (default: the model's ``context_embedding_max_length``); the server
    returns (batch, max_length, pred_dim) float32.

    ``mesh`` (a data mesh of n ranks, ``parallel.make_mesh``): the program
    is one rank's share of the request, ``batch / n`` rows, and the header
    records n and ``batch``; ``batch`` must divide the mesh, as in JAX."""
    n_cond = _n_cond(model, num_conditioning, "context_embedding_max_length")
    settings = dict(name="adpm2", num_steps=num_steps, clamp=clamp,
                    sigma_min=sigma_min, sigma_max=sigma_max, rho=rho)
    ranks = 1 if mesh is None else mesh.size()
    if batch % ranks:
        raise ValueError(f"batch {batch} must divide the {ranks}-rank mesh")
    art = _export_denoise(model, device, "sampler", batch // ranks,
                          cond_scale, n_cond, settings,
                          [_spec((batch, n_cond), "float32")])
    if mesh is not None:
        art.header["mesh"] = {"size": ranks, "batch": batch}
    return art


def export_inpainter(model: nn.Module, *, batch: int, num_steps: int = 100,
                     num_resamples: int = 1, cond_scale: float = 7.5,
                     sigma_min: float = 1e-3, sigma_max: float = 9.0,
                     rho: float = 3.0,
                     num_conditioning: Optional[int] = None,
                     mesh=None, device="cuda") -> Artifact:
    """Export the RePaint inpainter (``models.qm_diffusion.inpaint``): the
    same denoise program, with ``num_resamples`` in the header.  The request
    is ``(sequences, source, mask)``: source (batch, L, pred_dim) float32,
    mask the same shape, bool (True = keep from source)."""
    _no_mesh(mesh)
    n_cond = _n_cond(model, num_conditioning, "context_embedding_max_length")
    track = (batch, model.max_length, model.pred_dim)
    settings = dict(name="inpaint_adpm2", num_steps=num_steps,
                    num_resamples=num_resamples, sigma_min=sigma_min,
                    sigma_max=sigma_max, rho=rho)
    inputs = [_spec((batch, n_cond), "float32"), _spec(track, "float32"),
              _spec(track, "bool")]
    return _export_denoise(model, device, "inpainter", batch, cond_scale,
                           n_cond, settings, inputs)


def export_generator(model: nn.Module, *, batch: int, start_len: int = 1,
                     tokens_to_generate: int = 63, cond_scale: float = 1.5,
                     temperature: float = 1.0, filter_thres: float = 0.9,
                     num_conditioning: Optional[int] = None,
                     mesh=None, device="cuda") -> Artifact:
    """Export one decode step of the AR transformer's KV-cached CFG
    generation (``models.transformers.generate_sequence``); the settings are
    in the header.  The request is ``(sequences, start_ids)``: the (batch,
    num_conditioning) property scalars (default: the model's
    ``max_text_len``) and the (batch, start_len) int64 prompt; the server
    returns (batch, start_len + tokens_to_generate) int64 ids."""
    _no_mesh(mesh)
    device = _export_device(model, device)
    n_cond = _n_cond(model, num_conditioning, "max_text_len")
    total = start_len + tokens_to_generate
    caches = model.init_cache(2 * batch, total, device)
    context, example = _export(model, _Context(model, total), (
        torch.zeros(batch, n_cond, device=device),))
    program, _ = _export(model, _DecodeStep(model), (
        example, torch.zeros(batch, dtype=torch.int64, device=device),
        torch.zeros((), dtype=torch.int64, device=device), *caches))
    header = {"format": FORMAT, "kind": "generator", "device": device.type,
              "inputs": [_spec((batch, n_cond), "float32"),
                         _spec((batch, start_len), "int64")],
              "generator": dict(start_len=start_len,
                                tokens_to_generate=tokens_to_generate,
                                cond_scale=cond_scale,
                                temperature=temperature,
                                filter_thres=filter_thres,
                                vocab=model.logits_dim)}
    return Artifact(program, header, {"context": context})


def export_encoder(model: nn.Module, *, batch: int, max_length: int = 64,
                   mesh=None, device="cuda") -> Artifact:
    """Export the forward property transformer
    (``MoleculeTransformerSequenceEncoder``): the request is ``ids``
    (batch, max_length) int64 padded token ids; the server returns the raw
    scaled-property logits (apply ``scaler.inverse_transform`` on the
    host)."""
    _no_mesh(mesh)
    device = _export_device(model, device)
    ids = torch.zeros(batch, max_length, dtype=torch.int64, device=device)
    program, _ = _export(model, _Encode(model), (ids,))
    header = {"format": FORMAT, "kind": "encoder", "device": device.type,
              "inputs": [_spec((batch, max_length), "int64")]}
    return Artifact(program, header)


# ------------------------------------------------------ the program's args --

def program_inputs(program: torch.export.ExportedProgram,
                   device: Optional[torch.device] = None):
    """The program's call arguments as zero tensors of its own input specs,
    ``(variables, *args)`` structured by its input tree, on ``device`` (else
    on the device it was exported on; ``"meta"`` allocates nothing)."""
    from torch.utils import _pytree
    user = set(program.graph_signature.user_inputs)
    flat = [torch.zeros(node.meta["val"].shape, dtype=node.meta["val"].dtype,
                        device=node.meta["val"].device if device is None
                        else device)
            for node in program.graph.nodes
            if node.op == "placeholder" and node.name in user]
    args, _ = _pytree.tree_unflatten(flat, program.call_spec.in_spec)
    return args


def variables_skeleton(program: torch.export.ExportedProgram,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, torch.Tensor]:
    """Zero tensors of the program's first argument, the variables, by name
    and shape from the program's own input specs (on ``device``, else on
    the device it was exported on): a serving process restores a
    checkpoint into it without any model code."""
    return program_inputs(program, device)[0]


# --------------------------------------------------------- wire format --

def _save(program: torch.export.ExportedProgram, extra=None) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files=extra)
    return buf.getvalue()


def serialize(artifact: Artifact) -> bytes:
    """The ``.pt2`` bytes of ``artifact``'s main program, with the header
    and the other programs (each a ``.pt2`` of its own, base64) in
    ``extra_files``."""
    extra = {HEADER: json.dumps(artifact.header)}
    for name, program in artifact.programs.items():
        extra[f"{name}.pt2.b64"] = base64.b64encode(_save(program)).decode()
    return _save(artifact.program, extra)


@contextlib.contextmanager
def _type_hints_memoized() -> Iterator[None]:
    """While active, torch's program reader (``torch._export.serde``) gets
    each dataclass's type hints computed once: it asks
    ``typing.get_type_hints`` again for every field of every node, about
    half the seconds of loading a 91M sampler.  The answers are the same;
    only the module's name ``typing`` is swapped, and put back after."""
    from torch._export.serde import serialize as serde
    real = serde.typing
    hints: Dict[Any, Any] = {}

    class Typing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def get_type_hints(obj, globalns=None, localns=None,
                           include_extras=False):
            key = (obj, id(globalns), id(localns), include_extras)
            if key not in hints:
                hints[key] = real.get_type_hints(obj, globalns, localns,
                                                 include_extras)
            return hints[key]

    serde.typing = Typing()
    try:
        yield
    finally:
        serde.typing = real


def deserialize(blob: bytes) -> Artifact:
    extra = {HEADER: "", **{f"{name}.pt2.b64": "" for name in AUX}}
    with _type_hints_memoized():
        program = torch.export.load(io.BytesIO(blob), extra_files=extra)
        header = json.loads(extra[HEADER]) if extra[HEADER] else {}
        if header.get("format") != FORMAT:
            raise ValueError("not a serving artifact of this package (no "
                             f"{FORMAT} header)")
        programs = {name: torch.export.load(io.BytesIO(base64.b64decode(
            extra[f"{name}.pt2.b64"]))) for name in AUX
            if extra[f"{name}.pt2.b64"]}
    return Artifact(program, header, programs)


def save_artifact(artifact: Artifact, path: str, *, tokenizer=None,
                  scaler=None, training_smiles: Optional[Sequence[str]] = None,
                  extra: Optional[dict] = None) -> None:
    """Write a serving bundle.  ``tokenizer`` (``CharTokenizer``) and
    ``scaler`` (``MinMaxScaler``) are embedded via their ``state_dict``;
    ``training_smiles`` (the novelty reference set) and ``extra`` (free-form
    JSON metadata, e.g. the task) are optional."""
    header = dict(artifact.header)
    header.update(extra or {})
    if tokenizer is not None:
        header["tokenizer"] = tokenizer.state_dict()
    if scaler is not None:
        header["scaler"] = scaler.state_dict()
    if training_smiles is not None:
        header["training_smiles"] = list(training_smiles)
    with open(path, "wb") as f:
        f.write(serialize(Artifact(artifact.program, header,
                                   artifact.programs)))


def read_artifact(path: str) -> Artifact:
    """A serving bundle's programs and header."""
    with open(path, "rb") as f:
        return deserialize(f.read())


def load_bundle(path: str) -> Tuple[torch.export.ExportedProgram, dict]:
    """A serving artifact's main program and its header."""
    art = read_artifact(path)
    return art.program, art.header


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """A serving artifact's main program; call ``.module()(variables,
    *args)``."""
    return load_bundle(path)[0]
