"""Model-code-free serving of exported artifacts (port of `design/serve.py`).

``ArtifactServer`` is the deployment side of ``design/export.py``: it loads a
``.pt2`` artifact, rebuilds the program's variables from the program's own
input specs (``variables_skeleton``), fills them from a checkpoint or from
seeded placeholders, makes the kernel weights from them once (the artifact's
``prepare`` program), and runs one fixed-batch request at a time.  It imports
the port's ``ops`` (which registers the kernels' operators), ``diffusion/``,
``nn.transformer_blocks`` (the AR loop) and ``data/``, never ``models/``.

Artifact kinds and their requests (``specs``, after padding to ``batch``):

  sampler    (props)                 -> one-hot tracks (b, L, vocab)
  inpainter  (props, source, mask)   -> one-hot tracks (b, L, vocab)
  generator  (props, start_ids)      -> token ids (b, start + new)
  encoder    (ids)                   -> scaled property logits

Randomness: the JAX ``key`` becomes ``seed=``, and the draws of a request
come from a ``torch.Generator`` on the serving device seeded with it, in
bulk: the sampler's start noise and every step's noise, the inpainter's
start, source, step and renoise draws, the generator's uniforms.  A draw
handed in (``noise=``, ``step_noise=``, ``source_noise=``, ``renoise=``,
``uniforms=``; shaped for the full batch) replaces the seeded one, so a
test can feed the JAX package's draws.

Two tiers serve, both on the card, both through the same program and its
kernels; ``tier`` names the one that answers:

- ``"graph"``: at load, on a CUDA device, one whole fixed-batch request
  (every denoise evaluation of the sampler loop, or every token of the
  generator) is captured into a ``torch.cuda.CUDAGraph``; a call copies its
  inputs and draws into the captured buffers and replays.  It is the
  counterpart of JAX's bundled live-compiled executable: fixed to this
  process and its addresses.  Every launch of the request is on the
  current stream and every workspace comes from the graph's pool; the
  kernels' host-side state (the TMA tensor maps ``csrc/gemm_tc.cuh``
  encodes at a launch) is baked in, which holds because every address
  stays put: ``reload_checkpoint`` copies into the variables in place, and
  the kernel weights (the weight casts and K8's layout) that the
  ``prepare`` program makes at load are remade into the same storage.  A
  generator's request runs the ``context`` program once, as the live path
  does, and the main program at every token.  A replay runs
  no Python, so the kernel wrappers' counters count the capture's launches
  once; ``launches`` keeps them (a request's K1, uniform_ctx and K8
  launches), and ``served`` counts the requests each tier answered.
- ``"eager"``: the program run call by call (on the CPU always; on the
  card where the capture failed, its error kept in ``exec_error``).

A sampler exported with ``mesh=`` (its program one rank's share of the
request) is served by every rank of a data mesh of its size
(``ArtifactServer(..., mesh=)``; every rank calls with the same request
and seed): each rank draws the whole request's draws from the seed, as one
card would, runs its rows through the program (the graph tier captures its
share), and the rows are gathered so that every rank returns the whole
output.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import read_state_dict
from ..diffusion.samplers import inpaint_adpm2
from ..diffusion.samplers import sample as run_sampler
from ..diffusion.schedules import karras_schedule
from ..nn.transformer_blocks import decode_loop
from ..ops import resnet_fusion, transformer_fusion  # their operators
from .export import InputSpec, program_inputs, read_artifact

_COUNTERS = ((transformer_fusion, "LAUNCHES"),
             (transformer_fusion, "UNIFORM_LAUNCHES"),
             (resnet_fusion, "RESNET_LAUNCHES"))


def serving_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card must be there when it is
    asked for (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serving on {device}: no CUDA device here")
    return device


class ArtifactServer:
    """One loaded artifact and its variables, ready to serve on ``device``
    (the card unless the caller names another).

    ``checkpoint``: restored into the program's variables; omitted ->
    seeded random-normal placeholders (smoke mode, clearly not a trained
    model).  ``startup`` holds the seconds of the load and of the
    capture.  ``mesh``: the data mesh that serves an artifact exported
    with one, of the size it records (and only such an artifact)."""

    def __init__(self, artifact_path: str, checkpoint: Optional[str] = None,
                 *, seed: int = 0, device="cuda", mesh=None):
        t0 = time.perf_counter()
        self.device = serving_device(device)
        art = read_artifact(artifact_path)
        self.program, header = art.program, art.header
        self.programs = art.programs
        exported_on = header.pop("device")
        if exported_on != self.device.type:
            raise ValueError(f"{artifact_path} was exported on {exported_on}"
                             f" and runs there only; export it on "
                             f"{self.device.type} to serve it there")
        header.pop("format")
        self.kind: str = header.pop("kind")
        self.specs: Tuple[InputSpec, ...] = tuple(
            InputSpec(tuple(s["shape"]), s["dtype"])
            for s in header.pop("inputs"))
        ranks = header.pop("mesh", {"size": 1})["size"]
        if ranks != (1 if mesh is None else mesh.size()):
            raise ValueError(
                f"{artifact_path} holds one rank's share of a {ranks}-rank "
                f"mesh and is served by a mesh of that size"
                if ranks > 1 else f"{artifact_path} was exported for one "
                f"card: serve it without a mesh")
        self.mesh = mesh
        self._rows = slice(None)
        if mesh is not None:
            from ..parallel.mesh import local_rows
            self._rows = local_rows(mesh, self.batch)
        self.tokenizer = self.scaler = None
        self.training_smiles: List[str] = header.pop("training_smiles", [])
        if "tokenizer" in header:
            from ..data.tokenizer import CharTokenizer
            self.tokenizer = CharTokenizer.from_state_dict(
                header.pop("tokenizer"))
        if "scaler" in header:
            from ..data.preprocess import MinMaxScaler
            self.scaler = MinMaxScaler.from_state_dict(header.pop("scaler"))
        self.meta: Dict[str, Any] = header
        args = program_inputs(self.program, self.device)
        self.variables: Dict[str, torch.Tensor] = args[0]
        self._program_args = args[1:]
        self._fn = self.program.module()
        self._aux = {name: p.module() for name, p in self.programs.items()}
        self.kernel_weights: Dict[str, Dict[str, torch.Tensor]] = {}
        self.restored_from = checkpoint
        if checkpoint:
            self.reload_checkpoint(checkpoint)
        else:
            rng = np.random.RandomState(seed)
            with torch.no_grad():
                for v in self.variables.values():
                    v.copy_(torch.from_numpy(
                        rng.normal(0, 0.02, tuple(v.shape))))
            self._prepare()
        self.startup = {"load_s": time.perf_counter() - t0}
        self.tier = "eager"
        self.exec_error: Optional[str] = None
        self.served = {"graph": 0, "eager": 0}
        self.launches: Dict[str, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            try:
                self._capture()
                self.tier = "graph"
            except Exception as e:  # noqa: BLE001 -- kept, and named
                self._graph = None
                self.exec_error = f"{type(e).__name__}: {e}"
            self.startup["capture_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------- weights --

    def reload_checkpoint(self, checkpoint: str) -> None:
        """Hot-swap the weights without exporting or capturing again: the
        program takes the variables as arguments, and the new values are
        copied into the same storage (which a captured graph reads)."""
        sd = read_state_dict(checkpoint)
        missing = sorted(set(self.variables) - set(sd))
        unexpected = sorted(set(sd) - set(self.variables))
        if missing or unexpected:
            raise ValueError(f"{checkpoint} does not fit the artifact: "
                             f"missing {missing[:5]}, unexpected "
                             f"{unexpected[:5]}")
        with torch.no_grad():
            for name, v in self.variables.items():
                if tuple(sd[name].shape) != tuple(v.shape):
                    raise ValueError(f"{checkpoint}: {name} is "
                                     f"{tuple(sd[name].shape)}, the artifact"
                                     f" wants {tuple(v.shape)}")
                v.copy_(sd[name])
        self._prepare()
        self.restored_from = checkpoint

    def _prepare(self) -> None:
        """Make the kernel weights from the variables (the ``prepare``
        program), into the storage of the first ones made."""
        if "prepare" not in self._aux:
            return
        with torch.no_grad():
            made = self._aux["prepare"](self.variables)
            if not self.kernel_weights:
                self.kernel_weights = made
                return
            for name, tensors in made.items():
                for k, v in tensors.items():
                    self.kernel_weights[name][k].copy_(v)

    @property
    def batch(self) -> int:
        """The artifact's fixed batch size (its first input's dim 0)."""
        return int(self.specs[0].shape[0])

    # ------------------------------------------------------------ draws --

    def _draw_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The request's random draws by name and shape."""
        b = self.batch
        if self.kind in ("sampler", "inpainter"):
            s = self.meta["sampler"]
            track = (b, *self.meta["shape"])
            steps = s["num_steps"] - 1
            if self.kind == "sampler":
                return {"noise": track, "step_noise": (steps, *track)}
            r = s["num_resamples"]
            shapes = {"noise": track, "source_noise": (steps, *track),
                      "step_noise": (steps, r, *track)}
            if r > 1:
                shapes["renoise"] = (steps, r, *track)
            return shapes
        if self.kind == "generator":
            g = self.meta["generator"]
            total = g["start_len"] + g["tokens_to_generate"]
            return {"uniforms": (total - 1, b, g["vocab"])}
        return {}

    def _draws(self, seed: Optional[int], given: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        shapes = self._draw_shapes()
        unknown = sorted(set(given) - set(shapes))
        if unknown:
            raise ValueError(f"a {self.kind} artifact draws {sorted(shapes)}"
                             f", not {unknown}")
        gen = torch.Generator(device=self.device).manual_seed(
            0 if seed is None else int(seed))
        out = {}
        for name, shape in shapes.items():
            t = given.get(name)
            if t is None:
                t = torch.empty(shape, device=self.device)
                if name == "uniforms":
                    t.uniform_(generator=gen)
                else:
                    t.normal_(generator=gen)
            elif tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(t.shape)}")
            out[name] = self._mine(t.to(self.device, torch.float32),
                                   draw=True)
        return out

    def _mine(self, t: torch.Tensor, draw: bool = False) -> torch.Tensor:
        """This rank's rows of a request tensor (all of it off a mesh); a
        ``draw`` ends with a sample's (b, *shape), after its step axes."""
        if self.mesh is None:
            return t
        axis = t.dim() - 1 - len(self.meta["shape"]) if draw else 0
        return t[(slice(None),) * axis + (self._rows,)].contiguous()

    # -------------------------------------------------------- a request --

    def _request(self, inputs: List[torch.Tensor],
                 draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One fixed-batch request through the program: the host loop of
        the artifact's kind around it.  No tensor is read back here."""
        fn, variables = self._fn, self.variables
        if self.kind == "encoder":
            return fn(variables, inputs[0])
        if self.kind == "generator":
            g = self.meta["generator"]
            props, start = inputs
            t0, total = g["start_len"], g["start_len"] + g[
                "tokens_to_generate"]
            context = self._aux["context"](variables, props)
            caches = [torch.zeros_like(t) for t in self._program_args[3:]]
            positions = torch.arange(total, device=self.device)
            ids = torch.zeros(start.shape[0], total, dtype=torch.int64,
                              device=self.device)
            ids[:, :t0] = start

            def step(token, pos):
                logits2, *new = fn(variables, context, token, positions[pos],
                                   *caches)
                caches[:] = new
                return logits2

            return decode_loop(step, ids, t0, cond_scale=g["cond_scale"],
                               filter_thres=g["filter_thres"],
                               temperature=g["temperature"],
                               uniforms=draws["uniforms"])
        s = self.meta["sampler"]
        props, weights = inputs[0], self.kernel_weights
        sigmas = karras_schedule(s["num_steps"], s["sigma_min"],
                                 s["sigma_max"], s["rho"])

        def denoise(x, sig):
            return fn(variables, weights, x, sig, props)

        if self.kind == "sampler":
            return run_sampler(denoise, draws["noise"], sigmas,
                               s["num_steps"], sampler="adpm2",
                               clamp=s["clamp"], objective_alias="k",
                               step_noise=draws["step_noise"], rho=1.0)
        return inpaint_adpm2(denoise, inputs[1], inputs[2], sigmas,
                             s["num_steps"], s["num_resamples"],
                             noise=draws["noise"],
                             source_noise=draws["source_noise"],
                             step_noise=draws["step_noise"],
                             renoise=draws.get("renoise"), rho=1.0)

    def _capture(self) -> None:
        """Capture one whole request into a CUDA graph, after one eager call
        of each program on a side stream: it loads the kernel libraries and
        sets their attributes, and makes the libraries' handles and
        workspaces, none of which a capture may do."""
        inputs = [self._mine(torch.zeros(s.shape, dtype=s.torch_dtype,
                                         device=self.device))
                  for s in self.specs]
        draws = {k: self._mine(torch.zeros(v, device=self.device),
                               draw=True)
                 for k, v in self._draw_shapes().items()}
        if self.kind == "generator":
            inputs[1].fill_(1)
        args = list(self._program_args)
        if self.kernel_weights:
            args[0] = self.kernel_weights
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            if "context" in self._aux:
                self._aux["context"](self.variables, inputs[0])
            self._fn(self.variables, *args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = {name: getattr(mod, name) for mod, name in _COUNTERS}
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            out = self._request(inputs, draws)
        self.launches = {name: getattr(mod, name) - before[name]
                         for mod, name in _COUNTERS}
        self._graph, self._static = graph, (inputs, draws, out)

    def call(self, *inputs, seed: Optional[int] = None, eager: bool = False,
             **draws: torch.Tensor) -> torch.Tensor:
        """Serve exactly the artifact's fixed-shape ``inputs`` (arrays or
        tensors): the request's draws come from ``seed`` (0 when None)
        unless handed in by name.  ``eager=True`` runs this request on the
        eager tier even where a graph was captured (to compare the tiers).
        Returns a tensor on the serving device (over a mesh, every rank's
        rows gathered on every rank)."""
        if len(inputs) != len(self.specs):
            raise ValueError(f"a {self.kind} artifact takes "
                             f"{len(self.specs)} inputs, got {len(inputs)}")
        tensors = []
        for a, spec in zip(inputs, self.specs):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
                a = a if a.flags.writeable else a.copy()
            t = torch.as_tensor(a)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"input of shape {tuple(t.shape)}, the "
                                 f"artifact takes {spec.shape}")
            tensors.append(self._mine(t.to(self.device, spec.torch_dtype)))
        drawn = self._draws(seed, draws)
        with torch.no_grad():
            if self._graph is None or eager:
                self.served["eager"] += 1
                return self._gather(self._request(tensors, drawn))
            static_inputs, static_draws, out = self._static
            for dst, src in zip(static_inputs, tensors):
                dst.copy_(src)
            for name, dst in static_draws.items():
                dst.copy_(drawn[name])
            self._graph.replay()
            self.served["graph"] += 1
            return self._gather(out.clone())

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return out
        from ..parallel.mesh import gather_rows
        return gather_rows(self.mesh, out, self.batch)

    def call_padded(self, *arrays, seed: Optional[int] = None,
                    **draws: torch.Tensor) -> np.ndarray:
        """Serve ``n <= batch`` rows: pad each input's leading dim to the
        artifact's fixed batch by repeating row 0, call, and slice the
        result back to ``n`` rows (a host array, float32 where the output
        is floating).  The padding rows share
        the batch's draws: the live rows' outputs are the full-batch
        request's outputs at those positions."""
        n = int(np.shape(arrays[0])[0])
        if n > self.batch:
            raise ValueError(f"batch {n} exceeds the artifact's fixed "
                             f"batch {self.batch}")
        padded = []
        for a in arrays:
            a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            if a.shape[0] < self.batch:
                a = np.concatenate(
                    [a, np.repeat(a[:1], self.batch - a.shape[0], 0)], 0)
            padded.append(a)
        out = self.call(*padded, seed=seed, **draws)[:n]
        # a host array: floating outputs (bf16 logits too) as float32
        return (out.float() if out.is_floating_point() else out).cpu().numpy()
