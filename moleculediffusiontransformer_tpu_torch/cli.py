"""Command-line interface: ``python -m moleculediffusiontransformer_tpu_torch``
(port of the JAX package's ``cli.py``).

The packaged equivalent of the reference's four notebooks, one subcommand
each:

  info      torch and CUDA versions, the card, the kernel switches and
            which kernel libraries are built (builds nothing)
  train     train any of the four notebook models (tiny or notebook
            preset), save checkpoints, report held-out metrics
  eval      held-out metrics for a checkpoint (R² / validity+novelty)
  sample    inverse design: property targets -> SMILES
            (diffusion sampler or KV-cached AR transformer)
  inpaint   constrained design: freeze draft positions, regenerate
            the rest under property conditioning (RePaint)
  predict   forward direction: SMILES -> 12 QM9 properties
  export    a serving artifact of a model (``design/export.py``)
  export-torch
            a checkpoint as a reference-layout state dict (.pt or .npz)
  inspect   an artifact's kind, inputs, parameter count and bundle
  serve     run an artifact without model code (``design/serve.py``);
            ``--http PORT`` starts the JSON daemon
            (``design/http_serve.py``)

Every subcommand that runs a model runs it on the card (``--device cuda``,
the default) unless ``--device cpu`` asks for the CPU; without a card it
fails rather than fall back.  ``--dtype`` is the model's compute dtype
(parameters, grads and Adam moments stay float32).  ``--checkpoint`` reads
the port's own checkpoints and reference-layout state dicts (``.pt``,
``.pth``, or the ``.npz``/``.pt`` the JAX package's ``export-torch`` writes
from its msgpack checkpoints).  ``--seed`` seeds the weights, the dataset
stand-in and the samplers' generators; it cannot give JAX's draws.  The
JSON printed carries the JAX CLI's keys.  ``export`` exports on the device it
runs on, where the artifact must be served (``--device cuda`` exports for
the card).

``train`` under ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N -m moleculediffusiontransformer_tpu_torch train ...``)
joins the process group and trains the diffusion tasks data-parallel over
every rank, as the JAX CLI trains over every local chip; rank 0 saves,
evaluates and prints.

Dataset flags: ``--csv qm9_.csv`` for the reference set (reference
README.md:30), a synthetic valence-correct stand-in otherwise.  Reference
flows: training `generative.py:1090-1180`, sampling
`generative.py:1662-1738`, prediction `generative.py:664-711` and
`:1864-1913`.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, Optional

import torch
import torch.distributed as dist

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _device(args) -> torch.device:
    """The device a subcommand runs on; the card unless ``--device`` names
    another, and an error where the card is asked for and missing."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         f"pass --device cpu to run on the CPU")
    return device


def _generator(args, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(args.seed)


def _dataset(args, mode: str):
    from .data.qm9 import load_qm9, prepare_qm9, synthetic_qm9
    if args.csv:
        smiles, props = load_qm9(args.csv, max_rows=args.rows)
    else:
        smiles, props = synthetic_qm9(n=args.rows or 2048, seed=args.seed,
                                      chemically_valid=True)
        print("NOTE: synthetic stand-in dataset "
              "(pass --csv qm9_.csv for the real set)", file=sys.stderr)
    return prepare_qm9(smiles, props, mode=mode)


def _data_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--csv", default=None,
                   help="qm9_.csv (synthetic stand-in when omitted)")
    p.add_argument("--rows", type=int, default=None,
                   help="cap dataset rows")
    p.add_argument("--seed", type=int, default=0)


def _run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="notebook",
                   choices=("tiny", "notebook"),
                   help="architecture scale (tiny: CPU-feasible smoke)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES),
                   help="the model's compute dtype")


def _model_flags(p: argparse.ArgumentParser, tasks) -> None:
    p.add_argument("--task", default=tasks[0], choices=list(tasks))
    _run_flags(p)


def _build(args, task: str, data, device: torch.device):
    from .train import recipes
    return recipes.build_model(task, data.vocab_size, args.preset,
                               dtype=DTYPES[args.dtype], device=device,
                               seed=args.seed)


def _load(args, task: str, data, checkpoint: Optional[str],
          device: torch.device):
    from .train import recipes
    model, _ = recipes.load_params(checkpoint, task,
                                   _build(args, task, data, device))
    if checkpoint is None:
        print("NOTE: random-init params (pass --checkpoint)",
              file=sys.stderr)
    return model


def _emit(payload: Dict) -> Dict:
    print(json.dumps(payload, indent=2, default=float))
    return payload


# ---------------------------------------------------------- subcommands ---

def _nvidia_smi() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    if shutil.which("nvidia-smi") is None:
        return None
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    return proc.stdout.strip() if proc.returncode == 0 else None


def cmd_info(args) -> Dict:
    from . import __version__
    from .ops import cuda_build
    from .ops import flash_attention as fa
    from .ops import resnet_fusion as rf
    from .ops import transformer_fusion as tf
    attention = importlib.import_module(".ops.attention", __package__)
    cuda = torch.cuda.is_available()
    sources = (tf.SOURCE, tf.BWD_SOURCE, rf.SOURCE, fa.SOURCE, fa.BWD_SOURCE,
               attention.SOURCE)
    return _emit({
        "version": __version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())] if cuda
        else ["cpu"],
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": _nvidia_smi(),
        # the stack kernels (K1-K4) take every Transformer1d stack on the
        # card that they fit; there is no switch
        "fusion_default": cuda,
        "flash_attention": fa.flash_enabled(),
        "resnet_fusion": rf.resnet_fusion_enabled(),
        "sharedkv": tf.cfg_null_half_active(),
        "kernels_built": {s: cuda_build.library_path(s).exists()
                          for s in sources},
    })


def _launches() -> Dict[str, int]:
    """The launch counters of the kernels on the training path."""
    from .ops import resnet_fusion as rf
    from .ops import transformer_fusion as tf
    names = ("LAUNCHES", "STASH_LAUNCHES", "UNIFORM_LAUNCHES",
             "CONV_OUT_BWD_LAUNCHES", "LAYER_BWD_LAUNCHES",
             "CONV_IN_GN_BWD_LAUNCHES")
    return {**{n: getattr(tf, n) for n in names},
            "RESNET_LAUNCHES": rf.RESNET_LAUNCHES}


def cmd_train(args) -> Dict:
    """Train on this process's card or, under ``torchrun``, join the
    process group (NCCL; gloo with ``--device cpu``) and train
    data-parallel over every rank: each rank takes its rows of every
    global batch of ``--batch-size``, and rank 0 saves, evaluates and
    prints."""
    from .core.checkpoint import checkpoint_state, save_checkpoint
    from .core.config import TrainConfig
    from .parallel import distributed_init, make_mesh
    from .train import recipes
    device = _device(args)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    mesh = None
    if joined:
        distributed_init(device=device.type)
        mesh = make_mesh(device=device.type)
    try:
        before = _launches()
        data = _dataset(args, recipes.data_mode(args.task))
        model = _build(args, args.task, data, device)
        config = TrainConfig(learning_rate=args.learning_rate,
                             batch_size=args.batch_size, epochs=args.epochs,
                             seed=args.seed,
                             accumulation_steps=args.accumulation_steps,
                             print_loss_every=args.print_loss_every)
        state, logger = recipes.train_task(
            args.task, model, data, config,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            mesh=mesh)
        if mesh is not None and mesh.get_local_rank() != 0:
            return {}
        if args.out:
            save_checkpoint(args.out, checkpoint_state(model))
            print(f"saved {args.out}", file=sys.stderr)
        metrics = recipes.eval_task(
            args.task, model, data, _generator(args, device),
            timesteps=args.timesteps, num_rescore=args.num_eval,
            num_generate=args.num_eval)
        after = _launches()
        return _emit({"task": args.task, "preset": args.preset,
                      "epochs": args.epochs,
                      **{k: v for k, v in metrics.items()
                         if k != "sample_smiles"},
                      "step": state.step,
                      "losses": [r["loss"] for r in logger.history
                                 if "loss" in r],
                      "world_size": 1 if mesh is None else mesh.size(),
                      "launches": {k: after[k] - before[k] for k in after}})
    finally:
        if joined:
            dist.destroy_process_group()


def cmd_eval(args) -> Dict:
    from .train import recipes
    device = _device(args)
    data = _dataset(args, recipes.data_mode(args.task))
    model = _load(args, args.task, data, args.checkpoint, device)
    metrics = recipes.eval_task(
        args.task, model, data, _generator(args, device),
        timesteps=args.timesteps, num_rescore=args.num_eval,
        num_generate=args.num_eval)
    return _emit({"task": args.task, "checkpoint": args.checkpoint,
                  **metrics})


def cmd_sample(args) -> Dict:
    import numpy as np

    from .design import (generate_from_conditioning,
                         generate_from_conditioning_transformer)
    from .train import recipes
    device = _device(args)
    data = _dataset(args, recipes.data_mode(args.task))
    model = _load(args, args.task, data, args.checkpoint, device)
    if args.properties:
        props = np.asarray([[float(v) for v in row.split(",")]
                            for row in args.properties], np.float32)
        props = data.scaler.transform(props)  # physical units in
    else:
        props = np.asarray(data.y_test[:args.num])
    generator = _generator(args, device)
    if args.task == "inverse_diffusion":
        report = generate_from_conditioning(
            model, props, data.tokenizer, generator,
            cond_scale=args.cond_scale, timesteps=args.timesteps,
            training_smiles=data.smiles)
    else:
        report = generate_from_conditioning_transformer(
            model, props, data.tokenizer, generator,
            cond_scale=args.cond_scale, tokens_to_generate=args.tokens,
            training_smiles=data.smiles)
    return _emit({"task": args.task, "smiles": report["smiles"],
                  "validity_fraction": report["validity_fraction"],
                  "novelty_fraction": report["novelty_fraction"]})


def cmd_inpaint(args) -> Dict:
    """Constrained design: freeze positions of a draft molecule,
    regenerate the rest under property conditioning (RePaint-style,
    reference `generative.py:1574-1660`)."""
    import numpy as np

    from .design import inpaint_from_draft_and_conditioning
    device = _device(args)
    data = _dataset(args, "inverse_diffusion")
    model = _load(args, "inverse_diffusion", data, args.checkpoint, device)
    if args.properties:
        props = data.scaler.transform(np.asarray(
            [[float(v) for v in args.properties.split(",")]], np.float32))
    else:
        props = np.asarray(data.y_test[:1])
    report = inpaint_from_draft_and_conditioning(
        model, args.draft, props, args.fixed, data.tokenizer,
        _generator(args, device), num_resamples=args.resamples,
        cond_scale=args.cond_scale, timesteps=args.timesteps,
        num_candidates=args.num, training_smiles=data.smiles)
    return _emit({"task": "inpaint", "draft": args.draft,
                  "fixed": args.fixed, "smiles": report["smiles"],
                  "validity_fraction": report["validity_fraction"],
                  "novelty_fraction": report["novelty_fraction"]})


def cmd_predict(args) -> Dict:
    from .design import (predict_properties_from_smiles,
                         predict_properties_from_smiles_transformer)
    from .train import recipes
    device = _device(args)
    data = _dataset(args, recipes.data_mode(args.task))
    model = _load(args, args.task, data, args.checkpoint, device)
    if args.task == "forward_transformer":
        preds = predict_properties_from_smiles_transformer(
            model, args.smiles, data.tokenizer, data.scaler)
    else:
        preds = predict_properties_from_smiles(
            model, args.smiles, data.tokenizer, data.scaler,
            _generator(args, device), timesteps=args.timesteps)
    return _emit({"task": args.task,
                  "predictions": {s: [float(v) for v in row]
                                  for s, row in zip(args.smiles, preds)}})


DIFFUSION_TASKS = ("inverse_diffusion", "forward_diffusion")


def cmd_export(args) -> Dict:
    """A serving artifact of the task's model (``design/export.py``).
    ``--fused`` exports with both kernel switches on (``ops.kernel_switches``)
    and ``--mesh-devices N`` one rank's share of the batch-parallel sampler
    over an N-rank data mesh, the process group (run under ``torchrun``;
    rank 0 writes)."""
    import contextlib
    import os

    import torch.distributed as dist

    from .design import export as dexport
    from .ops import kernel_switches
    from .train import recipes
    if (args.fused or args.mesh_devices) and args.task not in DIFFUSION_TASKS:
        raise SystemExit("--fused/--mesh-devices apply to the diffusion "
                         "tasks only")
    if args.inpaint and args.task not in DIFFUSION_TASKS:
        raise SystemExit("--inpaint applies to the diffusion tasks only")
    if args.inpaint and args.mesh_devices:
        raise SystemExit("--mesh-devices applies to the sampler only: the "
                         "inpainter has no mesh (as in JAX)")
    device = _device(args)
    bundle = {}
    vocab = args.vocab
    if args.embed_vocab:
        # a self-contained serving bundle: tokenizer, scaler and novelty
        # corpus ride with the program
        data = _dataset(args, recipes.data_mode(args.task))
        bundle = dict(tokenizer=data.tokenizer, scaler=data.scaler,
                      training_smiles=data.smiles)
        if vocab is None:
            vocab = data.vocab_size
    model = recipes.build_model(args.task, vocab, args.preset,
                                dtype=DTYPES[args.dtype], device=device,
                                seed=args.seed)
    if args.checkpoint:
        recipes.load_params(args.checkpoint, args.task, model)
    model.eval()
    mesh, joined = None, False
    if args.mesh_devices:
        from .parallel import make_mesh
        joined = not dist.is_initialized()
        try:
            mesh = make_mesh(args.mesh_devices, device=device.type)
        except ValueError as e:
            if joined and dist.is_initialized():
                dist.destroy_process_group()
            raise SystemExit(f"{e}: run the export under torchrun "
                             f"--nproc-per-node {args.mesh_devices}")
    try:
        with (kernel_switches(True) if args.fused
              else contextlib.nullcontext()):
            if args.inpaint:
                art = dexport.export_inpainter(
                    model, batch=args.batch, num_steps=args.timesteps,
                    num_resamples=args.resamples, cond_scale=args.cond_scale,
                    device=device)
            elif args.task in DIFFUSION_TASKS:
                art = dexport.export_sampler(
                    model, batch=args.batch, num_steps=args.timesteps,
                    cond_scale=args.cond_scale, mesh=mesh, device=device)
            elif args.task == "inverse_transformer":
                art = dexport.export_generator(
                    model, batch=args.batch, tokens_to_generate=args.tokens,
                    cond_scale=args.cond_scale, device=device)
            else:
                art = dexport.export_encoder(model, batch=args.batch,
                                             max_length=args.max_length,
                                             device=device)
        if mesh is None or mesh.get_local_rank() == 0:
            dexport.save_artifact(
                art, args.out, extra={"task": args.task, "fused": args.fused},
                **bundle)
        if mesh is not None:
            dist.barrier()
    finally:
        if joined:
            dist.destroy_process_group()
    size = os.path.getsize(args.out)
    print(f"wrote {args.out} ({size / 1e6:.2f} MB"
          f"{', fused' if args.fused else ''}"
          f"{f', mesh of {args.mesh_devices}' if mesh is not None else ''}"
          f"{', vocab+scaler embedded' if bundle else ''})", file=sys.stderr)
    return _emit({"artifact": args.out, "kind": art.header["kind"],
                  "task": args.task, "device": art.header["device"],
                  "bytes": size, "bundled": bool(bundle),
                  "fused": args.fused, "mesh_devices": args.mesh_devices})


def cmd_export_torch(args) -> Dict:
    """A checkpoint -> a reference-layout ``state_dict`` file (the keys and
    tensor layouts of the reference's torch modules and of the JAX
    package's ``params_to_state_dict``), for the reference's torch tooling
    (``model.load_state_dict(torch.load(out), strict=False)``)."""
    import numpy as np

    from .core.checkpoint import read_state_dict
    device = _device(args)
    sd = {k: v.to(device) for k, v in read_state_dict(
        args.checkpoint).items()}
    host = {k: v.detach().float().cpu() for k, v in sd.items()}
    if args.out.endswith(".npz"):
        np.savez(args.out, **{k: v.numpy() for k, v in host.items()})
    else:
        torch.save(host, args.out)
    total = sum(v.numel() for v in host.values())
    print(f"wrote {args.out}: {len(host)} tensors, {total:,} parameters",
          file=sys.stderr)
    return _emit({"out": args.out, "tensors": len(host),
                  "parameters": total})


def cmd_inspect(args) -> Dict:
    """An artifact's kind, input specs, device, parameter count and bundle
    contents, without running it."""
    import math

    from .design import export as dexport
    _device(args)
    program, header = dexport.load_bundle(args.artifact)
    variables = dexport.variables_skeleton(program, "meta")
    rest = {k: v for k, v in header.items()
            if k not in ("tokenizer", "scaler", "training_smiles", "kind",
                         "device", "inputs", "format")}
    return _emit({
        "artifact": args.artifact,
        "kind": header["kind"],
        "device": header["device"],
        "param_count": sum(math.prod(v.shape) for v in variables.values()),
        "inputs": header["inputs"],
        "bundle": {
            "tokenizer_vocab": (len(header["tokenizer"]["word_index"]) + 1
                                if "tokenizer" in header else None),
            "scaler": "scaler" in header,
            "novelty_corpus": len(header.get("training_smiles", [])),
            **rest,
        },
    })


def cmd_serve(args) -> Dict:
    """Model-code-free serving: artifact + checkpoint + vocabulary ->
    outputs, once, or as an HTTP daemon with ``--http PORT``."""
    import numpy as np

    from .design import ArtifactServer, decode_one_hot, evaluate_generated
    server = ArtifactServer(args.artifact, args.checkpoint, seed=args.seed,
                            device=_device(args))
    if args.checkpoint is None:
        print("NOTE: random placeholder params (pass --checkpoint)",
              file=sys.stderr)
    if args.http is not None:
        from .design.http_serve import make_httpd
        if server.tokenizer is not None:     # bundled artifact: no dataset
            httpd = make_httpd(server, host=args.host, port=args.http,
                               batch_window_ms=args.batch_window_ms)
        else:
            mode = {"encoder": "transformer",
                    "generator": "transformer"}.get(server.kind,
                                                    "inverse_diffusion")
            data = _dataset(args, mode)
            httpd = make_httpd(server, data.tokenizer, data.scaler,
                               data.smiles, host=args.host, port=args.http,
                               batch_window_ms=args.batch_window_ms)
        print(f"serving {server.kind} artifact ({server.tier} tier) on "
              f"http://{httpd.server_address[0]}:{httpd.server_address[1]} "
              "(POST /sample|/generate|/predict|/inpaint|/reload, "
              "GET /healthz|/specs|/metrics)", file=sys.stderr)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return {}
    n = min(args.num, server.batch)
    if server.kind == "encoder":
        max_length = server.specs[0].shape[1]
        data = _dataset(args, "transformer")
        ids = np.asarray(data.X_test[:n], np.int64)[:, :max_length]
        scaled = server.call_padded(ids).reshape(n, -1)[:, :12]
        props = data.scaler.inverse_transform(scaled)
        return _emit({"kind": server.kind, "tier": server.tier,
                      "predicted_properties": [[float(v) for v in r]
                                               for r in props]})
    n_cond = server.specs[0].shape[1]
    if server.kind == "sampler":
        data = _dataset(args, "inverse_diffusion")
        props = np.asarray(data.y_test[:n], np.float32)[:, :n_cond]
        out = server.call_padded(props, seed=args.seed)
        smiles = decode_one_hot(out, data.tokenizer)
    elif server.kind == "generator":
        from .data.tokenizer import remove_start_end_token_first
        data = _dataset(args, "transformer")
        props = np.asarray(data.y_test[:n], np.float32)[:, :n_cond]
        start_id = data.tokenizer.word_index.get("@", 1)
        start = np.full((n, server.specs[1].shape[1]), start_id, np.int64)
        ids = server.call_padded(props, start, seed=args.seed)
        smiles = [remove_start_end_token_first(t)
                  for t in data.tokenizer.decode(ids)]
    else:
        raise SystemExit("inpainter artifacts need source/mask inputs: "
                         "serve them with --http (POST /inpaint) or drive "
                         "design.ArtifactServer.call directly")
    rep = evaluate_generated(smiles, data.smiles)
    return _emit({"kind": server.kind, "tier": server.tier,
                  "smiles": smiles,
                  "validity_fraction": rep["validity_fraction"],
                  "novelty_fraction": rep["novelty_fraction"]})


def build_parser() -> argparse.ArgumentParser:
    from .train.recipes import TASKS
    p = argparse.ArgumentParser(
        prog="python -m moleculediffusiontransformer_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="versions, card, kernel switches and "
                   "builds").set_defaults(fn=cmd_info)

    t = sub.add_parser("train", help="train a model, save checkpoint, eval")
    _model_flags(t, TASKS)
    _data_flags(t)
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch-size", type=int, default=128)
    t.add_argument("--learning-rate", type=float, default=2e-4)
    t.add_argument("--accumulation-steps", type=int, default=1)
    t.add_argument("--print-loss-every", type=int, default=10,
                   help="read back and log the loss every N steps")
    t.add_argument("--timesteps", type=int, default=100)
    t.add_argument("--num-eval", type=int, default=8)
    t.add_argument("--out", default=None,
                   help="checkpoint path for the trained model (.pt)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="step-checkpoint directory (resumable)")
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="held-out metrics for a checkpoint")
    _model_flags(e, TASKS)
    _data_flags(e)
    e.add_argument("--checkpoint", default=None)
    e.add_argument("--timesteps", type=int, default=100)
    e.add_argument("--num-eval", type=int, default=16)
    e.set_defaults(fn=cmd_eval)

    s = sub.add_parser("sample", help="property targets -> SMILES")
    _model_flags(s, ("inverse_diffusion", "inverse_transformer"))
    _data_flags(s)
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--num", type=int, default=4,
                   help="held-out targets to condition on when "
                   "--properties is not given")
    s.add_argument("--properties", nargs="*", default=None,
                   help="explicit property rows, comma-separated physical "
                   "units, one row per molecule")
    s.add_argument("--cond-scale", type=float, default=2.0)
    s.add_argument("--timesteps", type=int, default=64)
    s.add_argument("--tokens", type=int, default=63)
    s.set_defaults(fn=cmd_sample)

    ip = sub.add_parser("inpaint", help="constrained design: freeze draft "
                        "positions, regenerate the rest")
    ip.add_argument("draft", help="draft SMILES")
    ip.add_argument("--fixed", type=int, nargs="+", required=True,
                    help="0-based character positions to keep")
    _run_flags(ip)
    _data_flags(ip)
    ip.add_argument("--checkpoint", default=None)
    ip.add_argument("--properties", default=None,
                    help="comma-separated property targets, physical units")
    ip.add_argument("--num", type=int, default=4, help="candidates")
    ip.add_argument("--resamples", type=int, default=1)
    ip.add_argument("--cond-scale", type=float, default=2.0)
    ip.add_argument("--timesteps", type=int, default=64)
    ip.set_defaults(fn=cmd_inpaint)

    pr = sub.add_parser("predict", help="SMILES -> 12 QM9 properties")
    _model_flags(pr, ("forward_transformer", "forward_diffusion"))
    _data_flags(pr)
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--timesteps", type=int, default=100)
    pr.add_argument("smiles", nargs="+")
    pr.set_defaults(fn=cmd_predict)

    x = sub.add_parser("export", help="serving artifact of a model (.pt2)")
    x.add_argument("--task", default=TASKS[0], choices=list(TASKS))
    x.add_argument("--preset", default="notebook",
                   choices=("tiny", "notebook"),
                   help="architecture scale (tiny: CPU-feasible smoke)")
    x.add_argument("--device", default="cuda",
                   help="where the artifact is exported and will be "
                   "served: cuda (the default) or cpu")
    x.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES),
                   help="the model's compute dtype")
    _data_flags(x)
    x.add_argument("--embed-vocab", action="store_true",
                   help="embed the dataset's tokenizer/scaler/novelty "
                   "corpus in the artifact (self-contained serving)")
    x.add_argument("--inpaint", action="store_true",
                   help="export the RePaint inpainter instead of the "
                   "sampler (diffusion tasks; serve via --http POST "
                   "/inpaint)")
    x.add_argument("--fused", action="store_true",
                   help="export with both kernel switches on: the "
                   "resnet-run kernel (K8) and the shared-KV null half "
                   "(diffusion tasks)")
    x.add_argument("--mesh-devices", type=int, default=0,
                   help="export one rank's share of the batch-parallel "
                   "sampler over an N-rank data mesh (run under torchrun "
                   "with N processes; rank 0 writes)")
    x.add_argument("--out", required=True)
    x.add_argument("--checkpoint", default=None)
    x.add_argument("--vocab", type=int, default=None)
    x.add_argument("--batch", type=int, default=512)
    x.add_argument("--timesteps", type=int, default=64)
    x.add_argument("--resamples", type=int, default=1)
    x.add_argument("--cond-scale", type=float, default=2.0)
    x.add_argument("--tokens", type=int, default=63)
    x.add_argument("--max-length", type=int, default=64)
    x.set_defaults(fn=cmd_export)

    xt = sub.add_parser("export-torch", help="checkpoint -> reference-layout "
                        "state_dict (.pt or .npz)")
    xt.add_argument("--checkpoint", required=True,
                    help="a checkpoint of this package or a "
                    "reference-layout state dict")
    xt.add_argument("--out", required=True,
                    help=".pt (torch.save) or .npz (numpy) output")
    xt.add_argument("--device", default="cuda",
                    help="where the weights are loaded: cuda (the default) "
                    "or cpu")
    xt.set_defaults(fn=cmd_export_torch)

    ins = sub.add_parser("inspect", help="artifact kind/specs/bundle report "
                         "(runs nothing)")
    ins.add_argument("artifact")
    ins.add_argument("--device", default="cuda",
                     help="cuda (the default) or cpu")
    ins.set_defaults(fn=cmd_inspect)

    sv = sub.add_parser("serve", help="serve an artifact (no model code)")
    sv.add_argument("artifact")
    sv.add_argument("--checkpoint", default=None)
    sv.add_argument("--device", default="cuda",
                    help="where it serves: cuda (the default) or cpu")
    sv.add_argument("--num", type=int, default=4,
                    help="held-out rows to serve (<= artifact batch)")
    sv.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="start a JSON HTTP daemon instead of a one-shot "
                    "run (design/http_serve.py)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic-batching window for /predict on encoder "
                    "artifacts: concurrent requests within the window "
                    "coalesce into one device call (exact; 0 disables)")
    _data_flags(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> Dict:
    """Run one subcommand; returns the JSON payload it printed."""
    args = build_parser().parse_args(argv)
    return args.fn(args)
