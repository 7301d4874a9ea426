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

Every subcommand that runs a model runs it on the card (``--device cuda``,
the default) unless ``--device cpu`` asks for the CPU; without a card it
fails rather than fall back.  ``--dtype`` is the model's compute dtype
(parameters, grads and Adam moments stay float32).  ``--checkpoint`` reads
the port's own checkpoints and reference-layout state dicts (``.pt``,
``.pth``, or the ``.npz``/``.pt`` the JAX package's ``export-torch`` writes
from its msgpack checkpoints).  ``--seed`` seeds the weights, the dataset
stand-in and the samplers' generators; it cannot give JAX's draws.  The
JSON printed carries the JAX CLI's keys.  ``export``, ``export-torch``,
``inspect`` and ``serve`` are not offered yet (serving is ROADMAP.md item
A8).

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
import shutil
import subprocess
import sys
from typing import Dict, Optional

import torch

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


def cmd_train(args) -> Dict:
    from .core.checkpoint import checkpoint_state, save_checkpoint
    from .core.config import TrainConfig
    from .train import recipes
    device = _device(args)
    data = _dataset(args, recipes.data_mode(args.task))
    model = _build(args, args.task, data, device)
    config = TrainConfig(learning_rate=args.learning_rate,
                         batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed,
                         accumulation_steps=args.accumulation_steps,
                         print_loss_every=args.print_loss_every)
    state, logger = recipes.train_task(args.task, model, data, config,
                                       checkpoint_dir=args.checkpoint_dir,
                                       resume=args.resume)
    if args.out:
        save_checkpoint(args.out, checkpoint_state(model))
        print(f"saved {args.out}", file=sys.stderr)
    metrics = recipes.eval_task(
        args.task, model, data, _generator(args, device),
        timesteps=args.timesteps, num_rescore=args.num_eval,
        num_generate=args.num_eval)
    return _emit({"task": args.task, "preset": args.preset,
                  "epochs": args.epochs,
                  **{k: v for k, v in metrics.items()
                     if k != "sample_smiles"},
                  "step": state.step,
                  "losses": [r["loss"] for r in logger.history
                             if "loss" in r]})


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
    return p


def main(argv=None) -> Dict:
    """Run one subcommand; returns the JSON payload it printed."""
    args = build_parser().parse_args(argv)
    return args.fn(args)
