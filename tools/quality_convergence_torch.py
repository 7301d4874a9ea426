"""Train the four notebook tasks to quality with the PyTorch/CUDA port and
record the curves (the port's counterpart of ``tools/quality_convergence.py``).

Training runs in CHUNKS of ``--chunk-epochs`` epochs through the port's
``train.recipes.train_task`` with ``checkpoint_dir`` + ``resume=True``, so
that a kill costs at most one chunk and re-running the same command
continues the curve.  After each chunk the task's notebook metric is
evaluated (``recipes.eval_task``) and one record is appended to
``<out>/<task>.jsonl``; the run stops at ``--max-epochs`` or when the best
metric has not improved by ``--min-delta`` over the last ``--patience``
evals.  Weights are float32 (the recipes' default), Adam 2e-4 with the
gradient clipped at 0.5.

Three rules differ from the JAX tool's:

- the epoch label of a chunk, and its seed (``--seed`` + epochs done //
  ``--chunk-epochs``), come from the restored checkpoint's
  ``TrainState.epoch``, not from the curve: a run killed after its
  checkpoint and before its curve line resumes with the right labels (the
  orphaned checkpoint is evaluated first, its record's ``train_s`` null);
- ``<out>/summary.json`` is merged: running one task keeps the others'
  entries (of the same rows, seed and preset);
- after each eval the checkpoint of the best held-out metric is kept as
  ``<out>/ckpts/<task>/best.pt`` beside the step checkpoints' three
  newest, and every record names the epoch of the best (``best_epoch``).

The eval draws come from a generator on the model's device seeded with
``--seed`` + 7, fresh for every eval, as the JAX tool passes one key to
every eval.  The batch plan is the port's ``PRODUCTION_BATCHES`` (the card
trains both diffusion tasks at 1,024 x 1).

  # on the card (notebook presets; resumable, re-run to continue):
  python tools/quality_convergence_torch.py --rows 20480 --out quality_torch
  # on the CPU (tiny presets, small corpus):
  python tools/quality_convergence_torch.py --device cpu --preset tiny \\
      --rows 512 --tasks inverse_diffusion --chunk-epochs 1 \\
      --max-epochs 2 --num-generate 4 --timesteps 8 --out /tmp/q
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from moleculediffusiontransformer_tpu_torch.train import (  # noqa: E402
    recipes as _recipes)

# task -> (metric key, batch size, accumulation steps) at notebook scale,
# the reference's batches (diffusion 1024, transformer 256); in sync with
# the port's production plan, asserted at import so the two cannot drift
TASK_PLAN = {
    "forward_diffusion": ("r2", 1024, 1),
    "inverse_diffusion": ("validity_fraction", 1024, 1),
    "inverse_transformer": ("validity_fraction", 256, 1),
    "forward_transformer": ("r2", 256, 1),
}
assert ({k: v[1:] for k, v in TASK_PLAN.items()}
        == _recipes.PRODUCTION_BATCHES)
EVAL_SEED_OFFSET = 7          # the JAX tool's PRNGKey(seed + 7)
OPTIMIZER = "adam 2e-4 + grad-clip 0.5 (reference generative.py:1132)"


def checkpoint_epoch(path: str) -> int:
    """The epochs a port checkpoint has completed, read without loading its
    tensors."""
    import torch
    return int(torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)["epoch"])


def keep_best(path: str, best: str) -> None:
    """Make ``best`` the checkpoint at ``path`` (a hard link where the file
    system has them: the step checkpoint's pruning leaves it whole)."""
    import shutil
    tmp = best + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    try:
        os.link(path, tmp)
    except OSError:
        shutil.copyfile(path, tmp)
    os.replace(tmp, best)


def eval_generator(seed: int, device):
    import torch
    return torch.Generator(device=device).manual_seed(seed + EVAL_SEED_OFFSET)


def scalars(metrics: dict) -> dict:
    """An eval's scalar metrics, rounded as the JAX tool records them (list
    and dict metrics left out)."""
    return {k: (round(float(v), 4) if hasattr(v, "__float__") else v)
            for k, v in metrics.items() if not isinstance(v, (list, dict))}


def record_of(task: str, epoch: int, train_s, eval_s: float,
              metrics: dict) -> dict:
    """A curve record: the JAX tool's keys."""
    return {"task": task, "epoch": epoch,
            "train_s": None if train_s is None else round(train_s, 1),
            "eval_s": round(eval_s, 1), **scalars(metrics)}


def run_task(task: str, data, args, device) -> dict:
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        latest_checkpoint)
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.train import recipes

    metric_key, batch, accum = TASK_PLAN[task]
    if args.preset == "tiny":
        batch, accum = min(batch, 128), 1
    curve_path = os.path.join(args.out, f"{task}.jsonl")
    ckpt_dir = os.path.join(args.out, "ckpts", task)
    best_path = os.path.join(ckpt_dir, "best.pt")
    model = recipes.build_model(task, data.vocab_size, args.preset,
                                device=device, seed=args.seed)

    history = []
    if os.path.exists(curve_path):          # resuming: reload the curve
        with open(curve_path) as f:
            history = [json.loads(line) for line in f if line.strip()]
    latest = latest_checkpoint(ckpt_dir)
    epochs_done = checkpoint_epoch(latest) if latest else 0
    if history and history[-1]["epoch"] > epochs_done:
        raise ValueError(f"{curve_path} runs to epoch "
                         f"{history[-1]['epoch']}, past the checkpoints of "
                         f"{ckpt_dir} ({epochs_done}): not one run")
    best = max(history, key=lambda h: h[metric_key]) if history else None

    def plateaued() -> bool:
        vals = [h[metric_key] for h in history]
        if len(vals) <= args.patience:
            return False
        best_before = max(vals[:-args.patience])
        best_recent = max(vals[-args.patience:])
        return best_recent - best_before < args.min_delta

    def evaluate(train_s) -> None:
        nonlocal best
        t0 = time.time()
        model.eval()
        m = recipes.eval_task(task, model, data,
                              eval_generator(args.seed, device),
                              timesteps=args.timesteps,
                              num_rescore=args.num_rescore,
                              num_generate=args.num_generate)
        model.train()
        rec = record_of(task, epochs_done, train_s, time.time() - t0, m)
        if best is None or rec[metric_key] > best[metric_key]:
            keep_best(latest_checkpoint(ckpt_dir), best_path)
            best = rec
        rec["best_epoch"] = best["epoch"]
        history.append(rec)
        with open(curve_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[{task}] epoch {epochs_done}: {metric_key}="
              f"{rec[metric_key]:.4f} (best {best[metric_key]:.4f} at "
              f"epoch {best['epoch']}; train {train_s or 0:.0f}s)",
              flush=True)

    if latest and (not history or history[-1]["epoch"] < epochs_done):
        # killed between its checkpoint and its curve line: evaluate it
        recipes.load_params(latest, task, model)
        evaluate(None)
    while epochs_done < args.max_epochs and not plateaued():
        chunk = min(args.chunk_epochs, args.max_epochs - epochs_done)
        cfg = TrainConfig(
            learning_rate=2e-4, batch_size=batch, epochs=chunk,
            accumulation_steps=accum,
            seed=args.seed + epochs_done // max(args.chunk_epochs, 1),
            eval_every_steps=0, checkpoint_every_epochs=chunk)
        print(f"[{task}] training epochs {epochs_done + 1}..."
              f"{epochs_done + chunk} (batch {batch} x accum {accum}, "
              f"seed {cfg.seed})", flush=True)
        t0 = time.time()
        state, _ = recipes.train_task(task, model, data, cfg,
                                      checkpoint_dir=ckpt_dir, resume=True)
        train_s = time.time() - t0
        epochs_done = state.epoch
        evaluate(train_s)
    return {"task": task, "metric": metric_key,
            "best": best[metric_key], "final": history[-1][metric_key],
            "epochs": history[-1]["epoch"], "plateaued": plateaued(),
            "curve": curve_path, "best_epoch": best["epoch"],
            "best_checkpoint": best_path}


def merge_summary(path: str, head: dict, task: str, entry: dict) -> dict:
    """``summary.json`` with ``task``'s entry set and every other task's
    kept; refuses a file of another corpus or preset."""
    summary = dict(head, tasks={})
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        for key in ("rows", "seed", "preset"):
            if old.get(key) != head[key]:
                raise ValueError(f"{path} holds a run of {key}="
                                 f"{old.get(key)!r}, not {head[key]!r}: "
                                 f"give another --out")
        summary = dict(old, **head)
        summary["tasks"] = dict(old.get("tasks", {}))
    summary["tasks"][task] = entry
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    the device type off the card."""
    if device.type != "cuda":
        return device.type
    from moleculediffusiontransformer_tpu_torch.cli import _nvidia_smi
    return _nvidia_smi() or device.type


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", type=int, default=20480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", choices=("notebook", "tiny"),
                   default="notebook")
    p.add_argument("--tasks", default="all",
                   help="comma-separated task names, or 'all'")
    p.add_argument("--chunk-epochs", type=int, default=25,
                   help="epochs per train chunk between evals/checkpoints")
    p.add_argument("--max-epochs", type=int, default=1000)
    p.add_argument("--patience", type=int, default=8,
                   help="stop when the best metric of the last N evals "
                        "beats the earlier best by < --min-delta")
    p.add_argument("--min-delta", type=float, default=0.005)
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--num-rescore", type=int, default=64,
                   help="forward-R2 eval sample count")
    p.add_argument("--num-generate", type=int, default=41)
    p.add_argument("--out", default="quality_torch")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.train import recipes

    device = _device(args)
    os.makedirs(args.out, exist_ok=True)
    tasks = (list(TASK_PLAN) if args.tasks == "all"
             else args.tasks.split(","))
    unknown = sorted(set(tasks) - set(TASK_PLAN))
    if unknown:
        raise SystemExit(f"unknown tasks {unknown}: expected "
                         f"{list(TASK_PLAN)}")
    smiles, props = synthetic_qm9(n=args.rows, seed=args.seed,
                                  chemically_valid=True)
    head = {"rows": args.rows, "seed": args.seed, "preset": args.preset,
            "corpus": "synthetic_qm9(chemically_valid=True)",
            "optimizer": OPTIMIZER, "dtype": "float32",
            "device": card_name(device)}
    summary = {}
    for task in tasks:
        data = prepare_qm9(smiles, props, mode=recipes.data_mode(task))
        summary = merge_summary(os.path.join(args.out, "summary.json"), head,
                                task, run_task(task, data, args, device))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
