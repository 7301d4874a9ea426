"""Notebook-protocol evaluation of the port's quality checkpoints (the
port's counterpart of ``tools/eval_converged.py``).

The curves of ``tools/quality_convergence_torch.py`` evaluate with
variance-reducing settings (64-sample forward R², 41 generations).  This
tool re-evaluates each task's selected checkpoint (``best.pt``, the best
held-out metric) and, beside it, the latest step checkpoint under the
reference notebooks' protocols:

  forward diffusion    16 held-out molecules, 100-step ADPM2, cond 1.0
                       (Forward_Diffusion.ipynb cell 56)
  inverse diffusion    4 generations (cell 65's 1/4-valid anchor) and 41
  inverse transformer  41 generations (Inverse_Transformer.ipynb cell 51)
  forward transformer  held-out R² (256 samples)

Checkpoints are the port's (``core/checkpoint.py``); the corpus and seed
must be those of training, so that the held-out split is the same.  Every
evaluation draws from a generator on the model's device seeded with
``--seed`` + 7 (the curves' eval draws).  The output is merged into an
existing file, so tasks evaluated in separate runs share one report.

``--serve`` also serves the inverse diffusion ``best.pt`` through an
artifact: the sampler is exported from a freshly built model at the
notebook preset (float32, 41 rows, 64 steps, cond scale 2.0),
loaded in ``ArtifactServer``, the checkpoint swapped in with
``reload_checkpoint``, and one request of the first held-out targets is
served, decoded and scored against the live sampler on the same draws.

  python tools/eval_converged_torch.py --ckpts quality_torch/ckpts \\
      --rows 20480 --out quality_torch/notebook_parity_eval.json --serve
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PLAN = [
    ("forward_diffusion", dict(timesteps=100, num_rescore=16), "n16"),
    ("inverse_diffusion", dict(timesteps=100, num_generate=4), "n4"),
    ("inverse_diffusion", dict(timesteps=100, num_generate=41), "n41"),
    ("inverse_transformer", dict(num_generate=41), "n41"),
    ("forward_transformer", {}, "n256"),
]
SERVE_ROWS, SERVE_STEPS, SERVE_COND_SCALE = 41, 64, 2.0


def checkpoints(ckpts: str, task: str) -> dict:
    """``{"best": path, "latest": path}`` of a task's checkpoints; a task
    without ``best.pt`` (written by ``quality_convergence_torch.py`` after
    each eval) is refused."""
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        latest_checkpoint
    latest = latest_checkpoint(os.path.join(ckpts, task))
    if latest is None:
        raise FileNotFoundError(f"no step_*.pt under {ckpts}/{task}")
    best = os.path.join(ckpts, task, "best.pt")
    if not os.path.exists(best):
        raise FileNotFoundError(
            f"no best.pt under {ckpts}/{task}: tools/"
            f"quality_convergence_torch.py selects it after each eval")
    return {"best": best, "latest": latest}


def serve_best(model, data, best: str, seed: int, preset: str,
               device) -> dict:
    """``best`` served through an exported sampler after
    ``reload_checkpoint``, against the live sampler on the same draws: the
    decoded molecules, their validity and novelty, both ways."""
    import numpy as np
    import torch

    from moleculediffusiontransformer_tpu_torch.design import (
        ArtifactServer, decode_one_hot, evaluate_generated)
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    from moleculediffusiontransformer_tpu_torch.train import recipes
    if len(data.y_test) < SERVE_ROWS:
        raise ValueError(f"{len(data.y_test)} held-out rows for a request "
                         f"of {SERVE_ROWS}: give more --rows")
    fresh = recipes.build_model("inverse_diffusion", data.vocab_size,
                                preset, device=device, seed=seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sampler.pt2")
        t0 = time.perf_counter()
        dx.save_artifact(dx.export_sampler(
            fresh.eval(), batch=SERVE_ROWS, num_steps=SERVE_STEPS,
            cond_scale=SERVE_COND_SCALE, device=device), path,
            tokenizer=data.tokenizer, scaler=data.scaler,
            training_smiles=data.smiles)
        del fresh
        server = ArtifactServer(path, device=device)
        server.reload_checkpoint(best)
        load_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    cond = torch.tensor(np.asarray(data.y_test[:SERVE_ROWS], np.float32),
                        device=device)
    track = (SERVE_ROWS, *server.meta["shape"])
    draws = dict(noise=torch.randn(track, generator=gen, device=device),
                 step_noise=torch.randn((SERVE_STEPS - 1, *track),
                                        generator=gen, device=device))
    with torch.no_grad():
        live = sample(model, cond, num_steps=SERVE_STEPS,
                      cond_scale=SERVE_COND_SCALE, **draws)
        served = server.call(cond, **draws)
    out = {"rows": SERVE_ROWS, "steps": SERVE_STEPS,
           "cond_scale": SERVE_COND_SCALE, "checkpoint": best,
           "tier": server.tier, "startup_s": round(load_s, 1),
           "max_abs_err": float((served.float() - live.float())
                                .abs().max())}
    for name, x in (("live", live), ("served", served)):
        smiles = decode_one_hot(x, data.tokenizer)
        rep = evaluate_generated(smiles, data.smiles)
        out[name] = {"validity_fraction": rep["validity_fraction"],
                     "novelty_fraction": rep["novelty_fraction"],
                     "num_valid": rep["num_valid"], "smiles": smiles}
    out["same_molecules"] = out["live"]["smiles"] == out["served"]["smiles"]
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpts", default="quality_torch/ckpts")
    p.add_argument("--rows", type=int, default=20480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", choices=("notebook", "tiny"),
                   default="notebook")
    p.add_argument("--tasks", default="all",
                   help="comma-separated task names, or 'all'")
    p.add_argument("--out", default="quality_torch/notebook_parity_eval.json")
    p.add_argument("--serve", action="store_true",
                   help="also serve the inverse diffusion best.pt through "
                        "an artifact against live on the same draws")
    p.add_argument("--device", default="cuda",
                   help="where to evaluate: cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.train import recipes
    from quality_convergence_torch import (checkpoint_epoch, eval_generator,
                                           scalars)

    device = _device(args)
    known = {t for t, _, _ in PLAN}
    tasks = known if args.tasks == "all" else set(args.tasks.split(","))
    if tasks - known:
        raise SystemExit(f"unknown tasks {sorted(tasks - known)}: expected "
                         f"{sorted(known)}")
    smiles, props = synthetic_qm9(n=args.rows, seed=args.seed,
                                  chemically_valid=True)
    out = {"corpus": f"synthetic_qm9(n={args.rows}, seed={args.seed}, "
                     "chemically_valid=True)",
           "checkpoints": {}, "latest_checkpoints": {}, "epochs": {},
           "metrics": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        if old.get("corpus") != out["corpus"]:
            raise SystemExit(f"{args.out} reports {old.get('corpus')}: "
                             f"give another --out")
        for key, value in old.items():
            out[key] = dict(value) if isinstance(value, dict) else value
    cache = {}

    def entry(task):
        if task not in cache:
            data = prepare_qm9(smiles, props, mode=recipes.data_mode(task))
            paths = checkpoints(args.ckpts, task)
            cache[task] = (data, paths, recipes.build_model(
                task, data.vocab_size, args.preset, device=device).eval())
            out["checkpoints"][task] = paths["best"]
            out["latest_checkpoints"][task] = paths["latest"]
            out["epochs"][task] = {k: checkpoint_epoch(v)
                                   for k, v in paths.items()}
        return cache[task]

    for task, kw, tag in PLAN:
        if task not in tasks:
            continue
        data, paths, model = entry(task)
        for which, suffix in (("best", ""), ("latest", "_latest")):
            recipes.load_params(paths[which], task, model)
            m = recipes.eval_task(task, model, data,
                                  eval_generator(args.seed, device), **kw)
            out["metrics"][f"{task}_{tag}{suffix}"] = scalars(m)
            print(f"[{task} {tag} {which}] {scalars(m)}", flush=True)
    if args.serve:
        data, paths, model = entry("inverse_diffusion")
        recipes.load_params(paths["best"], "inverse_diffusion", model)
        out["served"] = serve_best(model, data, paths["best"], args.seed,
                                   args.preset, device)
        print(json.dumps({k: v for k, v in out["served"].items()
                          if k not in ("live", "served")}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
