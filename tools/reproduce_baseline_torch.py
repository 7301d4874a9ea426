"""Reproduce the BASELINE.md quality table with the PyTorch/CUDA port in ONE
command (the port's counterpart of ``tools/reproduce_baseline.py``).

Given the reference dataset (``qm9_.csv``, reference README.md:30) and the
four published checkpoints (reference README.md:44-60), this recomputes
every quality number in BASELINE.md:

  1. forward diffusion  -- property R² (16 held-out, 100-step ADPM2,
     cond_scale 1; Forward_Diffusion.ipynb cell 56: 0.9668)
  2. inverse diffusion  -- validity + novelty of generated molecules
     (Inverse_Diffusion.ipynb cell 65: novelty 0.25, 1/4 valid)
  3. inverse transformer -- validity + novelty + per-molecule re-scored R²
     (Inverse_Transformer.ipynb cell 51: novelty 0.2195, 9/41 valid)
  4. forward transformer -- property R² on held-out data

Checkpoints are the reference's torch state dicts (``{task}.pt``/``.pth``),
read by the port's ``recipes.load_params`` directly (their keys are the
port's), or the port's own checkpoints; a JAX ``.msgpack`` crosses through
the JAX package's ``export-torch`` first.  Dataset and checkpoints are
optional: absent blobs fall back to the synthetic stand-in and seeded
random weights (clearly labelled: random-weight numbers are smoke values).
``--train-epochs N`` trains every model WITHOUT a checkpoint in-process for
N epochs first (``--train-preset tiny``: CPU-feasible architectures;
``notebook``: the full presets, at ``recipes.PRODUCTION_BATCHES`` unless
``--train-batch`` overrides).  Every evaluation draws from a generator on
the model's device seeded with ``--seed``.  Runs on the card unless
``--device cpu``.

  python tools/reproduce_baseline_torch.py \\
      --csv qm9_.csv --checkpoint-dir ckpts/ --out baseline_repro.json
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from moleculediffusiontransformer_tpu_torch.train import recipes  # noqa: E402

MODELS = recipes.TASKS


def find_checkpoint(directory, name):
    if not directory:
        return None
    hits = sorted(glob.glob(os.path.join(directory, f"{name}*")))
    return hits[0] if hits else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", default=None, help="qm9_.csv; synthetic "
                   "stand-in when omitted")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="dir with {model_name}.{pt|pth|npz} files")
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--num-rescore", type=int, default=16,
                   help="forward-R2 sample count (notebook: 16)")
    p.add_argument("--num-generate", type=int, default=41,
                   help="inverse-generation count (notebook: 41/4)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="baseline_repro.json")
    p.add_argument("--train-epochs", type=int, default=0,
                   help="train any model WITHOUT a checkpoint in-process "
                   "for N epochs before evaluating (0 = evaluate as-is; "
                   "random-init numbers are smoke values)")
    p.add_argument("--train-preset", choices=("tiny", "notebook"),
                   default="tiny",
                   help="architecture scale for --train-epochs (tiny: "
                   "CPU-feasible; notebook: the full presets)")
    p.add_argument("--train-batch", type=int, default=None,
                   help="override the per-task batch (default: "
                   "recipes.PRODUCTION_BATCHES for the notebook preset, "
                   "128 for tiny)")
    p.add_argument("--expect-sha256", default=None,
                   help="make the CSV checksum check fatal against this "
                   "hash (default: structural checks fatal, hash recorded)")
    p.add_argument("--device", default="cuda",
                   help="where the models run: cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        load_qm9, prepare_qm9, synthetic_qm9, verify_qm9_csv)
    from moleculediffusiontransformer_tpu_torch.design.inverse_design import \
        rescore_generated

    device = _device(args)
    verification = None
    if args.csv:
        verification = verify_qm9_csv(args.csv,
                                      expected_sha256=args.expect_sha256)
        smiles, props = load_qm9(args.csv, max_rows=args.rows)
        dataset = os.path.abspath(args.csv)
    else:
        # chemically_valid: valence-correct molecules, so validity/novelty
        # metrics carry meaning even on the stand-in
        smiles, props = synthetic_qm9(n=args.rows or 4096, seed=args.seed,
                                      chemically_valid=True)
        dataset = "synthetic stand-in (pass --csv qm9_.csv for the real set)"
        print(f"NOTE: {dataset}")

    def generator():
        return torch.Generator(device=device).manual_seed(args.seed)

    results = {"dataset": dataset, "checkpoints": {}, "metrics": {}}
    if verification is not None:
        results["dataset_verification"] = verification
    if args.train_epochs:
        results["training"] = {"epochs": args.train_epochs,
                               "preset": args.train_preset,
                               "batch": args.train_batch or "production plan",
                               "optimizer": "adam 2e-4 + grad-clip 0.5 "
                                            "(reference generative.py:1132)"}

    def task_train_cfg(task):
        """Reference hyperparameters (Adam 2e-4 + grad-clip 0.5,
        generative.py:1132) at the task's production batch unless
        --train-batch overrides."""
        if args.train_batch is not None:
            batch, accum = args.train_batch, 1
        elif args.train_preset == "notebook":
            batch, accum = recipes.PRODUCTION_BATCHES[task]
        else:
            batch, accum = 128, 1
        return TrainConfig(learning_rate=2e-4, batch_size=batch,
                           accumulation_steps=accum,
                           epochs=args.train_epochs, seed=args.seed)

    def get_model(task, data):
        """Checkpoint > in-process training > random init, per task."""
        ckpt = find_checkpoint(args.checkpoint_dir, task)
        train = ckpt is None and args.train_epochs > 0
        preset = args.train_preset if train else "notebook"
        model = recipes.build_model(task, data.vocab_size, preset,
                                    device=device, seed=args.seed)
        if train:
            cfg = task_train_cfg(task)
            recipes.train_task(task, model, data, cfg)
            src = (f"trained in-process ({preset} preset, "
                   f"{args.train_epochs} epochs, batch {cfg.batch_size}"
                   f"x{cfg.accumulation_steps} accum)")
        else:
            model, src = recipes.load_params(ckpt, task, model)
        results["checkpoints"][task] = src
        return model.eval()

    # ---- 1. forward diffusion: property R² --------------------------------
    data_fd = prepare_qm9(smiles, props, mode="forward_diffusion")
    model_fd = get_model("forward_diffusion", data_fd)
    m = recipes.eval_task("forward_diffusion", model_fd, data_fd,
                          generator(), timesteps=args.timesteps,
                          num_rescore=args.num_rescore)
    results["metrics"]["forward_diffusion_r2"] = m["r2"]
    results["metrics"]["forward_diffusion_mae"] = m["mae"]
    print(f"forward diffusion R2 = {m['r2']:.4f}  "
          f"(BASELINE.md target: 0.9668)")

    # ---- 2. inverse diffusion: validity + novelty -------------------------
    data_id = prepare_qm9(smiles, props, mode="inverse_diffusion")
    model_id = get_model("inverse_diffusion", data_id)
    m = recipes.eval_task("inverse_diffusion", model_id, data_id,
                          generator(), timesteps=args.timesteps,
                          num_generate=args.num_generate)
    results["metrics"]["inverse_diffusion_validity"] = m["validity_fraction"]
    results["metrics"]["inverse_diffusion_novelty"] = m["novelty_fraction"]
    print(f"inverse diffusion validity = {m['validity_fraction']:.4f}, "
          f"novelty = {m['novelty_fraction']:.4f}  "
          f"(BASELINE.md novelty: 0.25)")
    del model_id

    # ---- 3. inverse transformer: validity/novelty + re-scored R² ----------
    data_tr = prepare_qm9(smiles, props, mode="transformer")
    model_it = get_model("inverse_transformer", data_tr)
    m = recipes.eval_task("inverse_transformer", model_it, data_tr,
                          generator(), num_generate=args.num_generate)
    results["metrics"]["inverse_transformer_validity"] = (
        m["validity_fraction"])
    results["metrics"]["inverse_transformer_novelty"] = m["novelty_fraction"]
    print(f"inverse transformer validity = {m['validity_fraction']:.4f}, "
          f"novelty = {m['novelty_fraction']:.4f}  "
          f"(BASELINE.md novelty: 0.2195)")

    # re-score the generated molecules with the forward diffusion model
    # (reference sample_loop_transformer -> forward re-score,
    # generative.py:1505-1529)
    gen = [s for s in m.get("sample_smiles", []) if s]
    if gen:
        targets = data_tr.scaler.inverse_transform(
            np.asarray(data_tr.y_test[:len(gen)]))
        rs = rescore_generated(model_fd, gen, targets, data_fd.tokenizer,
                               data_fd.scaler, generator())
        per_mol = [round(float(r), 3) for r in rs["per_molecule_r2"]]
        results["metrics"]["rescored_per_molecule_r2"] = per_mol
        print(f"re-scored per-molecule R2 = {per_mol}  "
              f"(BASELINE.md spread: 0.25-0.98)")

    # ---- 4. forward transformer: property R² ------------------------------
    model_ft = get_model("forward_transformer", data_tr)
    m = recipes.eval_task("forward_transformer", model_ft, data_tr)
    results["metrics"]["forward_transformer_r2"] = m["r2"]
    print(f"forward transformer R2 = {m['r2']:.4f}")

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
