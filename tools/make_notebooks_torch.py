"""Generate the PyTorch port's notebook-form entry points
(``notebooks/*_torch.ipynb``; the counterpart of ``tools/make_notebooks.py``).

A notebook per port example (``examples/*_torch.py``) -- markdown
front-matter from the example's own docstring, a smoke-scale run cell that
calls the example's ``main(ARGV)``, and the full-scale command -- plus a
cell-by-cell quickstart that walks the train -> sample -> evaluate flow on
the port.  Every notebook runs on the card; its one ``DEVICE`` line set to
``"cpu"`` runs it without one.

Deterministic output (no timestamps or ids), so the notebooks are committed
and regenerable:  python tools/make_notebooks_torch.py [--out DIR]
"""
import argparse
import ast
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "notebooks")
README = ("the root README's port section (`README.md`, \"PyTorch/CUDA "
          "port\", \"Examples and notebooks\")")

# (example module, notebook title, reference notebook it rebuilds)
EXAMPLES = [
    ("forward_diffusion_torch", "Forward_Diffusion",
     "Forward_Diffusion.ipynb"),
    ("inverse_diffusion_torch", "Inverse_Diffusion",
     "Inverse_Diffusion.ipynb"),
    ("forward_transformer_torch", "Forward_Transformer",
     "Forward_Transformer.ipynb"),
    ("inverse_transformer_torch", "Inverse_Transformer",
     "Inverse_Transformer.ipynb"),
    ("simple_models_torch", "Simple_Models",
     "Simple examples of basic models.ipynb"),
    ("audio_diffusion_torch", "Audio_Diffusion",
     "(audio lineage, reference model.py)"),
]
TOURS = ("simple_models_torch", "audio_diffusion_torch")


def md(source: str) -> dict:
    return {"cell_type": "markdown", "metadata": {},
            "source": source.splitlines(keepends=True)}


def code(source: str) -> dict:
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "outputs": [], "source": source.splitlines(keepends=True)}


def notebook(cells) -> dict:
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def write(out: str, name: str, nb: dict) -> str:
    path = os.path.join(out, name + "_torch.ipynb")
    with open(path, "w") as f:
        json.dump(nb, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", path)
    return path


def example_docstring(module: str) -> str:
    with open(os.path.join(REPO, "examples", module + ".py")) as f:
        return ast.get_docstring(ast.parse(f.read())) or ""


def smoke_argv(module: str) -> str:
    """The smoke cell's ``ARGV``: the tiny model for two epochs, or the
    tour at its tiny sizes."""
    if module in TOURS:
        return "['--device', DEVICE]"
    return "['--tiny', '--epochs', '2', '--device', DEVICE]"


def full_command(module: str) -> str:
    if module in TOURS:
        return f"python examples/{module}.py --full"
    return (f"python examples/{module}.py --csv qm9_.csv --epochs 300 "
            "--checkpoint-dir ckpts/")


def example_notebook(module: str, title: str, ref: str) -> dict:
    doc = example_docstring(module)
    cells = [
        md(f"# {title} (PyTorch port)\n\n"
           f"The PyTorch/CUDA port's rebuild of the reference notebook "
           f"**{ref}**.\n\n"
           f"The implementation lives in `examples/{module}.py` (and the\n"
           f"`moleculediffusiontransformer_tpu_torch` package it drives); "
           f"this\nnotebook is the interactive surface over it.\n\n"
           "```\n" + doc + "\n```"),
        code("import os, sys\n"
             "REPO = os.path.abspath('..')\n"
             "sys.path.insert(0, REPO)\n"
             "sys.path.insert(0, os.path.join(REPO, 'examples'))"),
        md("## Smoke-scale run\n\nTiny model, synthetic QM9 stand-in -- "
           "minutes on the card or the CPU. `DEVICE = 'cuda'` runs it on "
           "the card; `'cpu'` runs it without one. Edit the `ARGV` list "
           "like you would the CLI flags."),
        code(f"import {module} as example\n"
             "DEVICE = 'cuda'  # 'cpu' runs it without a card\n"
             f"ARGV = {smoke_argv(module)}\n"
             "result = example.main(ARGV)"),
        md("## Full scale\n\nThe notebook-preset run on the card (pass the "
           "real dataset when available):\n\n"
           f"```bash\n{full_command(module)}\n```\n\n"
           f"See {README} for the flags, the commands on the CPU and on "
           "the card, and how to regenerate these notebooks."),
    ]
    return notebook(cells)


QUICKSTART_CELLS = [
    md("# Quickstart: train → sample → evaluate (PyTorch port)\n\n"
       "The inverse-design flow (12 QM9 properties → SMILES) cell by "
       "cell at toy scale -- the interactive equivalent of the reference's "
       "Inverse_Diffusion.ipynb core loop, on the PyTorch/CUDA port."),
    code("import os, sys\n"
         "sys.path.insert(0, os.path.abspath('..'))\n"
         "import numpy as np, torch\n"
         "DEVICE = torch.device('cuda')  # torch.device('cpu') runs it "
         "without a card\n"
         "print(torch.cuda.get_device_name(DEVICE) if DEVICE.type == 'cuda' "
         "else DEVICE)"),
    md("## Data\n\nSynthetic QM9 stand-in (chemically valid mode); swap "
       "in `load_qm9('qm9_.csv')` for the real set."),
    code("from moleculediffusiontransformer_tpu_torch.data.qm9 import "
         "synthetic_qm9, prepare_qm9\n"
         "smiles, props = synthetic_qm9(512, seed=1, "
         "chemically_valid=True)\n"
         "data = prepare_qm9(smiles, props, mode='inverse_diffusion', "
         "max_length=16)\n"
         "data.X_train.shape, data.y_train.shape, data.vocab_size"),
    md("## Model\n\nA tiny `QMDiffusion` with seeded weights (the notebook "
       "preset is `recipes.build_model('inverse_diffusion', vocab)` -- 91M "
       "params)."),
    code("from moleculediffusiontransformer_tpu_torch.models import "
         "QMDiffusion, sample\n"
         "from moleculediffusiontransformer_tpu_torch.nn.primitives import "
         "init_parameters\n"
         "model = QMDiffusion(max_length=16, channels=16, "
         "pred_dim=data.vocab_size,\n"
         "                    text_embed_dim=16, embed_dim_position=8,\n"
         "                    context_embedding_max_length=12, "
         "multipliers=(1, 2),\n"
         "                    factors=(2,), num_blocks=(1,), "
         "attentions=(1,),\n"
         "                    attention_heads=2, attention_features=8,\n"
         "                    pre_transformer=1, patch_size=1)\n"
         "init_parameters(model, torch.Generator().manual_seed(0))\n"
         "model = model.to(DEVICE)\n"
         "X = torch.as_tensor(data.X_train[:32], device=DEVICE)\n"
         "y = torch.as_tensor(data.y_train[:32], device=DEVICE)"),
    md("## Train\n\nThe train step (`ClipAdam` at 1e-3 with the gradient "
       "clipped at 0.5; the reference's recipe is 2e-4). Loss must "
       "fall."),
    code("from moleculediffusiontransformer_tpu_torch.core.config import "
         "TrainConfig\n"
         "from moleculediffusiontransformer_tpu_torch.train.trainer import "
         "(\n"
         "    TrainState, make_diffusion_train_step, make_optimizer)\n"
         "opt = make_optimizer(TrainConfig(learning_rate=1e-3))\n"
         "state = TrainState.create(model, opt)\n"
         "step = make_diffusion_train_step(model, opt)\n"
         "gen = torch.Generator(device=DEVICE).manual_seed(0)\n"
         "for i in range(20):\n"
         "    loss = step(state, y, X, gen)\n"
         "    if i % 5 == 0: print(i, float(loss))"),
    md("## Sample + evaluate\n\n64-step CFG sampling, decode to SMILES, "
       "validity/novelty report (valence-aware checker when RDKit is "
       "absent)."),
    code("from moleculediffusiontransformer_tpu_torch.design import ("
         "decode_one_hot, evaluate_generated)\n"
         "out = sample(model.eval(), y[:8], gen, num_steps=64, "
         "cond_scale=2.0)\n"
         "generated = decode_one_hot(out, data.tokenizer)\n"
         "evaluate_generated(generated, data.smiles)"),
    md("## Scale up\n\n"
       "- notebook presets: `train.recipes.build_model(task, vocab)` (the "
       "91M inverse model, the 18M forward one, the two transformers), or "
       "`models.from_config(QMDiffusion, core.config."
       "inverse_diffusion_qm9(vocab))`\n"
       "- data-parallel training: `train_diffusion(..., mesh=parallel."
       "make_mesh())` in every process of `torchrun --nproc-per-node N`, "
       "or the CLI's `train` under `torchrun`\n"
       "- serving: `python -m moleculediffusiontransformer_tpu_torch "
       "export --task inverse_diffusion --out sampler.pt2`, then `python "
       "-m moleculediffusiontransformer_tpu_torch serve sampler.pt2 "
       "--http 8000`\n"
       "- the whole quality table: `tools/reproduce_baseline_torch.py`\n\n"
       f"More in {README}."),
]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=OUT,
                   help="directory of the notebooks (default: notebooks/)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    paths = [write(args.out, title, example_notebook(module, title, ref))
             for module, title, ref in EXAMPLES]
    paths.append(write(args.out, "Quickstart", notebook(QUICKSTART_CELLS)))
    return paths


if __name__ == "__main__":
    main()
