"""Turn a published reference PyTorch state dict into a checkpoint of the
PyTorch/CUDA port (the port's counterpart of
``tools/import_torch_checkpoint.py``).

The reference publishes state dicts for the four trained models
(README.md:44-60: forward diffusion epoch 78, forward transformer epoch 10,
inverse diffusion epoch 4851, inverse transformer epoch 2861).  The port's
modules keep the reference's parameter names and layouts, so the state
dict loads with ``strict=True`` into the task's model, which is then saved
as a port checkpoint (``core/checkpoint.py::checkpoint_state``, no
optimizer state) that the other tools, the CLI and ``ArtifactServer`` read.
The file may also be the ``.npz``/``.pt`` the JAX package's
``export-torch`` writes from its msgpack checkpoints.  The model is built on
the card unless ``--device cpu``.

  python tools/import_torch_checkpoint_torch.py statedict.pt out.pt \\
      --model inverse_diffusion --vocab 22
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_checkpoint")
    p.add_argument("output")
    p.add_argument("--model", required=True,
                   choices=["inverse_diffusion", "forward_diffusion",
                            "inverse_transformer", "forward_transformer"])
    p.add_argument("--vocab", type=int, default=22,
                   help="vocabulary size incl. padding (22 plain, 24 with "
                        "@/$ delimiters)")
    p.add_argument("--preset", choices=("notebook", "tiny"),
                   default="notebook",
                   help="the architecture the state dict holds")
    p.add_argument("--device", default="cuda",
                   help="where the model is built: cuda (the default) or "
                        "cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, save_checkpoint)
    from moleculediffusiontransformer_tpu_torch.train import recipes

    device = _device(args)
    model = recipes.build_model(args.model, args.vocab, args.preset,
                                device=device)
    recipes.load_params(args.torch_checkpoint, args.model, model)
    save_checkpoint(args.output, checkpoint_state(model))
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {len(model.state_dict())} torch tensors -> "
          f"{args.output} ({n:,} parameters)")
    return {"output": args.output, "parameters": n}


if __name__ == "__main__":
    main()
