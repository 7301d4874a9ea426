"""Build a serving artifact of the PyTorch/CUDA port for any of the four
notebook presets (the port's counterpart of
``tools/export_serving_artifact.py``).

The flags of the JAX tool, mapped onto the port CLI's ``export``
(``python -m moleculediffusiontransformer_tpu_torch export``): the output
path to ``--out``, ``--model`` to ``--task``, ``--steps`` to
``--timesteps``; every other flag passes through by its own name.  The
artifact is the CFG diffusion sampler (reference `generative.py:834-870`;
one denoise evaluation, the server runs the sampler's loop around it), one
KV-cached AR decode step (`transformer.py:786-838`), or the forward
property-regression pass (`generative.py:1864-1913`), as a ``.pt2`` that
``design.ArtifactServer`` (or the CLI's ``serve``) loads with any
checkpoint of the architecture: the file holds no weights.  An artifact
runs on the device type it was exported on, the card unless ``--device
cpu``.

  python tools/export_serving_artifact_torch.py out.pt2 \\
      --model inverse_diffusion --vocab 22 --batch 512 --steps 64 \\
      --cond-scale 2.0 [--fused]
  python tools/export_serving_artifact_torch.py gen.pt2 \\
      --model inverse_transformer --tokens 63
  python tools/export_serving_artifact_torch.py enc.pt2 \\
      --model forward_transformer --max-length 64

``--fused`` exports with both kernel switches on, the resnet-run kernel
(K8) and the shared-KV null half of the stack kernel: the nearest
counterpart of the JAX tool's baked-in Pallas path (the stack kernel K1 is
in every diffusion program).  ``--mesh-devices N`` exports one rank's share
of the batch-parallel sampler over an N-rank data mesh; the mesh is the
process group, so run the tool under ``torchrun --nproc-per-node N`` (rank
0 writes the file).  ``--platforms`` (XLA targets) is refused: the
artifact runs on the card it is loaded on.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("output")
    p.add_argument("--model", default="inverse_diffusion",
                   choices=["inverse_diffusion", "forward_diffusion",
                            "inverse_transformer", "forward_transformer"])
    p.add_argument("--vocab", type=int, default=None,
                   help="vocab size (default: 22 for diffusion presets, "
                   "24 with '@$' for the transformer presets)")
    p.add_argument("--checkpoint", help="checkpoint to check the "
                   "architecture against (loaded strict; optional)")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--cond-scale", type=float, default=2.0)
    p.add_argument("--tokens", type=int, default=63,
                   help="inverse_transformer: tokens to generate")
    p.add_argument("--max-length", type=int, default=64,
                   help="forward_transformer: padded SMILES id length")
    p.add_argument("--platforms", default=None,
                   help="refused: XLA targets have no meaning for an "
                   "artifact that runs on the card it is loaded on")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused", action="store_true",
                   help="export with both kernel switches on (K8 and the "
                   "shared-KV null half)")
    p.add_argument("--embed-vocab", action="store_true",
                   help="embed the dataset's tokenizer/scaler/novelty "
                   "corpus (self-contained serving bundle)")
    p.add_argument("--csv", default=None,
                   help="qm9_.csv for --embed-vocab (synthetic stand-in "
                   "when omitted)")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="export one rank's share of the batch-parallel "
                   "sampler over an N-rank data mesh (run under torchrun "
                   "with N processes)")
    p.add_argument("--preset", choices=("notebook", "tiny"),
                   default="notebook")
    p.add_argument("--device", default="cuda",
                   help="where the artifact runs: cuda (the default) or cpu")
    return p


def cli_argv(args: argparse.Namespace) -> list:
    """The CLI's ``export`` arguments for the tool's ``args``."""
    argv = ["export", "--out", args.output, "--task", args.model,
            "--timesteps", str(args.steps), "--batch", str(args.batch),
            "--cond-scale", str(args.cond_scale), "--tokens",
            str(args.tokens), "--max-length", str(args.max_length),
            "--dtype", args.dtype, "--preset", args.preset, "--device",
            args.device, "--mesh-devices", str(args.mesh_devices)]
    for flag, value in (("--vocab", args.vocab),
                        ("--checkpoint", args.checkpoint),
                        ("--csv", args.csv), ("--rows", args.rows)):
        if value is not None:
            argv += [flag, str(value)]
    return argv + [flag for flag, on in (("--fused", args.fused),
                                         ("--embed-vocab", args.embed_vocab))
                   if on]


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    if args.platforms is not None:
        p.error("--platforms names XLA targets: a port artifact runs on "
                "the device type it was exported on (--device)")
    from moleculediffusiontransformer_tpu_torch import cli
    return cli.main(cli_argv(args))


if __name__ == "__main__":
    main()
