"""Serve from an exported artifact on the PyTorch port -- no model code on
the host (the counterpart of ``examples/serve_artifact.py``).

Load a ``.pt2`` artifact that ``tools/export_serving_artifact_torch.py`` or
the port CLI's ``export`` wrote, restore a checkpoint into the artifact's
own variables, and serve.  All of that is ``design.ArtifactServer``: the
artifact KIND is read from its own header; the serving host needs the
artifact, a checkpoint and the tokenizer's vocabulary;
``moleculediffusiontransformer_tpu_torch.models`` is never imported.  On
the card the server captures one whole request into a CUDA graph at load
and answers on that tier.

Supported artifacts (see ``design/export.py``):
  * diffusion sampler  -- call(props, seed=) -> one-hot tracks
    (reference `generative.py:834-870` semantics) -> decoded SMILES
  * AR generator       -- call(props, start_ids, seed=) -> token ids
    (reference `transformer.py:786-838`) -> decoded SMILES
  * property encoder   -- call(ids) -> scaled properties
    (reference `generative.py:1864-1913`) -> physical-unit properties

``--checkpoint`` takes any checkpoint of the port (a ``step_N.pt`` of the
training loop or the quality tool's ``best.pt``) or a reference-layout
state dict; without it the server fills seeded placeholder weights.  The
JAX package's ``--aot-executable``, ``.mdtx`` and StableHLO tiers have no
counterpart here.  Runs on the card unless ``--device cpu`` (an artifact
serves on the device it was exported on).

  # build (once):
  python tools/export_serving_artifact_torch.py sampler.pt2 \\
      --model inverse_diffusion --batch 64 --steps 64
  # serve (synthetic data; placeholder weights without --checkpoint):
  python examples/serve_artifact_torch.py sampler.pt2 \\
      [--checkpoint ckpts/step_100.pt] [--csv qm9_.csv]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from common_torch import add_device_flag, load_dataset  # noqa: E402


def serve_sampler(server, args) -> dict:
    """Diffusion sampler: condition on held-out property vectors."""
    from moleculediffusiontransformer_tpu_torch.design import (
        decode_one_hot, evaluate_generated)
    n_cond = server.specs[0].shape[1]
    data = load_dataset(args, mode="inverse_diffusion", max_length=32)
    props = np.asarray(data.y_test[:server.batch], np.float32)[:, :n_cond]
    out = server.call_padded(props, seed=args.seed)
    smiles = decode_one_hot(out, data.tokenizer)
    return _report("sampled", smiles, evaluate_generated(smiles,
                                                         data.smiles))


def serve_generator(server, args) -> dict:
    """AR transformer: start every row at the '@' token, decode to '$'."""
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import \
        remove_start_end_token_first
    from moleculediffusiontransformer_tpu_torch.design import \
        evaluate_generated
    n_cond = server.specs[0].shape[1]
    start_len = server.specs[1].shape[1]
    data = load_dataset(args, mode="transformer", max_length=64)
    props = np.asarray(data.y_test[:server.batch], np.float32)[:, :n_cond]
    start_id = data.tokenizer.word_index.get("@", 1)
    start = np.full((props.shape[0], start_len), start_id, np.int64)
    ids = server.call_padded(props, start, seed=args.seed)
    texts = data.tokenizer.decode(ids)
    smiles = [remove_start_end_token_first(t) for t in texts]
    return _report("generated", smiles, evaluate_generated(smiles,
                                                           data.smiles))


def serve_encoder(server, args) -> dict:
    """Forward property prediction on held-out SMILES."""
    max_length = server.specs[0].shape[1]
    data = load_dataset(args, mode="transformer", max_length=max_length)
    ids = np.asarray(data.X_test[:server.batch], np.int64)
    logits = server.call_padded(ids)
    scaled = logits.reshape(ids.shape[0], -1)[:, :12]
    props = data.scaler.inverse_transform(scaled)
    print(f"served batch={ids.shape[0]}: predicted properties "
          f"(physical units, first 3 rows x 6 cols):")
    for row in props[:3]:
        print("  " + " ".join(f"{v:9.3f}" for v in row[:6]))
    return {"properties": props}


def _report(verb, smiles, report) -> dict:
    print(f"{verb} batch={len(smiles)}: validity "
          f"{report['validity_fraction']:.2f}, novelty "
          f"{report['novelty_fraction']:.2f}")
    for s in smiles[:8]:
        print(" ", s or "<empty>")
    return dict(report, smiles=smiles)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("artifact", help=".pt2 file from export_serving_artifact"
                                    "_torch.py or the CLI's export")
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoint (step_N.pt, best.pt) or a "
                        "reference-layout state dict; seeded placeholder "
                        "weights when omitted (smoke mode)")
    p.add_argument("--csv", default=None,
                   help="qm9_.csv for the tokenizer vocabulary + novelty "
                        "set; synthetic stand-in when omitted")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    return p


def main(argv=None) -> dict:
    """Serve one request; returns the report (``smiles`` with validity and
    novelty, or the encoder's ``properties``) and the ``server``."""
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.design import ArtifactServer

    device = _device(args)
    server = ArtifactServer(args.artifact, args.checkpoint, seed=args.seed,
                            device=device)
    if args.checkpoint:
        print(f"restored {args.checkpoint}")
    else:
        print("NOTE: random placeholder params (pass --checkpoint)")
    print(f"serving a {server.kind} artifact of batch {server.batch} on "
          f"{device} ({server.tier} tier)")

    if server.kind == "encoder":
        report = serve_encoder(server, args)
    elif server.kind == "sampler":
        report = serve_sampler(server, args)
    elif server.kind == "generator":
        report = serve_generator(server, args)
    else:
        sys.exit("inpainter artifacts need source/mask inputs — drive them "
                 "via server.call(props, source, mask, seed=...) directly")
    return dict(report, server=server)


if __name__ == "__main__":
    main()
