#!/usr/bin/env python3
"""The two readings of a traced graph replay, held to each other on one
CUDA card: ``chip_smoke.py``'s ``trace_events`` (the profiler's kineto
events as they come) against ``function_events`` (``prof.events()``, the
profiler's function-event list, which phase 30 read before).

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/check_torch_trace_reading.py [--replays 3] [--out FILE]

It exports and loads phase 30's encoder (bf16, 1,024 SMILES) and 91M
sampler (bf16, 512 rows, 64 steps, the stack kernel K1 built from
``csrc/``) with seeded random weights, traces ``--replays`` replays of the
same sampler request and one of the encoder through phase 30's
``replay_trace(..., hold_reading=True)``: each trace's device ms, busy ms
(the union of the device spans), the request's window and busy share from
the kineto events (a ``serve_replay_trace`` line), and the same trace read
both ways (a ``serve_trace_reading`` line: spans, device ms and window of
each reading, the largest difference of a time, the names found in one
reading only, the seconds ``prof.events()`` took).  It fails if the two
readings of a trace differ.  Replays of one request differ from each other
in their window (the host), which is what the spread of the busy share
across replays shows.  Prints a last JSON line with the card's name and
power limit and the sampler replays' busy shares.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replays", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
        add_start_end_char, pad_sequences)
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cuda_build.build(tf.SOURCE)
    inv, tr = cs.design_data()
    args_of = cs.serve_artifact_args(inv.vocab_size, tr.vocab_size)
    records = []
    with tempfile.TemporaryDirectory(prefix="trace_reading_") as tmp:
        def load(name, task, vocab):
            model = cs.serve_model(dev, task, vocab, 0, torch.bfloat16)
            path = cs.serve_export(dev, tmp, name, args_of[name][0],
                                   *args_of[name][1])
            return cs.serve_load(dev, path,
                                 cs.serve_checkpoint(tmp, model, name), name)

        encoder = load("encoder", "forward_transformer", tr.vocab_size)
        smiles = [tr.smiles[i % len(tr.smiles)]
                  for i in range(cs.SERVE_ENCODER_BATCH)]
        ids = torch.as_tensor(np.asarray(pad_sequences(
            tr.tokenizer.texts_to_sequences(add_start_end_char(smiles)),
            encoder.specs[0].shape[1]), np.int64), device=dev)
        sampler = load("sampler", "inverse_diffusion", inv.vocab_size)
        gen = torch.Generator(device=dev).manual_seed(30)
        props = torch.rand(cs.SERVE_BATCH, 12, generator=gen,
                           device=dev) * 2 - 1
        with torch.no_grad():
            records.append(cs.replay_trace("encoder bf16 1024", encoder,
                                           (ids,), hold_reading=True))
            for i in range(args.replays):
                records.append(cs.replay_trace(
                    f"sampler bf16 512, replay {i + 1}", sampler, (props,),
                    hold_reading=True))
    summary = {"card": card, "torch": torch.__version__,
               "busy_share_sampler": [r["busy_share"] for r in records[1:]],
               "device_ms_sampler": [r["device_ms"] for r in records[1:]],
               "traced_request_ms_sampler": [r["traced_request_ms"]
                                             for r in records[1:]]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"traces": records, **summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
