#!/usr/bin/env python3
"""One axis of ``chip_smoke.py``'s phase 33 (tp, sp, pp or ep) on two gloo
ranks of one CUDA card, from each of several checkouts in turn, so that a
parent and a change are compared in one call on one card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/check_torch_parallel_ab.py --mode ep [--steps 5]
        [--out FILE] ROOT [ROOT ...]

Each ROOT is a checkout (``.``, or a tree unpacked with ``git archive``);
give them in the order to run, parent, change, change, parent.  For each,
a process of its own builds the stack and streaming-attention kernels of
that tree, spawns two ranks that join a gloo group and run that tree's
``chip_smoke.<mode>_axis`` (the mode's bf16 steps at full width, then its
float32 check against one card) with ``--steps`` timed steps after the
first, and prints one JSON line a rank: the seconds of each step, the
collectives' seconds by kind and share of a timed step, the peak bytes, the
losses and the float32 check.  The first line is the card's name and power
limit.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

KEYS = ("seconds", "seconds_per_step", "collective_seconds",
        "collective_share", "peak_bytes", "losses", "dropped")


def load(root: str):
    """``root``'s ``chip_smoke.py`` as the module ``chip_smoke`` (a spawned
    rank unpickles its function by that name)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    return smoke


def rank_main(rank: int, tmp: str, cfg: dict) -> None:
    """One rank: join the gloo group and run the mode's body."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, cfg["root"])
    smoke = load(cfg["root"])
    from moleculediffusiontransformer_tpu_torch.parallel import \
        distributed_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // cfg["ranks"]))
    distributed_init(f"file://{os.path.join(tmp, 'rendezvous')}",
                     cfg["ranks"], rank, backend="gloo", device="cuda",
                     timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        out = getattr(smoke, f"{cfg['mode']}_axis")(dev, cfg)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run_tree(root: str, mode: str, steps: int) -> list:
    """The mode on two ranks from ``root``; each rank's record."""
    import torch
    import torch.multiprocessing as mp
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    smoke = load(root)
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    for source in (tf.SOURCE, tf.BWD_SOURCE, fa.SOURCE, fa.BWD_SOURCE):
        cuda_build.build(source)
    cfg = dict(smoke.axes_config(torch.device("cuda", 0)), root=root,
               mode=mode, steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(tmp, cfg), nprocs=cfg["ranks"],
                           join=True, start_method="spawn")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(cfg["ranks"])]
    records = []
    for rank, out in enumerate(outs):
        rec = {"root": root, "mode": mode, "rank": rank,
               **{k: out[k] for k in KEYS if k in out}}
        rec["fp32"] = {k: v for k, v in out["fp32"].items()
                       if not isinstance(v, list)}
        records.append(rec)
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=("tp", "sp", "pp", "ep"),
                        required=True)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+")
    args = parser.parse_args()
    if args.one:
        for rec in run_tree(args.roots[0], args.mode, args.steps):
            print(json.dumps(rec), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lines = [card]
    for root in args.roots:
        # a process a tree: each imports its own port package
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--mode",
             args.mode, "--steps", str(args.steps), root],
            capture_output=True, text=True)
        if done.returncode:
            sys.stderr.write(done.stdout[-4000:] + done.stderr[-8000:])
            return done.returncode
        for line in done.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
