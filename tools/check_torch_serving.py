#!/usr/bin/env python3
"""One served request of the PyTorch port's 91M inverse QM9 sampler on one
CUDA card: the artifact's graph and eager tiers beside the live path.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/check_torch_serving.py [--root DIR] [--switches on|off]
        [--batch 512] [--steps 64] [--out FILE]

It builds the flagship sampler (``recipes.build_model("inverse_diffusion",
10, "notebook")``) in bfloat16 with seeded random weights, exports it with
``design.export.export_sampler`` (cond scale 2.0), loads it in
``design.ArtifactServer`` on the card, and

1. times one request three times each, live (``models.qm_diffusion.sample``),
   on the graph tier and on the eager tier (host clock around a
   synchronised request);
2. traces one request of the graph tier and one live with ``torch.profiler``
   and reports the device time (the sum of the device's kernel and copy
   intervals), the same over the request's evaluations, and the largest
   kernels by device time.

``--switches on`` turns K8 (``enable_resnet_fusion``) and the shared-KV
null half (``enable_sharedkv``) on for the whole run.  ``--root DIR`` takes
the port package from another checkout (a tree unpacked with ``git
archive``), so that two trees can be compared in one call on one card, each
in its own process.  Prints one JSON object (also written to ``--out`` when
given), with the card's name and power limit.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--switches", choices=("on", "off"), default="on")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    from moleculediffusiontransformer_tpu_torch.design.serve import \
        ArtifactServer
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    from moleculediffusiontransformer_tpu_torch.ops import (
        cuda_build, resnet_fusion as rf, transformer_fusion as tf)
    from moleculediffusiontransformer_tpu_torch.train import recipes
    if not torch.cuda.is_available():
        print("check_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in (tf.SOURCE, rf.SOURCE):
        cuda_build.build(source)
    dev = torch.device("cuda", 0)
    on = args.switches == "on"
    rf.enable_resnet_fusion(on)
    tf.enable_sharedkv(on)
    model = recipes.build_model("inverse_diffusion", 10, "notebook",
                                dtype=torch.bfloat16, device=dev,
                                seed=0).eval()
    tmp = tempfile.mkdtemp(dir=os.path.join(
        root, "moleculediffusiontransformer_tpu_torch", "_build"))
    path = os.path.join(tmp, "sampler.pt2")
    t0 = time.perf_counter()
    dx.save_artifact(dx.export_sampler(model, batch=args.batch,
                                       num_steps=args.steps, cond_scale=2.0,
                                       device=dev), path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = ArtifactServer(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    props = torch.rand(args.batch, 12, generator=gen, device=dev) * 2 - 1
    paths = {
        "live": lambda: sample(model, props, num_steps=args.steps,
                               cond_scale=2.0, generator=gen),
        "graph": lambda: server.call(props, seed=1),
        "eager": lambda: server.call(props, seed=1, eager=True)}

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def device(fn, top: int = 8) -> dict:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name, total = {}, 0.0
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                us = evt.time_range.end - evt.time_range.start
                total += us
                by_name[evt.name[:80]] = by_name.get(evt.name[:80], 0.0) + us
        evals = 2 * (args.steps - 1)
        return {"device_ms": total / 1e3, "device_ms_an_eval":
                total / 1e3 / evals,
                "top_ms": [[k, v / 1e3] for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:top]]}

    with torch.no_grad():
        for fn in paths.values():
            fn()
        out = {
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(),
            "root": root, "switches": args.switches, "batch": args.batch,
            "steps": args.steps, "tier": server.tier,
            "exec_error": server.exec_error, "export_s": export_s,
            "load_s": load_s, "startup": server.startup,
            "programs": sorted(getattr(server, "programs", {})),
            "wall_s": {k: [wall(fn) for _ in range(3)]
                       for k, fn in paths.items()},
            "graph": device(paths["graph"]), "live": device(paths["live"])}
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
