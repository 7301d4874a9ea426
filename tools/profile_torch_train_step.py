#!/usr/bin/env python3
"""Where a train step of the PyTorch port's 91M inverse QM9 model spends its
time on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_torch_train_step.py [--out FILE]

It trains the flagship preset (``chip_smoke.FLAGSHIP``) in bfloat16 with
seeded random weights at batch 1024 as 2 x 512, and

1. times steps with the Transformer1d stacks through the hand-written
   kernels and through the module composition (``disable_fusion``: cuBLAS
   and autograd), in turns kernels, composition, composition, kernels;
2. traces one step through the kernels with ``torch.profiler`` and reports
   device time by kernel name and the number of kernel launches (the
   traced step's wall time carries the profiler's own cost: compare device
   time with the untraced steps' time).

Prints one JSON object (also written to ``--out`` when given).  Imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3      # timed steps per turn
TOP = 40       # kernel names listed


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import FLAGSHIP, MICRO_BATCHES, TRAIN_BATCH
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.train import trainer

    dev = torch.device("cuda", 0)
    model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, MICRO_BATCHES)
    gen = torch.Generator(device=dev).manual_seed(3)
    cond = torch.rand(TRAIN_BATCH, 12, generator=gen, device=dev) * 2 - 1
    tokens = torch.randint(0, FLAGSHIP["pred_dim"],
                           (TRAIN_BATCH, FLAGSHIP["max_length"]),
                           generator=gen, device=dev)
    target = F.one_hot(tokens, FLAGSHIP["pred_dim"]).float()

    def timed(composition: bool) -> float:
        for m in stacks:
            m.disable_fusion = composition
        step(state, cond, target, gen)                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, cond, target, gen)
        torch.cuda.synchronize()
        return TRAIN_BATCH * STEPS / (time.perf_counter() - t0)

    turns = [("kernels", False), ("composition", True),
             ("composition", True), ("kernels", False)]
    samples_per_s = [(name, timed(comp)) for name, comp in turns]

    for m in stacks:
        m.disable_fusion = False
    step(state, cond, target, gen)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, cond, target, gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # only the device's own events: a host op's entry repeats the device
    # time of the kernels it launched
    from torch.autograd import DeviceType
    kernels, launches = [], 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if evt.device_type == DeviceType.CUDA and device_us(evt) > 0:
            kernels.append({"name": evt.key[:120], "calls": evt.count,
                            "device_ms": device_us(evt) / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    device_ms = sum(k["device_ms"] for k in kernels)
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": TRAIN_BATCH, "micro_batches": MICRO_BATCHES,
        "samples_per_s": samples_per_s,
        "profiled_step": {"traced_wall_ms": wall_ms, "device_ms": device_ms,
                          "kernel_launches": launches,
                          "top": kernels[:TOP]},
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
