#!/usr/bin/env python3
"""Where a train step of the PyTorch port's 91M inverse QM9 model spends its
time on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_torch_train_step.py [--eval] [--resnet-fusion]
        [--root DIR] [--out FILE]

It trains the flagship preset (``chip_smoke.FLAGSHIP``) in bfloat16 with
seeded random weights at batch 1024 as 2 x 512, and

1. times steps with the Transformer1d stacks through the hand-written
   kernels and through the module composition (``disable_fusion``: cuBLAS
   and autograd), in turns kernels, composition, composition, kernels;
2. traces one step through the kernels with ``torch.profiler`` and reports
   device time by kernel name and the number of kernel launches (the
   traced step's wall time carries the profiler's own cost: compare device
   time with the untraced steps' time).

With ``--eval`` it serves instead: one denoise evaluation of the same model
at batch 512 under CFG (1,024 rows, the 64-step sampler's call), timed
untraced over 5 calls and then traced once as in 2; and the sampling rate
of one 64-step request of 512 (mol/s, host clock).  ``--root DIR`` takes
the port package from another checkout (a parent unpacked with ``git
archive``), so that two trees can be profiled in one call on one card, each
in its own process.  ``--resnet-fusion`` turns the resnet-run kernel (K8,
``ops.resnet_fusion.enable_resnet_fusion``, off by default) on for the
whole run, in whichever tree is profiled.

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
    parser.add_argument("--eval", action="store_true",
                        help="profile a serving eval instead of a step")
    parser.add_argument("--root", default=None,
                        help="the checkout whose port package to profile")
    parser.add_argument("--resnet-fusion", action="store_true",
                        help="run the UNet's resnet runs through K8")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (COND_SCALE, FLAGSHIP, MICRO_BATCHES, NUM_STEPS,
                            REQUESTS, TRAIN_BATCH)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    from moleculediffusiontransformer_tpu_torch.train import trainer

    rf.enable_resnet_fusion(args.resnet_fusion)

    dev = torch.device("cuda", 0)
    model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    gen = torch.Generator(device=dev).manual_seed(3)
    package = os.path.dirname(os.path.dirname(os.path.abspath(tf.__file__)))
    if args.eval:
        return report(args, serving_profile(model.eval(), gen, REQUESTS[-1],
                                            COND_SCALE, NUM_STEPS), package)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, MICRO_BATCHES)
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
    return report(args, {
        "batch": TRAIN_BATCH, "micro_batches": MICRO_BATCHES,
        "samples_per_s": samples_per_s,
        "profiled_step": traced(lambda: step(state, cond, target, gen))},
        package)


def traced(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (the profiler's
    cost included), device ms, kernel launches, the top kernels by device
    time and, of those, the stack GEMM's on the tensor cores
    (``gemm_tc_kernel``) and on the CUDA cores (``gemm_kernel``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # only the device's own events: a host op's entry repeats the device
    # time of the kernels it launched
    kernels, launches = [], 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if evt.device_type == DeviceType.CUDA and device_us(evt) > 0:
            kernels.append({"name": evt.key[:120], "calls": evt.count,
                            "device_ms": device_us(evt) / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    gemm = {label: sum(k["device_ms"] for k in kernels if part in k["name"])
            for label, part in (("gemm_tc_ms", "gemm_tc_kernel"),
                                ("gemm_cuda_cores_ms", "gemm_kernel"))}
    return {"traced_wall_ms": wall_ms,
            "device_ms": sum(k["device_ms"] for k in kernels),
            "kernel_launches": launches, **gemm, "top": kernels[:TOP]}


def serving_profile(model, gen, batch, cond_scale, num_steps) -> dict:
    """``--eval``: one denoise evaluation at ``batch`` requests under CFG,
    untraced (host clock over 5 calls) and traced, and one request."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    dev = next(model.parameters()).device
    props = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    x = torch.randn(batch, model.max_length, model.pred_dim, generator=gen,
                    device=dev)
    sigmas = torch.full((batch,), 1.0, device=dev)
    with torch.no_grad():
        emb = model.embed_conditioning(props)

        def evaluate():
            model.denoise(x, sigmas, emb, cond_scale)

        evaluate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            evaluate()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / 5
        profiled = traced(evaluate)
    sample(model, props, gen, num_steps=num_steps, cond_scale=cond_scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(model, props, gen, num_steps=num_steps, cond_scale=cond_scale)
    torch.cuda.synchronize()
    return {"batch": batch, "cond_scale": cond_scale,
            "eval_ms_untraced": eval_ms,
            "mol_per_s": batch / (time.perf_counter() - t0),
            "profiled_eval": profiled}


def report(args, result: dict, package: str) -> int:
    import torch
    text = json.dumps({"device": torch.cuda.get_device_name(0),
                       "package": package,
                       "resnet_fusion": args.resnet_fusion, **result},
                      indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
