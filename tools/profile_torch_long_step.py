#!/usr/bin/env python3
"""Where a train step and a denoise eval of the PyTorch port's long-sequence
``Model1d`` spend their time on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_torch_long_step.py [--batch 2] [--out FILE]

It builds the long-sequence model (``chip_smoke.LONG``) in bfloat16 with
seeded random weights and traces, with ``torch.profiler``, one train step
and one denoise eval in three settings: 2**17 samples with the streaming
attention kernels (attention at 4,096 tokens), the same with ``MDT_FLASH=0``
(the one-shot product), and 2**15 samples (attention at 1,024 tokens,
streamed when ``LONG_SEQ_THRESHOLD`` is 1,024 or less).  For each it reports the untraced time, the device time, the
number of kernel launches, and the device time and kernel count split into
the streaming kernels (forward, dq, dk/dv), copies and casts (PyTorch's copy
kernels: layout copies and dtype conversions), the rest of attention (matrix
products and softmax of the one-shot path), convolutions, and everything
else, with the longest kernels by name.

Prints one JSON object (also written to ``--out`` when given), beside the
card's name and power limit.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 12       # kernel names listed
# kernel-name fragments -> group, first match wins
GROUPS = (("fwd_kernel", "flash_fwd"), ("dq_kernel", "flash_dq"),
          ("dkv_kernel", "flash_dkv"), ("copy", "copies_and_casts"),
          ("softmax", "attention_softmax"),
          ("conv", "convs"), ("cudnn", "convs"), ("wgrad", "convs"),
          ("dgrad", "convs"), ("nchwToNhwc", "convs"),
          ("nhwcToNchw", "convs"), ("gemm", "matrix_products"),
          ("cutlass", "matrix_products"), ("cublas", "matrix_products"))


def group_of(name: str) -> str:
    low = name.lower()
    for fragment, group in GROUPS:
        if fragment.lower() in low:
            return group
    return "other"


def trace(fn):
    """(traced wall ms, device ms, launches, ms by group, top kernels)."""
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

    kernels, launches, groups, calls = [], 0, {}, {}
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if evt.device_type == DeviceType.CUDA and device_us(evt) > 0:
            ms = device_us(evt) / 1e3
            kernels.append({"name": evt.key[:100], "calls": evt.count,
                            "device_ms": ms})
            g = group_of(evt.key)
            groups[g] = groups.get(g, 0.0) + ms
            calls[g] = calls.get(g, 0) + evt.count
    kernels.sort(key=lambda k: -k["device_ms"])
    return {"traced_wall_ms": wall_ms,
            "device_ms": sum(k["device_ms"] for k in kernels),
            "kernel_launches": launches, "device_ms_by_group": groups,
            "kernels_by_group": calls,
            "top": kernels[:TOP]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_long_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (FLASH_SAMPLES, LONG, LONG_SAMPLES, flash_switch,
                            long_model)
    from moleculediffusiontransformer_tpu_torch.train import trainer

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    model = long_model(dev, torch.bfloat16).train()
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_model1d_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(3)

    def untraced_ms(fn, reps=3) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    cells = []
    for samples, flash in ((FLASH_SAMPLES, True), (FLASH_SAMPLES, False),
                           (LONG_SAMPLES, True)):
        x = torch.rand(args.batch, samples, LONG["in_channels"],
                       generator=gen, device=dev) * 2 - 1
        sigmas = torch.rand(args.batch, generator=gen, device=dev)

        def train():
            step(state, x, gen)

        def denoise():
            with torch.no_grad():
                model.denoise(x, sigmas)

        with flash_switch(flash):
            cell = {"samples": samples, "batch": args.batch,
                    "MDT_FLASH": flash, "attention_tokens": samples // 32}
            for name, fn in (("train_step", train), ("denoise_eval",
                                                     denoise)):
                ms = untraced_ms(fn)
                torch.cuda.reset_peak_memory_stats()
                cell[name] = {"untraced_ms": ms, **trace(fn),
                              "max_memory_allocated":
                                  torch.cuda.max_memory_allocated()}
        cells.append(cell)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "cells": cells}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
