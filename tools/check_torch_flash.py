#!/usr/bin/env python3
"""The streaming-attention kernels of the PyTorch port (K5 forward, K6 dq,
K7 dk/dv) on one NVIDIA GPU: what the compiler made of them, whether they
are right, and how long each takes, so that two checkouts can be held
against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:
``python3 tools/check_torch_flash.py [--root DIR] [--reps 20]
[--no-compiler-report] [--no-check]``.  It

1. compiles the checkout's ``csrc/flash_attention.cu`` and
   ``csrc/flash_attention_bwd.cu`` once more with ``-Xptxas -v`` and prints
   each kernel's registers, spills and shared memory and any note of ptxas
   about ``wgmma`` (``C7515``: the products were serialised), then counts
   per kernel, in the SASS of the libraries the port loads (``cuobjdump
   -sass``), the tensor-core instructions (``HGMMA``, ``HMMA``) and the
   waits for warpgroup products (``WARPGROUP.DEPBAR``: as many as ``HGMMA``
   means serialised);
2. holds the kernels against their plain versions with phase 15 of
   ``chip_smoke.py`` (``check_flash``: every head size, both types, the
   bitwise repeat, the split-head views against contiguous copies);
3. times ``flash_forward`` (K5) and ``flash_backward`` (K6, K7 and the
   ``di`` expression) in bfloat16 at bh 16, n = m = 4096, at every head size
   (and bh 64 at d 64) three ways: CUDA events around one call
   (``call_ms``: the host's time to make the call included), 20 calls
   enqueued back to back behind a busy card (``card_ms``), and each kernel's
   own device time from ``torch.profiler`` over 20 calls (``kernel_ms``);
   and the host's own time to make a call (``host_ms``: the wrapper's checks
   and launches, behind a busy card so that no call waits for it).

``--root DIR`` takes the port package, its sources and its build from
another checkout (an earlier commit unpacked with ``git archive``, say) and
skips step 2, which holds this checkout's phase 15: run it for both
checkouts in one call on the card, each in its own process, to compare
them.  It prints the card's name and power limit first and exits non-zero
on any disagreement.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (bh, n, m, d) of step 3
TIME_SHAPES = [(16, 4096, 4096, 16), (16, 4096, 4096, 32),
               (16, 4096, 4096, 64), (16, 4096, 4096, 128),
               (64, 4096, 4096, 64)]
# the kernels of step 3, by a part of their names in either checkout
KERNEL_NAMES = {"K5": "fwd_kernel", "K6": "dq_kernel", "K7": "dkv_kernel"}
SASS_OPS = ("HGMMA", "HMMA", "WARPGROUP.DEPBAR")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def compiler_report(cuda_build, source, match=None):
    """ptxas' resource lines for every kernel of ``source`` (whose name holds
    ``match``, when given) and the tensor-core and warpgroup-wait counts of
    the built library's SASS.  Returns {kernel: {"spills": [...],
    "notes": [...], **SASS counts}} of those kernels."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas",
               "-v", "-I", str(cuda_build.CSRC_DIR), "-o",
               os.path.join(tmp, "lib.so"), str(cuda_build.CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    name, report = None, {}
    for line in proc.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            pretty = subprocess.run(["c++filt", name], capture_output=True,
                                    text=True).stdout.strip() or name
            if match is not None and match not in name:
                name = None
            else:
                report[name] = {"spills": [], "notes": []}
        elif name is None:
            continue
        elif "registers" in line:
            print(json.dumps({"source": source, "kernel": pretty,
                              "ptxas": line.split(":", 1)[-1].strip()}),
                  flush=True)
        elif "spill" in line and "0 bytes spill stores" not in line:
            report[name]["spills"].append(line.strip())
            print(json.dumps({"kernel": pretty, "spills": line.strip()}),
                  flush=True)
        elif "warning" in line.lower() or "wgmma" in line:
            report[name]["notes"].append(line.strip())
            print(json.dumps({"kernel": pretty, "compiler": line.strip()}),
                  flush=True)
    path, _ = cuda_build.build(source)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\w+)", line)
        if found:
            function = found.group(1)
            if match is not None and match not in function:
                function = None
                continue
            counts[function] = {**dict.fromkeys(SASS_OPS, 0),
                                "example": None}
        elif function:
            for op in SASS_OPS:
                if re.search(rf"\b{re.escape(op)}\b", line):
                    counts[function][op] += 1
                    if op != "WARPGROUP.DEPBAR" and \
                            counts[function]["example"] is None:
                        counts[function]["example"] = " ".join(
                            line.split("*/")[1].split()) if "*/" in line \
                            else line.strip()
                    break
    for function, c in counts.items():
        print(json.dumps({"sass": function, "source": source, **c}),
              flush=True)
        report.setdefault(function, {"spills": [], "notes": []}).update(c)
    return report


def kernel_ms(fn, reps: int) -> dict:
    """Each flash kernel's own device milliseconds a call of ``fn()``, from
    ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = next((float(getattr(evt, attr)) for attr in (
            "self_device_time_total", "self_cuda_time_total")
            if hasattr(evt, attr)), 0.0)
        for label, part in KERNEL_NAMES.items():
            # "dq_kernel" is not a part of "dkv_kernel" nor the other way
            if re.search(rf"\b{part}\b", evt.key):
                found[label] = found.get(label, 0.0) + us / 1e3 / reps
    return found


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call of ``fn()`` takes to return while the card
    is busy with earlier work."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    blocker = torch.zeros(4096, 4096, device="cuda")
    torch.matmul(blocker, torch.matmul(blocker, blocker))
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def time_kernels(fa, dev, reps):
    """Step 3."""
    import torch
    from chip_smoke import cuda_ms, device_ms
    for bh, n, m, d in TIME_SHAPES:
        gen = torch.Generator().manual_seed(bh + n + m + d)
        q, k, v, do = (torch.randn(shape, generator=gen).to(
            dev, torch.bfloat16) for shape in ((bh, n, d), (bh, m, d),
                                               (bh, m, d), (bh, n, d)))
        scale = d ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
            calls = {"fwd": lambda: fa.flash_forward(q, k, v, scale),
                     "bwd": lambda: fa.flash_backward(q, k, v, o, lse, do,
                                                      scale)}
            row = {"time": (bh, n, m, d), "dtype": "bfloat16",
                   "call_ms": {key: cuda_ms(fn, reps=reps)
                               for key, fn in calls.items()},
                   "card_ms": {key: device_ms(fn, reps=reps)
                               for key, fn in calls.items()},
                   "host_ms": {key: host_ms(fn, reps)
                               for key, fn in calls.items()},
                   "kernel_ms": {**kernel_ms(calls["fwd"], reps),
                                 **kernel_ms(calls["bwd"], reps)}}
        work = bh * n * m * d
        row["kernel_tflops"] = {
            label: f * work / row["kernel_ms"][label] / 1e9
            for label, f in (("K5", 4), ("K6", 6), ("K7", 8))
            if row["kernel_ms"].get(label)}
        print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="the checkout whose port package to report "
                             "and time (default: this one)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-compiler-report", action="store_true")
    parser.add_argument("--no-check", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"package": os.path.dirname(os.path.dirname(
        os.path.abspath(fa.__file__)))}), flush=True)
    if not args.no_compiler_report:
        for source in (fa.SOURCE, fa.BWD_SOURCE):
            compiler_report(cuda_build, source)
    dev = torch.device("cuda", 0)
    if args.root is None and not args.no_check:
        chip_smoke.check_flash(dev)
    time_kernels(fa, dev, args.reps)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
