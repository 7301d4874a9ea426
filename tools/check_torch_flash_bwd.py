#!/usr/bin/env python3
"""The flash-attention backward kernels (K6 dq, K7 dk/dv) of the PyTorch port
on one NVIDIA GPU: what the compiler made of them, whether they are right,
and how fast they are.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:
``python3 tools/check_torch_flash_bwd.py [--reps 20]``.  It

1. compiles ``csrc/flash_attention_bwd.cu`` once more with ``-Xptxas -v``
   and prints each kernel's registers, spills and shared memory, then counts
   the tensor-core instructions (``HMMA`` / ``HGMMA``) per kernel in the SASS
   of the library the port loads (``cuobjdump -sass``);
2. holds ``flash_backward`` against ``flash_attention_backward_reference`` in
   bfloat16 and float32 at every head size and at square, rectangular and
   smallest shapes, with a bitwise-repeat check;
3. times both kernels (CUDA events, median) in bfloat16 at bh 16 and 64,
   n = m = 4096, d 64 and at bh 16, d 128, beside
   ``scaled_dot_product_attention``'s backward, and prints TFLOP/s.

It prints the card's name and power limit first and exits non-zero on any
disagreement.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (bh, n, m, d)
CHECK_SHAPES = [(2, 128, 128, 16), (2, 128, 128, 32), (2, 128, 128, 64),
                (2, 128, 128, 128), (3, 256, 384, 16), (3, 256, 384, 32),
                (3, 384, 256, 64), (3, 256, 384, 128), (16, 4096, 4096, 64),
                (16, 4096, 2048, 64), (16, 2048, 4096, 64),
                (4, 2048, 2048, 128)]
TIME_SHAPES = [(16, 4096, 4096, 64), (64, 4096, 4096, 64),
               (16, 4096, 4096, 128), (16, 1024, 1024, 64)]


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compiler_report(cuda_build, source):
    """ptxas' resource lines for every kernel of ``source`` and the
    tensor-core instruction counts of the built library's SASS."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas",
               "-v", "-I", str(cuda_build.CSRC_DIR), "-o",
               os.path.join(tmp, "lib.so"), str(cuda_build.CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    name = None
    for line in proc.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = subprocess.run(["c++filt", found.group(1)],
                                  capture_output=True, text=True
                                  ).stdout.strip() or found.group(1)
        elif "registers" in line and name:
            print(json.dumps({"kernel": name, "ptxas": line.split(":", 1)[-1]
                              .strip()}), flush=True)
        elif "spill" in line and name and "0 bytes spill stores" not in line:
            print(json.dumps({"kernel": name, "spills": line.strip()}),
                  flush=True)
        elif "warning" in line.lower() or "wgmma" in line:
            print(json.dumps({"kernel": name, "compiler": line.strip()}),
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
            counts[function] = {"HMMA": 0, "HGMMA": 0, "example": None}
        elif function:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[function][op] += 1
                    if counts[function]["example"] is None:
                        counts[function]["example"] = " ".join(
                            line.split("*/")[1].split()) if "*/" in line \
                            else line.strip()
                    break
    for function, c in counts.items():
        print(json.dumps({"sass": function, **c}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-compiler-report", action="store_true")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if not args.no_compiler_report:
        compiler_report(cuda_build, fa.BWD_SOURCE)
    dev = torch.device("cuda", 0)
    failed = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for bh, n, m, d in CHECK_SHAPES:
            gen = torch.Generator().manual_seed(bh + n + m + d)
            q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype)
                           for shape in ((bh, n, d), (bh, m, d), (bh, m, d),
                                         (bh, n, d)))
            scale = d ** -0.5
            with torch.no_grad():
                o, lse = fa.flash_attention_reference(q, k, v, scale)
                got = fa.flash_backward(q, k, v, o, lse, do, scale)
                again = fa.flash_backward(q, k, v, o, lse, do, scale)
                torch.cuda.synchronize()
                want = fa.flash_attention_backward_reference(
                    q, k, v, o, lse, do, scale)
            rel = {name: ((a.float() - b.float()).abs().max()
                          / b.float().abs().max()).item()
                   for name, a, b in zip(("dq", "dk", "dv"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = same and all(e <= TOL[dname] for e in rel.values())
            print(json.dumps(dict(check=(bh, n, m, d), dtype=dname, rel=rel,
                                  bitwise_repeat=same, ok=ok)), flush=True)
            if not ok:
                failed.append((dname, bh, n, m, d))
    for bh, n, m, d in TIME_SHAPES:
        gen = torch.Generator().manual_seed(1)
        q, k, v, do = (torch.randn(shape, generator=gen).to(
            dev, torch.bfloat16) for shape in ((bh, n, d), (bh, m, d),
                                               (bh, m, d), (bh, n, d)))
        scale = d ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_attention_reference(q, k, v, scale)
            di = (o.float() * do.float()).sum(dim=-1)
            lib = fa._bwd_library()
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            ins = [t.data_ptr() for t in (q, k, v, do, lse, di)]
            tail = fa._tail(q, k, scale)

            def launch(fn, *outs):
                code = fn(*ins, *[t.data_ptr() for t in outs], *tail)
                if code:
                    raise RuntimeError(f"launch failed: {code}")

            dq_ms = cuda_ms(lambda: launch(lib.fa_backward_dq, dq), args.reps)
            dkv_ms = cuda_ms(lambda: launch(lib.fa_backward_dkv, dk, dv),
                             args.reps)
            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale), args.reps)
        leaves = [t[None].clone().requires_grad_() for t in (q, k, v)]
        both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, scale=scale), leaves,
            do[None]), args.reps)
        work = bh * n * m * d
        print(json.dumps(dict(
            time=(bh, n, m, d), dtype="bfloat16", dq_ms=dq_ms, dkv_ms=dkv_ms,
            dq_tflops=6 * work / dq_ms / 1e9,
            dkv_tflops=8 * work / dkv_ms / 1e9, sum_ms=dq_ms + dkv_ms,
            library_bwd_ms=both - fwd,
            library_bwd_tflops=10 * work / (both - fwd) / 1e9)), flush=True)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
