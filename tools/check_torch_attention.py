#!/usr/bin/env python3
"""The resident-KV attention kernels of the PyTorch port (K9
``ops.attention``, K10 ``ops.packed_attention``, ``csrc/attention.cu``) on
one NVIDIA GPU: what the compiler made of them, how long each takes beside
its plain version, ``scaled_dot_product_attention`` and its bound, and where
the row route stops paying, so that two checkouts can be held against each
other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:
``python3 tools/check_torch_attention.py [--root DIR] [--reps 20]
[--no-compiler-report] [--no-sweep] [--dtypes bfloat16,float32]``.  It

1. prints the card's name and power limit;
2. compiles the checkout's ``csrc/attention.cu`` once more with ``-Xptxas
   -v`` and prints each kernel instance's registers, spills and static
   shared memory, then counts per kernel, in the SASS of the library the
   port loads, the tensor-core instructions (``HMMA``, ``HGMMA``); it fails
   if a bf16 tile-route instance has no ``HMMA`` or any instance spills;
3. times K9, K10 (where n, m <= 64), the plain version and
   ``scaled_dot_product_attention`` at ``chip_smoke.py``'s phase-21 shapes
   (its 11, then the route edges) in each dtype three ways: ``card_ms``, the
   same inputs back to back behind a busy card (``chip_smoke.device_ms``:
   the inputs may sit in the 50 MB L2); ``cold_ms``, calls rotating over
   input sets of more than 100 MB together, so that no call finds its inputs
   in L2 (``chip_smoke.cold_ms``); ``call_ms``, CUDA events around one call
   (the host's time to make it included); with each shape's bound and route
   and, in bf16, the sums over the 11 shapes;
4. the crossover sweep that sets ``ROW_ROUTE_MAX_ROWS``: n = 1 ... 32 at
   (bh 8,192, m 64, d 64) and at the AR decode shapes (bh 16,384, m 65 and
   13, d 16), the row route forced against the tile route (bf16) or the
   CUDA-core tiles (float32), ``card_ms`` and ``cold_ms`` of each, and the
   largest n at which the row route is still the faster by ``cold_ms``.

``--root DIR`` takes the port package, its sources and its build from
another checkout (an earlier commit unpacked with ``git archive``, say):
steps 3 and 4 time that checkout's kernels (step 4 only where it has
``plan``), so that parent and change run in turns (parent, change, change,
parent), each in its own process, in one call on the card.  Exits non-zero
on any disagreement with the plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# step 4: (bh, m, d) of the sweep and its n
SWEEP = [(8192, 64, 64), (16384, 65, 16), (16384, 13, 16)]
SWEEP_ROWS = range(1, 33)
OTHER_ROUTE = {"bfloat16": "tile", "float32": "cuda"}


def tile_instances_without_hmma(report: dict) -> list:
    """The bf16 tile-route instances whose SASS has no HMMA."""
    return [name for name, c in report.items()
            if "tile_kernel" in name and "cuda_tile" not in name
            and c.get("HMMA", 0) == 0]


def time_shapes(at, dev, dtypes, reps) -> bool:
    """Step 3.  Returns False where a kernel disagreed with the plain
    version."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    ok = True
    base = set(cs.ATTENTION_SHAPES)
    for dname in dtypes:
        dtype = getattr(torch, dname)
        sums = {}
        for shape in cs.attention_shapes(at, dtype):
            bh, n, m, d = shape
            q, k, v = cs._qkv(dev, bh, n, m, d, dtype)
            scale = d ** -0.5
            fns = {"K9": at.attention}
            if max(n, m) <= at.PACK_MAX:
                fns["K10"] = at.packed_attention
            plan = getattr(at, "plan", None)
            p = plan(bh, n, m, d, dtype) if plan else None
            with torch.no_grad():
                ref = at.attention_reference(q, k, v, scale)
                row = {"shape": shape, "dtype": dname,
                       "route": p.route if p else None,
                       "bound_ms": max(cs.bound(4 * bh * n * m * d, cs.nbytes(
                           q, k, v, ref)).values())}
                for name, fn in list(fns.items()):
                    try:
                        out = fn(q, k, v)
                    except ValueError as err:      # past the parent's range
                        row[name] = f"refused: {err}"[:80]
                        del fns[name]
                        continue
                    rel = cs._rel_err(out, ref)
                    if not rel <= cs.KERNEL_TOL[dname]:
                        ok = False
                        row[f"{name}_rel_err"] = rel
                fns["plain"] = lambda q_, k_, v_: at.attention_reference(
                    q_, k_, v_, scale)
                fns["library"] = lambda q_, k_, v_: \
                    F.scaled_dot_product_attention(
                        q_[:, None], k_[:, None], v_[:, None], scale=scale)
                for name, fn in fns.items():
                    warm = lambda fn=fn: fn(q, k, v)
                    cold = cs.cold_fn(fn, dev, bh, n, m, d, dtype)
                    row[name] = {"card_ms": cs.device_ms(warm, reps=reps),
                                 "cold_ms": cs.device_ms(cold, reps=reps),
                                 "call_ms": cs.cuda_ms(warm, reps=reps)}
                    del cold
                    if shape in base and dname == "bfloat16":
                        for key, val in row[name].items():
                            sums.setdefault(name, {}).setdefault(key, 0.0)
                            sums[name][key] += val
                if shape in base and dname == "bfloat16":
                    sums.setdefault("bound_ms", 0.0)
                    sums["bound_ms"] += row["bound_ms"]
            print(json.dumps(row), flush=True)
            del q, k, v, ref
            torch.cuda.empty_cache()
        if sums:
            print(json.dumps({"sum_over_11_shapes": sums, "dtype": dname}),
                  flush=True)
    return ok


def sweep(at, dev, dtypes, reps) -> None:
    """Step 4."""
    import torch
    import chip_smoke as cs
    for dname in dtypes:
        dtype = getattr(torch, dname)
        other = OTHER_ROUTE[dname]
        for bh, m, d in SWEEP:
            rows, last_row_win = [], 0
            for n in SWEEP_ROWS:
                q, k, v = cs._qkv(dev, bh, n, m, d, dtype)
                times = {}
                with torch.no_grad():
                    for route in ("row", other):
                        p = at.plan(bh, n, m, d, dtype, route=route)
                        if p is None:
                            continue

                        def run(q_, k_, v_, p=p):
                            return at._launch("attn_forward", "sweep", q_,
                                              k_, v_, d ** -0.5, p)
                        fn = lambda: run(q, k, v)
                        cold = cs.cold_fn(run, dev, bh, n, m, d, dtype)
                        times[route] = {
                            "card_ms": cs.device_ms(fn, reps=reps, rounds=3),
                            "cold_ms": cs.device_ms(cold, reps=reps,
                                                    rounds=3)}
                        del cold
                if "row" in times and other in times and (
                        times["row"]["cold_ms"] < times[other]["cold_ms"]):
                    last_row_win = n
                rows.append({"n": n, **times})
                del q, k, v
            torch.cuda.empty_cache()
            print(json.dumps({"sweep": (bh, m, d), "dtype": dname,
                              "against": other,
                              "largest_n_row_wins_cold": last_row_win,
                              "rows": rows}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="the checkout whose port package to report "
                             "and time (default: this one)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-compiler-report", action="store_true")
    parser.add_argument("--no-sweep", action="store_true")
    parser.add_argument("--dtypes", default="bfloat16,float32")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from check_torch_flash import compiler_report, smi
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import importlib
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    at = importlib.import_module(
        "moleculediffusiontransformer_tpu_torch.ops.attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"package": os.path.dirname(os.path.dirname(
        os.path.abspath(at.__file__)))}), flush=True)
    ok = True
    if not args.no_compiler_report:
        report = compiler_report(cuda_build, at.SOURCE)
        spilled = [name for name, c in report.items() if c.get("spills")]
        no_hmma = tile_instances_without_hmma(report)
        print(json.dumps({"spilled": spilled, "tile_without_hmma": no_hmma}),
              flush=True)
        ok = not spilled and not no_hmma
    dev = torch.device("cuda", 0)
    dtypes = args.dtypes.split(",")
    ok = time_shapes(at, dev, dtypes, args.reps) and ok
    if not args.no_sweep and hasattr(at, "plan"):
        sweep(at, dev, dtypes, args.reps)
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
