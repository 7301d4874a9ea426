#!/usr/bin/env python3
"""The tensor-core GEMM of the PyTorch port's Transformer1d stack kernels
and resnet-run kernel (``csrc/gemm_tc.cuh``: every product of K1-K4 and K8,
bf16 in one pass, float32 in three TF32 passes) on one NVIDIA GPU: what the compiler made of it, how long it takes
at the 91M model's product shapes, and K1-K4 and K8 of this checkout
against another one's.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:
``python3 tools/check_torch_gemm.py [--root DIR] [--reps 20]
[--no-compiler-report] [--no-shapes] [--batches 1024,512] [--trace]
[--tiles] [--dtype bfloat16|float32|both] [--plain]``.
``--dtype`` picks the operands of steps 2 and 5 (bf16 by default; float32
takes the three-TF32-pass route, TF32 off in ``torch.matmul``).
It

1. compiles ``csrc/transformer1d_fwd.cu``, ``csrc/transformer1d_bwd.cu``
   and ``csrc/resnet_fwd.cu`` once more with ``-Xptxas -v`` and prints the
   registers, spills and shared memory of each ``gemm_tc_kernel`` (bf16)
   and ``gemm_tf32x3_kernel`` (float32, three TF32 passes) instance
   and any ptxas note about ``wgmma`` (``C7515``: the products were
   serialised), and counts in the SASS of the built libraries
   (``cuobjdump -sass``) the ``HGMMA`` against the ``WARPGROUP.DEPBAR`` of
   each instance (as many waits as products means serialised); it fails at the end if an instance spills, has a
   ``C7515`` note or is serialised;
2. times ``t1d_gemm_tc`` (``ops.transformer_fusion.gemm_tc``) at every
   product shape of the 91M model's four stacks at batch 1,024 and 512
   (forward products NT with their epilogues, the backward's NN and TN of
   K2, K3 and K4, TN split over rows as the backward splits it), on the
   card's time with the calls
   enqueued back to back (``chip_smoke.device_ms``), beside ``torch.matmul``
   of the same operands (a yardstick only: the port never calls it; float32
   with TF32 off), with each shape's TFLOP/s and bound (bf16: operations at
   989 TFLOP/s; float32: three TF32 passes at 495 TFLOP/s, with the
   CUDA-core bound at 67 TFLOP/s beside it);
3. with ``--trace``, builds the GEMM once more with its clock64 stamps
   (``-DGTC_TRACE``) and prints where block (0, 0, 0) spends its cycles at
   a few shapes: before the first k-step, each k-step's wait, barrier, load
   issue and products, the epilogue;
4. with ``--tiles``, builds the stack libraries twice more, every unsplit
   product on 64 x 64 blocks (``-DGTC_TILE=1``) and on 128 x 128 blocks
   (``-DGTC_TILE=2``), and in turns 64, 128, 128, 64, each in its own
   process, times the products of step 2 and K1 and K2 of step 5 on them:
   the data from which ``tile_for`` picks a block shape;
5. with ``--root DIR`` (a parent checkout, unpacked with ``git archive``),
   times K1 (phase 3's four stacks at batch 128), its stash and
   uniform-context variants and K2, K3, K4 (batch 512) and K8 (batch 1,024)
   of DIR's port package and of this checkout's, each in its own process,
   in turns parent, change, change, parent, with CUDA events around one call
   (``ms``, as every recorded time of these kernels), the card's time
   (``card_ms``) and the host's time to make the call behind a busy card
   (``host_ms``: the wrapper's checks and launches), and the host's time to
   build K1's weight list (``K1 weight list``, summed over the four stacks
   like the rest; each kernel's figures of each stack under ``by_stack``);
   for K8 also the products one call of each run sent to
   the tensor cores (``K8 products``, summed over the runs; absent for a
   tree whose K8 counts none).  With ``--plain`` the plain versions of K1,
   its stash, K2, K3 and K4 too (``K2 plain`` and so on), timed the same
   way in each turn.

It prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

BATCHES = (1024, 512)
HEADS, HEAD_DIM, MULT = 8, 64, 2


def product_shapes(batch):
    """(what, layout, rows, n, k, epilogue, output type) of every product
    of the 91M model's stack kernels at ``batch`` (rows: M of nt and nn, the
    summed K of tn); the stacks' L and C from ``chip_smoke.STACKS``."""
    from chip_smoke import CONTEXT, STACKS
    inner = HEADS * HEAD_DIM
    shapes = {}
    for _, length, c, _, cross in STACKS:
        r, h = batch * length, MULT * c
        kv_rows, ctx_c = batch * CONTEXT[0], CONTEXT[1]
        tag = f"L{length} C{c}"
        products = [
            ("conv", "nt", r, c, c, "bias", "bf16"),
            ("to_q", "nt", r, inner, c, "none", "bf16"),
            ("to_kv self", "nt", r, 2 * inner, c, "none", "bf16"),
            ("to_out", "nt", r, c, inner, "bias_res", "bf16"),
            ("ff0", "nt", r, h, c, "bias_gelu", "bf16"),
            ("ff2", "nt", r, c, h, "bias_res", "bf16"),
            ("ff0 recompute", "nt", r, h, c, "bias", "float32"),
            ("dh", "nn", r, h, c, "mul", "float32"),
            ("dy += dh W0", "nn", r, c, h, "res", "float32"),
            ("dout", "nn", r, inner, c, "none", "bf16"),
            ("dq_in", "nn", r, c, inner, "none", "float32"),
            ("dkv_in self", "nn", r, c, 2 * inner, "none", "float32"),
            ("dW2", "tn", r, c, h, "none", "float32"),
            ("dW0", "tn", r, h, c, "none", "float32"),
            ("dW_out", "tn", r, c, inner, "none", "float32"),
            ("dW_q", "tn", r, inner, c, "none", "float32"),
            ("dW_kv self", "tn", r, 2 * inner, c, "none", "float32"),
            # K3's and K4's weight grads have one shape
            ("K3 dW_out, K4 dW_in", "tn", r, c, c, "none", "float32"),
            ("K3 dy", "nn", r, c, c, "none", "bf16"),
            ("K4 dgn", "nn", r, c, c, "none", "float32")]
        if cross:
            products += [
                ("to_kv cross", "nt", kv_rows, 2 * inner, ctx_c, "none",
                 "bf16"),
                ("dkv_in cross", "nn", kv_rows, ctx_c, 2 * inner, "none",
                 "float32"),
                ("dW_kv cross", "tn", kv_rows, 2 * inner, ctx_c, "none",
                 "float32")]
        for what, layout, rows, n, k, epi, out in products:
            key = (layout, rows, n, k, epi, out)
            shapes.setdefault(key, f"{tag} {what}")
    return [(what, *key) for key, what in shapes.items()]


def time_products(tf, dev, reps, batches=BATCHES, dtype="bfloat16", **tags):
    """Step 2 in ``dtype``; ``tags`` are added to each printed line."""
    import torch
    from chip_smoke import F32_PEAK_FLOPS, bound, device_ms
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    for batch in batches:
        for what, layout, rows, n, k, epi, out in product_shapes(batch):
            gen = torch.Generator().manual_seed(rows + n + k)
            shapes = {"nt": ((rows, k), (n, k)), "nn": ((rows, k), (k, n)),
                      "tn": ((rows, n), (rows, k))}[layout]
            x, y = (torch.randn(s, generator=gen).to(dev, dt)
                    for s in shapes)
            m_out, n_out = (n, k) if layout == "tn" else (rows, n)
            odt = torch.float32 if out == "float32" or f32 else torch.bfloat16
            extra = {}
            if epi in ("bias", "bias_res", "bias_gelu"):
                extra["bias"] = torch.randn(n_out, device=dev)
            if epi in ("bias_res", "res"):
                extra["res"] = torch.randn(m_out, n_out, device=dev).to(odt)
            if epi == "mul":
                extra["mul"] = torch.randn(m_out, n_out, device=dev)
            kw = dict(epi=epi, out_dtype=odt, want_out_t=epi == "mul",
                      split=layout == "tn", **extra)
            info = {}
            with torch.no_grad():
                tf.gemm_tc(x, y, layout, info=info, **kw)
                card = device_ms(lambda: tf.gemm_tc(x, y, layout, **kw),
                                 reps=reps)
                a, b = {"nt": (x, y.t()), "nn": (x, y),
                        "tn": (x.t(), y)}[layout]
                library = device_ms(lambda: torch.matmul(a, b), reps=reps)
            flops = 2.0 * m_out * n_out * (rows if layout == "tn" else k)
            moved = (x.numel() + y.numel()) * x.element_size() + (
                m_out * n_out * (4 if odt == torch.float32 else 2))
            limit = bound(flops, moved, f32)
            extra = ({"cuda_core_bound_ms": max(
                flops / F32_PEAK_FLOPS * 1e3, limit["bytes_ms"])} if f32
                else {})
            print(json.dumps({
                **tags, "product": what, "dtype": dtype, "batch": batch,
                "layout": layout,
                "m": m_out, "n": n_out, "k": rows if layout == "tn" else k,
                "epi": epi, "out": "float32" if f32 else out,
                "route": info["route"],
                "splits": info["splits"], "card_ms": card,
                "library_ms": library, "tflops": flops / card / 1e9,
                "bound_ms": max(limit.values()),
                "bound_by": max(limit, key=limit.get)[:-3], **extra}),
                flush=True)


# (layout, rows, n, k, epilogue) of the traced products: a 64 x 64-block
# product of K1 at batch 128, a 128 x 128-block one at batch 1,024, an
# epilogue that reads, and a weight grad split over rows
TRACE_SHAPES = [("nt", 1024, 512, 512, "none"), ("nt", 8192, 512, 256, "none"),
                ("nt", 1024, 512, 512, "bias_res"), ("tn", 4096, 256, 512, "none")]


def trace_products(cuda_build, tf, dev):
    """``--trace``: the GEMM built apart with -DGTC_TRACE (gemm_tc.cuh's
    clock64 stamps of block (0, 0, 0)) and run at TRACE_SHAPES; prints each
    stamp and, from them, the block's cycles before its first k-step, each
    k-step's wait, barrier, load issue and products (their medians), and
    its epilogue.  The traced library is loaded beside the port's and used
    for these calls only."""
    import ctypes
    import statistics
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "libgemm_trace.so")
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-DGTC_TRACE", "-I",
                        str(cuda_build.CSRC_DIR), "-o", path,
                        str(cuda_build.CSRC_DIR / tf.BWD_SOURCE)],
                       check=True, capture_output=True)
        lib = tf.bind_bwd_library(ctypes.CDLL(path))
    lib.t1d_gemm_trace.argtypes = [ctypes.c_void_p]
    stamps = (ctypes.c_longlong * 64)()
    saved, tf._BWD_LIB = tf._BWD_LIB, lib
    try:
        for layout, rows, n, k, epi in TRACE_SHAPES:
            gen = torch.Generator().manual_seed(rows + n + k)
            shapes = {"nt": ((rows, k), (n, k)), "tn": ((rows, n), (rows, k))}[layout]
            x, y = (torch.randn(s, generator=gen).to(dev, torch.bfloat16) for s in shapes)
            kw = dict(out_dtype=torch.float32 if layout == "tn" else torch.bfloat16,
                      split=layout == "tn")
            if epi == "bias_res":
                kw.update(epi=epi, bias=torch.randn(n, device=dev),
                          res=torch.randn(rows, n, device=dev).to(torch.bfloat16))
            info = {}
            for _ in range(2):           # the second call's stamps are kept
                tf.gemm_tc(x, y, layout, info=info, **kw)
            torch.cuda.synchronize()
            if lib.t1d_gemm_trace(ctypes.cast(stamps, ctypes.c_void_p)):
                raise RuntimeError("reading the trace failed")
            got = [stamps[i] for i in range(min(stamps[63], 63))]
            steps = [got[1 + 4 * i:5 + 4 * i] for i in range((len(got) - 2) // 4)]
            prev = [got[0]] + [st[3] for st in steps[:-1]]
            parts = {name: statistics.median(st[j] - (st[j - 1] if j else p)
                                             for st, p in zip(steps, prev))
                     for j, name in enumerate(("wait", "barrier", "load_issue",
                                               "products"))}
            print(json.dumps({"trace": [layout, rows, n, k, epi], "route": info["route"],
                              "splits": info["splits"], "cycles": got,
                              "before_first_step": got[0], "k_steps": len(steps),
                              "median_step_cycles": parts,
                              "epilogue": got[-1] - got[-2]}), flush=True)
    finally:
        tf._BWD_LIB = saved


def time_stacks(reps, only=None, dtype="bfloat16", plain=False):
    """Step 5 for the port package first on ``sys.path``: K1, its stash and
    uniform-context variants, K2, K3, K4 and K8 in ``dtype`` (or the kernels
    named in ``only``), summed over their shapes, each as CUDA events around
    one call, as the card's time and as the host's time to make the call
    (each shape's under ``by_stack``); the host's time to build K1's weight
    list; with ``plain``, the plain versions of K1-K4 the same way."""
    import time
    import torch
    from check_torch_flash import host_ms
    from chip_smoke import (CONTEXT, NULL_HALF_BATCH, RESNET_BATCH,
                            RESNET_RUNS, STACK_BATCH, STACKS, UNIFORM_STACKS,
                            _resnet_case, cuda_ms, device_ms)
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    dev, dt = torch.device("cuda", 0), getattr(torch, dtype)
    sums = {}
    where = [None]           # the stack being timed

    def add(key, fn):
        if only is not None and key.replace(" plain", "") not in only:
            return
        if key.endswith(" plain") and not plain:
            return
        ms, card = cuda_ms(fn, reps=reps), device_ms(fn, reps=reps)
        host = host_ms(fn, reps)
        got = sums.setdefault(key, {"ms": 0.0, "card_ms": 0.0,
                                    "host_ms": 0.0, "by_stack": {}})
        got["ms"] += ms
        got["card_ms"] += card
        got["host_ms"] += host
        got["by_stack"][where[0]] = {"ms": ms, "card_ms": card,
                                     "host_ms": host}

    def add_host(key, fn):
        """A host-only function: the median of ``reps`` timed calls."""
        if only is not None and key not in only:
            return
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        got = sums.setdefault(key, {"host_ms": 0.0})
        got["host_ms"] += statistics.median(times) * 1e3

    def stack(length, c, layers, cross, batch, seed):
        gen = torch.Generator().manual_seed(seed)
        mod = Transformer1d(layers, c, HEADS, HEAD_DIM, MULT,
                            context_features=CONTEXT[1] if cross else None,
                            dtype=dt)
        init_parameters(mod, gen)
        kp = mod.to(dev).kernel_params()
        x = torch.randn(batch, length, c, generator=gen).to(dev, dt)
        ctx = (torch.randn(batch, *CONTEXT, generator=gen).to(dev, dt)
               if cross else None)
        return kp, x, ctx, gen

    kw = dict(heads=HEADS, head_dim=HEAD_DIM)
    with torch.no_grad():
        for name, length, c, layers, cross in STACKS:
            where[0] = name
            kp, x, ctx, _ = stack(length, c, layers, cross, STACK_BATCH,
                                  length * c + layers)
            add("K1", lambda: tf.transformer1d_forward(
                kp, x, ctx, num_layers=layers, multiplier=MULT, **kw))
            add("K1 plain", lambda: tf.transformer1d_reference(
                kp, x, ctx, num_layers=layers, multiplier=MULT, **kw))
            add_host("K1 weight list", lambda: tf._kernel_weights(
                kp, layers, cross, dt))
            batch = 512
            kp, x, ctx, gen = stack(length, c, layers, cross, batch,
                                    length * c + layers)
            g = torch.randn(x.shape, generator=gen).to(dev, dt)
            w = tf._kernel_weights(kp, layers, cross, dt)
            _, stash = tf.transformer1d_forward(
                kp, x, ctx, num_layers=layers, multiplier=MULT,
                with_stash=True, **kw)
            add("K1 stash", lambda: tf.transformer1d_forward(
                kp, x, ctx, num_layers=layers, multiplier=MULT,
                with_stash=True, **kw))
            add("K1 stash plain", lambda: tf.transformer1d_reference(
                kp, x, ctx, num_layers=layers, multiplier=MULT,
                with_stash=True, **kw))
            per_layer, per_stash = (20, 3) if cross else (12, 2)

            def layers_bwd(fn):
                for i in range(layers):
                    s0 = i * per_stash
                    fn(g, stash[s0], stash[s0 + 1] if cross else None,
                       stash[s0 + per_stash - 1], ctx,
                       w[4 + i * per_layer:4 + (i + 1) * per_layer], **kw)

            add("K2", lambda: layers_bwd(tf.bwd_layer))
            add("K2 plain", lambda: layers_bwd(tf.bwd_layer_reference))
            add("K3", lambda: tf.bwd_conv_out(g, stash[-1], w[-2]))
            add("K3 plain", lambda: tf.bwd_conv_out_reference(
                g, stash[-1], w[-2]))
            add("K4", lambda: tf.bwd_conv_in_gn(g, x, w[2], w[0], w[1]))
            add("K4 plain", lambda: tf.bwd_conv_in_gn_reference(
                g, x, w[2], w[0], w[1]))
        for name, length, c, layers, m in UNIFORM_STACKS:
            where[0] = name
            kp, x, _, gen = stack(length, c, layers, True, NULL_HALF_BATCH,
                                  length * c + m)
            table = torch.randn(1, m, CONTEXT[1], generator=gen).to(dev, dt)
            add("K1 uniform_ctx", lambda: tf.transformer1d_forward(
                kp, x, table, num_layers=layers, multiplier=MULT,
                uniform_ctx=True, **kw))
        counted = getattr(rf, "gemm_tc_launches", None)
        for i, (name, length, c, n, layout, cm) in enumerate(RESNET_RUNS):
            where[0] = name
            _, w, x, mp, skips, rkw = _resnet_case(
                dev, length, c, n, layout, cm, dt, RESNET_BATCH, i)
            if counted is not None and (only is None or "K8" in only):
                before = counted()
                rf.resnet_stack_forward(w, x, mp, skips, **rkw)
                got = sums.setdefault("K8 products", {"products": 0})
                got["products"] += counted() - before
            add("K8", lambda: rf.resnet_stack_forward(w, x, mp, skips, **rkw))
    return sums


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="a parent checkout whose K1, K2 (and K3, K4, "
                             "K8) to time against this one's, in turns")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-compiler-report", action="store_true")
    parser.add_argument("--no-shapes", action="store_true")
    parser.add_argument("--batches", default=",".join(map(str, BATCHES)),
                        help="batches of step 2, comma-separated")
    parser.add_argument("--trace", action="store_true",
                        help="build the GEMM with its clock64 stamps and "
                             "trace a block at a few shapes")
    parser.add_argument("--tiles", action="store_true",
                        help="time the products and K1, K2 with every "
                             "unsplit product on 64 x 64 and on 128 x 128 "
                             "blocks, in turns")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32", "both"),
                        help="operands of the products and the kernels")
    parser.add_argument("--plain", action="store_true",
                        help="time the plain versions of K1-K4 in each turn")
    parser.add_argument("--stacks-of", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tile", type=int, default=0, help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = ("bfloat16", "float32") if args.dtype == "both" else (
        args.dtype,)
    if args.stacks_of is not None:     # one turn of step 4 or 5, alone
        import chip_smoke  # noqa: F401  (this checkout's harness for both)
        sys.path.insert(0, os.path.abspath(args.stacks_of))
        from moleculediffusiontransformer_tpu_torch.ops import \
            transformer_fusion
        only = None
        if args.tile:                  # step 4: libraries of one block shape
            from moleculediffusiontransformer_tpu_torch.ops import cuda_build
            cuda_build.NVCC_FLAGS += (f"-DGTC_TILE={args.tile}",)
            for dtype in dtypes:
                time_products(transformer_fusion, torch.device("cuda", 0),
                              args.reps,
                              [int(b) for b in args.batches.split(",")],
                              dtype, tile=args.tile)
            only = ("K1", "K2")
        print(json.dumps({"package": os.path.dirname(os.path.dirname(
            os.path.abspath(transformer_fusion.__file__))), "tile": args.tile,
            **{dtype: time_stacks(args.reps, only, dtype, args.plain)
               for dtype in dtypes}}), flush=True)
        return 0
    from check_torch_flash import compiler_report, smi
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    print(smi("name,power.limit"), flush=True)
    faults = []
    if not args.no_compiler_report:
        for source in (tf.SOURCE, tf.BWD_SOURCE, rf.SOURCE):
            report = compiler_report(cuda_build, source,
                                     match=("gemm_tc", "gemm_tf32x3"))
            for kernel, r in report.items():
                if r["spills"] or any("C7515" in n for n in r["notes"]):
                    faults.append((kernel, r["spills"], r["notes"]))
                if "HGMMA" in r and not 0 < r["WARPGROUP.DEPBAR"] < r["HGMMA"]:
                    faults.append((kernel, "HGMMA", r["HGMMA"],
                                   "WARPGROUP.DEPBAR", r["WARPGROUP.DEPBAR"]))
    dev = torch.device("cuda", 0)
    if args.trace:
        trace_products(cuda_build, tf, dev)
    if not args.no_shapes:
        for dtype in dtypes:
            time_products(tf, dev, args.reps,
                          [int(b) for b in args.batches.split(",")], dtype)
    turns = []
    if args.tiles:
        turns += [(f"tile {t}", ROOT, t) for t in (1, 2, 2, 1)]
    if args.root is not None:
        turns += [(label, root, 0) for label, root in (
            ("parent", args.root), ("change", ROOT), ("change", ROOT),
            ("parent", args.root))]
    me = os.path.abspath(__file__)
    for label, root, tile in turns:
        proc = subprocess.run(
            [sys.executable, me, "--stacks-of", root, "--reps",
             str(args.reps), "--tile", str(tile), "--batches", args.batches,
             "--dtype", args.dtype] + (["--plain"] if args.plain else []),
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:                      # step 4's products
            print(line, flush=True)
        print(json.dumps({"turn": label, **json.loads(lines[-1])}),
              flush=True)
    if faults:
        print(json.dumps({"faults": faults}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
