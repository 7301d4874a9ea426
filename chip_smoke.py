#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (on PATH or in /usr/local/cuda/bin) and PyTorch built for
CUDA; it imports nothing of JAX and nothing of the JAX package.  Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the Transformer1d stack kernel from ``csrc/`` with nvcc;
3. kernel against its plain PyTorch version at the four Transformer1d stack
   shapes of the 91M inverse QM9 model, batch 128 (a CFG-doubled 64), in
   float32 (TF32 off) and bfloat16, with CUDA-event timings of both;
4. the serving path: the 91M model in bfloat16 with seeded random weights
   answers three ``sample(num_steps=64, cond_scale=2.0)`` requests (batch 1,
   16, 512), each of which must launch the stack kernel at least 9 x 126
   times; then one float32 batch-8 sample through the kernel on the card is
   held against the same sample through the plain version on the CPU.

Any failed check raises, and the script exits non-zero.  The last two lines
are a JSON record of the kernels and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the 91M inverse QM9 notebook preset (core/config.py::inverse_diffusion_qm9
# at vocab 22; bench.py::_flagship_model)
FLAGSHIP = dict(max_length=32, channels=128, pred_dim=22, text_embed_dim=64,
                embed_dim_position=64, context_embedding_max_length=12,
                multipliers=(1, 2, 4), factors=(4, 4), num_blocks=(3, 3),
                attentions=(4, 4), attention_heads=8, attention_features=64,
                attention_multiplier=2, pre_transformer=2, patch_size=1)
# (name, L, C, layers, cross) of the flagship's Transformer1d stacks
STACKS = [("pre_transformer L8 C256", 8, 256, 2, False),
          ("transformer L8 C256", 8, 256, 4, True),
          ("pre_transformer L2 C512", 2, 512, 2, False),
          ("transformer L2 C512", 2, 512, 4, True)]
STACK_BATCH = 128
CONTEXT = (12, 128)
NUM_STEPS, COND_SCALE = 64, 2.0
REQUESTS = (1, 16, 512)
STACKS_PER_EVAL = 9          # pre + transformer in 2 down and 2 up blocks,
EVALS = 2 * (NUM_STEPS - 1)  # plus the bottleneck; 2 evals per ADPM2 step
# fp32 on unit-scale inputs, TF32 off: only the order of float32 sums
# differs; bf16: the JAX fused-vs-composition band (0.016 on unit scale)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# A 64-step float32 sample through the kernel vs the plain version: the
# JAX suite's full-UNet band (measured 2.1e-7 apart on an H100)
SAMPLE_TOL = 1e-4


def phase(step: str, **fields) -> None:
    print(json.dumps({"phase": step, **fields}), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, from CUDA events."""
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


def check_stacks(dev):
    """Phase 3: the kernel against its plain version at the flagship stack
    shapes.  Returns the largest error per dtype, and the kernel's and the
    plain version's bf16 milliseconds summed over the four shapes."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = 0.0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, length, c, layers, cross in STACKS:
            gen = torch.Generator().manual_seed(length * c + layers)
            mod = Transformer1d(layers, c, 8, 64, 2,
                                context_features=CONTEXT[1] if cross else None,
                                dtype=dtype)
            init_parameters(mod, gen)
            mod = mod.to(dev)
            params = mod.kernel_params()
            x = torch.randn(STACK_BATCH, length, c, generator=gen).to(
                dev, dtype)
            ctx = (torch.randn(STACK_BATCH, *CONTEXT, generator=gen).to(
                dev, dtype) if cross else None)
            kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
            with torch.no_grad():
                out = tf.transformer1d_forward(params, x, ctx, **kw)
                torch.cuda.synchronize()
                ref = tf.transformer1d_reference(params, x, ctx, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                t_kernel = cuda_ms(
                    lambda: tf.transformer1d_forward(params, x, ctx, **kw))
                t_plain = cuda_ms(
                    lambda: tf.transformer1d_reference(params, x, ctx, **kw))
            phase("kernel", stack=name, dtype=dname, batch=STACK_BATCH,
                  max_abs_err=err, tol=KERNEL_TOL[dname],
                  ref_max_abs=ref.float().abs().max().item(),
                  ms=t_kernel, plain_ms=t_plain)
            if not err <= KERNEL_TOL[dname]:
                raise AssertionError(f"{name} {dname}: kernel differs from "
                                     f"the plain version by {err}")
            worst[dname] = max(worst[dname], err)
            if dtype == torch.bfloat16:
                ms += t_kernel
                plain_ms += t_plain
    return worst, ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(
            ROOT, "moleculediffusiontransformer_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import (
        QMDiffusion, sample)
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf

    # fp32 checks are against true fp32: no TF32 in cuDNN convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build
    path, seconds = cuda_build.build(tf.SOURCE)
    phase("build", library=os.path.relpath(path, ROOT), seconds=seconds)

    # 3. kernel against its plain version
    worst, stack_ms, stack_plain_ms = check_stacks(dev)

    # 4. the serving path
    model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.rand(b, 12, generator=gen, device=dev) * 2 - 1
                for b in REQUESTS]
    tf.LAUNCHES = 0
    results = []
    for props in requests:
        before = tf.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(model, props, gen, num_steps=NUM_STEPS,
                     cond_scale=COND_SCALE)
        torch.cuda.synchronize()
        results.append((props.shape[0], out, time.perf_counter() - t0,
                        tf.LAUNCHES - before))
    launches = tf.LAUNCHES
    for b, out, seconds, n in results:
        phase("request", batch=b, seconds=seconds, mol_per_s=b / seconds,
              stack_launches=n, shape=list(out.shape),
              finite=bool(torch.isfinite(out).all()))
        if tuple(out.shape) != (b, FLAGSHIP["max_length"],
                                FLAGSHIP["pred_dim"]):
            raise AssertionError(f"batch {b}: output shape {out.shape}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"batch {b}: non-finite output")
        if n < STACKS_PER_EVAL * EVALS:
            raise AssertionError(f"batch {b}: {n} stack kernel launches, "
                                 f"expected >= {STACKS_PER_EVAL * EVALS}")

    model32 = QMDiffusion(**FLAGSHIP, dtype=torch.float32)
    init_parameters(model32, torch.Generator().manual_seed(0))
    cpu_gen = torch.Generator().manual_seed(2)
    props = torch.rand(8, 12, generator=cpu_gen) * 2 - 1
    noise = torch.randn(8, 32, 22, generator=cpu_gen)
    step_noise = torch.randn(NUM_STEPS - 1, 8, 32, 22, generator=cpu_gen)
    plain = sample(model32.eval(), props, num_steps=NUM_STEPS,
                   cond_scale=COND_SCALE, noise=noise, step_noise=step_noise)
    model32 = model32.to(dev)
    kernel = sample(model32, props.to(dev), num_steps=NUM_STEPS,
                    cond_scale=COND_SCALE, noise=noise.to(dev),
                    step_noise=step_noise.to(dev)).cpu()
    sample_err = (kernel - plain).abs().max().item()
    phase("fp32_sample_vs_plain", batch=8, max_abs_err=sample_err,
          tol=SAMPLE_TOL)
    if not sample_err <= SAMPLE_TOL:
        raise AssertionError(f"fp32 sample: kernel vs plain {sample_err}")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "moleculediffusiontransformer_tpu"))
    if leaked:
        raise AssertionError(f"imported JAX or the JAX package: {leaked}")

    print(json.dumps({"kernels": [{
        "name": "transformer1d_stack_fwd",
        "route": "cuda",
        "source": "moleculediffusiontransformer_tpu_torch/csrc/"
                  "transformer1d_fwd.cu",
        "replaces": "moleculediffusiontransformer_tpu/ops/"
                    "transformer_fusion.py:313",
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": stack_ms,
        "plain_ms": stack_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
