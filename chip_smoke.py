#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (on PATH or in /usr/local/cuda/bin) and PyTorch built for
CUDA; it imports nothing of JAX and nothing of the JAX package.  Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the Transformer1d stack kernels from ``csrc/`` with nvcc, one
   nvcc per source, all started together (this phase reports the forward's);
3. kernel against its plain PyTorch version at the four Transformer1d stack
   shapes of the 91M inverse QM9 model, batch 128 (a CFG-doubled 64), in
   float32 (TF32 off) and bfloat16, with CUDA-event timings of both;
4. the serving path: the 91M model in bfloat16 with seeded random weights
   answers three ``sample(num_steps=64, cond_scale=2.0)`` requests (batch 1,
   16, 512), each of which must launch the stack kernel at least 9 x 126
   times and never its stash variant; then one float32 batch-8 sample
   through the kernel on the card is held against the same sample through
   the plain version on the CPU;
5. build of the backward kernels (``csrc/transformer1d_bwd.cu``, built with
   phase 2's);
6. the training kernels against their plain versions at the four stack
   shapes, batch 512 (the training micro-batch), float32 and bfloat16: the
   stash forward slot by slot, the conv-out (K3), every layer's (K2) and the
   GroupNorm + conv-in (K4) backward output by output, the whole stack's
   grads through the autograd function against autograd of the plain
   forward, CUDA-event timings of each kernel and of the chain against the
   plain versions, and a bitwise determinism check of the chain;
7. the training path: the 91M model in bfloat16 trains one warm-up and 5
   timed steps of batch 1024 as 2 x 512 (Adam 2e-4, clip 0.5); every loss
   is finite and each training kernel launched at least (its stacks or
   layers) x 2 x 6 times; then one float32 step at batch 8 through the
   kernels on the card is held against the same step through the plain
   versions on the CPU.

Any failed check raises, and the script exits non-zero.  The last two lines
are a JSON record of the kernels and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# Training kernels vs their plain versions, as a fraction of each output
# tensor's largest magnitude: the same bands as KERNEL_TOL, scaled because
# weight grads are sums over all b*L rows and dy grows through the layers
TRAIN_BATCH, MICRO_BATCHES, TIMED_STEPS = 1024, 2, 5
# One float32 train step at batch 8, card vs CPU: the loss within 1e-4
# relative, every grad within 1e-3 of its tensor's largest magnitude --
# cuDNN's and the CPU's conv backward sum in other orders, and the loss
# weight (up to ~1e4 at small sigma) magnifies float32 sum-order noise
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3


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


def _rel_err(got, want) -> float:
    """Largest |got - want| as a fraction of want's largest magnitude."""
    scale = max(want.float().abs().max().item(), 1e-30)
    return _abs_err(got, want) / scale


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_backward(dev):
    """Phase 6: the stash forward and K3, K2, K4 against their plain
    versions at the flagship stack shapes, batch 512.  Returns, per kernel,
    the largest bf16 absolute error and the bf16 kernel and plain
    milliseconds summed over the four shapes."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    kernels = ("stash", "conv_out", "layer", "conv_in_gn")
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in kernels}
    batch = TRAIN_BATCH // MICRO_BATCHES
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        for name, length, c, layers, cross in STACKS:
            gen = torch.Generator().manual_seed(length * c + layers)
            mod = Transformer1d(layers, c, 8, 64, 2,
                                context_features=CONTEXT[1] if cross else None,
                                dtype=dtype)
            init_parameters(mod, gen)
            mod = mod.to(dev)
            kp = mod.kernel_params()
            x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
            ctx = (torch.randn(batch, *CONTEXT, generator=gen).to(dev, dtype)
                   if cross else None)
            g = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
            kw = dict(num_layers=layers, heads=8, head_dim=64)
            w = tf._kernel_weights(kp, layers, cross, dtype)
            per_layer, per_stash = (20, 3) if cross else (12, 2)
            layer_args = [
                (w[4 + i * per_layer:4 + (i + 1) * per_layer],
                 i * per_stash) for i in range(layers)]
            errs = dict.fromkeys(kernels, 0.0)      # relative to the scale
            abs_errs = dict.fromkeys(kernels, 0.0)
            with torch.no_grad():
                out, stash = tf.transformer1d_forward(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw)
                ref, ref_stash = tf.transformer1d_reference(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw)
                pairs = {"stash": [(out, ref)] + [
                    (stash[i], ref_stash[i]) for i in range(stash.shape[0])]}
                for fn, plain, key, args in (
                        (tf.bwd_conv_out, tf.bwd_conv_out_reference,
                         "conv_out", (g, ref_stash[-1], w[-2])),
                        (tf.bwd_conv_in_gn, tf.bwd_conv_in_gn_reference,
                         "conv_in_gn", (g, x, w[2], w[0], w[1]))):
                    pairs[key] = list(zip(fn(*args), plain(*args)))

                def run_layers(fn, s):
                    outs = []
                    for lw, s0 in layer_args:
                        outs.append(fn(
                            g, s[s0], s[s0 + 1] if cross else None,
                            s[s0 + per_stash - 1],
                            ctx.to(dtype) if cross else None, lw, heads=8,
                            head_dim=64))
                    return outs

                pairs["layer"] = []
                for got, want in zip(run_layers(tf.bwd_layer, ref_stash),
                                     run_layers(tf.bwd_layer_reference,
                                                ref_stash)):
                    pairs["layer"] += [(got[0], want[0])] + list(
                        zip(got[2], want[2]))
                    if cross:
                        pairs["layer"].append((got[1], want[1]))
                for key, kernel_pairs in pairs.items():
                    errs[key] = max(_rel_err(a, b) for a, b in kernel_pairs)
                    abs_errs[key] = max(_abs_err(a, b) for a, b in kernel_pairs)
                times = {
                    "stash": (
                        lambda: tf.transformer1d_forward(
                            kp, x, ctx, multiplier=2, with_stash=True, **kw),
                        lambda: tf.transformer1d_reference(
                            kp, x, ctx, multiplier=2, with_stash=True,
                            **kw)),
                    "conv_out": (
                        lambda: tf.bwd_conv_out(g, stash[-1], w[-2]),
                        lambda: tf.bwd_conv_out_reference(g, stash[-1],
                                                          w[-2])),
                    "layer": (lambda: run_layers(tf.bwd_layer, stash),
                              lambda: run_layers(tf.bwd_layer_reference,
                                                 stash)),
                    "conv_in_gn": (
                        lambda: tf.bwd_conv_in_gn(g, x, w[2], w[0], w[1]),
                        lambda: tf.bwd_conv_in_gn_reference(
                            g, x, w[2], w[0], w[1])),
                }
                ms = {k: (cuda_ms(a, reps=10), cuda_ms(b, reps=10))
                      for k, (a, b) in times.items()}
                chain = tf.transformer1d_backward(kp, x, ctx, stash, g,
                                                  multiplier=2, **kw)
                again = tf.transformer1d_backward(kp, x, ctx, stash, g,
                                                  multiplier=2, **kw)
                deterministic = (torch.equal(chain[1], again[1])
                                 and all(torch.equal(chain[0][n],
                                                     again[0][n])
                                         for n in chain[0])
                                 and (not cross
                                      or torch.equal(chain[2], again[2])))
                chain_ms = cuda_ms(lambda: tf.transformer1d_backward(
                    kp, x, ctx, stash, g, multiplier=2, **kw), reps=10)
                plain_chain_ms = cuda_ms(
                    lambda: tf.transformer1d_backward_reference(
                        kp, x, ctx, ref_stash, g, **kw), reps=10)

            # the whole stack through the autograd function against autograd
            # of the plain forward, on the module's own float32 parameters
            params = dict(mod.named_parameters())
            xg = x.clone().requires_grad_()
            cg = ctx.clone().requires_grad_() if cross else None
            y = tf.transformer1d(kp, params, xg, cg, multiplier=2, **kw)
            leaves = list(params.values()) + [xg] + ([cg] if cross else [])
            got = torch.autograd.grad(y, leaves, g)
            y = tf.transformer1d_reference(params, xg, cg, multiplier=2,
                                           **kw)
            want = torch.autograd.grad(y, leaves, g)
            stack_err = max(_rel_err(a, b) for a, b in zip(got, want))
            torch.cuda.synchronize()

            phase("train_kernels", stack=name, dtype=dname, batch=batch,
                  rel_err=errs, max_abs_err=abs_errs,
                  stack_grad_rel_err=stack_err, tol=tol,
                  ms={k: v[0] for k, v in ms.items()},
                  plain_ms={k: v[1] for k, v in ms.items()},
                  chain_ms=chain_ms, plain_chain_ms=plain_chain_ms,
                  deterministic=deterministic)
            bad = {k: v for k, v in errs.items() if not v <= tol}
            if bad or not stack_err <= tol:
                raise AssertionError(f"{name} {dname}: training kernels "
                                     f"differ from the plain versions: "
                                     f"{bad}, stack grads {stack_err}")
            if not deterministic:
                raise AssertionError(f"{name} {dname}: two backward calls "
                                     f"gave different grads")
            if dtype == torch.bfloat16:
                for k in kernels:
                    summary[k]["max_abs_err"] = max(
                        summary[k]["max_abs_err"], abs_errs[k])
                    summary[k]["ms"] += ms[k][0]
                    summary[k]["plain_ms"] += ms[k][1]
    return summary


def train_path(dev):
    """Phase 7: the 91M model trains in bf16 at batch 1024 (2 x 512).
    Returns the launches of each training kernel during these steps."""
    import torch
    import torch.nn.functional as F
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    from moleculediffusiontransformer_tpu_torch.train import trainer

    model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    layers = sum(m.num_layers for m in stacks)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, MICRO_BATCHES)
    gen = torch.Generator(device=dev).manual_seed(3)
    cond = torch.rand(TRAIN_BATCH, 12, generator=gen, device=dev) * 2 - 1
    tokens = torch.randint(0, FLAGSHIP["pred_dim"],
                           (TRAIN_BATCH, FLAGSHIP["max_length"]),
                           generator=gen, device=dev)
    target = F.one_hot(tokens, FLAGSHIP["pred_dim"]).float()

    names = ("LAUNCHES", "STASH_LAUNCHES", "CONV_OUT_BWD_LAUNCHES",
             "LAYER_BWD_LAUNCHES", "CONV_IN_GN_BWD_LAUNCHES")
    for n in names:
        setattr(tf, n, 0)
    losses = [step(state, cond, target, gen).item()]      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    timed = [step(state, cond, target, gen) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TIMED_STEPS
    losses += [t.item() for t in timed]
    counts = {n: getattr(tf, n) for n in names}
    steps = 1 + TIMED_STEPS
    want = {"STASH_LAUNCHES": len(stacks), "CONV_OUT_BWD_LAUNCHES":
            len(stacks), "LAYER_BWD_LAUNCHES": layers,
            "CONV_IN_GN_BWD_LAUNCHES": len(stacks)}
    want = {k: v * MICRO_BATCHES * steps for k, v in want.items()}
    phase("train", batch=TRAIN_BATCH, micro_batches=MICRO_BATCHES,
          steps=steps, seconds_per_step=seconds,
          samples_per_s=TRAIN_BATCH / seconds, losses=losses,
          max_memory_allocated=torch.cuda.max_memory_allocated(dev),
          stacks=len(stacks), layers=layers, launches=counts,
          min_launches=want)
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite training loss: {losses}")
    short = {k: counts[k] for k, v in want.items() if counts[k] < v}
    if short or counts["LAUNCHES"]:
        raise AssertionError(f"training launched the kernels {counts}, "
                             f"expected at least {want} and no stash-less "
                             f"forward")
    return counts


def fp32_step_vs_plain(dev):
    """Phase 7, last: one fp32 step at batch 8 through the kernels on the
    card against the same step through the plain versions on the CPU."""
    import torch
    import torch.nn.functional as F
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.train import trainer

    cpu_gen = torch.Generator().manual_seed(4)
    model32 = QMDiffusion(**FLAGSHIP, dtype=torch.float32)
    init_parameters(model32, torch.Generator().manual_seed(0))
    batch = 8
    cond = torch.rand(batch, 12, generator=cpu_gen) * 2 - 1
    target = F.one_hot(torch.randint(0, FLAGSHIP["pred_dim"],
                                     (batch, FLAGSHIP["max_length"]),
                                     generator=cpu_gen),
                       FLAGSHIP["pred_dim"]).float()
    sigmas = torch.exp(-1.2 + 1.2 * torch.randn(batch, generator=cpu_gen))
    noise = torch.randn(target.shape, generator=cpu_gen)
    results = []
    for device in (dev, torch.device("cpu")):
        m = copy.deepcopy(model32).to(device)
        o = trainer.make_optimizer(trainer.OptimizerConfig())
        loss = trainer.make_diffusion_train_step(m, o, MICRO_BATCHES)(
            trainer.TrainState.create(m, o), cond.to(device),
            target.to(device), sigmas=sigmas.to(device),
            noise=noise.to(device)).item()
        results.append((loss, {n: p.grad.cpu() for n, p in
                               m.named_parameters()}))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = results
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n]) for n in cpu_grads)
    phase("fp32_step_vs_plain", batch=batch, loss=card_loss,
          plain_loss=cpu_loss, loss_rel_err=loss_err, grad_rel_err=grad_err,
          tol={"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL})
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL):
        raise AssertionError(f"fp32 train step: card vs CPU loss "
                             f"{loss_err}, grads {grad_err}")


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

    # 2. build, both sources at once (phase 5 reports the backward's)
    with ThreadPoolExecutor(2) as pool:
        builds = dict(zip((tf.SOURCE, tf.BWD_SOURCE),
                          pool.map(cuda_build.build,
                                   (tf.SOURCE, tf.BWD_SOURCE))))
    path, seconds = builds[tf.SOURCE]
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
    tf.LAUNCHES = tf.STASH_LAUNCHES = 0
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
    if tf.STASH_LAUNCHES:
        raise AssertionError(f"sampling launched the stash forward "
                             f"{tf.STASH_LAUNCHES} times")
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

    # 5. build of the backward kernels (started in phase 2)
    path, seconds = builds[tf.BWD_SOURCE]
    phase("build_bwd", library=os.path.relpath(path, ROOT), seconds=seconds)

    # 6. the training kernels against their plain versions
    train_kernels = check_backward(dev)

    # 7. the training path
    train_launches = train_path(dev)
    fp32_step_vs_plain(dev)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "moleculediffusiontransformer_tpu"))
    if leaked:
        raise AssertionError(f"imported JAX or the JAX package: {leaked}")

    csrc = "moleculediffusiontransformer_tpu_torch/csrc/"
    jax_ops = "moleculediffusiontransformer_tpu/ops/transformer_fusion.py"
    kernels = [{
        "name": "transformer1d_stack_fwd",
        "route": "cuda",
        "source": csrc + "transformer1d_fwd.cu",
        "replaces": jax_ops + ":313",
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": stack_ms,
        "plain_ms": stack_plain_ms,
    }]
    # the training kernels' numbers: bf16, batch 512, from phase 6
    for key, name, source, line, count in (
            ("stash", "transformer1d_stack_fwd_stash", "transformer1d_fwd.cu",
             313, "STASH_LAUNCHES"),
            ("conv_out", "transformer1d_bwd_conv_out",
             "transformer1d_bwd.cu", 780, "CONV_OUT_BWD_LAUNCHES"),
            ("layer", "transformer1d_bwd_layer", "transformer1d_bwd.cu", 847,
             "LAYER_BWD_LAUNCHES"),
            ("conv_in_gn", "transformer1d_bwd_conv_in_gn",
             "transformer1d_bwd.cu", 799, "CONV_IN_GN_BWD_LAUNCHES")):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": f"{jax_ops}:{line}",
                        "launches": train_launches[count],
                        **train_kernels[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
