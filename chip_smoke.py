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
   float32 (TF32 off) and bfloat16, with CUDA-event timings of both around
   one call (``ms``) and, for the kernel, the card's time with the calls
   enqueued back to back (``card_ms``);
4. the serving path: the 91M model in bfloat16 with seeded random weights
   answers three ``sample(num_steps=64, cond_scale=2.0)`` requests (batch 1,
   16, 512), each of which must launch the stack kernel at least 9 x 126
   times and never its stash variant, and every product of every stack
   launch must go to the tensor-core GEMM (``gemm_tc.cuh``, counted by the
   stack libraries); one denoise evaluation at batch 512 under CFG is timed
   under ``torch.profiler`` (device ms, launches, GEMM launches) beside the
   host clock; then one float32 batch-8 sample through the kernel on the
   card is held against the same sample through the plain version on the
   CPU;
5. build of the backward kernels (``csrc/transformer1d_bwd.cu``, built with
   phase 2's);
6. the training kernels against their plain versions at the four stack
   shapes, batch 512 (the training micro-batch), float32 and bfloat16: the
   stash forward slot by slot, the conv-out (K3), every layer's (K2) and the
   GroupNorm + conv-in (K4) backward output by output, the whole stack's
   grads through the autograd function against autograd of the plain
   forward, CUDA-event timings of each kernel (and in bf16 the card's time)
   and of the chain against the plain versions, and a bitwise determinism
   check of the chain; each bf16 K3 and K4 call must send its two products
   to the tensor-core GEMM (a float32 call none);
7. the training path: the 91M model in bfloat16 trains one warm-up and 5
   timed steps of batch 1024 as 2 x 512 (Adam 2e-4, clip 0.5); every loss
   is finite, each training kernel launched at least (its stacks or
   layers) x 2 x 6 times, and every product of the stash forward, K3, K2
   and K4 went to the tensor-core GEMM; one more step under ``torch.profiler``
   (device ms, launches, GEMM launches) beside the host clock; then one
   float32 step at batch 8 through the kernels on the card is held against
   the same step through the plain versions on the CPU;
8. the resnet-run kernel (K8, ``csrc/resnet_fwd.cu``, built with phase 2's)
   against its plain version at the eight resnet runs of the 91M inverse
   and the 18M forward presets, batch 1,024 (512 requests under CFG), in
   float32 and bfloat16, with CUDA-event timings of the kernel (``ms``, and
   the card's time with the calls back to back, ``card_ms``), the plain
   version and the module composition the switch-off path runs, and a
   determinism check; each bf16 call must send all its products (two convs
   a block, each projection, one FiLM product a run: 7 for a 3-block down
   run, 13 for a 4-block up run) to the tensor-core GEMM, counted by
   ``resnet_fusion.gemm_tc_launches``, and a float32 call none; then its
   gradients through the autograd function against autograd of the
   composition at batch 512;
9. K1's uniform-context variant (the shared-KV CFG null half) against its
   plain version at the four cross-stack shapes of the two presets, batch
   512, float32 and bfloat16, with timings (``ms``, ``card_ms``);
10. the 91M model serving with both switches on (``enable_resnet_fusion``,
   ``enable_sharedkv``): three 64-step CFG requests (batch 1, 16, 512),
   each launching K8 at least 4 x 126 times and the uniform-context kernel
   at least 5 x 126 times; then one float32 batch-8 sample with both
   switches on the card against phase 4's plain sample on the CPU;
11. the 91M model training with K8 on: one warm-up and 2 steps of batch
   1024 as 2 x 512;
12. the 18M forward model (``QMDiffusionForward``) with K8 on: three
   100-step requests at cond scale 1.0 (batch 1, 16, 512), one of 512 at
   cond scale 2.0 with the shared-KV null half on too, one warm-up and 5
   steps of batch 1024 as 2 x 512, and one float32 batch-8 step with K8 on
   the card against the module composition on the CPU;
13. for each model, both switches on against both off in turns
   on/off/off/on: a request of 512 and 2 training steps of 2 x 512;
14. build of the streaming-attention kernels (``csrc/flash_attention.cu``,
   K5, and ``csrc/flash_attention_bwd.cu``, K6 and K7, built with phase
   2's);
15. K5, K6 and K7 against their plain versions at bh 16 and 64, n = m =
   4096, d 64, at n 2048, m 4096 and at n 4096, m 2048, in float32 and
   bfloat16, and in bfloat16 also at d 16, 32 and 128 and at the smallest
   shape the wrapper takes (n = m = 128); o, lse, dq, dk and dv bitwise
   equal across two calls, with the card's time of each kernel (calls
   enqueued back to back), its TFLOP/s, its bound and the time of its
   exponentials at the special-function units' rate, the plain versions'
   times and, in bfloat16, ``scaled_dot_product_attention`` with its
   backward (timed here as a yardstick, called nowhere in the package);
   then the three kernels on the long model's split heads at 2**17 samples,
   batch 8 (views of its projections), against their plain versions and,
   bit for bit, against contiguous copies;
16. the crossover: K5 alone and K5 + K6 + K7 under autograd against the
   one-shot ``sdpa`` and its autograd on split-head views, n = m in 512 ...
   8192, bh 16, d 64, bfloat16, each with CUDA events around one call and
   with calls enqueued back to back;
17. the long-sequence model serving: the ``Model1d`` of the JAX package's
   ``tools/bench_audio_long.py`` (9.1M parameters, full width and depth,
   seeded random weights, bfloat16), ``sample_model1d`` at its defaults
   (linear schedule, v-sampler, clamp, 50 steps = 49 evals) on waveforms of
   2**15 samples (attention at 1,024 tokens: K5 when ``LONG_SEQ_THRESHOLD``
   is 1,024 or less) and 2**17 samples (attention at 4,096 tokens: K5),
   batch 2 and 8; each output finite, in [-1, 1], and K5 launched exactly
   49 x the attention layers that route, counted from the model;
18. the long-sequence model training: one warm-up and 5 timed bfloat16
   steps (Adam 2e-4, clip 0.5) at 2**17 samples, batch 2 and 8, and 2 at
   2**15 samples, batch 2 and 8; K5, K6 and K7 each launched exactly (the
   layers that route) x the steps; then ``MDT_FLASH`` on/off/off/on for a
   request and for 2 training steps at 2**17 and 2**15 samples, batch 8,
   with each turn's peak memory;
19. float32 parity of the long model: a batch-1 training step and a 4-step
   sample at 2**16 samples (attention at 2,048 tokens) through K5-K7 on
   the card against the same through the plain versions on the CPU;
20. build of the resident-KV attention kernels (``csrc/attention.cu``, K9
   and K10, built with phase 2's);
21. K9 (``ops.attention``) and, where n, m <= 64, K10
   (``ops.packed_attention``) against their plain version in float32 and
   bfloat16, each bitwise equal across two calls, with CUDA-event timings of
   the kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick, called nowhere in the package), each as the card's time with
   the calls enqueued back to back, and each shape's bound, at the
   shapes of the JAX package's own tests of these kernels, the attention of
   the 91M and 18M presets at 512 requests under CFG, the AR transformer's
   decode step at batch 1024 under CFG (n 1, m 65 and m 13, d 16, beside
   the multi-query module math that computes it in the model) and one shape
   past K10's range, then at each route's edges (``ATTENTION_EDGE_SHAPES``
   and the largest m a call takes at d 64 and 128); each line names the
   route ``ops.attention.plan`` took and adds ``cold_ms``, the same calls on
   rotating inputs of more than 100 MB that no call finds in L2; then the
   public entry points at the AR decode shapes
   with the counts set to 0 before and read after -- no model calls these
   two kernels in either package, so this call is their main path;
22. the inverse AR transformer serving: ``MoleculeTransformerSequence`` at
   its notebook preset (2.4M parameters, full width and depth, seeded random
   weights, bfloat16) answers ``generate_sequence`` requests of batch 1, 16
   and 1024 (63 tokens from a start token of 1, cond scale 3.0, filter
   threshold 0.9): ids (b, 64), the start column kept, every id in [0, 24);
   a traced 16-token request at batch 1 and 1024 for the device's busy share; then a
   float32 batch-8 request on the card against the CPU on the same
   uniforms: the blended logits of every step within 1e-4, and the ids equal
   wherever the two largest perturbed logits are more than 1e-3 apart;
23. the inverse AR transformer training: one warm-up and 5 timed bfloat16
   steps at batch 512 x 64 tokens (Adam 2e-4, clip 0.5), every loss finite;
   then one float32 batch-8 step on the card against the CPU;
24. the forward transformer: ``MoleculeTransformerSequenceEncoder`` at its
   notebook preset (3.2M parameters, full width and depth, seeded random
   weights, bfloat16) predicts the properties of 1, 16 and 1,024 SMILES
   of the synthetic QM9 stand-in through
   ``predict_properties_from_smiles_transformer`` (finite, (b, 12)), a
   traced request of 1,024, then one warm-up and 5 timed training steps at
   batch 256 (Adam 2e-4, clip 0.5), every loss finite; no kernel lies on
   its path; then a float32 batch-8 prediction and step on the card
   against the CPU;
25. the inverse-design pipeline on the 91M preset at the tokenizer's
   vocabulary (bfloat16): ``generate_from_conditioning`` for 64 targets
   (100 steps, cond scale 7.5), every stack call through K1 (9 x 198
   launches) with its products on the tensor cores; ``evaluate_generated``
   against the training set; a traced denoise evaluation;
   ``inpaint_from_draft_and_conditioning`` (4 candidates, 2 resamples, 9 x
   396 K1 launches, the fixed positions decoding to the draft's tokens);
   ``rescore_generated`` with the 18M model (5 x 198 K1 launches) and with
   phase 24's encoder; ``generate_from_conditioning_transformer`` on the
   AR preset for 16 targets; the generate again with K8 on (4 x 198 K8
   launches);
26. float32 parity of the pipeline: ``generate_from_conditioning`` and
   ``qm_diffusion.inpaint`` at batch 8 and 64 steps on the card against the
   CPU on the same draws, within the full-UNet band of phase 4, the decoded
   tokens equal wherever the two largest channels are more than 1e-3 apart.

Any failed check raises, and the script exits non-zero.  The last two lines
are a JSON record of the kernels -- each with its launches on its main path,
its bfloat16 time beside its plain version's (the stack kernels K1-K4, K8
and the streaming-attention kernels also with ``card_ms``; the stack
kernels and K8, whose bf16 products all run on the tensor-core GEMM, with
``products`` naming it), the library call's
where there is one, and the least time the card could take (the larger of
its operations over 989 TFLOP/s and its bytes over 3.35 TB/s) -- and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
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
CROSS_STACKS_PER_EVAL = 5    # the transformers with a context
RESNET_RUNS_PER_EVAL = 4     # the blocks runs of 2 down and 2 up blocks
# the 18M forward QM9 notebook preset (core/config.py::forward_diffusion_qm9)
# and its predict path (design/inverse_design.py: 100 steps, cond scale 1.0,
# token ids / the vocabulary size as the (b, 64) conditioning)
FORWARD = dict(max_length=64, channels=64, pred_dim=1, text_embed_dim=64,
               embed_dim_position=64, context_embedding_max_length=64,
               multipliers=(1, 2, 4), factors=(4, 4), num_blocks=(3, 3),
               attentions=(2, 2), attention_heads=8, attention_features=64,
               attention_multiplier=2, pre_transformer=0, patch_size=4)
FORWARD_STEPS, FORWARD_VOCAB = 100, 22
# (name, L, C, blocks, layout, C_m) of the resnet runs: the 91M inverse
# preset's, then the 18M forward preset's
RESNET_RUNS = [("inverse down 0", 8, 256, 3, "down", 512),
               ("inverse down 1", 2, 512, 3, "down", 512),
               ("inverse up 0", 2, 512, 4, "up", 512),
               ("inverse up 1", 8, 256, 4, "up", 512),
               ("forward down 0", 4, 128, 3, "down", 256),
               ("forward down 1", 1, 256, 3, "down", 256),
               ("forward up 0", 1, 256, 4, "up", 256),
               ("forward up 1", 4, 128, 4, "up", 256)]
RESNET_BATCH = 1024          # 512 requests under CFG
# (name, L, C, layers, context length) of the cross stacks' null half
UNIFORM_STACKS = [("inverse transformer L8 C256", 8, 256, 4, 12),
                  ("inverse transformer L2 C512", 2, 512, 4, 12),
                  ("forward transformer L4 C128", 4, 128, 2, 64),
                  ("forward transformer L1 C256", 1, 256, 2, 64)]
NULL_HALF_BATCH = 512
# K8 and the uniform-context kernel against their plain versions, as a
# fraction of each output's largest magnitude (residual streams grow through
# the blocks): the KERNEL_TOL bands
AB_TRAIN_STEPS = 2
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
# weight (up to ~1e4 at small sigma) magnifies float32 sum-order noise.  A
# magnitude under STEP_GRAD_FLOOR counts as the floor: a grad that is zero
# but for that noise (a conv bias right before a GroupNorm, as in the
# Patcher and Unpatcher) is held to 1e-6 absolute
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR = 1e-4, 1e-3, 1e-3


# the long-sequence Model1d of tools/bench_audio_long.py: v-diffusion, a
# uniform sigma distribution (the class's defaults), 9,122,206 parameters
LONG = dict(in_channels=2, channels=64, patch_size=2, multipliers=(1, 2, 4),
            factors=(4, 4), num_blocks=(2, 2), attentions=(0, 1, 1),
            attention_heads=8, attention_features=64, attention_multiplier=2)
# waveform samples: attention runs at samples / 32 tokens, so 2**15 stays
# on the one-shot path (1,024 tokens) and 2**17 streams (4,096 tokens)
LONG_SAMPLES, FLASH_SAMPLES, PARITY_SAMPLES = 2 ** 15, 2 ** 17, 2 ** 16
LONG_BATCHES = (2, 8)
LONG_STEPS = 50
# (bh, n, m, d): the long model's attention at batch 2 and 8 and the two
# rectangular cases, in both types; then, in bfloat16 only, the other head
# sizes and the smallest shape the wrapper takes
FLASH_SHAPES = [(16, 4096, 4096, 64), (64, 4096, 4096, 64),
                (16, 2048, 4096, 64), (16, 4096, 2048, 64)]
FLASH_BF16_SHAPES = [(16, 4096, 4096, 16), (16, 4096, 4096, 32),
                     (16, 4096, 4096, 128), (16, 128, 128, 64)]
# (b, h, n, d) of the split-head case: the long model's attention at 2**17
# samples, batch 8, as views of its (b, n, h d) projections
FLASH_SPLIT_HEADS = (8, 8, 4096, 64)
# the SMs' special-function units: exponentials an SM a clock (MUFU.EX2)
EXP_PER_CLOCK = 16
CROSSOVER_LENGTHS = (512, 1024, 2048, 4096, 8192)
# the inverse AR transformer's notebook preset
# (core/config.py::inverse_transformer_qm9; 2,407,712 parameters) and the
# request of bench.py's AR metric: 63 tokens from a (b, 1) start of ones
AR_PRESET = dict(dim=128, depth=12, heads=8, dim_head=16, logits_dim=24,
                 text_embed_dim=16, max_text_len=12)
AR_REQUESTS = (1, 16, 1024)
AR_TOKENS, AR_COND_SCALE, AR_FILTER_THRES = 63, 3.0, 0.9
AR_TRACED_TOKENS = 16
AR_TRAIN_BATCH, AR_TRAIN_TOKENS = 512, 64
# its decode step at batch 1024 under CFG, (bh, n, m, d): self-attention
# over the null KV and a full 64-token cache (K9: m > 64), cross-attention
# over the null KV and 12 properties (K10)
AR_DECODE_SHAPES = {"attention": (16384, 1, 65, 16),
                    "packed_attention": (16384, 1, 13, 16)}
# (bh, n, m, d) of phase 21: tests/test_ops.py's two; the 91M preset's self
# and cross attention at L 8 and L 2 and the 18M preset's cross attention at
# L 4 and L 1, 512 requests under CFG with 8 heads; the AR decode shapes;
# one shape past K10's range
ATTENTION_SHAPES = [(8, 16, 24, 64), (128, 16, 12, 64), (8192, 8, 8, 64),
                    (8192, 8, 12, 64), (8192, 2, 2, 64), (8192, 2, 12, 64),
                    (8192, 4, 64, 64), (8192, 1, 64, 64),
                    *AR_DECODE_SHAPES.values(), (64, 256, 256, 64)]
# and each route's edges: n = 1 at d 128 (a row route team of several
# warps); n = 15, 16, 17 at m 64 (row route, tile route, a ragged tile);
# K10 at bh 8 and 130 (fewer head-batches than the card has SMs, and just
# under two blocks an SM); then, from ``attention_edge_shapes``, the largest
# m a call takes at n 64 at d 64 and 128, and in bf16 the tile route's own
# limit where the CUDA-core tiles reach further
ATTENTION_EDGE_SHAPES = [(4096, 1, 64, 128), (1024, 15, 64, 64),
                         (1024, 16, 64, 64), (1024, 17, 64, 64),
                         (8, 1, 13, 16), (130, 1, 13, 16), (130, 4, 64, 64)]
# rotating input sets of a ``cold_ms`` timing hold more than this together,
# twice the card's 50 MB L2, so that no call finds its inputs there
COLD_BYTES = 100 * 2 ** 20
# A float32 AR request, card against CPU: every step's blended logits
# within AR_LOGIT_TOL; a token may differ only where the two largest
# Gumbel-perturbed logits are within AR_GAP of each other
AR_LOGIT_TOL, AR_GAP = 1e-4, 1e-3
# the forward transformer's notebook preset
# (core/config.py::forward_transformer_qm9; 3,162,496 parameters at 24
# tokens): SMILES ids (b, 64) -> (b, 1, 12) properties
ENCODER_PRESET = dict(dim=256, depth=6, heads=16, ff_mult=2, logits_dim=1,
                      logits_dim_length=12, max_length=64, max_tokens=24,
                      embed_dim=16)
ENCODER_REQUESTS = (1, 16, 1024)
# train/recipes.py::PRODUCTION_BATCHES["forward_transformer"]
ENCODER_TRAIN_BATCH = 256
# the design pipeline (design/inverse_design.py at its defaults: 100 steps,
# cond scale 7.5) on the synthetic QM9 stand-in of data/qm9.py in its
# chemically valid mode, so that validity and novelty mean something
DESIGN_SMILES = 4096
DESIGN_TARGETS, DESIGN_STEPS, DESIGN_COND_SCALE = 64, 100, 7.5
DESIGN_EVALS = 2 * (DESIGN_STEPS - 1)
# rescore_generated predicts with predict_properties_from_smiles's 100 steps
RESCORE_EVALS = 2 * (100 - 1)
INPAINT_CANDIDATES, INPAINT_RESAMPLES = 4, 2
INPAINT_FIXED = (0, 1, 2, 3)
AR_DESIGN_TARGETS = 16
# float32 parity of the pipeline, card against CPU: NUM_STEPS-step requests
# of 8 held to SAMPLE_TOL; a decoded token may differ only where the CPU's
# two largest channels at its position are within DESIGN_GAP
DESIGN_PARITY_BATCH, DESIGN_GAP = 8, 1e-3
# where the bf16 products of the stack kernels (K1 and its variants, K2-K4)
# and of the resnet-run kernel (K8) run
TC_PRODUCTS = "tensor cores (wgmma, csrc/gemm_tc.cuh)"
# the card's published dense peaks (NVIDIA's H100 SXM data sheet): bf16
# tensor-core operations a second, device-memory bytes a second
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def exp_bound_ms(count: float) -> float:
    """The least milliseconds ``count`` exponentials take on the SMs'
    special-function units at the card's largest SM clock (a bound the
    operations bound leaves out)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return count / (sms * EXP_PER_CLOCK * mhz * 1e6) * 1e3


def bound(flops: float, nbytes: float) -> dict:
    """The least milliseconds the card could take: each operation at the
    bf16 peak, each input byte read and output byte written once."""
    return {"ops_ms": flops / PEAK_FLOPS * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES * 1e3}


def add_bound(summary: dict, b: dict) -> None:
    """Sum a shape's bound into ``summary`` (the larger of the two times
    binds each shape) and keep both sums to say which binds overall."""
    summary["bound_ms"] = summary.get("bound_ms", 0.0) + max(b.values())
    for k, v in b.items():
        summary[k] = summary.get(k, 0.0) + v


def close_bound(summary: dict) -> dict:
    ops, nbytes = summary.pop("ops_ms"), summary.pop("bytes_ms")
    summary["bound_by"] = "operations" if ops >= nbytes else "bytes"
    return summary


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def stack_layer_flops(b, length, c, cross, m=0, cctx=0, kv_rows=None,
                      mid=512, mult=2) -> float:
    """One TransformerBlock's forward products at R = b * length rows."""
    r = b * length
    per = (2 * r * c * mid + 2 * r * c * 2 * mid + 4 * r * length * mid
           + 2 * r * mid * c + 4 * r * c * mult * c)
    if cross:
        kv_rows = b * m if kv_rows is None else kv_rows
        per += (2 * r * c * mid + 2 * kv_rows * cctx * 2 * mid
                + 4 * r * m * mid + 2 * r * mid * c)
    return per


def stack_flops(b, length, c, layers, cross, m=0, cctx=0,
                kv_rows=None) -> float:
    """A Transformer1d stack's forward: the two 1x1 convs and its layers."""
    return 4 * b * length * c * c + layers * stack_layer_flops(
        b, length, c, cross, m, cctx, kv_rows)


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


_BLOCKER = None


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median milliseconds a call of ``fn()`` keeps the card busy, for calls
    shorter than the host takes to make them: ``reps`` calls are enqueued
    behind two large matrix products, which keep the card busy while the
    host enqueues, so the events see the calls run back to back and not the
    host's time between launches (which ``cuda_ms`` would see)."""
    import torch
    global _BLOCKER
    if _BLOCKER is None:
        _BLOCKER = torch.zeros(4096, 4096, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.matmul(_BLOCKER, torch.matmul(_BLOCKER, _BLOCKER))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cold_fn(fn, dev, bh, n, m, d, dtype, total: int = COLD_BYTES):
    """A call of ``fn(q, k, v)`` that takes the next of enough seeded
    (bh, n, d), (bh, m, d), (bh, m, d) input sets to hold more than
    ``total`` bytes together, so that a run of calls never finds its inputs
    in L2 (a decode step reads another layer's cache every time)."""
    import torch
    one = (bh * n * d + 2 * bh * m * d) * torch.finfo(dtype).bits // 8
    sets = max(2, -(-total // one) + 1)
    gen = torch.Generator(dev).manual_seed(bh + n + m + d)
    q, k, v = (torch.randn((sets, bh, rows, d), generator=gen, device=dev,
                           dtype=dtype) for rows in (n, m, m))
    turn = [0]

    def call():
        i = turn[0] = (turn[0] + 1) % sets
        return fn(q[i], k[i], v[i])
    return call


def largest_m(at, n: int, d: int, dtype, route=None) -> int:
    """The largest m that ``ops.attention`` takes at (1, n, m, d) (through
    ``route`` only, when given): the routes' limits grow with m."""
    lo, hi = 0, 1 << 14
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if at.plan(1, n, mid, d, dtype, route=route) is not None:
            lo = mid
        else:
            hi = mid - 1
    return lo


def attention_edge_shapes(at, dtype) -> list:
    """``ATTENTION_EDGE_SHAPES`` and the range limits of ``dtype``."""
    shapes = list(ATTENTION_EDGE_SHAPES)
    for d in (64, 128):
        shapes.append((16, 64, largest_m(at, 64, d, dtype), d))
        tile = largest_m(at, 64, d, dtype, "tile")
        if tile and (16, 64, tile, d) not in shapes:
            shapes.append((16, 64, tile, d))
    return shapes


def attention_shapes(at, dtype) -> list:
    """Phase 21's shapes in ``dtype``: the 11, then the route edges (where
    ``at`` has no ``plan``, an earlier checkout's, the 11 and the fixed
    edges)."""
    if not hasattr(at, "plan"):
        return ATTENTION_SHAPES + ATTENTION_EDGE_SHAPES
    return ATTENTION_SHAPES + attention_edge_shapes(at, dtype)


def check_stacks(dev):
    """Phase 3: the kernel against its plain version at the flagship stack
    shapes.  Returns the largest error per dtype, and the kernel's (CUDA
    events around one call, and the card's time of calls back to back) and
    the plain version's bf16 milliseconds summed over the four shapes, with
    the bound of those four calls."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = card_ms = 0.0
    limit = {}
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
                t_card = device_ms(
                    lambda: tf.transformer1d_forward(params, x, ctx, **kw))
                t_plain = cuda_ms(
                    lambda: tf.transformer1d_reference(params, x, ctx, **kw))
            phase("kernel", stack=name, dtype=dname, batch=STACK_BATCH,
                  max_abs_err=err, tol=KERNEL_TOL[dname],
                  ref_max_abs=ref.float().abs().max().item(),
                  ms=t_kernel, card_ms=t_card, plain_ms=t_plain)
            if not err <= KERNEL_TOL[dname]:
                raise AssertionError(f"{name} {dname}: kernel differs from "
                                     f"the plain version by {err}")
            worst[dname] = max(worst[dname], err)
            if dtype == torch.bfloat16:
                ms += t_kernel
                card_ms += t_card
                plain_ms += t_plain
                add_bound(limit, bound(
                    stack_flops(STACK_BATCH, length, c, layers, cross,
                                *CONTEXT),
                    nbytes(x, out, ctx, *tf._kernel_weights(
                        params, layers, cross, dtype))))
    return worst, ms, card_ms, plain_ms, close_bound(limit)


def _rel_err(got, want, floor: float = 1e-30) -> float:
    """Largest |got - want| as a fraction of want's largest magnitude (or
    of ``floor``, if that is larger)."""
    scale = max(want.float().abs().max().item(), floor)
    return _abs_err(got, want) / scale


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_backward(dev):
    """Phase 6: the stash forward and K3, K2, K4 against their plain
    versions at the flagship stack shapes, batch 512.  Returns, per kernel,
    the largest bf16 absolute error, the bf16 kernel (CUDA events around one
    call, and the card's time of calls back to back) and plain milliseconds
    summed over the four shapes, and the bound of those calls.  A layer's
    backward is counted as three times its forward products: recomputing
    them from the stash, and a data and a weight gradient for each."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    kernels = ("stash", "conv_out", "layer", "conv_in_gn")
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "card_ms": 0.0,
                   "plain_ms": 0.0} for k in kernels}
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
                # K3's and K4's bf16 products go to the tensor cores, each
                # call's CONV_BWD_PRODUCTS of them; float32 ones do not
                conv_products = {}
                for fn, plain, key, args in (
                        (tf.bwd_conv_out, tf.bwd_conv_out_reference,
                         "conv_out", (g, ref_stash[-1], w[-2])),
                        (tf.bwd_conv_in_gn, tf.bwd_conv_in_gn_reference,
                         "conv_in_gn", (g, x, w[2], w[0], w[1]))):
                    before = tf.gemm_tc_launches()
                    got = fn(*args)
                    conv_products[key] = tf.gemm_tc_launches() - before
                    pairs[key] = list(zip(got, plain(*args)))
                want_conv = (tf.CONV_BWD_PRODUCTS
                             if dtype == torch.bfloat16 else 0)
                if any(v != want_conv for v in conv_products.values()):
                    raise AssertionError(
                        f"{name} {dname}: K3/K4 sent {conv_products} "
                        f"products to the tensor cores, expected "
                        f"{want_conv} each")

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
                card = ({k: device_ms(a, reps=10, rounds=3)
                         for k, (a, _) in times.items()}
                        if dtype == torch.bfloat16 else None)
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
                  ms={k: v[0] for k, v in ms.items()}, card_ms=card,
                  plain_ms={k: v[1] for k, v in ms.items()},
                  chain_ms=chain_ms, plain_chain_ms=plain_chain_ms,
                  deterministic=deterministic,
                  conv_gemm_tc_launches=conv_products)
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
                    summary[k]["card_ms"] += card[k]
                    summary[k]["plain_ms"] += ms[k][1]
                conv = 4 * batch * length * c * c
                grad32 = 4 * (c * c + 3 * c)     # a float32 dW and vectors
                lw_bytes = sum(nbytes(*lw) + 4 * sum(t.numel() for t in lw)
                               for lw, _ in layer_args)
                limits = {
                    "stash": bound(
                        stack_flops(batch, length, c, layers, cross,
                                    *CONTEXT),
                        nbytes(x, out, ctx, stash, *w)),
                    "conv_out": bound(conv, nbytes(g, g, g, w[-2]) + grad32),
                    "layer": bound(
                        3 * layers * stack_layer_flops(batch, length, c,
                                                       cross, *CONTEXT),
                        layers * ((2 + per_stash) * nbytes(g)
                                  + 2 * nbytes(ctx)) + lw_bytes),
                    "conv_in_gn": bound(conv, nbytes(g, x, g, w[2]) + grad32)}
                for k in kernels:
                    add_bound(summary[k], limits[k])
    return {k: close_bound(v) for k, v in summary.items()}


def train_path(dev):
    """Phase 7: the 91M model trains in bf16 at batch 1024 (2 x 512), every
    product of its stacks' forward, K3, K2 and K4 on the tensor cores; then one step
    under the profiler.  Returns the launches of each training kernel
    during the timed steps."""
    import torch
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
    gen = torch.Generator(device=dev).manual_seed(3)
    cond, target = inverse_batch(TRAIN_BATCH, gen, dev)

    reset_counts()
    products = tf.gemm_tc_launches()
    losses, seconds, peak = train_steps(model, cond, target, gen,
                                        TIMED_STEPS)
    products = tf.gemm_tc_launches() - products
    counts_ = counts()
    steps = 1 + TIMED_STEPS
    want = {"STASH_LAUNCHES": len(stacks), "CONV_OUT_BWD_LAUNCHES":
            len(stacks), "LAYER_BWD_LAUNCHES": layers,
            "CONV_IN_GN_BWD_LAUNCHES": len(stacks)}
    want = {k: v * MICRO_BATCHES * steps for k, v in want.items()}
    want_products = stack_products(model, backward=True) * (
        MICRO_BATCHES * steps)
    phase("train", batch=TRAIN_BATCH, micro_batches=MICRO_BATCHES,
          steps=steps, seconds_per_step=seconds,
          samples_per_s=TRAIN_BATCH / seconds, losses=losses,
          max_memory_allocated=peak, stacks=len(stacks), layers=layers,
          launches=counts_, min_launches=want, gemm_tc_launches=products,
          want_gemm_tc_launches=want_products)
    short = {k: counts_[k] for k, v in want.items() if counts_[k] < v}
    if short or counts_["LAUNCHES"]:
        raise AssertionError(f"training launched the kernels {counts_}, "
                             f"expected at least {want} and no stash-less "
                             f"forward")
    if products != want_products:
        raise AssertionError(f"training sent {products} products to the "
                             f"tensor cores, expected {want_products}")
    # one step under the profiler: the card's time against the host clock
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, MICRO_BATCHES)
    step(state, cond, target, gen)
    torch.cuda.synchronize()
    products = tf.gemm_tc_launches()
    device_ms_, launches, wall_ms = device_busy(
        lambda: step(state, cond, target, gen))
    phase("train_profile", batch=TRAIN_BATCH, micro_batches=MICRO_BATCHES,
          device_ms=device_ms_, host_ms_untraced=seconds * 1e3,
          traced_wall_ms=wall_ms, launches=launches,
          gemm_tc_launches=tf.gemm_tc_launches() - products)
    return counts_


def fp32_step_vs_plain(dev, cls=None, preset=None, make_batch=None,
                       card_switches=False, what="fp32_step_vs_plain"):
    """One fp32 step at batch 8 through the kernels on the card (with both
    switches set to ``card_switches``) against the same step through the
    plain versions and the module composition on the CPU; the 91M inverse
    model unless told otherwise."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.train import trainer

    cls, preset = cls or QMDiffusion, preset or FLAGSHIP
    make_batch = make_batch or inverse_batch
    cpu_gen = torch.Generator().manual_seed(4)
    model32 = cls(**preset, dtype=torch.float32)
    init_parameters(model32, torch.Generator().manual_seed(0))
    batch = 8
    cond, target = make_batch(batch, cpu_gen, torch.device("cpu"))
    sigmas = torch.exp(-1.2 + 1.2 * torch.randn(batch, generator=cpu_gen))
    noise = torch.randn(target.shape, generator=cpu_gen)
    results = []
    for device, on in ((dev, card_switches), (torch.device("cpu"), False)):
        switches(on)
        m = copy.deepcopy(model32).to(device)
        o = trainer.make_optimizer(trainer.OptimizerConfig())
        loss = trainer.make_diffusion_train_step(m, o, MICRO_BATCHES)(
            trainer.TrainState.create(m, o), cond.to(device),
            target.to(device), sigmas=sigmas.to(device),
            noise=noise.to(device)).item()
        results.append((loss, {n: p.grad.cpu() for n, p in
                               m.named_parameters()}))
    switches(False)
    (card_loss, card_grads), (cpu_loss, cpu_grads) = results
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n], STEP_GRAD_FLOOR)
                   for n in cpu_grads)
    phase(what, model=cls.__name__, switches=card_switches, batch=batch,
          loss=card_loss, plain_loss=cpu_loss, loss_rel_err=loss_err,
          grad_rel_err=grad_err,
          tol={"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL})
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL):
        raise AssertionError(f"{what} {cls.__name__}: card vs CPU loss "
                             f"{loss_err}, grads {grad_err}")


_COUNTERS = {"transformer_fusion": (
    "LAUNCHES", "STASH_LAUNCHES", "UNIFORM_LAUNCHES", "CONV_OUT_BWD_LAUNCHES",
    "LAYER_BWD_LAUNCHES", "CONV_IN_GN_BWD_LAUNCHES"),
    "resnet_fusion": ("RESNET_LAUNCHES",),
    "flash_attention": ("FLASH_FWD_LAUNCHES", "FLASH_DQ_LAUNCHES",
                        "FLASH_DKV_LAUNCHES"),
    "attention": ("ATTENTION_LAUNCHES", "PACKED_ATTENTION_LAUNCHES")}


def attention_ops():
    """The module behind ``ops.attention`` (the name itself is the function,
    as in the JAX package)."""
    import importlib
    return importlib.import_module(
        "moleculediffusiontransformer_tpu_torch.ops.attention")


def _ops():
    from moleculediffusiontransformer_tpu_torch.ops import flash_attention
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion
    from moleculediffusiontransformer_tpu_torch.ops import transformer_fusion
    return {"transformer_fusion": transformer_fusion,
            "resnet_fusion": resnet_fusion,
            "flash_attention": flash_attention,
            "attention": attention_ops()}


def counts() -> dict:
    """Every kernel wrapper's launch count."""
    mods = _ops()
    return {n: getattr(mods[m], n) for m, names in _COUNTERS.items()
            for n in names}


def reset_counts() -> None:
    mods = _ops()
    for m, names in _COUNTERS.items():
        for n in names:
            setattr(mods[m], n, 0)


def switches(on: bool) -> None:
    """The resnet-run kernel and the shared-KV null half, both on or off."""
    mods = _ops()
    mods["resnet_fusion"].enable_resnet_fusion(on)
    mods["transformer_fusion"].enable_sharedkv(on)


def serve(model, requests, gen, num_steps, cond_scale, what, shape,
          min_launches):
    """Sample each request; check each output's shape (batch, *shape) and
    finiteness and each request's launches against ``min_launches``.
    Returns the launches of all requests together."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    reset_counts()
    results = []
    for props in requests:
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(model, props, gen, num_steps=num_steps,
                     cond_scale=cond_scale)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] - before[k]}
        results.append((props.shape[0], out, seconds, launches))
    total = counts()
    for b, out, seconds, launches in results:
        phase(what, batch=b, num_steps=num_steps, cond_scale=cond_scale,
              seconds=seconds, per_s=b / seconds, launches=launches,
              shape=list(out.shape), finite=bool(torch.isfinite(out).all()))
        if tuple(out.shape) != (b, *shape):
            raise AssertionError(f"{what} batch {b}: output shape "
                                 f"{out.shape}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{what} batch {b}: non-finite output")
        short = {k: (launches.get(k, 0), v) for k, v in min_launches.items()
                 if launches.get(k, 0) < v}
        if short:
            raise AssertionError(f"{what} batch {b}: launches (got, wanted) "
                                 f"{short}")
    return total


def train_steps(model, cond, target, gen, steps):
    """One warm-up and ``steps`` timed train steps at MICRO_BATCHES
    micro-batches: (losses, seconds a step, peak bytes)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, MICRO_BATCHES)
    losses = [step(state, cond, target, gen).item()]      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = [step(state, cond, target, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / max(steps, 1)
    losses += [t.item() for t in timed]
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite training loss: {losses}")
    return losses, seconds, torch.cuda.max_memory_allocated()


def inverse_batch(batch, gen, dev):
    """Property targets (b, 12) and one-hot SMILES tracks (b, 32, 22)."""
    import torch
    import torch.nn.functional as F
    cond = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    tokens = torch.randint(0, FLAGSHIP["pred_dim"],
                           (batch, FLAGSHIP["max_length"]), generator=gen,
                           device=dev)
    return cond, F.one_hot(tokens, FLAGSHIP["pred_dim"]).float()


def forward_batch(batch, gen, dev):
    """SMILES token ids / the vocabulary size (b, 64), and property tracks
    (b, 64, 1): 12 scaled properties, zero-padded (train/recipes.py)."""
    import torch
    ids = torch.randint(0, FORWARD_VOCAB, (batch, FORWARD["max_length"]),
                        generator=gen, device=dev)
    target = torch.zeros(batch, FORWARD["max_length"], 1, device=dev)
    target[:, :12, 0] = torch.rand(batch, 12, generator=gen,
                                   device=dev) * 2 - 1
    return ids.float() / FORWARD_VOCAB, target


def _resnet_case(dev, length, c, n, layout, cm, dtype, batch, seed):
    """A run of n blocks (modules and kernel weights) and its inputs."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.blocks import \
        ResnetBlock1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    gen = torch.Generator().manual_seed(seed)
    cin = 2 * c if layout == "up" else c
    blocks = []
    for _ in range(n):
        blk = ResnetBlock1d(cin, c, num_groups=8, context_mapping_features=cm,
                            dtype=dtype)
        init_parameters(blk, gen)
        with torch.no_grad():
            for p in blk.parameters():
                if p.dim() == 1:     # non-trivial norm scales and biases
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
        blocks.append(blk.to(dev))
    x = torch.randn(batch, length, c, generator=gen).to(dev, dtype)
    mp = torch.randn(batch, cm, generator=gen).to(dev, dtype)
    skips = ([torch.randn(batch, length, c, generator=gen).to(dev, dtype)
              for _ in range(n)] if layout == "up" else None)
    kw = dict(skip_scale=2 ** -0.5 if layout == "up" else 1.0,
              collect=layout == "down")
    return blocks, rf.kernel_weights(blocks, dtype), x, mp, skips, kw


def resnet_work(w, length: int, batch: int):
    """(operations, weight bytes) a resnet run needs: the convs' products
    over batch * length rows, the projections' and the FiLM products.  At
    L = 1 a conv's two outer taps see only zeros, so only the centre tap's
    products and third of the conv weights count."""
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    rows, taps = batch * length, 1 if length == 1 else 3
    flops, moved = 0, 0
    for ws in w:
        _, c1, fm, _, c2, proj = rf._split(ws, True)
        conv = (c1[0].numel() + c2[0].numel()) * taps // 3
        flops += 2 * rows * (conv + (proj[0].numel() if proj else 0))
        flops += 2 * batch * fm[0].numel()
        moved += (nbytes(*ws) - (c1[0].numel() + c2[0].numel())
                  * c1[0].element_size() * (3 - taps) // 3)
    return flops, moved


def check_resnet(dev):
    """Phase 8: K8 against its plain version at the eight resnet runs, then
    its gradients against the composition's.  Returns the largest bf16
    absolute error, the bf16 kernel (CUDA events around one call, and the
    card's time of calls back to back), plain and composition milliseconds
    summed over the runs, the bound of those calls and the tensor-core
    products of one call of each run."""
    import torch
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    summary = {"max_abs_err": 0.0, "ms": 0.0, "card_ms": 0.0,
               "plain_ms": 0.0, "composition_ms": 0.0, "products": {}}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        for name, length, c, n, layout, cm in RESNET_RUNS:
            blocks, w, x, mp, skips, kw = _resnet_case(
                dev, length, c, n, layout, cm, dtype, RESNET_BATCH,
                seed=length * c + n)
            with torch.no_grad():
                products = rf.gemm_tc_launches()
                out, outs = rf.resnet_stack_forward(w, x, mp, skips, **kw)
                torch.cuda.synchronize()
                products = rf.gemm_tc_launches() - products
                want_products = (rf.tc_products(w, True)
                                 if dtype == torch.bfloat16 else 0)
                ref, ref_outs = rf.resnet_stack_reference(w, x, mp, skips,
                                                          **kw)
                pairs = [(out, ref)] + list(zip(outs, ref_outs))
                rel = max(_rel_err(a, b) for a, b in pairs)
                err = max(_abs_err(a, b) for a, b in pairs)
                again, _ = rf.resnet_stack_forward(w, x, mp, skips, **kw)
                deterministic = torch.equal(out, again)
                t_kernel = cuda_ms(
                    lambda: rf.resnet_stack_forward(w, x, mp, skips, **kw))
                t_card = device_ms(
                    lambda: rf.resnet_stack_forward(w, x, mp, skips, **kw))
                t_plain = cuda_ms(
                    lambda: rf.resnet_stack_reference(w, x, mp, skips, **kw))
                t_comp = cuda_ms(lambda: rf.resnet_stack_composition(
                    blocks, x, mp, skips, skip_scale=kw["skip_scale"]))
            phase("resnet_kernel", run=name, dtype=dname, batch=RESNET_BATCH,
                  max_abs_err=err, rel_err=rel, tol=tol,
                  ref_max_abs=ref.float().abs().max().item(), ms=t_kernel,
                  card_ms=t_card, plain_ms=t_plain, composition_ms=t_comp,
                  deterministic=deterministic, gemm_tc_launches=products,
                  want_gemm_tc_launches=want_products)
            if products != want_products:
                raise AssertionError(f"{name} {dname}: K8 sent {products} "
                                     f"products to the tensor cores, "
                                     f"expected {want_products}")
            if not rel <= tol:
                raise AssertionError(f"{name} {dname}: K8 differs from its "
                                     f"plain version by {rel} of scale")
            if not deterministic:
                raise AssertionError(f"{name} {dname}: two K8 calls differ")
            if dtype == torch.bfloat16:
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
                summary["ms"] += t_kernel
                summary["card_ms"] += t_card
                summary["plain_ms"] += t_plain
                summary["composition_ms"] += t_comp
                summary["products"][name] = products
                flops, weight_bytes = resnet_work(w, length, RESNET_BATCH)
                add_bound(summary, bound(flops, weight_bytes + nbytes(
                    x, mp, *(skips or []), *(outs or [out]))))
    try:        # a tensor the kernel does not take raises, on the card too
        rf.resnet_stack_forward(w, x.half(), mp, skips, **kw)
    except TypeError:
        pass
    else:
        raise AssertionError("K8 took a float16 input")

    # gradients: the autograd function (kernel forward, autograd of the
    # module composition backward) against autograd of the composition
    for name, length, c, n, layout, cm in RESNET_RUNS:
        blocks, w, x, mp, skips, kw = _resnet_case(
            dev, length, c, n, layout, cm, torch.float32, RESNET_BATCH // 2,
            seed=length * c + n + 1)
        xg, mg = x.requires_grad_(), mp.requires_grad_()
        sg = [s.requires_grad_() for s in skips] if skips else None
        leaves = ([xg, mg] + (sg or [])
                  + [p for blk in blocks for p in blk.parameters()])
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(n)
                        ).to(dev)
        out, _ = rf.resnet_stack(blocks, w, xg, mg, sg, **kw)
        got = torch.autograd.grad(out, leaves, g)
        out, _ = rf.resnet_stack_composition(blocks, xg, mg, sg,
                                             skip_scale=kw["skip_scale"])
        want = torch.autograd.grad(out, leaves, g)
        rel = max(_rel_err(a, b) for a, b in zip(got, want))
        phase("resnet_grads", run=name, dtype="float32",
              batch=RESNET_BATCH // 2, rel_err=rel,
              tol=KERNEL_TOL["float32"])
        if not rel <= KERNEL_TOL["float32"]:
            raise AssertionError(f"{name}: K8 grads differ from the "
                                 f"composition's by {rel} of scale")
    return close_bound(summary)


def check_uniform(dev):
    """Phase 9: the uniform-context stack kernel against its plain version
    and the per-row kernel at the cross stacks' shapes.  Returns the largest
    bf16 absolute error, the bf16 kernel and plain milliseconds summed
    over the four shapes, and the bound of those calls."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    summary = {"max_abs_err": 0.0, "ms": 0.0, "card_ms": 0.0,
               "plain_ms": 0.0, "per_row_ms": 0.0}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        for name, length, c, layers, m in UNIFORM_STACKS:
            gen = torch.Generator().manual_seed(length * c + m)
            mod = Transformer1d(layers, c, 8, 64, 2,
                                context_features=CONTEXT[1], dtype=dtype)
            init_parameters(mod, gen)
            kp = mod.to(dev).kernel_params()
            x = torch.randn(NULL_HALF_BATCH, length, c, generator=gen).to(
                dev, dtype)
            table = torch.randn(1, m, CONTEXT[1], generator=gen).to(
                dev, dtype)
            rows = table.expand(NULL_HALF_BATCH, m, CONTEXT[1]).contiguous()
            kw = dict(num_layers=layers, heads=8, head_dim=64, multiplier=2)
            with torch.no_grad():
                out = tf.transformer1d_forward(kp, x, table, uniform_ctx=True,
                                               **kw)
                torch.cuda.synchronize()
                ref = tf.transformer1d_reference(kp, x, table,
                                                 uniform_ctx=True, **kw)
                per_row = tf.transformer1d_forward(kp, x, rows, **kw)
                rel = max(_rel_err(out, ref), _rel_err(out, per_row))
                err = _abs_err(out, ref)
                t_kernel = cuda_ms(lambda: tf.transformer1d_forward(
                    kp, x, table, uniform_ctx=True, **kw))
                t_card = device_ms(lambda: tf.transformer1d_forward(
                    kp, x, table, uniform_ctx=True, **kw))
                t_plain = cuda_ms(lambda: tf.transformer1d_reference(
                    kp, x, table, uniform_ctx=True, **kw))
                t_rows = cuda_ms(
                    lambda: tf.transformer1d_forward(kp, x, rows, **kw))
            phase("uniform_kernel", stack=name, dtype=dname,
                  batch=NULL_HALF_BATCH, context=m, max_abs_err=err,
                  rel_err=rel, tol=tol,
                  ref_max_abs=ref.float().abs().max().item(), ms=t_kernel,
                  card_ms=t_card, plain_ms=t_plain, per_row_kernel_ms=t_rows)
            if not rel <= tol:
                raise AssertionError(f"{name} {dname}: the uniform-context "
                                     f"kernel differs by {rel} of scale")
            if dtype == torch.bfloat16:
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
                summary["ms"] += t_kernel
                summary["card_ms"] += t_card
                summary["plain_ms"] += t_plain
                summary["per_row_ms"] += t_rows
                add_bound(summary, bound(
                    stack_flops(NULL_HALF_BATCH, length, c, layers, True, m,
                                CONTEXT[1], kv_rows=m),
                    nbytes(x, out, table, *tf._kernel_weights(
                        kp, layers, True, dtype))))
    return close_bound(summary)


def ab(what, run):
    """Both switches on against both off, turns on/off/off/on, one number
    from ``run()`` per turn."""
    turns = []
    for on in (True, False, False, True):
        switches(on)
        turns.append(["on" if on else "off", run()])
    switches(False)
    phase("ab", what=what, turns=turns)


def timed_request(model, props, gen, num_steps, cond_scale):
    """Molecules (or property tracks) per second of one request."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(model, props, gen, num_steps=num_steps, cond_scale=cond_scale)
    torch.cuda.synchronize()
    return props.shape[0] / (time.perf_counter() - t0)


def timed_training(step, state, cond, target, gen):
    """Samples per second of AB_TRAIN_STEPS train steps."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AB_TRAIN_STEPS):
        loss = step(state, cond, target, gen)
    torch.cuda.synchronize()
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss.item()}")
    return cond.shape[0] * AB_TRAIN_STEPS / (time.perf_counter() - t0)


@contextlib.contextmanager
def flash_switch(on: bool):
    """``MDT_FLASH`` set to on or off for the block, then put back."""
    old = os.environ.get("MDT_FLASH")
    os.environ["MDT_FLASH"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MDT_FLASH"]
        else:
            os.environ["MDT_FLASH"] = old


def check_flash(dev):
    """Phase 15: K5, K6 and K7 against their plain versions.  Returns, per
    kernel, the numbers of the kernels line: bf16 at bh 16, n = m = 4096,
    d 64, the long model's attention at batch 2.  The kernels and the
    library calls are timed two ways: ``ms``, CUDA events around one call
    (``cuda_ms``, host time to make the call included, as every earlier
    record of them), and ``card_ms``, 20 calls enqueued back to back behind
    a busy card (``device_ms``): the card's time alone, which is what a call
    costs inside a model that keeps the card busy."""
    import torch
    import torch.nn.functional as F
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    summary = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        shapes = FLASH_SHAPES + (FLASH_BF16_SHAPES
                                 if dtype == torch.bfloat16 else [])
        for bh, n, m, d in shapes:
            scale = d ** -0.5
            gen = torch.Generator().manual_seed(bh + n + m + d)
            q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype)
                           for shape in ((bh, n, d), (bh, m, d), (bh, m, d),
                                         (bh, n, d)))
            reps = 5 if bh > 16 else 10
            with torch.no_grad():
                o, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
                o_again, lse_again = fa.flash_forward(q, k, v, scale,
                                                      with_lse=True)
                torch.cuda.synchronize()
                ref_o, ref_lse = fa.flash_attention_reference(q, k, v, scale)
                got = fa.flash_backward(q, k, v, ref_o, ref_lse, do, scale)
                again = fa.flash_backward(q, k, v, ref_o, ref_lse, do, scale)
                want = fa.flash_attention_backward_reference(
                    q, k, v, ref_o, ref_lse, do, scale)
                pairs = {"fwd": [(o, ref_o), (lse, ref_lse)],
                         "dq": [(got[0], want[0])],
                         "dkv": [(got[1], want[1]), (got[2], want[2])]}
                rel = {key: max(_rel_err(a, b) for a, b in ps)
                       for key, ps in pairs.items()}
                err = {key: max(_abs_err(a, b) for a, b in ps)
                       for key, ps in pairs.items()}
                deterministic = (torch.equal(o, o_again)
                                 and torch.equal(lse, lse_again)
                                 and all(torch.equal(a, b)
                                         for a, b in zip(got, again)))
                del got, again, want, o_again, lse_again
                # K6 and K7 are launched together by the wrapper: time the
                # forward, then each backward kernel alone
                fwd = {"fwd": lambda: fa.flash_forward(q, k, v, scale)}
                lib = fa._bwd_library()
                di = (ref_o.float() * do.float()).sum(dim=-1)
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
                ins = [t.data_ptr() for t in (q, k, v, do, ref_lse, di)]
                tail = fa._args((q, k, v, do, dq, dk, dv), q, k, scale)

                def launch(fn, *outs):
                    code = fn(*ins, *[t.data_ptr() for t in outs], *tail)
                    if code:
                        raise AssertionError(f"launch failed: {code}")

                calls = {**fwd,
                         "dq": lambda: launch(lib.fa_backward_dq, dq),
                         "dkv": lambda: launch(lib.fa_backward_dkv, dk, dv)}
                ms = {key: cuda_ms(fn, reps=reps)
                      for key, fn in calls.items()}
                card = {key: device_ms(fn) for key, fn in calls.items()}
                plain = {"fwd": cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, scale), reps=reps)}
                plain["dq"] = plain["dkv"] = cuda_ms(
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, ref_o, ref_lse, do, scale), reps=reps)
            library = {"fwd": None, "bwd": None}
            library_card = dict(library)
            if dtype == torch.bfloat16:
                q4, k4, v4 = (t[None] for t in (q, k, v))
                leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]

                def lib_fwd():
                    with torch.no_grad():
                        F.scaled_dot_product_attention(q4, k4, v4,
                                                       scale=scale)

                def lib_both():
                    torch.autograd.grad(F.scaled_dot_product_attention(
                        *leaves, scale=scale), leaves, do[None])

                for into, timer in ((library, lambda fn: cuda_ms(
                        fn, reps=reps)), (library_card, device_ms)):
                    into["fwd"] = timer(lib_fwd)
                    into["bwd"] = timer(lib_both) - into["fwd"]
            work = bh * n * m * d
            flops = {"fwd": 4 * work, "dq": 6 * work, "dkv": 8 * work}
            tflops = {key: f / ms[key] / 1e9 for key, f in flops.items()}
            card_tflops = {key: f / card[key] / 1e9
                           for key, f in flops.items()}
            exp_ms = exp_bound_ms(bh * n * m)
            phase("flash_kernels", bh=bh, n=n, m=m, d=d, dtype=dname,
                  rel_err=rel, max_abs_err=err, tol=tol,
                  deterministic=deterministic, ms=ms, tflops=tflops,
                  card_ms=card, card_tflops=card_tflops, plain_ms=plain,
                  library_ms=library, library_card_ms=library_card,
                  exp_bound_ms=exp_ms)
            bad = {key: e for key, e in rel.items() if not e <= tol}
            if bad:
                raise AssertionError(f"flash bh {bh} n {n} m {m} d {d} "
                                     f"{dname}: kernels differ from their "
                                     f"plain versions: {bad}")
            if not deterministic:
                raise AssertionError(f"flash bh {bh} n {n} m {m} d {d} "
                                     f"{dname}: two calls differ")
            if dtype == torch.bfloat16 and (bh, n, m, d) == FLASH_SHAPES[0]:
                rows = nbytes(ref_lse, di)
                limits = {
                    "fwd": bound(4 * work, nbytes(q, k, v, o)),
                    "dq": bound(6 * work, nbytes(q, k, v, do, dq) + rows),
                    "dkv": bound(8 * work,
                                 nbytes(q, k, v, do, dk, dv) + rows)}
                for key in ("fwd", "dq", "dkv"):
                    lib_key = "fwd" if key == "fwd" else "bwd"
                    summary[key] = close_bound(dict(
                        max_abs_err=err[key], ms=ms[key],
                        plain_ms=plain[key], bound_ms=max(
                            limits[key].values()), **limits[key],
                        library_ms=library[lib_key]))
                    summary[key].update(
                        tflops=tflops[key], card_ms=card[key],
                        card_tflops=card_tflops[key],
                        library_card_ms=library_card[lib_key],
                        exp_bound_ms=exp_ms)
    check_split_heads(dev)
    return summary


def check_split_heads(dev):
    """Phase 15, last case: the three kernels on the long model's split
    heads -- q and do transposed views of (b, n, h d) projections, k and v
    ``.chunk`` views of one (b, n, 2 h d) projection, as ``AttentionBase``
    hands them over -- against their plain versions on the same views and,
    bit for bit, against the same values made contiguous; with the card's
    times (``device_ms``) of K5 on the views, on contiguous copies, and of
    the copies the wrapper made before the kernels took strides."""
    import torch
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    b, h, n, d = FLASH_SPLIT_HEADS
    scale, tol = d ** -0.5, KERNEL_TOL["bfloat16"]
    gen = torch.Generator().manual_seed(b + h + n + d)

    def split(t):
        return t.reshape(b, n, h, d).transpose(1, 2)

    proj_q, proj_do = (torch.randn(b, n, h * d, generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    proj_kv = torch.randn(b, n, 2 * h * d, generator=gen).to(
        dev, torch.bfloat16)
    q, do = split(proj_q), split(proj_do)
    k, v = (split(t) for t in proj_kv.chunk(2, dim=-1))
    flat = [t.contiguous() for t in (q, k, v)]
    with torch.no_grad():
        o, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
        got = fa.flash_backward(q, k, v, o, lse, do, scale)
        o_flat, lse_flat = fa.flash_forward(*flat, scale, with_lse=True)
        got_flat = fa.flash_backward(*flat, o_flat, lse_flat,
                                     do.contiguous(), scale)
        torch.cuda.synchronize()
        same = (torch.equal(o, o_flat) and torch.equal(lse, lse_flat) and all(
            torch.equal(a, w) for a, w in zip(got, got_flat)))
        merge_free = o.transpose(1, 2).is_contiguous() and all(
            g.transpose(1, 2).is_contiguous() for g in got)
        del o_flat, lse_flat, got_flat
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v, scale)
        rel = {"o": _rel_err(o, ref_o), "lse": _rel_err(lse, ref_lse)}
        want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     scale)
        rel.update({name: _rel_err(g, w) for name, g, w in
                    zip(("dq", "dk", "dv"), got, want)})
        del want, ref_o
        ms = {"strided": device_ms(lambda: fa.flash_forward(q, k, v, scale)),
              "contiguous": device_ms(lambda: fa.flash_forward(*flat,
                                                               scale)),
              "copies": device_ms(lambda: [t.contiguous()
                                           for t in (q, k, v)])}
    phase("flash_split_heads", b=b, h=h, n=n, d=d, dtype="bfloat16",
          rel_err=rel, tol=tol, equal_to_contiguous=same,
          outputs_merge_free=merge_free, fwd_card_ms=ms)
    if not (same and merge_free and all(e <= tol for e in rel.values())):
        raise AssertionError(f"flash kernels on split heads: {rel}, equal "
                             f"to contiguous {same}, outputs merge free "
                             f"{merge_free}")


def check_crossover(dev):
    """Phase 16: streaming against one-shot attention over the length, on
    split-head views as the model hands them over: each route's time a call
    with CUDA events around one call (host and device) and with calls
    enqueued back to back (the card's time, as inside a model that keeps
    the card busy)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import sdpa
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    b, h, d = 2, 8, 64
    scale = d ** -0.5
    rows = []
    for n in CROSSOVER_LENGTHS:
        gen = torch.Generator().manual_seed(n)
        q, k, v, do = (torch.randn(b, n, h, d, generator=gen).to(
            dev, torch.bfloat16).transpose(1, 2) for _ in range(4))
        reps = 5 if n > 4096 else 10
        row = {"n": n}
        routes = (("one_shot", lambda *t: sdpa(*t, scale, torch.bfloat16)),
                  ("flash", lambda *t: fa.flash_attention(*t, scale=scale)))
        for name, timer in (("", lambda fn: cuda_ms(fn, reps=reps)),
                            ("device_", device_ms)):
            for route, fn in routes:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                # the switch off: sdpa takes the one-shot product
                with flash_switch(False):
                    with torch.no_grad():
                        row[f"{route}_fwd_{name}ms"] = timer(
                            lambda: fn(q, k, v))
                    row[f"{route}_fwd_bwd_{name}ms"] = timer(
                        lambda: torch.autograd.grad(fn(*leaves), leaves, do))
        rows.append(row)
    phase("flash_crossover", bh=b * h, d=d, dtype="bfloat16", rows=rows,
          threshold=fa.LONG_SEQ_THRESHOLD)
    return rows


def long_model(dev, dtype, seed=7):
    from moleculediffusiontransformer_tpu_torch.models import audio
    import torch
    return audio.build_model1d(device=dev,
                               generator=torch.Generator().manual_seed(seed),
                               dtype=dtype, **LONG)


def routed_layers(model, samples: int):
    """(attention layers whose self-attention streams, all attention
    layers, their token counts) for a waveform of ``samples``, read from
    the model: one eval with a hook on every Transformer1d stack."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].shape[1])))
        for m in model.modules() if isinstance(m, Transformer1d)]
    dev = next(model.parameters()).device
    with torch.no_grad():
        model.denoise(torch.zeros(1, samples, LONG["in_channels"],
                                  device=dev), torch.ones(1, device=dev))
    for hook in hooks:
        hook.remove()
    routed = sum(mod.num_layers for mod, tokens in seen
                 if tokens >= fa.LONG_SEQ_THRESHOLD
                 and fa.flash_takes(tokens, tokens, mod.head_features,
                                    mod.dtype))
    return routed, sum(mod.num_layers for mod, _ in seen), [
        tokens for _, tokens in seen]


def long_request(model, samples, batch, gen, steps=LONG_STEPS):
    """One ``sample_model1d`` request: (output, seconds, peak bytes)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    noise = torch.randn(batch, samples, LONG["in_channels"], generator=gen,
                        device=gen.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = audio.sample_model1d(model, noise, num_steps=steps)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def long_serve(model, samples, gen):
    """Phase 17 for one waveform length: a request at each batch size.
    Returns the launches of all its requests together."""
    import torch
    routed, layers, tokens = routed_layers(model, samples)
    evals = LONG_STEPS - 1
    long_request(model, samples, 1, gen, steps=3)            # warm-up
    total = dict.fromkeys(counts(), 0)
    for batch in LONG_BATCHES:
        reset_counts()
        out, seconds, peak = long_request(model, samples, batch, gen)
        launched = counts()
        total = {k: total[k] + launched[k] for k in total}
        want = {k: 0 for k in launched}
        want["FLASH_FWD_LAUNCHES"] = evals * routed
        lo, hi = out.min().item(), out.max().item()
        phase("long_request", samples=samples, batch=batch,
              num_steps=LONG_STEPS, evals=evals, attention_tokens=tokens,
              attention_layers=layers, attention_layers_streamed=routed,
              launches={k: v for k, v in launched.items() if v},
              expected_flash_fwd_launches=want["FLASH_FWD_LAUNCHES"],
              seconds=seconds, samples_per_s=batch / seconds,
              max_memory_allocated=peak, shape=list(out.shape),
              finite=bool(torch.isfinite(out).all()), min=lo, max=hi)
        if tuple(out.shape) != (batch, samples, LONG["in_channels"]):
            raise AssertionError(f"long request: output shape {out.shape}")
        if not (torch.isfinite(out).all() and -1.0 <= lo and hi <= 1.0):
            raise AssertionError(f"long request {samples} x {batch}: output "
                                 f"not finite in [-1, 1]: {lo}, {hi}")
        if launched != want:
            raise AssertionError(f"long request {samples} x {batch}: "
                                 f"launches {launched}, expected {want}")
    return total


def long_train_steps(model, x, gen, steps):
    """One warm-up and ``steps`` timed steps of the long model: (losses,
    seconds a step, peak bytes)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_model1d_train_step(model, opt)
    losses = [step(state, x, gen).item()]                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = [step(state, x, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / max(steps, 1)
    losses += [t.item() for t in timed]
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite training loss: {losses}")
    return losses, seconds, torch.cuda.max_memory_allocated()


def long_train(dev, samples, batch, steps=TIMED_STEPS):
    """Phase 18 for one (length, batch).  Returns the launches."""
    import torch
    model = long_model(dev, torch.bfloat16).train()
    routed, layers, tokens = routed_layers(model, samples)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand(batch, samples, LONG["in_channels"], generator=gen,
                   device=dev) * 2 - 1
    reset_counts()
    losses, seconds, peak = long_train_steps(model, x, gen, steps)
    launched = counts()
    want = {k: 0 for k in launched}
    for k in _COUNTERS["flash_attention"]:
        want[k] = routed * (1 + steps)
    phase("long_train", samples=samples, batch=batch, steps=1 + steps,
          attention_tokens=tokens, attention_layers=layers,
          attention_layers_streamed=routed, seconds_per_step=seconds,
          samples_per_s=batch / seconds, losses=losses,
          max_memory_allocated=peak,
          launches={k: v for k, v in launched.items() if v},
          expected_launches_each=routed * (1 + steps))
    if launched != want:
        raise AssertionError(f"long training {samples} x {batch}: launches "
                             f"{launched}, expected {want}")
    return launched


def ab_flash(what, run):
    """``MDT_FLASH`` on against off, turns on/off/off/on; ``run()`` gives a
    number and the peak bytes of its turn."""
    turns = []
    for on in (True, False, False, True):
        with flash_switch(on):
            value, peak = run()
        turns.append(["on" if on else "off", value, peak])
    phase("ab_flash", what=what, turns=turns)


def long_fp32_vs_plain(dev):
    """Phase 19: a float32 batch-1 training step and a 4-step sample of the
    long model at PARITY_SAMPLES through K5-K7 on the card against the
    plain versions on the CPU."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    from moleculediffusiontransformer_tpu_torch.train import trainer
    cpu = torch.device("cpu")
    model32 = long_model(cpu, torch.float32)
    gen = torch.Generator().manual_seed(12)
    shape = (1, PARITY_SAMPLES, LONG["in_channels"])
    x = torch.rand(shape, generator=gen) * 2 - 1
    sigmas = torch.rand(1, generator=gen)
    noise = torch.randn(shape, generator=gen)
    start = torch.randn(shape, generator=gen)
    results = []
    for device in (dev, cpu):
        m = copy.deepcopy(model32).to(device)
        o = trainer.make_optimizer(trainer.OptimizerConfig())
        reset_counts()
        loss = trainer.make_model1d_train_step(m, o)(
            trainer.TrainState.create(m, o), x.to(device),
            sigmas=sigmas.to(device), noise=noise.to(device)).item()
        grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
        # the step moved m's parameters: sample from the untouched copy
        m = copy.deepcopy(model32).to(device)
        sampled = audio.sample_model1d(m, start, num_steps=4).cpu()
        results.append((loss, grads, sampled, counts()))
    (card_loss, card_grads, card_out, launched), (
        cpu_loss, cpu_grads, cpu_out, cpu_launched) = results
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n], STEP_GRAD_FLOOR)
                   for n in cpu_grads)
    sample_err = _abs_err(card_out, cpu_out)
    flash = {k: launched[k] for k in _COUNTERS["flash_attention"]}
    phase("long_fp32_vs_plain", samples=PARITY_SAMPLES, batch=1,
          loss=card_loss, plain_loss=cpu_loss, loss_rel_err=loss_err,
          grad_rel_err=grad_err, sample_max_abs_err=sample_err,
          launches=flash, tol={"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL,
                               "sample": SAMPLE_TOL})
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
            and sample_err <= SAMPLE_TOL):
        raise AssertionError(f"long model fp32, card vs CPU: loss "
                             f"{loss_err}, grads {grad_err}, sample "
                             f"{sample_err}")
    if not all(flash.values()) or any(cpu_launched.values()):
        raise AssertionError(f"long model fp32: the card launched {flash}, "
                             f"the CPU run {cpu_launched}")


def _qkv(dev, bh, n, m, d, dtype):
    import torch
    gen = torch.Generator().manual_seed(bh + n + m + d)
    return [torch.randn(shape, generator=gen).to(dev, dtype)
            for shape in ((bh, n, d), (bh, m, d), (bh, m, d))]


def mqa_core_ms(dev, bh, m, d, heads, dtype):
    """Milliseconds of the multi-query attention math as ``MQAttention``
    runs it in a decode step (one KV track shared by the heads, a mask, the
    scores in float32) at the problem size of a (bh, 1, m, d) call."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.transformer_blocks import \
        NEG_INF
    b = bh // heads
    gen = torch.Generator().manual_seed(m)
    q = torch.randn(b, heads, 1, d, generator=gen).to(dev, dtype)
    kv = torch.randn(b, m, d, generator=gen).to(dev, dtype)
    mask = torch.ones(m, dtype=torch.bool, device=dev)

    def core():
        sim = torch.matmul(q.float(), kv.float().transpose(1, 2)[:, None])
        sim = torch.where(mask, sim, NEG_INF)
        attn = torch.softmax(sim, dim=-1).to(dtype)
        return torch.matmul(attn, kv[:, None])

    with torch.no_grad():
        return device_ms(core)


def check_attention(dev):
    """Phase 21: K9 and K10 against their plain version at the 11 shapes
    and the route edges.  Returns each kernel's bf16 numbers at its AR
    decode shape."""
    import torch
    import torch.nn.functional as F
    at = attention_ops()
    rows = {"attention": {}, "packed_attention": {}}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        for shape in attention_shapes(at, dtype):
            bh, n, m, d = shape
            edge = shape not in ATTENTION_SHAPES
            q, k, v = _qkv(dev, bh, n, m, d, dtype)
            scale = d ** -0.5
            fns = {"attention": at.attention}
            if max(n, m) <= at.PACK_MAX:
                fns["packed_attention"] = at.packed_attention
            with torch.no_grad():
                ref = at.attention_reference(q, k, v, scale)
                # these calls are shorter than the host takes to make
                # them: device_ms times them back to back on the card
                plain_ms = device_ms(
                    lambda: at.attention_reference(q, k, v, scale))
                # one problem a batch element, one head
                q4, k4, v4 = (t[:, None] for t in (q, k, v))
                library_ms = device_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                           scale=scale))
                module_ms = (mqa_core_ms(dev, bh, m, d, AR_PRESET["heads"],
                                         dtype)
                             if shape in AR_DECODE_SHAPES.values() else None)
                limit = bound(4 * bh * n * m * d, nbytes(q, k, v, ref))
                route = at.plan(bh, n, m, d, dtype).route
                for name, fn in fns.items():
                    out, again = fn(q, k, v), fn(q, k, v)
                    torch.cuda.synchronize()
                    rel, err = _rel_err(out, ref), _abs_err(out, ref)
                    same = torch.equal(out, again)
                    ms = device_ms(lambda: fn(q, k, v))
                    # the same calls on inputs no call finds in L2
                    cold = device_ms(cold_fn(fn, dev, bh, n, m, d, dtype))
                    # one call between two events: the host's time a call
                    call_ms = cuda_ms(lambda: fn(q, k, v))
                    row = close_bound(dict(
                        max_abs_err=err, ms=ms, cold_ms=cold,
                        plain_ms=plain_ms, bound_ms=max(limit.values()),
                        **limit, library_ms=library_ms, route=route))
                    phase("attention_kernel", kernel=name, bh=bh, n=n, m=m,
                          d=d, dtype=dname, edge=edge, rel_err=rel, tol=tol,
                          deterministic=same, mqa_module_ms=module_ms,
                          host_call_ms=call_ms, **row)
                    if not rel <= tol:
                        raise AssertionError(
                            f"{name} {shape} {dname}: kernel differs from "
                            f"the plain version by {rel} of its scale")
                    if not same:
                        raise AssertionError(f"{name} {shape} {dname}: two "
                                             f"calls differ")
                    if dtype == torch.bfloat16 and not edge:
                        rows[name][shape] = row
            del q, k, v, ref
            torch.cuda.empty_cache()
    for name, by_shape in rows.items():
        phase("attention_summary", kernel=name, dtype="bfloat16",
              shapes=len(by_shape),
              **{key: sum(r[key] for r in by_shape.values())
                 for key in ("ms", "cold_ms", "plain_ms", "library_ms",
                             "bound_ms")})
    return {name: rows[name][shape]
            for name, shape in AR_DECODE_SHAPES.items()}


def drive_attention_entry_points(dev):
    """The main path of K9 and K10: no model calls them in either package,
    so it is a call of the public ``ops.attention`` and
    ``ops.packed_attention`` at the AR decode shapes, the counts set to 0
    before and read after.  ``packed_attention`` launches K10 at m 13 and
    goes to K9 at m 65."""
    import torch
    from moleculediffusiontransformer_tpu_torch import ops
    at = attention_ops()
    inputs = [_qkv(dev, *shape, torch.bfloat16)
              for shape in AR_DECODE_SHAPES.values()]
    reset_counts()
    with torch.no_grad():
        outs = [(fn(q, k, v), (q, k, v)) for q, k, v in inputs
                for fn in (ops.attention, ops.packed_attention)]
    torch.cuda.synchronize()
    launched = counts()
    worst = max(_rel_err(out, at.attention_reference(
        *qkv, qkv[0].shape[-1] ** -0.5)) for out, qkv in outs)
    want = {k: 0 for k in launched}
    want.update(ATTENTION_LAUNCHES=3, PACKED_ATTENTION_LAUNCHES=1)
    phase("attention_entry_points", shapes=list(AR_DECODE_SHAPES.values()),
          dtype="bfloat16", rel_err=worst, tol=KERNEL_TOL["bfloat16"],
          launches={k: v for k, v in launched.items() if v})
    if launched != want or not worst <= KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"attention entry points: launches {launched}, "
                             f"expected {want}; error {worst}")
    return launched


def ar_model(dev, dtype, seed=13):
    import torch
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        MoleculeTransformerSequence
    return MoleculeTransformerSequence(
        device=dev, dtype=dtype,
        generator=torch.Generator().manual_seed(seed), **AR_PRESET)


def ar_request(model, batch, gen, tokens=AR_TOKENS):
    """One ``generate_sequence`` request: (ids, seconds)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        generate_sequence
    dev = gen.device
    props = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    start = torch.ones(batch, 1, dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = generate_sequence(model, props, start, gen,
                            tokens_to_generate=tokens,
                            cond_scale=AR_COND_SCALE,
                            filter_thres=AR_FILTER_THRES)
    torch.cuda.synchronize()
    return ids, time.perf_counter() - t0


def device_busy(fn):
    """(device ms, kernel launches, traced wall ms) of ``fn()`` under
    ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if evt.device_type == DeviceType.CUDA:
            device_us += float(getattr(evt, "self_device_time_total",
                                       getattr(evt, "self_cuda_time_total",
                                               0.0)))
    return device_us / 1e3, launches, wall_ms


def stack_products(model, backward: bool = False) -> int:
    """Products one forward of the model's Transformer1d stacks sends to the
    tensor-core GEMM in bf16 (gemm_tc.cuh); with ``backward``, those of the
    stash forward and of the backward chain: K3, K2 over the layers and K4
    (``transformer_fusion.stack_products``, ``CONV_BWD_PRODUCTS``)."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    total = 0
    for m in model.modules():
        if isinstance(m, Transformer1d):
            cross = bool(m.context_features)
            total += tf.stack_products(m.num_layers, cross)
            if backward:
                total += (tf.stack_products(m.num_layers, cross, backward=True)
                          + 2 * tf.CONV_BWD_PRODUCTS)
    return total


def eval_profile(model, batch, gen, evals: int = 3) -> dict:
    """One denoise evaluation of a QM model at ``batch`` requests under CFG
    (the ADPM2 sampler's call, 2 x batch rows): device ms from a short
    ``torch.profiler`` window over ``evals`` calls, kernel launches, the
    host clock of untraced calls, and tensor-core GEMM launches, each a
    call."""
    import torch
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    dev = next(model.parameters()).device
    props = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    x = torch.randn(batch, model.max_length, model.pred_dim, generator=gen,
                    device=dev)
    sigmas = torch.full((batch,), 1.0, device=dev)

    def run():
        for _ in range(evals):
            model.denoise(x, sigmas, emb, COND_SCALE)

    with torch.no_grad():
        emb = model.embed_conditioning(props)
        run()
        torch.cuda.synchronize()
        products = tf.gemm_tc_launches()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / evals
        products = tf.gemm_tc_launches() - products
        device_ms_, launches, wall_ms = device_busy(run)
    return {"device_ms": device_ms_ / evals, "host_ms": host_ms,
            "traced_wall_ms": wall_ms / evals, "launches": launches / evals,
            "gemm_tc_launches": products / evals}


def ar_serve(dev):
    """Phase 22, bfloat16: the requests and the traced ones."""
    import torch
    model = ar_model(dev, torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(14)
    ar_request(model, 1, gen, tokens=4)                       # warm-up
    reset_counts()
    for batch in AR_REQUESTS:
        ids, seconds = ar_request(model, batch, gen)
        lo, hi = ids.min().item(), ids.max().item()
        phase("ar_request", batch=batch, tokens=AR_TOKENS,
              cond_scale=AR_COND_SCALE, filter_thres=AR_FILTER_THRES,
              seconds=seconds, tokens_per_s=batch * AR_TOKENS / seconds,
              shape=list(ids.shape), min=lo, max=hi,
              distinct_ids=int(ids[:, 1:].unique().numel()))
        if tuple(ids.shape) != (batch, 1 + AR_TOKENS):
            raise AssertionError(f"AR request {batch}: ids {ids.shape}")
        if not (bool((ids[:, 0] == 1).all()) and 0 <= lo
                and hi < AR_PRESET["logits_dim"]):
            raise AssertionError(f"AR request {batch}: start column or id "
                                 f"range wrong: {lo}, {hi}")
    stray = {k: v for k, v in counts().items() if v}
    if stray:
        raise AssertionError(f"the AR model launched {stray}: no kernel "
                             f"lies on its path")
    # a shorter request keeps the trace small; every decode step is alike
    for batch in (AR_REQUESTS[0], AR_REQUESTS[-1]):
        device_ms, launches, wall_ms = device_busy(
            lambda: ar_request(model, batch, gen, tokens=AR_TRACED_TOKENS))
        phase("ar_request_traced", batch=batch, tokens=AR_TRACED_TOKENS,
              device_ms=device_ms, kernel_launches=launches,
              traced_wall_ms=wall_ms, device_busy_share=device_ms / wall_ms)


def ar_fp32_request_vs_cpu(dev):
    """Phase 22, float32: a batch-8 request on the card against the CPU on
    the same uniforms."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        generate_sequence
    from moleculediffusiontransformer_tpu_torch.nn.transformer_blocks import (
        gumbel_noise, top_k_filter)
    cpu = torch.device("cpu")
    model32 = ar_model(cpu, torch.float32)
    gen = torch.Generator().manual_seed(15)
    batch = 8
    props = torch.rand(batch, 12, generator=gen) * 2 - 1
    start = torch.ones(batch, 1, dtype=torch.long)
    uniforms = torch.rand(AR_TOKENS, batch, AR_PRESET["logits_dim"],
                          generator=gen)
    results = []
    for device in (dev, cpu):
        m = copy.deepcopy(model32).to(device).eval()
        ids, logits = generate_sequence(
            m, props.to(device), start.to(device),
            uniforms=uniforms.to(device), tokens_to_generate=AR_TOKENS,
            cond_scale=AR_COND_SCALE, filter_thres=AR_FILTER_THRES,
            return_logits=True)
        results.append((ids.cpu(), logits.cpu()))
    (card_ids, card_logits), (cpu_ids, cpu_logits) = results
    # a row is compared until its first differing token, which is allowed
    # only at a near-tie of the perturbed logits
    alive = torch.ones(batch, dtype=torch.bool)
    worst, unexplained = 0.0, 0
    for pos in range(AR_TOKENS):
        if alive.any():
            err = (card_logits[pos] - cpu_logits[pos]).abs().amax(dim=-1)
            worst = max(worst, err[alive].max().item())
        perturbed = (top_k_filter(cpu_logits[pos], AR_FILTER_THRES)
                     + gumbel_noise(uniforms[pos]))
        top2 = perturbed.topk(2, dim=-1).values
        differ = card_ids[:, pos + 1] != cpu_ids[:, pos + 1]
        unexplained += int((alive & differ
                            & (top2[:, 0] - top2[:, 1] > AR_GAP)).sum())
        alive &= ~differ
    phase("ar_fp32_request_vs_cpu", batch=batch, tokens=AR_TOKENS,
          logits_max_abs_err=worst, tol=AR_LOGIT_TOL, near_tie_gap=AR_GAP,
          rows_equal_to_the_end=int(alive.sum()),
          tokens_differing_without_a_near_tie=unexplained)
    if not worst <= AR_LOGIT_TOL or unexplained:
        raise AssertionError(f"AR fp32 request, card vs CPU: logits {worst}, "
                             f"{unexplained} tokens differ without a near "
                             f"tie")


def ar_batch(batch, gen, dev):
    """Property targets (b, 12) and token ids (b, 64)."""
    import torch
    props = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    ids = torch.randint(0, AR_PRESET["logits_dim"], (batch, AR_TRAIN_TOKENS),
                        generator=gen, device=dev)
    return props, ids


def ar_train(dev, steps=TIMED_STEPS):
    """Phase 23, bfloat16: one warm-up and ``steps`` timed steps."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    model = ar_model(dev, torch.bfloat16).train()
    gen = torch.Generator(device=dev).manual_seed(16)
    props, ids = ar_batch(AR_TRAIN_BATCH, gen, dev)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_transformer_train_step(model, opt)
    reset_counts()
    losses = [step(state, props, ids, gen).item()]            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = [step(state, props, ids, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / steps
    losses += [t.item() for t in timed]
    phase("ar_train", batch=AR_TRAIN_BATCH, tokens=AR_TRAIN_TOKENS,
          steps=1 + steps, seconds_per_step=seconds,
          samples_per_s=AR_TRAIN_BATCH / seconds,
          tokens_per_s=AR_TRAIN_BATCH * AR_TRAIN_TOKENS / seconds,
          losses=losses, max_memory_allocated=torch.cuda.max_memory_allocated())
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite AR training loss: {losses}")
    stray = {k: v for k, v in counts().items() if v}
    if stray:
        raise AssertionError(f"AR training launched {stray}: no kernel lies "
                             f"on its path")


def ar_fp32_step_vs_cpu(dev):
    """Phase 23, float32: one batch-8 step on the card against the CPU,
    with the same conditioning-dropout mask."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    cpu = torch.device("cpu")
    model32 = ar_model(cpu, torch.float32)
    gen = torch.Generator().manual_seed(17)
    props, ids = ar_batch(8, gen, cpu)
    keep = torch.tensor([True, False, True, True, False, True, True, True])
    results = []
    for device in (dev, cpu):
        m = copy.deepcopy(model32).to(device).train()
        o = trainer.make_optimizer(trainer.OptimizerConfig())
        loss = trainer.make_transformer_train_step(m, o)(
            trainer.TrainState.create(m, o), props.to(device),
            ids.to(device), keep=keep.to(device)).item()
        results.append((loss, {n: p.grad.cpu()
                               for n, p in m.named_parameters()}))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = results
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n], STEP_GRAD_FLOOR)
                   for n in cpu_grads)
    phase("ar_fp32_step_vs_cpu", batch=8, loss=card_loss, plain_loss=cpu_loss,
          loss_rel_err=loss_err, grad_rel_err=grad_err,
          tol={"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL})
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL):
        raise AssertionError(f"AR fp32 step, card vs CPU: loss {loss_err}, "
                             f"grads {grad_err}")


def timed(fn):
    """(fn(), host seconds), the card synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_no_launches(what):
    stray = {k: v for k, v in counts().items() if v}
    if stray:
        raise AssertionError(f"{what} launched {stray}: no kernel lies on "
                             f"its path")


def design_data():
    """The synthetic QM9 stand-in, prepared for the inverse diffusion model
    and, with start and end characters, for the transformers."""
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    smiles, props = synthetic_qm9(DESIGN_SMILES, seed=20,
                                  chemically_valid=True)
    return (prepare_qm9(smiles, props, mode="inverse_diffusion"),
            prepare_qm9(smiles, props, mode="transformer"))


def encoder_model(dev, dtype, seed=21):
    import torch
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        MoleculeTransformerSequenceEncoder
    return MoleculeTransformerSequenceEncoder(
        device=dev, dtype=dtype,
        generator=torch.Generator().manual_seed(seed), **ENCODER_PRESET)


def encoder_serve_and_train(dev, tr):
    """Phase 24, bfloat16: predictions for 1, 16 and 1,024 SMILES, a traced
    one of 1,024, and training at batch 256.  Returns the serving model."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.design import \
        predict_properties_from_smiles_transformer as predict
    from moleculediffusiontransformer_tpu_torch.train import trainer

    t0 = time.perf_counter()
    model = encoder_model(dev, torch.bfloat16).eval()

    def request(b):
        return predict(model, tr.smiles[:b], tr.tokenizer, tr.scaler)

    request(1)                                                # warm-up
    reset_counts()
    for b in ENCODER_REQUESTS:
        props, seconds = timed(lambda: request(b))
        finite = bool(np.isfinite(props).all())
        phase("encoder_request", batch=b, seconds=seconds,
              predictions_per_s=b / seconds, shape=list(props.shape),
              finite=finite)
        if props.shape != (b, 12) or not finite:
            raise AssertionError(f"encoder request {b}: {props.shape}, "
                                 f"finite {finite}")
    b = ENCODER_REQUESTS[-1]
    device_ms, launches, wall_ms = device_busy(lambda: request(b))
    phase("encoder_request_traced", batch=b, device_ms=device_ms,
          kernel_launches=launches, traced_wall_ms=wall_ms,
          device_busy_share=device_ms / wall_ms)

    train = encoder_model(dev, torch.bfloat16).train()
    ids = torch.tensor(tr.X_train[:ENCODER_TRAIN_BATCH], dtype=torch.long,
                       device=dev)
    targets = torch.tensor(tr.y_train[:ENCODER_TRAIN_BATCH], device=dev)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(train, opt)
    step = trainer.make_encoder_train_step(train, opt)
    losses = [step(state, ids, targets).item()]               # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps, seconds = timed(lambda: [step(state, ids, targets)
                                    for _ in range(TIMED_STEPS)])
    losses += [t.item() for t in steps]
    seconds /= TIMED_STEPS
    phase("encoder_train", batch=ENCODER_TRAIN_BATCH, steps=1 + TIMED_STEPS,
          seconds_per_step=seconds,
          samples_per_s=ENCODER_TRAIN_BATCH / seconds, losses=losses,
          max_memory_allocated=torch.cuda.max_memory_allocated())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite encoder training loss: {losses}")
    check_no_launches("the forward transformer")
    phase("encoder_phase_seconds", seconds=time.perf_counter() - t0)
    return model


def encoder_fp32_vs_cpu(dev, tr):
    """Phase 24, float32: a batch-8 prediction and one step on the card
    against the CPU."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    cpu = torch.device("cpu")
    model32 = encoder_model(cpu, torch.float32)
    ids = torch.tensor(tr.X_test[:8], dtype=torch.long)
    targets = torch.tensor(tr.y_test[:8])
    results = []
    for device in (dev, cpu):
        m = copy.deepcopy(model32).to(device)
        with torch.no_grad():
            logits = m(ids.to(device)).cpu()
        o = trainer.make_optimizer(trainer.OptimizerConfig())
        loss = trainer.make_encoder_train_step(m, o)(
            trainer.TrainState.create(m, o), ids.to(device),
            targets.to(device)).item()
        results.append((logits, loss, {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}))
    (card_logits, card_loss, card_grads), (cpu_logits, cpu_loss,
                                           cpu_grads) = results
    logit_err = _rel_err(card_logits, cpu_logits)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n], STEP_GRAD_FLOOR)
                   for n in cpu_grads)
    tol = {"logits": KERNEL_TOL["float32"], "loss": STEP_LOSS_TOL,
           "grad": STEP_GRAD_TOL}
    phase("encoder_fp32_vs_cpu", batch=8, logits_rel_err=logit_err,
          loss=card_loss, plain_loss=cpu_loss, loss_rel_err=loss_err,
          grad_rel_err=grad_err, tol=tol)
    if not (logit_err <= tol["logits"] and loss_err <= tol["loss"]
            and grad_err <= tol["grad"]):
        raise AssertionError(f"encoder fp32, card vs CPU: logits "
                             f"{logit_err}, loss {loss_err}, grads "
                             f"{grad_err}")


def design_model(dev, inv, dtype, seed=22):
    """The 91M inverse preset at the tokenizer's vocabulary
    (core/config.py::inverse_diffusion_qm9(vocab))."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    model = QMDiffusion(**dict(FLAGSHIP, pred_dim=inv.vocab_size),
                        dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def design_pipeline(dev, inv, tr, encoder):
    """Phase 25, bfloat16: generate, evaluate, inpaint and re-score on the
    91M model, the 18M model, the encoder and the AR transformer, each
    request with the counts set to 0 before it and read after it."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch import design
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusionForward
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf

    t0 = time.perf_counter()
    model = design_model(dev, inv, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(23)
    targets = inv.scaler.inverse_transform(inv.y_test[:DESIGN_TARGETS])
    kw = dict(scaler=inv.scaler, training_smiles=inv.smiles,
              cond_scale=DESIGN_COND_SCALE, timesteps=DESIGN_STEPS)
    design.generate_from_conditioning(model, targets[:1], inv.tokenizer,
                                      gen, **dict(kw, timesteps=3))
    stack_calls = STACKS_PER_EVAL * DESIGN_EVALS

    def generate(what, resnet_runs=0):
        reset_counts()
        products = tf.gemm_tc_launches()
        report, seconds = timed(lambda: design.generate_from_conditioning(
            model, targets, inv.tokenizer, gen, **kw))
        launched = counts()
        products = tf.gemm_tc_launches() - products
        raw = report["raw_samples"]
        phase(what, targets=len(targets), steps=DESIGN_STEPS,
              cond_scale=DESIGN_COND_SCALE, seconds=seconds,
              molecules_per_s=len(targets) / seconds,
              launches={k: v for k, v in launched.items() if v},
              gemm_tc_launches=products, shape=list(raw.shape),
              num_valid=report["num_valid"], num_novel=report["num_novel"],
              sample_smiles=report["smiles"][:4])
        want = {k: 0 for k in launched}
        want.update(LAUNCHES=stack_calls,
                    RESNET_LAUNCHES=RESNET_RUNS_PER_EVAL * DESIGN_EVALS
                    * resnet_runs)
        if launched != want:
            raise AssertionError(f"{what}: launches {launched}, expected "
                                 f"{want} (every stack and, with K8 on, "
                                 f"every resnet run through its kernel)")
        if products != stack_products(model) * DESIGN_EVALS:
            raise AssertionError(f"{what}: {products} products on the "
                                 f"tensor cores, expected "
                                 f"{stack_products(model) * DESIGN_EVALS}")
        if (raw.shape != (len(targets), model.max_length, model.pred_dim)
                or not np.isfinite(raw).all()):
            raise AssertionError(f"{what}: samples {raw.shape}, finite "
                                 f"{bool(np.isfinite(raw).all())}")
        return report

    report = generate("design_generate")
    smiles = report["smiles"]
    rep, seconds = timed(lambda: design.evaluate_generated(smiles,
                                                           inv.smiles))
    phase("design_evaluate", seconds=seconds, num_samples=rep["num_samples"],
          num_valid=rep["num_valid"], num_novel=rep["num_novel"],
          validity_fraction=rep["validity_fraction"],
          novelty_fraction=rep["novelty_fraction"],
          training_smiles=len(inv.smiles))
    if not (len(smiles) == rep["num_samples"] == DESIGN_TARGETS
            and rep["num_novel"] <= rep["num_valid"] <= rep["num_samples"]):
        raise AssertionError(f"evaluate_generated: {len(smiles)} strings, "
                             f"{rep}")
    phase("design_eval_profile", batch=DESIGN_TARGETS,
          cond_scale=DESIGN_COND_SCALE,
          **eval_profile(model, DESIGN_TARGETS, gen))

    draft = next(s for s in inv.smiles if len(s) >= 8)
    reset_counts()
    inpainted, seconds = timed(
        lambda: design.inpaint_from_draft_and_conditioning(
            model, draft, targets[0], INPAINT_FIXED, inv.tokenizer, gen,
            scaler=inv.scaler, num_resamples=INPAINT_RESAMPLES,
            cond_scale=DESIGN_COND_SCALE, timesteps=DESIGN_STEPS,
            num_candidates=INPAINT_CANDIDATES, training_smiles=inv.smiles))
    launched = counts()
    prefix = draft[:len(INPAINT_FIXED)]
    phase("design_inpaint", draft=draft, fixed=list(INPAINT_FIXED),
          candidates=INPAINT_CANDIDATES, resamples=INPAINT_RESAMPLES,
          steps=DESIGN_STEPS, seconds=seconds,
          launches={k: v for k, v in launched.items() if v},
          smiles=inpainted["smiles"], num_valid=inpainted["num_valid"])
    if launched["LAUNCHES"] != stack_calls * INPAINT_RESAMPLES:
        raise AssertionError(f"inpainting launched K1 "
                             f"{launched['LAUNCHES']} times, expected "
                             f"{stack_calls * INPAINT_RESAMPLES}")
    if (len(inpainted["smiles"]) != INPAINT_CANDIDATES
            or not all(s.startswith(prefix) for s in inpainted["smiles"])):
        raise AssertionError(f"inpainting lost the fixed positions of "
                             f"{draft!r}: {inpainted['smiles']}")

    fmodel = QMDiffusionForward(**FORWARD, dtype=torch.bfloat16)
    init_parameters(fmodel, torch.Generator().manual_seed(24))
    fmodel = fmodel.to(dev).eval()
    for what, run, want in (
            ("design_rescore_forward_diffusion",
             lambda: design.rescore_generated(
                 fmodel, smiles, targets, inv.tokenizer, inv.scaler, gen),
             {"LAUNCHES": CROSS_STACKS_PER_EVAL * RESCORE_EVALS}),
            ("design_rescore_encoder",
             lambda: design.rescore_generated(
                 None, smiles, targets, tr.tokenizer, tr.scaler,
                 transformer_encoder=encoder), {})):
        reset_counts()
        scores, seconds = timed(run)
        launched = {k: v for k, v in counts().items() if v}
        preds = scores["predicted_properties"]
        phase(what, molecules=len(smiles), seconds=seconds,
              launches=launched, overall_r2=scores["overall_r2"],
              mae=scores["mae"], shape=list(preds.shape))
        if launched != want or preds.shape != (len(smiles), 12) or not (
                np.isfinite(preds).all()):
            raise AssertionError(f"{what}: launches {launched} (expected "
                                 f"{want}), predictions {preds.shape}")

    ar = ar_model(dev, torch.bfloat16).eval()
    reset_counts()
    ar_report, seconds = timed(
        lambda: design.generate_from_conditioning_transformer(
            ar, targets[:AR_DESIGN_TARGETS], tr.tokenizer, gen,
            scaler=tr.scaler, training_smiles=tr.smiles))
    phase("design_generate_transformer", targets=AR_DESIGN_TARGETS,
          seconds=seconds, molecules_per_s=AR_DESIGN_TARGETS / seconds,
          num_valid=ar_report["num_valid"], num_novel=ar_report["num_novel"],
          sample_smiles=ar_report["smiles"][:4])
    check_no_launches("the AR design request")
    if len(ar_report["smiles"]) != AR_DESIGN_TARGETS:
        raise AssertionError(f"AR design: {len(ar_report['smiles'])} "
                             f"strings")

    rf.enable_resnet_fusion(True)
    try:
        generate("design_generate_resnet_fusion", resnet_runs=1)
    finally:
        rf.enable_resnet_fusion(False)
    phase("design_phase_seconds", seconds=time.perf_counter() - t0)


def decode_agreement(card, cpu, gap=DESIGN_GAP):
    """(tokens that differ although the CPU's two largest channels at their
    position are more than ``gap`` apart, rows whose tokens all agree)."""
    differ = card.argmax(-1) != cpu.argmax(-1)
    top2 = cpu.topk(2, dim=-1).values
    unexplained = int((differ & (top2[..., 0] - top2[..., 1] > gap)).sum())
    return unexplained, ~differ.any(-1)


def design_fp32_vs_cpu(dev, inv):
    """Phase 26, float32: ``generate_from_conditioning`` and
    ``qm_diffusion.inpaint`` (the pipeline's source and mask for a draft) at
    batch 8 on the card against the CPU, on the same draws."""
    import torch
    from moleculediffusiontransformer_tpu_torch import design
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
        one_hot_signed, pad_sequences)
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        inpaint
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    model32 = design_model(cpu, inv, torch.float32)
    b, vocab = DESIGN_PARITY_BATCH, inv.vocab_size
    shape = (b, FLAGSHIP["max_length"], vocab)
    g = torch.Generator().manual_seed(25)
    targets = inv.scaler.inverse_transform(inv.y_test[:b])
    draws = dict(noise=torch.randn(shape, generator=g),
                 step_noise=torch.randn(NUM_STEPS - 1, *shape, generator=g))
    draft = next(s for s in inv.smiles if len(s) >= 8)
    cond = torch.tensor(inv.scaler.transform(targets[:1]),
                        dtype=torch.float32).repeat(b, 1)
    source = torch.tensor(one_hot_signed(pad_sequences(
        inv.tokenizer.texts_to_sequences([draft]), shape[1]),
        vocab)).repeat(b, 1, 1)
    mask = torch.zeros(shape, dtype=torch.bool)
    mask[:, list(INPAINT_FIXED)] = True
    r = INPAINT_RESAMPLES
    inpaint_draws = dict(
        noise=torch.randn(shape, generator=g),
        source_noise=torch.randn(NUM_STEPS - 1, *shape, generator=g),
        step_noise=torch.randn(NUM_STEPS - 1, r, *shape, generator=g),
        renoise=torch.randn(NUM_STEPS - 1, r, *shape, generator=g))
    results = []
    for m, device in ((copy.deepcopy(model32).to(dev), dev), (model32, cpu)):
        report = design.generate_from_conditioning(
            m, targets, inv.tokenizer, scaler=inv.scaler,
            cond_scale=DESIGN_COND_SCALE, timesteps=NUM_STEPS,
            **{k: v.to(device) for k, v in draws.items()})
        out = inpaint(m, cond.to(device), source.to(device),
                      mask.to(device), num_steps=NUM_STEPS,
                      num_resamples=r, cond_scale=DESIGN_COND_SCALE,
                      **{k: v.to(device) for k, v in inpaint_draws.items()})
        results.append((torch.from_numpy(report["raw_samples"]),
                        report["smiles"], out.cpu(),
                        design.decode_one_hot(out, inv.tokenizer)))
    (card_gen, card_smiles, card_inp, card_inp_smiles), \
        (cpu_gen, cpu_smiles, cpu_inp, cpu_inp_smiles) = results
    record = {}
    for what, card, plain, card_s, plain_s in (
            ("generate", card_gen, cpu_gen, card_smiles, cpu_smiles),
            ("inpaint", card_inp, cpu_inp, card_inp_smiles,
             cpu_inp_smiles)):
        unexplained, agree = decode_agreement(card, plain)
        record[what] = dict(
            max_abs_err=_abs_err(card, plain),
            tokens_differing_without_a_near_tie=unexplained,
            rows_equal=int(agree.sum()),
            smiles_equal_where_tokens_agree=all(
                card_s[i] == plain_s[i] for i in range(b) if agree[i]))
    phase("design_fp32_vs_cpu", batch=b, steps=NUM_STEPS,
          resamples=r, tol=SAMPLE_TOL, near_tie_gap=DESIGN_GAP,
          seconds=time.perf_counter() - t0, **record)
    for what, rec in record.items():
        if not (rec["max_abs_err"] <= SAMPLE_TOL
                and rec["tokens_differing_without_a_near_tie"] == 0
                and rec["smiles_equal_where_tokens_agree"]):
            raise AssertionError(f"fp32 {what}, card vs CPU: {rec}")


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
        QMDiffusion, QMDiffusionForward, sample)
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import cuda_build
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    from moleculediffusiontransformer_tpu_torch.train import trainer

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

    # 2. build, every source at once (phases 5, 8, 14 and 20 report the
    # others)
    at = attention_ops()
    sources = (tf.SOURCE, tf.BWD_SOURCE, rf.SOURCE, fa.SOURCE, fa.BWD_SOURCE,
               at.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(cuda_build.build, sources)))
    path, seconds = builds[tf.SOURCE]
    phase("build", library=os.path.relpath(path, ROOT), seconds=seconds)

    # 3. kernel against its plain version
    worst, stack_ms, stack_card_ms, stack_plain_ms, stack_bound = \
        check_stacks(dev)

    # 4. the serving path, both switches at their default (off)
    if rf.resnet_fusion_enabled() or tf.cfg_null_half_active():
        raise AssertionError("a switch is on by default")
    model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.rand(b, 12, generator=gen, device=dev) * 2 - 1
                for b in REQUESTS]
    inverse_shape = (FLAGSHIP["max_length"], FLAGSHIP["pred_dim"])
    products = tf.gemm_tc_launches()
    served = serve(model, requests, gen, NUM_STEPS, COND_SCALE, "request",
                   inverse_shape, {"LAUNCHES": STACKS_PER_EVAL * EVALS})
    products = tf.gemm_tc_launches() - products
    launches = served["LAUNCHES"]
    stray = {k: v for k, v in served.items() if k != "LAUNCHES" and v}
    if stray:
        raise AssertionError(f"sampling with the switches off launched "
                             f"{stray}")
    # every product of every stack launch on the tensor cores
    want_products = stack_products(model) * launches // STACKS_PER_EVAL
    profile = eval_profile(model, REQUESTS[-1], gen)
    phase("request_products", gemm_tc_launches=products,
          want_gemm_tc_launches=want_products)
    phase("eval_profile", batch=REQUESTS[-1], cond_scale=COND_SCALE,
          **profile)
    if products != want_products:
        raise AssertionError(f"sampling sent {products} products to the "
                             f"tensor cores, expected {want_products}")

    model32 = QMDiffusion(**FLAGSHIP, dtype=torch.float32)
    init_parameters(model32, torch.Generator().manual_seed(0))
    cpu_gen = torch.Generator().manual_seed(2)
    props = torch.rand(8, 12, generator=cpu_gen) * 2 - 1
    noise = torch.randn(8, 32, 22, generator=cpu_gen)
    step_noise = torch.randn(NUM_STEPS - 1, 8, 32, 22, generator=cpu_gen)
    plain = sample(model32.eval(), props, num_steps=NUM_STEPS,
                   cond_scale=COND_SCALE, noise=noise, step_noise=step_noise)
    model32 = model32.to(dev)

    def card_sample():
        return sample(model32, props.to(dev), num_steps=NUM_STEPS,
                      cond_scale=COND_SCALE, noise=noise.to(dev),
                      step_noise=step_noise.to(dev)).cpu()

    sample_err = (card_sample() - plain).abs().max().item()
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

    # 8. K8 against its plain version (built in phase 2)
    path, seconds = builds[rf.SOURCE]
    phase("build_resnet", library=os.path.relpath(path, ROOT),
          seconds=seconds)
    resnet = check_resnet(dev)

    # 9. the uniform-context stack kernel against its plain version
    uniform = check_uniform(dev)

    # 10. the 91M model serving with both switches on
    switches(True)
    served_on = serve(model, requests, gen, NUM_STEPS, COND_SCALE,
                      "request_switches_on", inverse_shape,
                      {"LAUNCHES": STACKS_PER_EVAL * EVALS,
                       "RESNET_LAUNCHES": RESNET_RUNS_PER_EVAL * EVALS,
                       "UNIFORM_LAUNCHES": CROSS_STACKS_PER_EVAL * EVALS})
    on_err = (card_sample() - plain).abs().max().item()
    switches(False)
    phase("fp32_sample_switches_on_vs_plain", batch=8, max_abs_err=on_err,
          tol=SAMPLE_TOL)
    if not on_err <= SAMPLE_TOL:
        raise AssertionError(f"fp32 sample, switches on: card vs CPU "
                             f"composition {on_err}")

    # 11. the 91M model training with K8 on
    train_model = QMDiffusion(**FLAGSHIP, dtype=torch.bfloat16)
    init_parameters(train_model, torch.Generator().manual_seed(0))
    train_model = train_model.to(dev).train()
    tgen = torch.Generator(device=dev).manual_seed(3)
    cond, target = inverse_batch(TRAIN_BATCH, tgen, dev)
    rf.enable_resnet_fusion(True)
    reset_counts()
    losses, seconds, peak = train_steps(train_model, cond, target, tgen,
                                        AB_TRAIN_STEPS)
    trained = counts()
    rf.enable_resnet_fusion(False)
    want = RESNET_RUNS_PER_EVAL * MICRO_BATCHES * (1 + AB_TRAIN_STEPS)
    phase("train_resnet_on", batch=TRAIN_BATCH, micro_batches=MICRO_BATCHES,
          steps=1 + AB_TRAIN_STEPS, seconds_per_step=seconds,
          samples_per_s=TRAIN_BATCH / seconds, losses=losses,
          max_memory_allocated=peak, launches=trained)
    if trained["RESNET_LAUNCHES"] < want:
        raise AssertionError(f"training with K8 on launched it "
                             f"{trained['RESNET_LAUNCHES']} times, < {want}")

    # 12. the 18M forward model, K8 on
    fmodel = QMDiffusionForward(**FORWARD, dtype=torch.bfloat16)
    init_parameters(fmodel, torch.Generator().manual_seed(5))
    fmodel = fmodel.to(dev).eval()
    fgen = torch.Generator(device=dev).manual_seed(6)
    frequests = [forward_batch(b, fgen, dev)[0] for b in REQUESTS]
    fshape = (FORWARD["max_length"], FORWARD["pred_dim"])
    fevals = 2 * (FORWARD_STEPS - 1)
    rf.enable_resnet_fusion(True)
    # the forward preset has no pre_transformer: its 5 stacks an eval are
    # the cross stacks
    serve(fmodel, frequests, fgen, FORWARD_STEPS, 1.0, "forward_request",
          fshape, {"LAUNCHES": CROSS_STACKS_PER_EVAL * fevals,
                   "RESNET_LAUNCHES": RESNET_RUNS_PER_EVAL * fevals})
    tf.enable_sharedkv(True)
    serve(fmodel, frequests[-1:], fgen, FORWARD_STEPS, COND_SCALE,
          "forward_request_switches_on", fshape,
          {"RESNET_LAUNCHES": RESNET_RUNS_PER_EVAL * fevals,
           "UNIFORM_LAUNCHES": CROSS_STACKS_PER_EVAL * fevals})
    tf.enable_sharedkv(False)
    ftrain = QMDiffusionForward(**FORWARD, dtype=torch.bfloat16)
    init_parameters(ftrain, torch.Generator().manual_seed(5))
    ftrain = ftrain.to(dev).train()
    fcond, ftarget = forward_batch(TRAIN_BATCH, fgen, dev)
    reset_counts()
    losses, seconds, peak = train_steps(ftrain, fcond, ftarget, fgen,
                                        TIMED_STEPS)
    ftrained = counts()
    rf.enable_resnet_fusion(False)
    want = RESNET_RUNS_PER_EVAL * MICRO_BATCHES * (1 + TIMED_STEPS)
    phase("forward_train", batch=TRAIN_BATCH, micro_batches=MICRO_BATCHES,
          steps=1 + TIMED_STEPS, seconds_per_step=seconds,
          samples_per_s=TRAIN_BATCH / seconds, losses=losses,
          max_memory_allocated=peak, launches=ftrained)
    if ftrained["RESNET_LAUNCHES"] < want:
        raise AssertionError(f"forward training with K8 on launched it "
                             f"{ftrained['RESNET_LAUNCHES']} times, < {want}")
    fp32_step_vs_plain(dev, QMDiffusionForward, FORWARD, forward_batch,
                       card_switches=True, what="forward_fp32_step_vs_plain")

    # 13. switches on against off, in turns
    ab("inverse sampling, batch 512, mol/s",
       lambda: timed_request(model, requests[-1], gen, NUM_STEPS,
                             COND_SCALE))
    ab("forward sampling, batch 512, cond scale 1.0, requests/s",
       lambda: timed_request(fmodel, frequests[-1], fgen, FORWARD_STEPS,
                             1.0))
    for what, m, c, t, g in (
            ("inverse training, 2 x 512, samples/s", train_model, cond,
             target, tgen),
            ("forward training, 2 x 512, samples/s", ftrain, fcond, ftarget,
             fgen)):
        opt = trainer.make_optimizer(trainer.OptimizerConfig())
        state = trainer.TrainState.create(m, opt)
        step = trainer.make_diffusion_train_step(m, opt, MICRO_BATCHES)
        ab(what, lambda: timed_training(step, state, c, t, g))

    # 14. build of the streaming-attention kernels (started in phase 2)
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        path, seconds = builds[source]
        phase("build_flash", library=os.path.relpath(path, ROOT),
              seconds=seconds)

    # 15. K5, K6, K7 against their plain versions; 16. the crossover
    flash = check_flash(dev)
    check_crossover(dev)

    # 17. the long-sequence model serving, MDT_FLASH at its default (on)
    if not fa.flash_enabled():
        raise AssertionError("MDT_FLASH is off by default")
    lmodel = long_model(dev, torch.bfloat16).eval()
    lgen = torch.Generator(device=dev).manual_seed(8)
    short_served = long_serve(lmodel, LONG_SAMPLES, lgen)
    long_served = long_serve(lmodel, FLASH_SAMPLES, lgen)
    # attention runs at samples / 32 tokens: at 2**15 samples it streams
    # exactly when the threshold is 1,024 or less
    if bool(short_served["FLASH_FWD_LAUNCHES"]) != (
            fa.LONG_SEQ_THRESHOLD <= LONG_SAMPLES // 32):
        raise AssertionError(f"attention at {LONG_SAMPLES // 32} tokens, "
                             f"threshold {fa.LONG_SEQ_THRESHOLD}: "
                             f"{short_served}")

    # 18. the long-sequence model training
    long_train(dev, LONG_SAMPLES, LONG_BATCHES[0], steps=AB_TRAIN_STEPS)
    long_train(dev, LONG_SAMPLES, LONG_BATCHES[1], steps=AB_TRAIN_STEPS)
    long_trained = long_train(dev, FLASH_SAMPLES, LONG_BATCHES[0])
    long_train(dev, FLASH_SAMPLES, LONG_BATCHES[1])
    big = LONG_BATCHES[1]
    ltrain = long_model(dev, torch.bfloat16).train()
    for samples in (FLASH_SAMPLES, LONG_SAMPLES):
        def flash_request():
            _, seconds, peak = long_request(lmodel, samples, big, lgen)
            return big / seconds, peak

        ab_flash(f"long sampling, {samples} samples, batch {big}, "
                 f"samples/s, peak bytes", flash_request)
        lx = torch.rand(big, samples, LONG["in_channels"], generator=lgen,
                        device=dev) * 2 - 1

        def flash_training():
            _, seconds, peak = long_train_steps(ltrain, lx, lgen,
                                                AB_TRAIN_STEPS)
            return big / seconds, peak

        ab_flash(f"long training, {samples} samples, batch {big}, "
                 f"samples/s, peak bytes", flash_training)
    del ltrain, lx

    # 19. float32 parity of the long model, card against CPU
    long_fp32_vs_plain(dev)

    # 20. build of the resident-KV attention kernels (started in phase 2)
    path, seconds = builds[at.SOURCE]
    phase("build_attention", library=os.path.relpath(path, ROOT),
          seconds=seconds)

    # 21. K9 and K10 against their plain version, then their main path
    attention = check_attention(dev)
    attention_launched = drive_attention_entry_points(dev)

    # 22. the inverse AR transformer serving
    ar_serve(dev)
    ar_fp32_request_vs_cpu(dev)

    # 23. the inverse AR transformer training
    ar_train(dev)
    ar_fp32_step_vs_cpu(dev)

    # 24. the forward transformer
    inv, tr = design_data()
    encoder = encoder_serve_and_train(dev, tr)
    encoder_fp32_vs_cpu(dev, tr)

    # 25. the inverse-design pipeline on the 91M model
    design_pipeline(dev, inv, tr, encoder)

    # 26. float32 parity of the pipeline, card against CPU
    design_fp32_vs_cpu(dev, inv)

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
        "card_ms": stack_card_ms,
        "plain_ms": stack_plain_ms,
        **stack_bound,
        "library_ms": None,
        "products": TC_PRODUCTS,
    }]
    # the training kernels' numbers: bf16, batch 512, from phase 6; every
    # bf16 product of the four on the tensor cores (phases 6 and 7 check it)
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
                        **train_kernels[key], "library_ms": None,
                        "products": TC_PRODUCTS})
    # this slice's kernels: launches from phase 10, the 91M model serving
    # with both switches on; bf16 numbers from phases 8 and 9
    kernels.append({
        "name": "resnet_stack_fwd", "route": "cuda",
        "source": csrc + "resnet_fwd.cu",
        "replaces": "moleculediffusiontransformer_tpu/ops/resnet_fusion.py:83",
        "launches": served_on["RESNET_LAUNCHES"],
        "max_abs_err": resnet["max_abs_err"], "ms": resnet["ms"],
        "card_ms": resnet["card_ms"],
        "plain_ms": resnet["plain_ms"], "bound_ms": resnet["bound_ms"],
        "bound_by": resnet["bound_by"], "library_ms": None,
        "products": TC_PRODUCTS})
    kernels.append({
        "name": "transformer1d_stack_fwd_uniform_ctx", "route": "cuda",
        "source": csrc + "transformer1d_fwd.cu",
        "replaces": jax_ops + ":449",
        "launches": served_on["UNIFORM_LAUNCHES"],
        "max_abs_err": uniform["max_abs_err"], "ms": uniform["ms"],
        "card_ms": uniform["card_ms"],
        "plain_ms": uniform["plain_ms"], "bound_ms": uniform["bound_ms"],
        "bound_by": uniform["bound_by"], "library_ms": None,
        "products": TC_PRODUCTS})
    # the streaming-attention kernels: bf16 at bh 16, n = m = 4096, d 64
    # from phase 15 (plain_ms and library_ms of the dq and the dk/dv kernel
    # are those of the whole backward, which computes all three grads);
    # K5's launches from the 2**17-sample requests of phase 17, K6's and
    # K7's from the batch-2 training steps of phase 18
    jax_flash = "moleculediffusiontransformer_tpu/ops/flash_attention.py"
    for key, name, source, line, launched in (
            ("fwd", "flash_attention_fwd", fa.SOURCE, 89,
             long_served["FLASH_FWD_LAUNCHES"]),
            ("dq", "flash_attention_bwd_dq", fa.BWD_SOURCE, 185,
             long_trained["FLASH_DQ_LAUNCHES"]),
            ("dkv", "flash_attention_bwd_dkv", fa.BWD_SOURCE, 220,
             long_trained["FLASH_DKV_LAUNCHES"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": f"{jax_flash}:{line}",
                        "launches": launched, **flash[key]})
    # the resident-KV attention kernels: bf16 at the AR transformer's decode
    # shapes from phase 21 (K9 at m 65, K10 at m 13).  No model path launches
    # them in either package: their launches are those of the call of the
    # public entry points at these shapes that ends phase 21
    jax_attention = "moleculediffusiontransformer_tpu/ops/attention.py"
    for key, name, line, count in (
            ("attention", "attention_fwd", 37, "ATTENTION_LAUNCHES"),
            ("packed_attention", "packed_attention_fwd", 96,
             "PACKED_ATTENTION_LAUNCHES")):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + "attention.cu",
                        "replaces": f"{jax_attention}:{line}",
                        "launches": attention_launched[count],
                        **attention[key]})
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel was never launched on its main "
                             f"path: {kernels}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
