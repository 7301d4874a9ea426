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
   enqueued back to back (``card_ms``); every product of each call, in
   either dtype, must go to the tensor-core GEMM (float32 as three TF32
   passes);
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
   forward, CUDA-event timings of each kernel (and the card's time) and of
   the chain against the plain versions, and a bitwise determinism check of
   the chain; every product of each call, in either dtype, must go to the
   tensor-core GEMM (K3 and K4 two each, K2 its layers');
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
   determinism check; each call, in either dtype, must send all its
   products (two convs a block, each projection, one FiLM product a run: 7
   for a 3-block down run, 13 for a 4-block up run) to the tensor-core
   GEMM, counted by ``resnet_fusion.gemm_tc_launches``; then its
   gradients through the autograd function against autograd of the
   composition at batch 512;
9. K1's uniform-context variant (the shared-KV CFG null half) against its
   plain version at the four cross-stack shapes of the two presets, batch
   512, float32 and bfloat16, with timings (``ms``, ``card_ms``), every
   product on the tensor cores;
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
   tokens equal wherever the two largest channels are more than 1e-3 apart;
27. the training loop, checkpoints and the command line, called in-process
   (``cli.main``) on the CLI's synthetic stand-in of 4,096 rows: ``train
   --task inverse_diffusion --preset notebook`` (91M, float32, the recipes'
   default; batch and micro-batches from ``PRODUCTION_BATCHES``) for 2
   epochs into one directory, for 1 into another and ``--resume`` there for
   1 more: every loss finite, the resumed run's checkpoint equal to the
   straight run's (bitwise, or every tensor within 1e-6 of its scale; the
   phase says which held), and K1 stash, K3, K4 launched exactly stacks x
   micro-batches (the steps' and the preflight pass's), K2 layers x as
   many, K1 stacks x the held-out eval's evaluations and nothing else; the
   step through ``recipes.train_task`` at 1,024 x 1 and 4 x 256 in float32
   and 1,024 x 1 in bf16 (every bf16 product on the tensor cores): peak
   memory and seconds a step beside ``preflight_memory_check``'s estimate,
   and the float32 peak held against ``PRODUCTION_BATCHES`` (accumulation
   only above 70% of the card); the grads of one micro-batch three times
   with cuDNN's default and with its deterministic algorithms (which the
   loop runs), in float32 and bf16: the tensors that differ and seconds a
   forward and backward; ``eval``, ``sample`` (16 molecules, 64
   steps) and ``inpaint`` from the checkpoint, K1 exactly stacks x
   evaluations; the 18M forward model, the AR transformer and the forward
   transformer one epoch each at their notebook presets, then ``predict``
   or ``sample`` from their checkpoints (the 18M with its training and
   serving launches counted as the 91M's, the transformers launching
   nothing); two float32 ``train_diffusion`` steps of the 91M model at
   batch 8 on the same draws, card against CPU, the losses within 1e-4;
   and seconds an epoch with ``prefetch`` 2 and 0 in turns.  The straight
   run's training again on the Orbax checkpoint tier
   (``checkpoint_backend="orbax"``, ``core/checkpoint_orbax.py``) through
   ``recipes.train_task`` at the CLI's arguments: 1 epoch, then 1 more
   resumed, launches counted as above, the resumed run's last checkpoint
   held to the straight run's as the single-file tier's is; a line of every
   save of both tiers in those runs (the step stream's hold, seconds to
   commit, bytes) and of each restore's seconds;
28. the diffusion options on the audio preset
   (``AudioDiffusionConditional(768, 64, unet_type="all",
   diffusion_type="vk")``, 115M parameters at full width, bfloat16, seeded
   random weights, a random 64 x 768 conditioning): one warm-up and 3 timed
   training steps at batch 8 x 2**15 samples with ``embedding_mask_proba``
   0.1, every loss finite and K1 stash, K3, K4 launched exactly stacks x
   steps, K2 layers x steps; a 50-step Karras request with churn and a
   50-step ancestral Euler request at scale 5.0, batch 8, K1 launched
   exactly stacks x the denoise evaluations counted at the UNet; 2 spans of
   ``span_by_span_compose`` over ``inpaint_adpm2`` (K1 counted the same
   way); an evaluation and a step under ``torch.profiler``, the stack
   kernels' share of the device time; each of the 7 stacks against the
   plain versions on the activations of a CFG evaluation: bf16 K1 at the
   doubled batch 16, the stash forward, K3, K2 and K4 output by output at
   batch 8, within 2e-2 of scale; the "ncca" UNet at the same widths (one
   request with ``channels_augmentation``, one training step, launches
   exact); a ``use_rel_pos`` Transformer1d at the 91M cross stack's shape,
   K1-K4 launched 0 times and its forward and grads within 1e-4 of the CPU
   in float32; and float32 at batch 2 card against CPU: a 4-step Karras
   sample within 1e-4, the vk loss within 1e-4 relative and its grads
   (through K1 stash, K3, K2, K4) within 1e-3 of each grad's scale;
29. the GPT family (no kernel lies on its path: every count stays 0):
   ``MoleculeTransformerGPT`` at the reference's class defaults (bf16)
   answering ``generate_gpt`` requests of 1, 16 and 1,024 (31 tokens), a
   traced 16-token request of 1,024 for the device's busy share, one
   warm-up and 5 timed steps at 512 x 32 tokens; the MoE variant (8
   experts, top 2) 3 steps at batch 64 with ``aux_loss_weight`` 1e-2, its
   peak memory and dispatch bytes; the GNN variant one step;
   ``generate_gpt_mha`` at batch 16; ``generate_vectors`` of
   ``MoleculeTransformer`` and a forward of the Internaldim decoder at the
   AR preset's widths; then each class in float32 at batch 8, card against
   CPU: logits within 1e-4 and one train step's loss within 1e-4
   relative.

30. serving (``design/export.py``, ``design/serve.py``,
   ``design/http_serve.py``): through ``cli.main(["export", ...])`` the 91M
   sampler (bf16, batch 512, 64 steps, cond scale 2.0; once with both
   switches off, once with both on; and in float32 at batch 8, 8 steps,
   both on), its inpainter (batch 64), the AR generator (batch 1,024, 63
   tokens) and the encoder (batch 1,024), each loaded in
   ``ArtifactServer`` on the card, which must serve on its graph tier (one
   whole request captured in a CUDA graph); each against the live path on
   the same weights and draws, on both tiers: within 2e-2 of scale in
   bf16, 1e-4 in float32, the generator's ids equal; again after
   ``reload_checkpoint`` to second weights (switches on: bf16 on the graph
   tier, float32 on both); K1, uniform_ctx and K8 launched exactly stacks
   (or runs) x evaluations by the live request, captured in the graph and
   launched by the eager tier, and none by a replay; each captured graph's
   kernel nodes (read through libcuda) of K1's GroupNorm kernel and K8's
   SiLU kernel, each launched once a call, equal to those launch counts; a
   traced replay of the sampler, the generator and the encoder (device
   ms, the device's busy share of the traced request, the stack kernels
   seen running in it, the largest kernels), read from the profiler's
   kineto events, the encoder's reading held to ``prof.events()``'s on the
   same trace (the same device spans, names, times and window); then
   ``make_httpd`` on localhost:
   ``/healthz`` names the graph tier, ``/sample``, ``/inpaint``,
   ``/generate`` equal the direct call, ``/reload`` and ``/metrics``, and 64
   concurrent one-row ``/predict`` requests coalesced into fewer device
   calls, each equal to one direct call of all 64 rows.
31. the audio assemblies and the graph analogs (bfloat16, seeded random
   weights): ``AudioDiffusionUpsampler(1, factor=(2,))``,
   ``AudioDiffusionAE(1)`` (decoded at its encoder's factor, 8,192),
   ``AudioDiffusionVocoder(1)`` (trained through ``loss_from_wave``,
   sampled from the (8, 1, 512, 128) STFT magnitude of a 2**15 wave),
   ``AudioDiffusionUpphaser(1)`` and ``DiffusionAR1d`` at the waveform
   widths in chunks of 8,192 on 8 waveforms of 2**15 samples; then
   ``AnalogDiffusionSparse`` (pred_dim 3) and ``AnalogDiffusionFull``
   (pred_dim 3 + 1,024) at their class defaults on 64 packed (1,024, 4 +
   neighbours) tensors under 12 property scalars: for each its parameter
   count, one warm-up and 2 timed Adam steps (seconds a step, peak memory;
   K1 stash, K3, K4 launched exactly stacks x 3, K2 layers x 3), an 8-step
   request with its sampler (v; the graph models' ADPM2 under CFG at 2.0;
   seconds and rows a second; K1 launched exactly stacks x the denoise
   evaluations counted at the UNet), K1 against its plain version at every
   stack shape the model has; then each in float32 at batch 2, card
   against CPU on the same draws: a denoise evaluation within 1e-4 and the
   loss within 1e-4 relative, K1 launched exactly stacks x 2.
32. the data-parallel layer (``parallel/``): two spawned ranks of a gloo
   group on the one card (NCCL refuses a card twice) probe which
   collectives gloo takes on CUDA tensors; train the 91M in bf16 at a
   global batch of 1,024 (512 a rank; one warm-up and 2 steps), the
   parameters bitwise equal across ranks after every step, K1 stash, K3,
   K4 launched exactly stacks x 3 and K2 layers x 3 a rank, the first loss
   within 2e-2 of one card's on the same batch and draws, seconds a step,
   each rank's peak memory and the grads' all-reduce alone (gloo stages
   through the host: no figure of NVLink); float32 at a global batch of 8,
   2 steps within 1e-4 of one card (loss, parameters, grads); serve
   ``generate_from_conditioning(mesh=)``, a 64-step CFG (2.0) request of
   512 in bf16 (K1 exactly 9 x 126 a rank, within 2e-2 of one card) and
   one of 8 in float32 (within 1e-4), and the sampler exported with
   ``mesh=`` on the graph tier of both ranks (each capture holding its
   share's 1,134 K1 launches) against one card on the server's draws; then
   the CLI under ``python -m torch.distributed.run --standalone
   --nproc-per-node 1`` (NCCL) with phase 27's first run's arguments, its
   losses and launches held against that run's; then FSDP2 over a group of
   one (NCCL), 3 steps in bf16 at 512 and in float32 at 8 against the
   unsharded model (within 2e-2 and 1e-4), the kernels' cached weights
   equal to the gathered ones at every stack call.  After the two ranks'
   FSDP steps, each rank saves its shards on the Orbax tier in the
   background, takes one more step while the write is in flight, and
   restores into a freshly sharded model: every local shard bitwise the
   saved one, no tensor gathered during the restore, each rank's bytes.
33. the other axes of ``parallel/`` on two spawned ranks of a gloo group on
   the card: a pair of processes of its own probes what gloo takes on CUDA
   tensors of send/recv (``batch_isend_irecv``) and ``all_to_all_single``,
   and the helpers of ``parallel/collectives.py`` must stage through the
   host exactly what it refuses; then tensor parallelism (the 91M, data 1 x
   model 2, bf16 at a global batch of 512: K1 stash, K3, K4 a stack a step
   and K2 a layer a step on the gathered weights, exactly), sequence
   parallelism (the long Model1d at 2 x 2**17 samples: K5, K6, K7 exactly a
   streaming layer a step at n 2,048 and m 4,096), pipeline parallelism
   (the AR transformer in 2 stages of 6 layers, 4 micro-batches of 512 x 64
   tokens) and expert parallelism (the MoE GPT at 64 x 32 tokens, 4 of 8
   experts a rank, aux loss 1e-2): each 2 steps and a third with its
   collectives timed (seconds a step, the collectives' share, each rank's
   peak memory, the staged calls, the launches), the replicated parameters
   bitwise equal across the ranks after every step; then each in float32
   at batch 8 (the long model at 1 x 2**16) with SGD against one card:
   loss, parameters and grads within 1e-4, the parameters moved at least
   ten times past it (ep with its dropped tokens counted).
34. the quality tools: ``tools/quality_convergence_torch.py`` in this
   process on its synthetic corpus of 2,048 rows in chunks of one epoch
   (float32, Adam 2e-4, clip 0.5, evals of 8 generations of 64 steps): the
   forward transformer one epoch (launching nothing), the 91M at the
   notebook preset one epoch, its last curve line dropped as a kill between
   checkpoint and curve would, then resumed to 2 epochs: the checkpoint's
   epoch evaluated again, the next chunk labelled 2 and seeded 1 from the
   checkpoint, ``summary.json`` keeping both tasks, ``best.pt`` the best
   epoch's; K1 stash, K3, K4 launched exactly stacks x micro-batches (the
   steps' and each run's preflight pass), K2 layers x as many, K1 stacks x
   the evals' evaluations; then ``best.pt`` swapped into phase 30's 91M
   sampler (``reload_checkpoint``, no new export) and a request of 512
   held-out targets served on its graph tier against the live sampler of
   the same weights and draws, within 2e-2 of scale.
35. the examples and the notebooks, each example's ``main(argv)`` in this
   process on the card: ``examples/{inverse,forward}_diffusion_torch.py``
   at the 91M and 18M presets and ``examples/{inverse,forward}_
   transformer_torch.py`` at theirs, float32, one epoch of two steps at
   batch 256 on 600 synthetic rows with each one's eval (4 and 16 samples
   at 32 steps, 4 generations, 60 predictions) and checkpoint: K1 stash,
   K3, K4 launched exactly stacks x 3 micro-batches (the preflight pass
   counts as one), K2 layers x 3, K1 stacks x 62 evaluations, the
   transformers nothing; ``simple_models_torch.py --full`` (seven families,
   each differentiated and sampled), its QMDiffusion at the bench geometry
   (channels 64, max_length 64, pred_dim 16; its stacks at L 16 and 4), the
   launches of its and the graph analog's training and of its 64-step
   sample exact; that sample at batch 4 again on the module composition on
   the same draws, within 1e-4, and K1 alone against its plain version on
   the longest stack's input (L 16, C 128);
   ``serve_artifact_torch.py`` on phase 30's 91M sampler file with the
   inverse example's checkpoint, on its graph tier, 1,134 K1 launches
   captured and as many kernel nodes in the graph, every row decoded;
   ``audio_diffusion_torch.py`` at its tiny sizes; the code cells of
   ``notebooks/Quickstart_torch.ipynb`` in order.  Phase 30's directory
   goes after this phase, whether or not the phases before it passed.
36. the stack kernels past the whole-row attention core's 64 rows (the
   tiled core of ``csrc/stack_attention_tiles.cuh``, up to the JAX gate's
   L 512): K1 (plain, stash, uniform_ctx), K3, K2 and K4 against their
   plain versions at the audio preset's stack (C 512, 8 x 64, one layer,
   batch 2) at L 65, 128, 256, 512 and at L 128 on contexts of 64 and 200
   rows, float32 within 1e-4 and bfloat16 within 2e-2 of scale, two calls
   bitwise equal, with each one's card time beside its plain version's,
   K1's beside the module composition's, and the attention cores' (read
   from ``torch.profiler``) beside ``scaled_dot_product_attention``'s and
   its backward at the core's (b, h, L, m, d) (a yardstick, called nowhere
   in the package); then ``AudioDiffusionModel(in_channels=1)`` (bfloat16,
   seeded random weights) at 2**18 samples, batch 2, and 2**20, batch 1:
   a 25-step request (linear schedule, v sampler, clamp) and a warm-up and
   a timed train step (Adam), each on the kernels (K1 exactly 7 x the
   evaluations; the stash, K3, K4 7 and K2 7 a step) and on the module
   composition (``disable_fusion``, no launch), with seconds, rows a
   second and peak memory; a float32 denoise at 2**18, batch 1, card
   against CPU within 1e-4; and ``load_qm9`` and ``prepare_qm9`` on a
   133,885-row synthetic CSV through the native data path
   (``data/native``, built with g++) and the Python path: equal, each
   one's seconds.

Any failed check raises, and the script exits non-zero.  The last two lines
are a JSON record of the kernels -- each with its launches on its main path
(K1, K8 and uniform_ctx also with ``launches_served``, those of phase 30's
served requests; K1 and the training kernels also with
``launches_cli_train``, those of
phase 27's straight CLI train: its steps, its preflight pass and its
held-out eval; the training kernels also with
``launches_audio_all_train``, those of phase 28's training steps; K1 with
``launches_assemblies``, phase 31's requests, the training kernels with
``launches_assemblies_train``, its steps; K1 with ``launches_parallel``,
a rank's share of phase 32's mesh request, the training kernels with
``launches_parallel``, a rank's data-parallel steps; the training kernels
and the streaming-attention kernels with ``launches_parallel_axes``, a
rank's tensor- and sequence-parallel steps of phase 33; K1 and the training
kernels with ``launches_quality``, phase 34's two runs of the 91M, and with
``launches_examples``, phase 35's runs; K1 with ``launches_audio_long``,
phase 36's requests on the kernels, the training kernels with
``launches_audio_long_train``, its steps; K1, its stash and uniform_ctx
variants and K2-K4 with ``long``, phase 36's bf16 numbers at the tiled
lengths summed over its shapes),
its bfloat16 time beside its plain version's (the stack kernels K1-K4, K8
and the streaming-attention kernels also with ``card_ms``; the stack
kernels and K8, whose products all run on the tensor-core GEMM, with
``products`` naming it), the library call's
where there is one, and the least time the card could take (the larger of
its operations over 989 TFLOP/s and its bytes over 3.35 TB/s); K1, its
stash and uniform_ctx variants and K2-K4 also with ``float32``, phases 3,
6 and 9's float32 figures, whose bound counts three TF32 passes at 495
TFLOP/s (``cuda_core_bound_ms``: the operations at the CUDA cores' 67
TFLOP/s) -- and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# phase 27: the training loop, checkpoints and the CLI on the CLI's own
# data (``synthetic_qm9(rows, seed=0)``, chemically valid): a held-out eval
# of LOOP_NUM_EVAL targets at LOOP_EVAL_STEPS steps after each train, and
# the checkpoint's eval, sample and inpaint
LOOP_ROWS = 4096
LOOP_EVAL_STEPS, LOOP_NUM_EVAL = 32, 8
LOOP_SAMPLE_NUM, LOOP_SAMPLE_STEPS = 16, 64
LOOP_DRAFT, LOOP_FIXED = "CC(=O)N", ("0", "1", "2", "3")
# the step's peak memory and seconds: 7 steps of 1,024 an epoch, the first
# untimed; (dtype, batch, micro-batches): float32 at the full batch, the JAX
# package's v5e plan of 4 x 256, bf16 at the full batch
MEMORY_ROWS = 8192
MEMORY_RUNS = (("float32", 1024, 1), ("float32", 1024, 4),
               ("bfloat16", 1024, 1))
# accumulation is kept only where the float32 step at the full batch would
# peak above this share of the card (train/recipes.py::PRODUCTION_BATCHES)
ACCUMULATION_SHARE = 0.7
# the resumed run's parameters against the straight run's: bitwise, or else
# every tensor within RESUME_TOL of its largest magnitude
RESUME_TOL = 1e-6
LOADER_TURNS = (2, 0, 0, 2, 2, 0, 0, 2)
# phase 28: the audio preset (AudioDiffusionConditional's full widths:
# channels 128, multipliers to 4, patch 16; 115,442,196 parameters) as a
# CFG+NCCA ("all") UNet under the vk objective, conditioned on 64 x 768
# (T5-base's width; a random tensor, not T5's output) on 2**15-sample mono
# waveforms; trained with the documented dropout of 0.1 and sampled at the
# documented scale 5.0 by Karras (with churn) and ancestral Euler
AUDIO_ALL = dict(embedding_features=768, embedding_max_length=64,
                 in_channels=1, unet_type="all", diffusion_type="vk")
AUDIO_NCCA = dict(in_channels=1, unet_type="ncca", context_channels=(1,),
                  context_features=128)
AUDIO_SAMPLES, AUDIO_BATCH, AUDIO_TRAIN_STEPS = 2 ** 15, 8, 3
AUDIO_MASK_PROBA, AUDIO_SCALE = 0.1, 5.0
AUDIO_STEPS, AUDIO_CHURN = 50, 1.0
NCCA_SCALE = 0.5
SPAN_STEPS, SPAN_RESAMPLES, SPANS = 10, 1, 2
# the 91M preset's cross stack (L 8, C 256, 4 layers, 12 x 128 context) with
# the T5 bias (32 buckets, distance 128), batch 64, float32
REL_STACK = dict(num_layers=4, channels=256, num_heads=8, head_features=64,
                 multiplier=2, context_features=128, use_rel_pos=True,
                 rel_pos_num_buckets=32, rel_pos_max_distance=128)
REL_BATCH, REL_TOL = 64, 1e-4
AUDIO_PARITY_BATCH, AUDIO_PARITY_STEPS = 2, 4
# phase 29: the GPT at the reference's class defaults (dim 128, depth 12,
# 8 heads x 64, one KV head, 32 tokens and logits), its MoE and GNN
# variants, the MHA GPT at the same widths, and the continuous and
# Internaldim decoders at the inverse AR preset's widths
GPT_PRESET = dict(dim=128, depth=12, heads=8, dim_head=64, max_tokens=32,
                  logits_dim=32)
GPT_MOE = dict(ff_num_experts=8, ff_expert_top_k=2)
GPT_GNN = dict(gnn_layers=2, use_null_kv=False)
GPT_MHA = dict(dim=128, depth=12, heads=8, max_tokens=32, logits_dim=32)
GPT_REQUESTS, GPT_TOKENS, GPT_TRACED_TOKENS = (1, 16, 1024), 31, 16
GPT_TRAIN_BATCH, GPT_TRAIN_TOKENS = 512, 32
GPT_MOE_BATCH, GPT_MOE_AUX = 64, 1e-2
GPT_SMALL_BATCH = 16
GPT_PARITY_BATCH = 8
# phase 30: the serving artifacts, exported through the CLI's code at the
# notebook presets (the 91M sampler at the tokenizer's vocabulary, its
# inpainter, the AR generator, the encoder), bf16, seeded random weights;
# the float32 check at batch 8; 64 one-row /predict clients
SERVE_BATCH, SERVE_INPAINT_BATCH, SERVE_AR_BATCH = 512, 64, 1024
SERVE_ENCODER_BATCH, SERVE_PARITY_BATCH, SERVE_PARITY_STEPS = 1024, 8, 8
SERVE_PREDICT_CLIENTS, SERVE_WINDOW_MS = 64, 200.0
SERVE_PRESET = "notebook"
# phase 31: the audio assemblies at their presets on 2**15-sample mono
# waveforms, batch 8 (the AR model at the waveform widths in chunks of
# 8,192 samples, patch 16 x 4*4*4*2*2*2: the least length its UNet divides,
# four chunks a waveform), and the graph analogs at their class defaults
# (channels 128, max_length 1,024, a 1,024-wide conditioning of 12
# property scalars; Sparse predicting xyz, Full xyz and the 1,024-column
# adjacency), batch 64; bf16, seeded random weights; requests of 8 sampler
# steps (graph: CFG at scale 2.0); then float32 at batch 2, card against CPU
ASM_SAMPLES, ASM_BATCH, ASM_STEPS, ASM_TRAIN_STEPS = 2 ** 15, 8, 8, 2
ASM_AR_CHUNK = 16 * 4 * 4 * 4 * 2 * 2 * 2
GRAPH_BATCH, GRAPH_COND_SCALE, GRAPH_LENGTH = 64, 2.0, 1024
ASM_PARITY_BATCH, ASM_PARITY_TOL = 2, 1e-4
# phase 32: the data-parallel layer on the one card.  Two spawned ranks of a
# gloo group (NCCL refuses a card twice): the 91M in bf16 at a global batch
# of 1,024 (512 a rank), one warm-up and DP_STEPS steps; float32 at a global
# batch of 8, PARALLEL_FP32_STEPS steps against one card, taken with plain
# SGD at PARALLEL_FP32_LR (Adam moves a parameter ~lr sign(g) a step, so a
# grad near 0 whose last bits differ flips it by 2 lr, and no band on its
# parameters can both hold and see the update; SGD moves them in proportion
# to the grads, past the 1e-4 band, and the check fails unless they moved
# ten times past it); a 64-step CFG request of 512 over both ranks,
# live and from the sampler exported with mesh=, and a float32 one of 8 at
# PARALLEL_FP32_SERVE_STEPS steps.  Then, through NCCL at one rank, the CLI
# under torchrun (phase 27's first run again) and FSDP: FSDP_STEPS steps in
# bf16 at FSDP_BATCH (Adam) and in float32 at 8 (SGD, as above) against
# the unsharded model
PARALLEL_RANKS, PARALLEL_TIMEOUT = 2, 300
DP_BATCH, DP_STEPS = 1024, 2
PARALLEL_FP32_BATCH, PARALLEL_FP32_STEPS, PARALLEL_FP32_LR = 8, 2, 0.1
PARALLEL_FP32_TOL = 1e-4
PARALLEL_SERVE_BATCH, PARALLEL_FP32_SERVE_STEPS = 512, 8
FSDP_BATCH, FSDP_STEPS = 512, 3
PARALLEL_DTYPE = "bfloat16"     # the training and serving runs' dtype
# what the two ranks ask of gloo on the card's tensors (DP and serving the
# first two, FSDP the tensor forms)
PARALLEL_COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
                        "reduce_scatter_tensor")
SERVING_FLAG = "serving"   # written by rank 0 after the live mesh request

# phase 33: the other axes of parallel/ on the one card, two spawned ranks of
# a gloo group: tensor parallelism (the 91M at data 1 x model 2, bf16 at a
# global batch of TP_BATCH), sequence parallelism (the long Model1d at
# SP_BATCH x SP_SAMPLES, attention at 4,096 tokens, 2,048 a rank), pipeline
# parallelism (the AR transformer in 2 stages of 6 layers, PP_MICRO
# micro-batches of AR_TRAIN_BATCH x 64 tokens) and expert parallelism (the
# MoE GPT at GPT_MOE_BATCH x 32 tokens, 4 of its 8 experts a rank): each
# AXES_STEPS steps and a third with its collectives timed, then float32 at
# AXES_FP32_BATCH (the long model at 1 x SP_FP32_SAMPLES) with SGD against
# one card, within PARALLEL_FP32_TOL, the steps moving the parameters ten
# times past it.  A pair of processes of its own probes what gloo takes on
# CUDA tensors of send/recv and all_to_all_single (a refused send/recv
# breaks its pair's connections)
AXES_TIMEOUT, AXES_STEPS, AXES_FP32_STEPS = 420, 2, 2
TP_BATCH, AXES_FP32_BATCH = 512, 8
SP_SAMPLES, SP_BATCH, SP_FP32_SAMPLES = 2 ** 17, 2, 2 ** 16
PP_MICRO = 4
AXES_TARGET_SECONDS = 120

# phase 34: the quality tools (tools/quality_convergence_torch.py) in this
# process on the 91M at the notebook preset (float32, the tool's only
# dtype), on the tool's synthetic corpus of QUALITY_ROWS rows, in chunks of
# one epoch, each chunk evaluated on QUALITY_GENERATE generations of
# NUM_STEPS steps; first the forward transformer one epoch (no kernel: the
# merged summary), then the 91M one epoch, its last curve line dropped as a
# kill between checkpoint and curve would, and resumed to 2 epochs; its
# best.pt served by phase 30's sampler after reload_checkpoint
QUALITY_ROWS, QUALITY_GENERATE, QUALITY_PRESET = 2048, 8, "notebook"

# phase 35: the port's examples and notebooks, each example's main(argv) in
# this process on the card: the four task examples at their notebook presets
# (not --tiny) for one epoch on EXAMPLES_ROWS synthetic rows (540 train: two
# steps at the examples' default batch of 256, float32) with each one's
# eval and checkpoint;
# the tour of simple_models_torch.py at --full (its QMDiffusion the bench
# geometry: its 64-step float32 sample held against the module composition
# on the same draws, within SAMPLE_TOL); phase 30's 91M sampler file served
# by serve_artifact_torch.py with the inverse example's checkpoint; the
# audio tour at its tiny sizes; the Quickstart notebook's code cells
EXAMPLES_ROWS, EXAMPLES_BATCH, EXAMPLES_TARGET_SECONDS = 600, 256, 60
EXAMPLES_TINY, EXAMPLES_FULL = False, True

# phase 36: the stack kernels past the whole-row attention core's 64 rows
# (the tiled core, up to the JAX gate's L 512) at the default audio
# preset's stack (C 512, 8 heads x 64, one layer, batch 2): self-attention
# at L 65 (a ragged tile) to 512, and at L 128 cross-attention on contexts
# of 64 and 200 rows (128 features, as phase 3's), each (L, m) of them;
# then the preset itself (AudioDiffusionModel(in_channels=1), bfloat16,
# seeded random weights) at 2**18 samples, batch 2 (stacks at L 128, 64,
# 32, 32, 32, 64, 128) and 2**20, batch 1 (L 512 ... 512): a 25-step
# request at the reference's sampling kwargs and one warm-up and one timed
# train step, each on the kernels and on the module composition
# (disable_fusion); a float32 denoise at 2**18, batch 1, card against CPU;
# and the native data path on QM9's row count
LONG_STACK_SHAPES = [(65, None), (128, None), (256, None), (512, None),
                     (128, 64), (128, 200)]
LONG_STACK_C, LONG_STACK_BATCH = 512, 2
AUDIO_LONG = ((2 ** 18, 2), (2 ** 20, 1))     # (samples, batch)
AUDIO_LONG_STEPS, AUDIO_LONG_STACKS = 25, 7
AUDIO_LONG_PARITY_SAMPLES = 2 ** 18
QM9_ROWS = 133885

# where the products of the stack kernels (K1 and its variants, K2-K4) and
# of the resnet-run kernel (K8) run: bf16 in one pass, float32 in three TF32
# passes (hi.hi + hi.lo + lo.hi)
TC_PRODUCTS = "tensor cores (wgmma, csrc/gemm_tc.cuh)"
# the card's published dense peaks (NVIDIA's H100 SXM data sheet): bf16
# tensor-core operations a second, device-memory bytes a second; TF32
# tensor-core and float32 CUDA-core operations a second (a float32 product
# of the stack kernels is three TF32 passes: hi.hi + hi.lo + lo.hi)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
TF32_PEAK_FLOPS, F32_PEAK_FLOPS, TF32_PASSES = 495e12, 67e12, 3


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


def bound(flops: float, nbytes: float, f32: bool = False) -> dict:
    """The least milliseconds the card could take: each operation at the
    bf16 peak (``f32``: three TF32 passes of each at the TF32 peak), each
    input byte read and output byte written once."""
    ops = (TF32_PASSES * flops / TF32_PEAK_FLOPS if f32
           else flops / PEAK_FLOPS)
    return {"ops_ms": ops * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3}


def f32_bounds(flops: float, nbytes: float) -> dict:
    """A float32 call's two bounds: three TF32 passes on the tensor cores
    (``bound(..., f32=True)``) and, beside it, the CUDA cores' float32 peak
    (``cuda_core_ops_ms``)."""
    b = bound(flops, nbytes, f32=True)
    b["cuda_core_ops_ms"] = flops / F32_PEAK_FLOPS * 1e3
    return b


def add_bound(summary: dict, b: dict) -> None:
    """Sum a shape's bound into ``summary`` (the larger of the two times
    binds each shape) and keep both sums to say which binds overall; a
    float32 shape's CUDA-core bound (``f32_bounds``) is summed apart."""
    summary["bound_ms"] = summary.get("bound_ms", 0.0) + max(
        b["ops_ms"], b["bytes_ms"])
    if "cuda_core_ops_ms" in b:
        summary["cuda_core_bound_ms"] = summary.get(
            "cuda_core_bound_ms", 0.0) + max(b["cuda_core_ops_ms"],
                                             b["bytes_ms"])
    for k in ("ops_ms", "bytes_ms"):
        summary[k] = summary.get(k, 0.0) + b[k]


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
    shapes; each call, in either dtype, sends every product to the tensor
    cores (float32 as three TF32 passes).  Returns the largest error per
    dtype, and per dtype the kernel's (CUDA events around one call, and the
    card's time of calls back to back) and the plain version's milliseconds
    summed over the four shapes, with the bound of those four calls (float32
    also with its CUDA-core bound)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    worst = {"float32": 0.0, "bfloat16": 0.0}
    sums = {d: {"ms": 0.0, "card_ms": 0.0, "plain_ms": 0.0} for d in worst}
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
                products = tf.gemm_tc_launches()
                out = tf.transformer1d_forward(params, x, ctx, **kw)
                torch.cuda.synchronize()
                products = tf.gemm_tc_launches() - products
                ref = tf.transformer1d_reference(params, x, ctx, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                t_kernel = cuda_ms(
                    lambda: tf.transformer1d_forward(params, x, ctx, **kw))
                t_card = device_ms(
                    lambda: tf.transformer1d_forward(params, x, ctx, **kw))
                t_plain = cuda_ms(
                    lambda: tf.transformer1d_reference(params, x, ctx, **kw))
            want_products = tf.stack_products(layers, cross)
            phase("kernel", stack=name, dtype=dname, batch=STACK_BATCH,
                  max_abs_err=err, tol=KERNEL_TOL[dname],
                  ref_max_abs=ref.float().abs().max().item(),
                  ms=t_kernel, card_ms=t_card, plain_ms=t_plain,
                  gemm_tc_launches=products,
                  want_gemm_tc_launches=want_products)
            if not err <= KERNEL_TOL[dname]:
                raise AssertionError(f"{name} {dname}: kernel differs from "
                                     f"the plain version by {err}")
            if products != want_products:
                raise AssertionError(f"{name} {dname}: K1 sent {products} "
                                     f"products to the tensor cores, "
                                     f"expected {want_products}")
            worst[dname] = max(worst[dname], err)
            sums[dname]["ms"] += t_kernel
            sums[dname]["card_ms"] += t_card
            sums[dname]["plain_ms"] += t_plain
            flops = stack_flops(STACK_BATCH, length, c, layers, cross,
                                *CONTEXT)
            moved = nbytes(x, out, ctx, *tf._kernel_weights(
                params, layers, cross, dtype))
            add_bound(sums[dname], f32_bounds(flops, moved)
                      if dtype == torch.float32 else bound(flops, moved))
    return worst, {d: close_bound(v) for d, v in sums.items()}


def _rel_err(got, want, floor: float = 1e-30) -> float:
    """Largest |got - want| as a fraction of want's largest magnitude (or
    of ``floor``, if that is larger)."""
    scale = max(want.float().abs().max().item(), floor)
    return _abs_err(got, want) / scale


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_backward(dev):
    """Phase 6: the stash forward and K3, K2, K4 against their plain
    versions at the flagship stack shapes, batch 512; every product of each
    call, in either dtype, on the tensor cores (float32 as three TF32
    passes), counted.  Returns, per dtype and kernel, the largest absolute
    error, the kernel (CUDA events around one call, and the card's time of
    calls back to back) and plain milliseconds summed over the four shapes,
    and the bound of those calls (float32 also with its CUDA-core bound);
    and per dtype the backward chain's and the plain chain's milliseconds
    summed over the four shapes (``chain``).  A layer's backward is counted
    as three times its forward products: recomputing them from the stash,
    and a data and a weight gradient for each."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    kernels = ("stash", "conv_out", "layer", "conv_in_gn")
    summary = {d: {k: {"max_abs_err": 0.0, "ms": 0.0, "card_ms": 0.0,
                       "plain_ms": 0.0} for k in kernels}
               for d in ("float32", "bfloat16")}
    chains = {d: {"ms": 0.0, "plain_ms": 0.0} for d in summary}
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
                products = {"stash": tf.gemm_tc_launches()}
                out, stash = tf.transformer1d_forward(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw)
                products["stash"] = tf.gemm_tc_launches() - products["stash"]
                ref, ref_stash = tf.transformer1d_reference(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw)
                pairs = {"stash": [(out, ref)] + [
                    (stash[i], ref_stash[i]) for i in range(stash.shape[0])]}
                # every product of a call on the tensor cores, in either
                # dtype: K3 and K4 CONV_BWD_PRODUCTS each, K2 its layers'
                for fn, plain, key, args in (
                        (tf.bwd_conv_out, tf.bwd_conv_out_reference,
                         "conv_out", (g, ref_stash[-1], w[-2])),
                        (tf.bwd_conv_in_gn, tf.bwd_conv_in_gn_reference,
                         "conv_in_gn", (g, x, w[2], w[0], w[1]))):
                    before = tf.gemm_tc_launches()
                    got = fn(*args)
                    products[key] = tf.gemm_tc_launches() - before
                    pairs[key] = list(zip(got, plain(*args)))

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
                before = tf.gemm_tc_launches()
                layer_outs = run_layers(tf.bwd_layer, ref_stash)
                products["layer"] = tf.gemm_tc_launches() - before
                want_products = {
                    "stash": tf.stack_products(layers, cross),
                    "conv_out": tf.CONV_BWD_PRODUCTS,
                    "layer": tf.stack_products(layers, cross,
                                               backward=True),
                    "conv_in_gn": tf.CONV_BWD_PRODUCTS}
                if products != want_products:
                    raise AssertionError(
                        f"{name} {dname}: the training kernels sent "
                        f"{products} products to the tensor cores, "
                        f"expected {want_products}")
                for got, want in zip(layer_outs,
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
                card = {k: device_ms(a, reps=10, rounds=3)
                        for k, (a, _) in times.items()}
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
                  gemm_tc_launches=products)
            bad = {k: v for k, v in errs.items() if not v <= tol}
            if bad or not stack_err <= tol:
                raise AssertionError(f"{name} {dname}: training kernels "
                                     f"differ from the plain versions: "
                                     f"{bad}, stack grads {stack_err}")
            if not deterministic:
                raise AssertionError(f"{name} {dname}: two backward calls "
                                     f"gave different grads")
            chains[dname]["ms"] += chain_ms
            chains[dname]["plain_ms"] += plain_chain_ms
            for k in kernels:
                got = summary[dname][k]
                got["max_abs_err"] = max(got["max_abs_err"], abs_errs[k])
                got["ms"] += ms[k][0]
                got["card_ms"] += card[k]
                got["plain_ms"] += ms[k][1]
            conv = 4 * batch * length * c * c
            grad32 = 4 * (c * c + 3 * c)     # a float32 dW and vectors
            lw_bytes = sum(nbytes(*lw) + 4 * sum(t.numel() for t in lw)
                           for lw, _ in layer_args)
            limit = (f32_bounds if dtype == torch.float32 else bound)
            limits = {
                "stash": limit(
                    stack_flops(batch, length, c, layers, cross,
                                *CONTEXT),
                    nbytes(x, out, ctx, stash, *w)),
                "conv_out": limit(conv, nbytes(g, g, g, w[-2]) + grad32),
                "layer": limit(
                    3 * layers * stack_layer_flops(batch, length, c,
                                                   cross, *CONTEXT),
                    layers * ((2 + per_stash) * nbytes(g)
                              + 2 * nbytes(ctx)) + lw_bytes),
                "conv_in_gn": limit(conv, nbytes(g, x, g, w[2]) + grad32)}
            for k in kernels:
                add_bound(summary[dname][k], limits[k])
    return ({d: {k: close_bound(v) for k, v in per.items()}
             for d, per in summary.items()}, chains)


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


def inverse_batch(batch, gen, dev, preset=None):
    """Property targets (b, 12) and one-hot SMILES tracks (b, 32, 22), or
    (b, max_length, pred_dim) of another ``preset``."""
    import torch
    import torch.nn.functional as F
    preset = preset or FLAGSHIP
    cond = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    tokens = torch.randint(0, preset["pred_dim"],
                           (batch, preset["max_length"]), generator=gen,
                           device=dev)
    return cond, F.one_hot(tokens, preset["pred_dim"]).float()


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
                want_products = rf.tc_products(w, True)
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
    and the per-row kernel at the cross stacks' shapes, every product on the
    tensor cores in either dtype.  Returns the largest bf16 absolute error,
    the bf16 kernel and plain milliseconds summed over the four shapes, and
    the bound of those calls; under ``float32`` the same in float32."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    sums = {d: {"max_abs_err": 0.0, "ms": 0.0, "card_ms": 0.0,
                "plain_ms": 0.0, "per_row_ms": 0.0}
            for d in ("float32", "bfloat16")}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        summary = sums[dname]
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
                products = tf.gemm_tc_launches()
                out = tf.transformer1d_forward(kp, x, table, uniform_ctx=True,
                                               **kw)
                torch.cuda.synchronize()
                products = tf.gemm_tc_launches() - products
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
                  card_ms=t_card, plain_ms=t_plain, per_row_kernel_ms=t_rows,
                  gemm_tc_launches=products)
            if not rel <= tol:
                raise AssertionError(f"{name} {dname}: the uniform-context "
                                     f"kernel differs by {rel} of scale")
            if products != tf.stack_products(layers, True):
                raise AssertionError(f"{name} {dname}: the uniform-context "
                                     f"kernel sent {products} products to "
                                     f"the tensor cores")
            summary["max_abs_err"] = max(summary["max_abs_err"], err)
            summary["ms"] += t_kernel
            summary["card_ms"] += t_card
            summary["plain_ms"] += t_plain
            summary["per_row_ms"] += t_rows
            flops = stack_flops(NULL_HALF_BATCH, length, c, layers, True, m,
                                CONTEXT[1], kv_rows=m)
            moved = nbytes(x, out, table, *tf._kernel_weights(
                kp, layers, True, dtype))
            add_bound(summary, f32_bounds(flops, moved)
                      if dtype == torch.float32 else bound(flops, moved))
    return {**close_bound(sums["bfloat16"]),
            "float32": close_bound(sums["float32"])}


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


def cli_run(argv):
    """``cli.main(argv)`` in this process, its JSON kept out of the output:
    (payload, host seconds, kernel launches, tensor-core products), the
    counts set to 0 just before and read just after."""
    import io

    import torch
    from moleculediffusiontransformer_tpu_torch import cli
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    torch.cuda.synchronize()
    reset_counts()
    products = tf.gemm_tc_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, counts(), tf.gemm_tc_launches() - products


def model_stacks(model) -> tuple:
    """The Transformer1d stacks of ``model`` and their layers (every stack
    of the models the script counts takes the stack kernel)."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    return len(stacks), sum(m.num_layers for m in stacks)


def task_stacks(task):
    """A task's notebook model on the meta device, with its Transformer1d
    stacks and their layers counted as phase 7 counts them."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import recipes
    with torch.device("meta"):
        model = recipes.build_model(task, device="meta")
    return (model, *model_stacks(model))


def loop_want(stacks, layers, micro_batches, evals):
    """The launches of a train (``micro_batches`` forwards with the stash
    and backward chains: the steps' and the preflight pass's) and of
    ``evals`` denoise evaluations, every other count 0."""
    want = {k: 0 for k in counts()}
    want.update(STASH_LAUNCHES=stacks * micro_batches,
                CONV_OUT_BWD_LAUNCHES=stacks * micro_batches,
                LAYER_BWD_LAUNCHES=layers * micro_batches,
                CONV_IN_GN_BWD_LAUNCHES=stacks * micro_batches,
                LAUNCHES=stacks * evals)
    return want


def check_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: launched {got}, expected {want}")


def resume_agreement(straight_path, resumed_path):
    """Compare two checkpoint files (``checkpoint_agreement``)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        load_checkpoint
    return checkpoint_agreement(*(load_checkpoint(p, torch.device("cpu"))
                                  for p in (straight_path, resumed_path)))


def checkpoint_agreement(a, b):
    """Compare two checkpoints' contents (``checkpoint_state``'s layout):
    how the parameters agree ('bitwise', 'within 1e-6 of scale' or None),
    and the largest difference over a tensor's largest magnitude, with its
    tensor's name, among the parameters and among Adam's moments."""
    import torch
    params = {k: (a["model"][k], b["model"][k]) for k in b["model"]}
    moments = {f"{m}.{k}": (a["adam"][m][k], b["adam"][m][k])
               for m in ("mu", "nu") for k in b["adam"][m]}

    def worst(pairs):
        name = max(pairs, key=lambda k: _rel_err(*pairs[k]))
        return {"max_rel_err": _rel_err(*pairs[name]), "tensor": name,
                "bitwise": all(torch.equal(x, y) for x, y in pairs.values())}

    record = {"params": worst(params), "moments": worst(moments),
              "counts_equal": (a["step"], a["epoch"], a["adam"]["count"])
              == (b["step"], b["epoch"], b["adam"]["count"])}
    held = None
    if record["counts_equal"] and record["params"]["bitwise"]:
        held = "bitwise"
    elif (record["counts_equal"]
          and record["params"]["max_rel_err"] <= RESUME_TOL):
        held = f"within {RESUME_TOL} of scale"
    return held, record


def loop_train_and_resume(tmp, dev):
    """Phase 27, steps 1 and 3: the 91M inverse model trained through the
    CLI (float32, the recipes' default) for 2 epochs into D1, for 1 into
    D2 and resumed there for 1 more; every launch counted; then ``eval``,
    ``sample`` and ``inpaint`` from D1's latest checkpoint; between them the
    Orbax tier's runs (``loop_orbax_tier``).  Returns the straight run's
    launches and the first run's arguments (without its
    directory), losses and launches (phase 32 runs it again under
    ``torchrun``)."""
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        latest_checkpoint
    from moleculediffusiontransformer_tpu_torch.train import recipes
    task = "inverse_diffusion"
    _, stacks, layers = task_stacks(task)
    batch, micro = recipes.PRODUCTION_BATCHES[task]
    d1, d2 = os.path.join(tmp, "d1"), os.path.join(tmp, "d2")
    base = ["train", "--task", task, "--preset", "notebook",
            "--rows", str(LOOP_ROWS), "--batch-size", str(batch),
            "--accumulation-steps", str(micro), "--print-loss-every", "1",
            "--timesteps", str(LOOP_EVAL_STEPS),
            "--num-eval", str(LOOP_NUM_EVAL)]
    evals = 2 * (LOOP_EVAL_STEPS - 1)
    runs, launches = {}, {}
    for name, extra in (("straight", ["--epochs", "2", "--checkpoint-dir",
                                      d1]),
                        ("first", ["--epochs", "1", "--checkpoint-dir", d2]),
                        ("resumed", ["--epochs", "1", "--checkpoint-dir", d2,
                                     "--resume"])):
        out, seconds, launched, _ = cli_run(base + extra)
        steps = out["step"] - (runs["first"]["step"] if name == "resumed"
                               else 0)
        losses = out["losses"]
        want = loop_want(stacks, layers, micro * steps + 1, evals)
        phase("loop_train", run=name, task=task, dtype="float32",
              batch=batch, micro_batches=micro, steps=steps,
              seconds=seconds, losses=losses, launches=launched,
              validity=out["validity_fraction"])
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses} for {steps} "
                                 f"steps")
        check_launches(f"CLI train ({name})", launched, want)
        runs[name], launches[name] = out, launched
    straight_ckpt, resumed_ckpt = latest_checkpoint(d1), latest_checkpoint(d2)
    held, record = resume_agreement(straight_ckpt, resumed_ckpt)
    phase("loop_resume", straight=os.path.basename(straight_ckpt),
          resumed=os.path.basename(resumed_ckpt), held=held, **record,
          losses_equal=runs["straight"]["losses"] == (
              runs["first"]["losses"] + runs["resumed"]["losses"]))
    if held is None:
        raise AssertionError(f"the resumed run's parameters differ from "
                             f"the straight run's: {record}")
    loop_orbax_tier(tmp, dev, straight_ckpt, runs["straight"]["losses"])

    use = ["--preset", "notebook", "--rows", str(LOOP_ROWS),
           "--checkpoint", straight_ckpt]
    for name, argv, steps, n in (
            ("eval", ["eval", "--task", task, *use, "--timesteps",
                      str(LOOP_EVAL_STEPS), "--num-eval",
                      str(LOOP_NUM_EVAL)], LOOP_EVAL_STEPS, None),
            ("sample", ["sample", "--task", task, *use, "--num",
                        str(LOOP_SAMPLE_NUM), "--timesteps",
                        str(LOOP_SAMPLE_STEPS)], LOOP_SAMPLE_STEPS,
             LOOP_SAMPLE_NUM),
            ("inpaint", ["inpaint", LOOP_DRAFT, "--fixed", *LOOP_FIXED,
                         *use, "--timesteps", str(LOOP_SAMPLE_STEPS)],
             LOOP_SAMPLE_STEPS, 4)):
        out, seconds, launched, _ = cli_run(argv)
        smiles = out.get("smiles")
        phase("loop_use", command=name, seconds=seconds, launches=launched,
              smiles=smiles, validity=out.get("validity_fraction"),
              novelty=out.get("novelty_fraction"))
        check_launches(f"CLI {name}", launched,
                       loop_want(stacks, layers, 0, 2 * (steps - 1)))
        if n is not None and len(smiles) != n:
            raise AssertionError(f"CLI {name}: {len(smiles)} SMILES")
        if name == "inpaint" and not all(
                s.startswith(LOOP_DRAFT[:len(LOOP_FIXED)]) for s in smiles):
            raise AssertionError(f"inpaint lost the fixed positions: "
                                 f"{smiles}")
    first = {"argv": base + ["--epochs", "1"],
             "losses": runs["first"]["losses"], "launches": launches["first"]}
    return launches["straight"], first


def loop_orbax_tier(tmp, dev, straight_ckpt, straight_losses):
    """Phase 27, step 1b: the straight CLI run's training again on the Orbax
    checkpoint tier (``TrainConfig.checkpoint_backend="orbax"``):
    ``recipes.train_task``, the CLI's training call, on the CLI's data and
    model at its arguments (float32), 1 epoch into D3 and 1 more resumed
    there, every launch counted; the resumed run's last state (what its
    last save wrote) held to the straight run's checkpoint as the
    single-file tier's resumed one is."""
    import torch
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, load_checkpoint)
    from moleculediffusiontransformer_tpu_torch.core.checkpoint_orbax import \
        OrbaxCheckpointer
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.train import recipes
    task = "inverse_diffusion"
    _, stacks, layers = task_stacks(task)
    batch, micro = recipes.PRODUCTION_BATCHES[task]
    data = prepare_qm9(*synthetic_qm9(LOOP_ROWS, seed=0,
                                      chemically_valid=True), mode=task)
    d3 = os.path.join(tmp, "d3")
    losses = []
    for name, resume in (("first", False), ("resumed", True)):
        model = recipes.build_model(task, data.vocab_size, "notebook",
                                    device=dev, seed=0)
        config = TrainConfig(learning_rate=2e-4, batch_size=batch, epochs=1,
                             seed=0, accumulation_steps=micro,
                             print_loss_every=1, checkpoint_backend="orbax")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, logger = recipes.train_task(task, model, data, config,
                                           checkpoint_dir=d3, resume=resume)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
        run = [r["loss"] for r in logger.history if "loss" in r]
        steps = len(run)
        phase("loop_train_orbax", run=name, task=task, dtype="float32",
              batch=batch, micro_batches=micro, steps=steps, at=state.step,
              seconds=seconds, losses=run, launches=launched)
        if not steps or not all(map(math.isfinite, run)):
            raise AssertionError(f"orbax {name}: losses {run}")
        check_launches(f"Orbax-tier train ({name})", launched,
                       loop_want(stacks, layers, micro * steps + 1, 0))
        losses += run
    # the resumed run's last state (its last save's) on the card against
    # the straight run's checkpoint loaded there
    held, record = checkpoint_agreement(
        load_checkpoint(straight_ckpt, dev), checkpoint_state(model, state))
    phase("loop_resume_orbax", straight=os.path.basename(straight_ckpt),
          committed=OrbaxCheckpointer(d3).all_steps(), held=held, **record,
          losses_equal=losses == straight_losses)
    if held is None:
        raise AssertionError(f"the Orbax tier's resumed run differs from "
                             f"the straight run: {record}")


@contextlib.contextmanager
def checkpoint_timings():
    """Phase 27: the two checkpoint tiers' saves and restores inside
    ``train_diffusion`` while the block runs.  A single-file save
    (``save_step_checkpoint``, synchronous: the step stream waits for all
    of it) timed between two synchronisations, with its file's bytes; every
    ``OrbaxCheckpointer`` the loop makes kept (its ``saves``: the staging
    copy's hold of the step stream from CUDA events, the seconds from
    ``save`` to the commit, the bytes); each restore of either tier timed
    to the synchronisation after it."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    rec = {"single_file": [], "orbax": [], "restores": []}
    names = ("save_step_checkpoint", "restore_checkpoint",
             "restore_train_state", "OrbaxCheckpointer")
    saved = {n: getattr(trainer, n) for n in names}

    def save_step_checkpoint(directory, state, step, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = saved["save_step_checkpoint"](directory, state, step, *args,
                                             **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec["single_file"].append({"step": step, "hold_ms": 1e3 * seconds,
                                   "commit_seconds": seconds,
                                   "bytes": os.path.getsize(path)})
        return path

    def timed(tier, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["restores"].append({"tier": tier,
                                    "seconds": time.perf_counter() - t0})
            return out
        return call

    class Kept(saved["OrbaxCheckpointer"]):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["orbax"].append(self)

    trainer.save_step_checkpoint = save_step_checkpoint
    trainer.restore_checkpoint = timed("single_file",
                                       saved["restore_checkpoint"])
    trainer.restore_train_state = timed("orbax", saved["restore_train_state"])
    trainer.OrbaxCheckpointer = Kept
    try:
        yield rec
    finally:
        for n, fn in saved.items():
            setattr(trainer, n, fn)


def report_checkpoint_tiers(rec) -> None:
    """Phase 27: the line of the two tiers' saves and restores on the 91M
    (``checkpoint_timings``)."""
    orbax = [s for ck in rec["orbax"] for s in ck.saves]
    phase("loop_checkpoint_tiers", single_file_saves=rec["single_file"],
          orbax_saves=orbax, restores=rec["restores"],
          note="hold_ms: the step stream held by a save (single-file: the "
               "whole synchronous save on the host's clock; Orbax: the "
               "staging copy into pinned host memory, CUDA events); the "
               "Orbax write and commit run on the writer thread")
    tiers = [r["tier"] for r in rec["restores"]]
    if len(orbax) != 2 or len(rec["single_file"]) != 4 or sorted(
            tiers) != ["orbax", "single_file"]:
        raise AssertionError(f"checkpoint saves and restores: {rec}")


def loop_step_memory(dev):
    """Phase 27, step 2: ``recipes.train_task`` (the CLI's training call) on
    the 91M inverse model at each of MEMORY_RUNS: peak memory, seconds a
    step from the loop's own clock (the loss read back every step), the
    preflight estimate beside the peak.  Returns the prepared data."""
    import gc

    import torch
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    from moleculediffusiontransformer_tpu_torch.train import (recipes,
                                                              trainer)
    task = "inverse_diffusion"
    data = prepare_qm9(*synthetic_qm9(MEMORY_ROWS, seed=0,
                                      chemically_valid=True), mode=task)
    card = torch.cuda.mem_get_info()[1]
    peaks = {}
    for dtype, batch, micro in MEMORY_RUNS:
        model = recipes.build_model(task, data.vocab_size, "notebook",
                                    dtype=getattr(torch, dtype), device=dev)
        config = TrainConfig(batch_size=batch, epochs=1, print_loss_every=1,
                             accumulation_steps=micro)
        # under cuDNN's deterministic algorithms, as the loop runs it
        with trainer.deterministic_convs():
            estimate = trainer.preflight_memory_check(
                model, trainer.TrainState.create(
                    model, trainer.make_optimizer(config)),
                torch.as_tensor(data.y_train[:batch], device=dev),
                torch.as_tensor(data.X_train[:batch], device=dev), micro)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        products = tf.gemm_tc_launches()
        state, logger = recipes.train_task(task, model, data, config)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        products = tf.gemm_tc_launches() - products
        logged = [r for r in logger.history if "loss" in r]
        elapsed = [r["step"] * batch / r["samples_per_sec"] for r in logged]
        seconds = (elapsed[-1] - elapsed[0]) / (len(elapsed) - 1)
        want_products = (stack_products(model, backward=True)
                         * (micro * state.step + 1))
        peaks[(dtype, micro)] = peak
        phase("loop_step_memory", dtype=dtype, batch=batch,
              micro_batches=micro, steps=state.step,
              seconds_per_step=seconds, samples_per_s=batch / seconds,
              max_memory_allocated=peak, card_bytes=card,
              card_share=peak / card,
              preflight_estimated_bytes=estimate["estimated_bytes"],
              preflight_peak_bytes=estimate["peak_bytes"],
              preflight_over_peak=estimate["estimated_bytes"] / peak,
              losses=[r["loss"] for r in logged], gemm_tc_launches=products,
              want_gemm_tc_launches=want_products)
        if not all(math.isfinite(r["loss"]) for r in logged):
            raise AssertionError(f"{dtype} {micro} x {batch // micro}: "
                                 f"non-finite loss")
        if products != want_products:
            raise AssertionError(f"{dtype} training sent {products} products "
                                 f"to the tensor cores, expected "
                                 f"{want_products}")
        del model, state, logger
        gc.collect()
        torch.cuda.empty_cache()
    needs = peaks[("float32", 1)] > ACCUMULATION_SHARE * card
    planned = recipes.PRODUCTION_BATCHES[task][1]
    phase("loop_production_batches", task=task,
          float32_full_batch_share=peaks[("float32", 1)] / card,
          limit_share=ACCUMULATION_SHARE, accumulation_needed=needs,
          planned=recipes.PRODUCTION_BATCHES[task])
    if needs != (planned > 1):
        raise AssertionError(f"PRODUCTION_BATCHES[{task!r}] accumulates "
                             f"{planned}, but the float32 step peaks at "
                             f"{peaks[('float32', 1)] / card:.2f} of the "
                             f"card")
    return data


def loop_determinism(dev, data):
    """Phase 27, step 2: why the loop runs cuDNN's deterministic algorithms
    (``trainer.deterministic_convs``): the grads of one 91M micro-batch of
    1,024, three times from the same draws, with cuDNN's default and with
    its deterministic algorithms, in float32 and bf16; the tensors whose
    grads differ between the passes, the largest difference over a
    tensor's scale, and seconds a forward and backward."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import recipes
    cond = torch.as_tensor(data.y_train[:1024], device=dev)
    target = torch.as_tensor(data.X_train[:1024], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        model = recipes.build_model("inverse_diffusion", data.vocab_size,
                                    "notebook", dtype=dtype, device=dev)
        params = [(n, p) for n, p in model.named_parameters()]
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            grads, seconds = [], []
            for _ in range(3):
                for _, p in params:
                    p.grad = None
                gen = torch.Generator(device=dev).manual_seed(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(cond, target, gen).backward()
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                grads.append([None if p.grad is None else p.grad.clone()
                              for _, p in params])
            differ = {}
            for i, (name, _) in enumerate(params):
                if grads[0][i] is None:
                    continue
                err = max(_rel_err(g[i], grads[0][i]) for g in grads[1:])
                if err:
                    differ[name] = err
            worst = max(differ, key=differ.get) if differ else None
            phase("loop_determinism", dtype=str(dtype).split(".")[-1],
                  cudnn_deterministic=deterministic, batch=1024,
                  tensors=sum(g is not None for g in grads[0]),
                  tensors_differing=len(differ), worst_tensor=worst,
                  worst_rel_err=differ.get(worst, 0.0),
                  fwd_bwd_seconds=statistics.median(seconds[1:]))
        torch.backends.cudnn.deterministic = False
        del model, params, grads
        torch.cuda.empty_cache()


def loop_other_tasks(tmp):
    """Phase 27, step 4: the three other tasks, one epoch each at their
    notebook presets and production batches through the CLI, then
    ``predict`` or ``sample`` from the checkpoint."""
    import torch
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        latest_checkpoint
    from moleculediffusiontransformer_tpu_torch.train import recipes
    card = torch.cuda.mem_get_info()[1]
    smiles = ["CCO", "C1CC1", LOOP_DRAFT]
    for task in ("forward_diffusion", "inverse_transformer",
                 "forward_transformer"):
        _, stacks, layers = task_stacks(task)
        batch, micro = recipes.PRODUCTION_BATCHES[task]
        directory = os.path.join(tmp, task)
        torch.cuda.reset_peak_memory_stats()
        out, seconds, launched, _ = cli_run(
            ["train", "--task", task, "--preset", "notebook", "--rows",
             str(LOOP_ROWS), "--batch-size", str(batch),
             "--accumulation-steps", str(micro), "--print-loss-every", "1",
             "--timesteps", str(LOOP_EVAL_STEPS), "--num-eval",
             str(LOOP_NUM_EVAL), "--checkpoint-dir", directory])
        peak = torch.cuda.max_memory_allocated()
        losses = out["losses"]
        metrics = {k: out[k] for k in ("r2", "mae", "validity_fraction",
                                       "novelty_fraction") if k in out}
        phase("loop_task_train", task=task, batch=batch,
              micro_batches=micro, steps=out["step"], seconds=seconds,
              max_memory_allocated=peak, card_share=peak / card,
              losses=losses, launches=launched, **metrics)
        if len(losses) != out["step"] or not all(map(math.isfinite,
                                                     losses)):
            raise AssertionError(f"{task}: losses {losses}")
        diffusion = task == "forward_diffusion"
        check_launches(f"CLI train {task}", launched, loop_want(
            stacks, layers, micro * out["step"] + 1,
            2 * (LOOP_EVAL_STEPS - 1)) if diffusion else loop_want(
            0, 0, 0, 0))
        if diffusion and (peak > ACCUMULATION_SHARE * card) != (micro > 1):
            raise AssertionError(f"PRODUCTION_BATCHES[{task!r}] accumulates "
                                 f"{micro}, but training peaks at "
                                 f"{peak / card:.2f} of the card")
        use = ["--task", task, "--preset", "notebook", "--rows",
               str(LOOP_ROWS), "--checkpoint", latest_checkpoint(directory)]
        if task == "inverse_transformer":
            argv = ["sample", *use, "--num", str(LOOP_SAMPLE_NUM)]
        else:
            argv = ["predict", *use, "--timesteps", str(LOOP_EVAL_STEPS),
                    *smiles]
        out, seconds, launched, _ = cli_run(argv)
        phase("loop_task_use", task=task, command=argv[0], seconds=seconds,
              launches=launched, smiles=out.get("smiles"),
              predictions=out.get("predictions"))
        check_launches(f"CLI {argv[0]} {task}", launched, loop_want(
            stacks, layers, 0, 2 * (LOOP_EVAL_STEPS - 1)) if diffusion
            else loop_want(0, 0, 0, 0))
        if task == "inverse_transformer":
            if len(out["smiles"]) != LOOP_SAMPLE_NUM:
                raise AssertionError(f"AR sample: {out['smiles']}")
        elif not all(len(v) == 12 and all(map(math.isfinite, v))
                     for v in out["predictions"].values()):
            raise AssertionError(f"{task} predict: {out['predictions']}")


def loop_fp32_vs_cpu(dev, data):
    """Phase 27, step 5: two float32 ``train_diffusion`` steps of the 91M
    model at batch 8 on the same injected draws, on the card (prefetched
    on a side stream, preflight on) and on the CPU: the losses within
    STEP_LOSS_TOL."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.data.qm9 import \
        batch_iterator
    from moleculediffusiontransformer_tpu_torch.train import (recipes,
                                                              trainer)
    batch, steps = 8, 2
    cpu = torch.device("cpu")
    model = recipes.build_model("inverse_diffusion", data.vocab_size,
                                "notebook", device=cpu)
    g = torch.Generator().manual_seed(27)
    draws = [(torch.exp(-1.2 + 1.2 * torch.randn(batch, generator=g)),
              torch.randn(batch, FLAGSHIP["max_length"], data.vocab_size,
                          generator=g)) for _ in range(steps)]
    X, y = data.X_train[:batch * steps], data.y_train[:batch * steps]
    config = TrainConfig(batch_size=batch, epochs=1, print_loss_every=1)
    results = []
    for m in (copy.deepcopy(model).to(dev), model):
        _, log = trainer.train_diffusion(
            m, lambda: batch_iterator(X, y, batch,
                                      rng=np.random.RandomState(0)),
            config, draws=lambda step: draws[step])
        results.append(([r["loss"] for r in log.history],
                        [p.detach().cpu() for p in m.parameters()]))
    (card, card_p), (plain, plain_p) = results
    err = max(abs(a - b) / abs(b) for a, b in zip(card, plain))
    phase("loop_fp32_vs_cpu", batch=batch, steps=steps, losses=card,
          plain_losses=plain, loss_rel_err=err, tol=STEP_LOSS_TOL,
          params_max_abs_err=max(_abs_err(a, b)
                                 for a, b in zip(card_p, plain_p)))
    if len(card) != steps or not err <= STEP_LOSS_TOL:
        raise AssertionError(f"train_diffusion fp32 card vs CPU: {err}")


def loop_loader_ab(dev, data):
    """Phase 27, step 6: seconds an epoch of bf16 91M training (7 steps of
    1,024) with ``prefetch`` 2 against 0, in turns, after a warm-up."""
    import torch
    from moleculediffusiontransformer_tpu_torch.core.config import \
        TrainConfig
    from moleculediffusiontransformer_tpu_torch.train import recipes
    task = "inverse_diffusion"
    model = recipes.build_model(task, data.vocab_size, "notebook",
                                dtype=torch.bfloat16, device=dev)

    def epoch_seconds(prefetch):
        config = TrainConfig(batch_size=1024, epochs=1, prefetch=prefetch,
                             preflight_memory_check=False,
                             print_loss_every=10 ** 9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recipes.train_task(task, model, data, config)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    epoch_seconds(2)
    turns = [(p, epoch_seconds(p)) for p in LOADER_TURNS]
    phase("loop_loader", steps_an_epoch=len(data.X_train) // 1024,
          turns=[{"prefetch": p, "seconds": t} for p, t in turns])


def train_loop(dev):
    """Phase 27: the training loop, checkpoints and resume, the task
    recipes and the CLI.  Returns the launches of the straight CLI train of
    the 91M model (its steps and its held-out eval) and the record of its
    first one-epoch run (``loop_train_and_resume``)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with checkpoint_timings() as timings:
            launched, first = loop_train_and_resume(tmp, dev)
        report_checkpoint_tiers(timings)
        data = loop_step_memory(dev)
        loop_determinism(dev, data)
        loop_other_tasks(tmp)
    loop_fp32_vs_cpu(dev, data)
    loop_loader_ab(dev, data)
    phase("train_loop_phase_seconds", seconds=time.perf_counter() - t0)
    return launched, first


def count_calls(module):
    """A list that grows by one at every forward of ``module``, and the
    hook's handle."""
    calls = []
    handle = module.register_forward_hook(lambda *args: calls.append(1))
    return calls, handle


STACK_KERNEL_SOURCES = ("transformer1d_fwd.cu", "transformer1d_bwd.cu",
                        "gemm_tc.cuh", "gemm.cuh")


def stack_kernel_pattern():
    """A regex matching the profiler's name of a kernel of the stack
    libraries (K1-K4): a ``__global__`` function of STACK_KERNEL_SOURCES in
    their top-level anonymous namespace (``gtc::`` for the GEMM; a name
    carries its return type only when it is a template's).  ATen's
    kernels in ``at::native::(anonymous namespace)`` do not match.  K8's
    library shares the GEMM's names: callers keep its switch off."""
    import re
    csrc = os.path.join(ROOT, "moleculediffusiontransformer_tpu_torch",
                        "csrc")
    names = set()
    for src in STACK_KERNEL_SOURCES:
        with open(os.path.join(csrc, src)) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)", f.read()))
    return re.compile(r"^(?:void )?\(anonymous namespace\)::(?:gtc::)?"
                      r"(?:%s)[<(]" % "|".join(sorted(names)))


def stack_library_share(fn, top: int = 8):
    """Device ms of ``fn()`` under ``torch.profiler`` and the part of it in
    the stack libraries' kernels (``stack_kernel_pattern``), with the
    ``top`` kernels counted there and outside by device ms, the launches and
    the traced wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion
    if resnet_fusion.resnet_fusion_enabled():
        raise AssertionError("K8 shares the stack GEMM's kernel names: turn "
                             "it off to count the stack kernels")
    pattern = stack_kernel_pattern()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = 0
    kernels = {True: [], False: []}
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if evt.device_type == DeviceType.CUDA:
            us = float(getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0)))
            kernels[bool(pattern.match(evt.key))].append((us, evt.key))
    stack = sum(us for us, _ in kernels[True])
    total = stack + sum(us for us, _ in kernels[False])

    def largest(rows):
        return [[key[:100], us / 1e3] for us, key in sorted(rows)[::-1][:top]]

    return {"device_ms": total / 1e3, "stack_kernels_ms": stack / 1e3,
            "stack_share": stack / total if total else None,
            "launches": launches, "traced_wall_ms": wall_ms,
            "stack_kernels_top_ms": largest(kernels[True]),
            "other_kernels_top_ms": largest(kernels[False])}


def audio_stacks(model):
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    return len(stacks), sum(m.num_layers for m in stacks)


def audio_all_model(dev, dtype, seed=31):
    import torch
    from moleculediffusiontransformer_tpu_torch.diffusion.distributions \
        import make_distribution
    from moleculediffusiontransformer_tpu_torch.models import audio
    return audio.AudioDiffusionConditional(
        **AUDIO_ALL, diffusion_sigma_distribution=make_distribution("vk"),
        dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(seed))


def audio_request(model, what, stacks, evals, gen, emb, **kw):
    """One ``sample_model1d`` request at the audio shape; its output
    finite, clamped, of the request's shape, the sampler's denoise
    evaluations (counted at the UNet) ``evals``, and K1 launched exactly
    stacks x evals (and nothing else).  Returns (output, seconds)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    b = emb.shape[0] if emb is not None else kw.pop("batch")
    calls, handle = count_calls(model.unet)
    reset_counts()
    out, seconds = timed(lambda: audio.sample_model1d(
        model, shape=(b, AUDIO_SAMPLES, model.in_channels), generator=gen,
        num_steps=AUDIO_STEPS, **({} if emb is None else dict(embedding=emb)),
        **kw))
    handle.remove()
    launched = counts()
    phase("audio_request", what=what, batch=b, num_steps=AUDIO_STEPS,
          evals=len(calls), seconds=seconds, launches=launched,
          samples_per_s=b * AUDIO_SAMPLES / seconds,
          finite=bool(torch.isfinite(out).all()))
    if tuple(out.shape) != (b, AUDIO_SAMPLES, model.in_channels) or not (
            torch.isfinite(out).all() and out.abs().max() <= 1):
        raise AssertionError(f"{what}: output {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    if len(calls) != evals:
        raise AssertionError(f"{what}: {len(calls)} evaluations, expected "
                             f"{evals}")
    check_launches(what, launched, loop_want(stacks, 0, 0, evals))
    return out, seconds


def audio_train_step(model):
    """``step(x, gen, **net_kwargs) -> loss``: ``make_model1d_train_step``
    with its own optimizer state."""
    from moleculediffusiontransformer_tpu_torch.train import trainer
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_model1d_train_step(model, opt)
    return lambda x, gen, **kw: step(state, x, gen, **kw)


def audio_train(model, what, stacks, layers, gen, steps, **net_kwargs):
    """One warm-up and ``steps`` timed bf16 steps at AUDIO_BATCH: every loss
    finite, K1 stash, K3, K4 launched stacks x steps, K2 layers x steps and
    nothing else.  Returns the launches."""
    import torch
    step = audio_train_step(model)
    x = torch.rand(AUDIO_BATCH, AUDIO_SAMPLES, model.in_channels,
                   generator=gen, device=gen.device) * 2 - 1
    reset_counts()
    first, first_seconds = timed(lambda: step(x, gen, **net_kwargs))
    losses = [first.item()]
    torch.cuda.reset_peak_memory_stats()
    timed_losses, seconds = timed(
        lambda: [step(x, gen, **net_kwargs) for _ in range(steps)])
    losses += [t.item() for t in timed_losses]
    launched = counts()
    per_step = seconds / steps if steps else None
    phase("audio_train", what=what, batch=AUDIO_BATCH,
          samples=AUDIO_SAMPLES, steps=1 + steps,
          first_step_seconds=first_seconds, seconds_per_step=per_step,
          samples_per_s=AUDIO_BATCH / per_step if steps else None,
          losses=losses,
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=launched)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    check_launches(what, launched, loop_want(stacks, layers, 1 + steps, 0))
    return launched


def stack_inputs(model, run):
    """Each Transformer1d of ``model`` beside the (x, context) it was first
    called with during ``run()`` (no grad)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    seen = {}

    def keep(mod, args, kwargs):
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        seen.setdefault(mod, (args[0].detach().contiguous(),
                              ctx.detach().contiguous()
                              if mod.context_features else None))

    handles = [m.register_forward_pre_hook(keep, with_kwargs=True)
               for m in model.modules() if isinstance(m, Transformer1d)]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return seen


def audio_stack_kernels(model, run):
    """Phase 28: every stack of the bf16 "all" model against the plain
    versions on the activations it gets in ``run()`` (one CFG evaluation):
    K1 at the CFG-doubled batch, and the stash forward, K3, K2 and K4
    output by output at the first AUDIO_BATCH rows with a random output
    grad, as phase 6 does at the 91M shapes.  Each within KERNEL_TOL of its
    plain version's scale; K3 and K4 each sent CONV_BWD_PRODUCTS products
    to the tensor cores.  Launches here are not the main path's."""
    import torch
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    tol = KERNEL_TOL["bfloat16"]
    gen = torch.Generator().manual_seed(36)
    worst = {}
    for i, (mod, (x2, c2)) in enumerate(stack_inputs(model, run).items()):
        kp, geom = mod.kernel_params(), mod._geometry()
        layers, heads, hd = (geom["num_layers"], geom["heads"],
                             geom["head_dim"])
        cross = c2 is not None
        with torch.no_grad():
            pairs = {"fwd": [(tf.transformer1d_forward(kp, x2, c2, **geom),
                              tf.transformer1d_reference(kp, x2, c2,
                                                         **geom))]}
            x = x2[:AUDIO_BATCH]
            ctx = None if c2 is None else c2[:AUDIO_BATCH].to(x.dtype)
            g = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
            w = tf._kernel_weights(kp, layers, cross, x.dtype)
            per_layer, per_stash = (20, 3) if cross else (12, 2)
            out, stash = tf.transformer1d_forward(kp, x, ctx,
                                                  with_stash=True, **geom)
            ref, ref_stash = tf.transformer1d_reference(
                kp, x, ctx, with_stash=True, **geom)
            pairs["stash"] = [(out, ref)] + list(zip(stash, ref_stash))
            products = {}
            for fn, plain, key, args in (
                    (tf.bwd_conv_out, tf.bwd_conv_out_reference, "conv_out",
                     (g, ref_stash[-1], w[-2])),
                    (tf.bwd_conv_in_gn, tf.bwd_conv_in_gn_reference,
                     "conv_in_gn", (g, x, w[2], w[0], w[1]))):
                before = tf.gemm_tc_launches()
                got = fn(*args)
                products[key] = tf.gemm_tc_launches() - before
                pairs[key] = list(zip(got, plain(*args)))
            pairs["layer"] = []
            for j in range(layers):
                s0 = j * per_stash
                args = (g, ref_stash[s0],
                        ref_stash[s0 + 1] if cross else None,
                        ref_stash[s0 + per_stash - 1], ctx,
                        w[4 + j * per_layer:4 + (j + 1) * per_layer])
                got = tf.bwd_layer(*args, heads=heads, head_dim=hd)
                want = tf.bwd_layer_reference(*args, heads=heads,
                                              head_dim=hd)
                pairs["layer"] += [(got[0], want[0])] + list(
                    zip(got[2], want[2]))
                if cross:
                    pairs["layer"].append((got[1], want[1]))
        errs = {k: max(_rel_err(a, b) for a, b in v)
                for k, v in pairs.items()}
        phase("audio_stack_kernels", stack=i, layers=layers,
              channels=x.shape[-1], length=x.shape[1], batch=x2.shape[0],
              train_batch=x.shape[0],
              context=None if c2 is None else list(c2.shape[1:]),
              rel_err=errs, conv_gemm_tc_launches=products, tol=tol)
        bad = {k: v for k, v in errs.items() if not v <= tol}
        if bad or any(v != tf.CONV_BWD_PRODUCTS for v in products.values()):
            raise AssertionError(f"audio stack {i}: kernels differ from the "
                                 f"plain versions {bad}, K3/K4 tensor-core "
                                 f"products {products}")
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def rel_pos_stack(dev):
    """Phase 28: a ``use_rel_pos`` Transformer1d at the 91M cross stack's
    shape, float32: K1-K4 launch 0 times on the card, and its forward and
    backward (every grad) are within REL_TOL of the same on the CPU, as a
    fraction of each tensor's largest magnitude."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    g = torch.Generator().manual_seed(32)
    cpu = Transformer1d(**REL_STACK)
    init_parameters(cpu, g)
    card = copy.deepcopy(cpu).to(dev)
    x = torch.randn(REL_BATCH, 8, 256, generator=g)
    ctx = torch.randn(REL_BATCH, 12, 128, generator=g)
    w = torch.randn(REL_BATCH, 8, 256, generator=g)
    results, launched = [], []
    for m, d in ((card, dev), (cpu, torch.device("cpu"))):
        xx = x.to(d).requires_grad_(True)
        cc = ctx.to(d).requires_grad_(True)
        reset_counts()
        out = m(xx, cc)
        (out * w.to(d)).sum().backward()
        torch.cuda.synchronize()
        launched.append(counts())
        results.append([out.detach().cpu(), xx.grad.cpu(), cc.grad.cpu()]
                       + [p.grad.cpu() for p in m.parameters()])
    launched = launched[0]
    errs = [_rel_err(a, b) for a, b in zip(*results)]
    phase("rel_pos_stack", batch=REL_BATCH, shape=[8, 256], context=[12, 128],
          launches=launched, out_rel_err=errs[0], grad_rel_err=max(errs[1:]),
          tol=REL_TOL)
    if any(launched.values()):
        raise AssertionError(f"a rel-pos stack launched {launched}")
    if not max(errs) <= REL_TOL:
        raise AssertionError(f"rel-pos stack, card vs CPU: {errs}")


def audio_fp32_vs_cpu(dev):
    """Phase 28: the "all"/vk model in float32 at batch 2 on the same
    draws, card against CPU: a 4-step Karras sample at scale 5.0 within
    SAMPLE_TOL; then one step's loss (with the dropout's keep mask handed
    in) within STEP_LOSS_TOL relative and its grads, through K1 stash and
    K3, K2, K4 on the card, within STEP_GRAD_TOL of each grad's scale."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    cpu = torch.device("cpu")
    model = audio_all_model(cpu, torch.float32)
    g = torch.Generator().manual_seed(33)
    b, shape = AUDIO_PARITY_BATCH, (AUDIO_PARITY_BATCH, AUDIO_SAMPLES, 1)
    x = torch.rand(shape, generator=g) * 2 - 1
    emb = torch.randn(b, AUDIO_ALL["embedding_max_length"],
                      AUDIO_ALL["embedding_features"], generator=g)
    sigmas = model.sigma_distribution(b, normals=torch.randn(b, generator=g))
    noise = torch.randn(shape, generator=g)
    keep = torch.tensor([True, False])
    start = torch.randn(shape, generator=g)
    step_noise = torch.randn((AUDIO_PARITY_STEPS - 1,) + shape, generator=g)
    results = []
    for m, d in ((copy.deepcopy(model).to(dev), dev), (model, cpu)):
        out = audio.sample_model1d(
            m.eval(), start.to(d), num_steps=AUDIO_PARITY_STEPS,
            sampler="karras", schedule="karras", step_noise=step_noise.to(d),
            sampler_kwargs={"s_churn": AUDIO_CHURN}, embedding=emb.to(d),
            embedding_scale=AUDIO_SCALE).cpu()
        reset_counts()
        loss = m.train()(x.to(d), sigmas=sigmas.to(d), noise=noise.to(d),
                         embedding=emb.to(d),
                         embedding_mask_proba=AUDIO_MASK_PROBA,
                         embedding_keep=keep.to(d))
        loss.backward()
        launched = counts()
        results.append((loss.item(), out, launched, {
            n: p.grad.cpu() for n, p in m.named_parameters()}))
    (card_loss, card_out, launched, card_grads), (cpu_loss, cpu_out, _,
                                                  cpu_grads) = results
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(_rel_err(card_grads[n], cpu_grads[n], STEP_GRAD_FLOOR)
                   for n in cpu_grads)
    sample_err = _abs_err(card_out, cpu_out)
    phase("audio_fp32_vs_cpu", batch=b, loss=card_loss, plain_loss=cpu_loss,
          loss_rel_err=loss_err, grad_rel_err=grad_err,
          step_launches=launched, sample_steps=AUDIO_PARITY_STEPS,
          sample_max_abs_err=sample_err,
          tol={"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL,
               "sample": SAMPLE_TOL})
    stacks, layers = audio_stacks(model)
    check_launches("audio fp32 step", launched,
                   loop_want(stacks, layers, 1, 0))
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
            and sample_err <= SAMPLE_TOL):
        raise AssertionError(f"audio fp32 card vs CPU: loss {loss_err}, "
                             f"grads {grad_err}, sample {sample_err}")


def audio_options(dev):
    """Phase 28: the ported diffusion options on the audio preset.  Returns
    the training launches of the "all" model."""
    import torch
    from moleculediffusiontransformer_tpu_torch.diffusion import samplers
    from moleculediffusiontransformer_tpu_torch.diffusion.schedules import \
        karras_schedule
    from moleculediffusiontransformer_tpu_torch.models import audio
    t0 = time.perf_counter()
    model = audio_all_model(dev, torch.bfloat16)
    stacks, layers = audio_stacks(model)
    phase("audio_all_model", parameters=sum(p.numel()
                                            for p in model.parameters()),
          stacks=stacks, layers=layers, dtype="bfloat16", **{
              k: v for k, v in AUDIO_ALL.items() if k != "in_channels"})
    gen = torch.Generator(device=dev).manual_seed(34)
    emb = torch.randn(AUDIO_BATCH, AUDIO_ALL["embedding_max_length"],
                      AUDIO_ALL["embedding_features"], generator=gen,
                      device=dev)
    launched = audio_train(model.train(), "all/vk training", stacks, layers,
                           gen, AUDIO_TRAIN_STEPS, embedding=emb,
                           embedding_mask_proba=AUDIO_MASK_PROBA)
    model.eval()
    # Karras: two evaluations a step (sigma_next is never 0 inside the
    # schedule's first AUDIO_STEPS sigmas); ancestral Euler: one
    sampled, _ = audio_request(
        model, "all/vk karras", stacks, 2 * (AUDIO_STEPS - 1), gen, emb,
        sampler="karras", schedule="karras",
        sampler_kwargs={"s_churn": AUDIO_CHURN}, embedding_scale=AUDIO_SCALE)
    audio_request(model, "all/vk aeuler", stacks, AUDIO_STEPS - 1, gen, emb,
                  sampler="aeuler", schedule="karras",
                  embedding_scale=AUDIO_SCALE)

    # where an evaluation's and a training step's device time goes (the
    # first profiler window of a process carries its start-up: take an
    # empty one first)
    stack_library_share(lambda: None)
    x = torch.randn(AUDIO_BATCH, AUDIO_SAMPLES, 1, generator=gen,
                    device=dev)
    sig = torch.full((AUDIO_BATCH,), 1.0, device=dev)
    with torch.no_grad():
        phase("audio_eval_profile", batch=AUDIO_BATCH,
              embedding_scale=AUDIO_SCALE, **stack_library_share(
                  lambda: model.denoise(x, sig, gen, embedding=emb,
                                        embedding_scale=AUDIO_SCALE)))
    model.train()
    step_model = audio_train_step(model)
    phase("audio_step_profile", batch=AUDIO_BATCH, **stack_library_share(
        lambda: step_model(x, gen, embedding=emb,
                           embedding_mask_proba=AUDIO_MASK_PROBA)))
    model.eval()
    del step_model
    audio_stack_kernels(model, lambda: model.denoise(
        x, sig, gen, embedding=emb, embedding_scale=AUDIO_SCALE))

    # span-by-span outpainting over RePaint inpainting, starting from the
    # Karras sample
    sigmas = karras_schedule(SPAN_STEPS)
    calls, handle = count_calls(model.unet)

    def inpaint(source, mask):
        return samplers.inpaint_adpm2(
            lambda x, s: model.denoise(x, s, gen, embedding=emb,
                                       embedding_scale=AUDIO_SCALE),
            source, mask, sigmas, SPAN_STEPS, SPAN_RESAMPLES, generator=gen)

    reset_counts()
    with torch.no_grad():
        spans, seconds = timed(lambda: samplers.span_by_span_compose(
            inpaint, sampled, SPANS))
    handle.remove()
    span_launched = counts()
    phase("audio_span_by_span", spans=SPANS, steps=SPAN_STEPS,
          resamples=SPAN_RESAMPLES, evals=len(calls), seconds=seconds,
          shape=list(spans.shape), launches=span_launched)
    span_evals = SPANS * (SPAN_STEPS - 1) * SPAN_RESAMPLES * 2
    if tuple(spans.shape) != (AUDIO_BATCH, SPANS * AUDIO_SAMPLES // 2, 1) \
            or not torch.isfinite(spans).all() or len(calls) != span_evals:
        raise AssertionError(f"span_by_span_compose: {tuple(spans.shape)}, "
                             f"{len(calls)} evaluations")
    check_launches("span_by_span_compose", span_launched,
                   loop_want(stacks, 0, 0, span_evals))
    del model, sampled, spans

    # the NCCA UNet at the same widths: one request and one step
    ncca = audio.AudioDiffusionModel(
        **AUDIO_NCCA, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(35))
    nstacks, nlayers = audio_stacks(ncca)
    chan = torch.rand(AUDIO_BATCH, AUDIO_SAMPLES, 1, generator=gen,
                      device=dev) * 2 - 1
    ncca_kw = dict(channels_list=[chan], channels_augmentation=True,
                   channels_scale=NCCA_SCALE)
    audio_request(ncca.eval(), "ncca v", nstacks, AUDIO_STEPS - 1, gen, None,
                  batch=AUDIO_BATCH, **ncca_kw)
    audio_train(ncca.train(), "ncca training", nstacks, nlayers, gen, 0,
                **ncca_kw)
    del ncca
    torch.cuda.empty_cache()

    rel_pos_stack(dev)
    audio_fp32_vs_cpu(dev)
    phase("audio_options_phase_seconds", seconds=time.perf_counter() - t0)
    return launched


def gpt_model(cls, dev, dtype, seed, **kw):
    import torch
    return cls(dtype=dtype, device=dev,
               generator=torch.Generator().manual_seed(seed), **kw)


def gpt_ids(batch, tokens, gen, vocab):
    import torch
    return torch.randint(0, vocab, (batch, tokens), generator=gen,
                         device=gen.device)


def gpt_request(model, batch, tokens, gen):
    """One ``generate_gpt`` request from a (b, 1) start of ones: (ids,
    seconds)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        generate_gpt
    start = torch.ones(batch, 1, dtype=torch.long, device=gen.device)
    return timed(lambda: generate_gpt(model, start, gen,
                                      tokens_to_generate=tokens))


def gpt_train(model, what, batch, steps, gen, **kw):
    """One warm-up and ``steps`` timed ``make_gpt_train_step`` steps at
    ``batch`` x GPT_TRAIN_TOKENS: every loss finite."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_gpt_train_step(model, opt, **kw)
    ids = gpt_ids(batch, GPT_TRAIN_TOKENS, gen, GPT_PRESET["logits_dim"])
    losses = [step(state, ids).item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed_losses, seconds = timed(lambda: [step(state, ids)
                                           for _ in range(steps)])
    losses += [t.item() for t in timed_losses]
    per_step = seconds / max(steps, 1)
    record = dict(what=what, batch=batch, tokens=GPT_TRAIN_TOKENS,
                  steps=1 + steps, seconds_per_step=per_step,
                  tokens_per_s=batch * GPT_TRAIN_TOKENS / per_step,
                  losses=losses,
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return record


def gpt_fp32_vs_cpu(dev):
    """Phase 29: each class in float32 at batch 8, card against CPU on the
    same inputs: logits within AR_LOGIT_TOL, one train step's loss within
    STEP_LOSS_TOL relative."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import transformers
    from moleculediffusiontransformer_tpu_torch.train import trainer
    g = torch.Generator().manual_seed(41)
    b = GPT_PARITY_BATCH
    ids = torch.randint(0, 32, (b, GPT_TRAIN_TOKENS), generator=g)
    props = torch.rand(b, 12, generator=g) * 2 - 1
    ar_ids = torch.randint(0, AR_PRESET["logits_dim"], (b, 64), generator=g)
    vectors = torch.randn(b, 31, AR_PRESET["logits_dim"], generator=g)
    keep = torch.tensor([True, False] * (b // 2))
    cases = [
        ("gpt", transformers.MoleculeTransformerGPT, GPT_PRESET, "gpt",
         (ids,)),
        ("gpt_moe", transformers.MoleculeTransformerGPT,
         dict(GPT_PRESET, **GPT_MOE), "gpt", (ids,)),
        ("gpt_gnn", transformers.MoleculeTransformerGPT,
         dict(GPT_PRESET, **GPT_GNN), "gpt", (ids,)),
        ("gpt_mha", transformers.MoleculeTransformerGPTPyTorch, GPT_MHA,
         "gpt", (ids,)),
        ("continuous", transformers.MoleculeTransformer, AR_PRESET,
         "transformer", (props, vectors)),
        ("internaldim", transformers.MoleculeTransformerSequenceInternaldim,
         dict(AR_PRESET, max_tokens=AR_PRESET["logits_dim"]), "transformer",
         (props, ar_ids))]
    for name, cls, kw, kind, inputs in cases:
        cpu_model = gpt_model(cls, "cpu", torch.float32, 42, **kw)
        results = []
        for m, d in ((copy.deepcopy(cpu_model).to(dev), dev),
                     (cpu_model, torch.device("cpu"))):
            args = [t.to(d) for t in inputs]
            opt = trainer.make_optimizer(trainer.OptimizerConfig())
            state = trainer.TrainState.create(m, opt)
            with torch.no_grad():
                logits = (m(*args) if kind == "gpt"
                          else m(*args, cond_drop_prob=0.0)).float().cpu()
            if kind == "gpt":
                loss = trainer.make_gpt_train_step(
                    m, opt, aux_loss_weight=GPT_MOE_AUX)(state, *args)
            else:
                loss = trainer.make_transformer_train_step(m, opt)(
                    state, *args, keep=keep.to(d))
            results.append((logits, loss.item()))
        (card, card_loss), (plain, plain_loss) = results
        logit_err = _abs_err(card, plain)
        loss_err = abs(card_loss - plain_loss) / abs(plain_loss)
        phase("gpt_fp32_vs_cpu", model=name, batch=b,
              logits_max_abs_err=logit_err, loss=card_loss,
              plain_loss=plain_loss, loss_rel_err=loss_err,
              tol={"logits": AR_LOGIT_TOL, "loss": STEP_LOSS_TOL})
        if not (logit_err <= AR_LOGIT_TOL and loss_err <= STEP_LOSS_TOL):
            raise AssertionError(f"{name} fp32 card vs CPU: logits "
                                 f"{logit_err}, loss {loss_err}")


def gpt_family(dev):
    """Phase 29: the GPT family on the card; no kernel lies on its path."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import transformers
    from moleculediffusiontransformer_tpu_torch.nn.moe import moe_capacity
    t0 = time.perf_counter()
    reset_counts()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(43)
    model = gpt_model(transformers.MoleculeTransformerGPT, dev, bf16, 44,
                      **GPT_PRESET).eval()
    phase("gpt_model", parameters=sum(p.numel() for p in model.parameters()),
          dtype="bfloat16", **GPT_PRESET)
    for b in GPT_REQUESTS:
        ids, seconds = gpt_request(model, b, GPT_TOKENS, gen)
        phase("gpt_request", batch=b, tokens=GPT_TOKENS, seconds=seconds,
              tokens_per_s=b * GPT_TOKENS / seconds)
        if tuple(ids.shape) != (b, GPT_TOKENS + 1) or not (
                (ids >= 0) & (ids < GPT_PRESET["logits_dim"])).all():
            raise AssertionError(f"generate_gpt batch {b}: {ids.shape}")
    big = GPT_REQUESTS[-1]
    gpt_request(model, big, GPT_TRACED_TOKENS, gen)
    device_ms_, launches, wall_ms = device_busy(
        lambda: gpt_request(model, big, GPT_TRACED_TOKENS, gen))
    phase("gpt_request_traced", batch=big, tokens=GPT_TRACED_TOKENS,
          device_ms=device_ms_, traced_wall_ms=wall_ms, launches=launches,
          device_busy_share=device_ms_ / wall_ms,
          launches_per_token=launches / GPT_TRACED_TOKENS)
    del model

    train = gpt_model(transformers.MoleculeTransformerGPT, dev, bf16, 44,
                      **GPT_PRESET).train()
    phase("gpt_train", **gpt_train(train, "dense", GPT_TRAIN_BATCH,
                                   TIMED_STEPS, gen))
    del train
    moe = gpt_model(transformers.MoleculeTransformerGPT, dev, bf16, 45,
                    **GPT_PRESET, **GPT_MOE).train()
    tokens = GPT_MOE_BATCH * GPT_TRAIN_TOKENS
    cap = moe_capacity(tokens, GPT_MOE["ff_num_experts"],
                       GPT_MOE["ff_expert_top_k"], 1.25)
    record = gpt_train(moe, "moe", GPT_MOE_BATCH, 3, gen,
                       aux_loss_weight=GPT_MOE_AUX)
    phase("gpt_train", parameters=sum(p.numel() for p in moe.parameters()),
          capacity=cap, dispatch_bytes=tokens * GPT_MOE["ff_num_experts"]
          * cap * 4, aux_losses=[a.item() for a in moe.moe_aux_losses()],
          **record)
    del moe
    gnn = gpt_model(transformers.MoleculeTransformerGPT, dev, bf16, 46,
                    **GPT_PRESET, **GPT_GNN).train()
    phase("gpt_train", **gpt_train(gnn, "gnn", GPT_MOE_BATCH, 1, gen))
    del gnn

    mha = gpt_model(transformers.MoleculeTransformerGPTPyTorch, dev, bf16,
                    47, **GPT_MHA).eval()
    start = torch.ones(GPT_SMALL_BATCH, 1, dtype=torch.long, device=dev)
    ids, seconds = timed(lambda: transformers.generate_gpt_mha(
        mha, start, gen, tokens_to_generate=GPT_TOKENS))
    phase("gpt_mha_request", batch=GPT_SMALL_BATCH, tokens=GPT_TOKENS,
          seconds=seconds, tokens_per_s=GPT_SMALL_BATCH * GPT_TOKENS / seconds)
    if tuple(ids.shape) != (GPT_SMALL_BATCH, GPT_TOKENS + 1):
        raise AssertionError(f"generate_gpt_mha: {ids.shape}")
    del mha

    props = torch.rand(GPT_SMALL_BATCH, 12, generator=gen, device=dev) * 2 - 1
    vec = gpt_model(transformers.MoleculeTransformer, dev, bf16, 48,
                    **AR_PRESET).eval()
    out, seconds = timed(lambda: transformers.generate_vectors(
        vec, props, tokens_to_generate=GPT_TOKENS))
    phase("continuous_request", batch=GPT_SMALL_BATCH, tokens=GPT_TOKENS,
          seconds=seconds, shape=list(out.shape))
    if tuple(out.shape) != (GPT_SMALL_BATCH, GPT_TOKENS,
                            AR_PRESET["logits_dim"]) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"generate_vectors: {tuple(out.shape)}")
    internal = gpt_model(transformers.MoleculeTransformerSequenceInternaldim,
                         dev, bf16, 49, max_tokens=AR_PRESET["logits_dim"],
                         **AR_PRESET).eval()
    ids = gpt_ids(GPT_SMALL_BATCH, 64, gen, AR_PRESET["logits_dim"])
    with torch.no_grad():
        logits, seconds = timed(lambda: internal(props, ids,
                                                 cond_drop_prob=0.0))
    phase("internaldim_forward", batch=GPT_SMALL_BATCH, tokens=64,
          seconds=seconds, shape=list(logits.shape),
          finite=bool(torch.isfinite(logits).all()))
    if not torch.isfinite(logits).all():
        raise AssertionError("Internaldim forward: non-finite logits")
    del vec, internal
    check_no_launches("the GPT family")
    gpt_fp32_vs_cpu(dev)
    check_no_launches("the GPT family")
    phase("gpt_family_phase_seconds", seconds=time.perf_counter() - t0)


def serve_export(dev, tmp, name, task, *args):
    """``python -m ... export`` of ``task`` at ``SERVE_PRESET`` on ``dev``,
    in this process (``cli_run``): the artifact's path.  Export calls each
    program once before tracing it (the launches reported)."""
    path = os.path.join(tmp, name + ".pt2")
    _, seconds, launched, _ = cli_run(
        ["export", "--task", task, "--preset", SERVE_PRESET, "--device",
         dev.type, "--out", path, *args])
    phase("serve_export", artifact=name, task=task, args=list(args),
          seconds=seconds, bytes=os.path.getsize(path),
          launched={k: v for k, v in launched.items() if v})
    return path


def serve_artifact_args(vocab, tvocab):
    """Phase 30's exports: name -> (task, the CLI's arguments), at the
    inverse tokenizer's ``vocab`` and the transformer one's ``tvocab``."""
    def diffusion(batch, steps=NUM_STEPS):
        return ("--vocab", str(vocab), "--timesteps", str(steps),
                "--cond-scale", str(COND_SCALE), "--batch", str(batch))

    inverse, ar, enc = ("inverse_diffusion", "inverse_transformer",
                        "forward_transformer")
    return {
        "sampler": (inverse, diffusion(SERVE_BATCH)),
        "sampler_switches_on": (inverse, diffusion(SERVE_BATCH)),
        "sampler_fp32": (inverse, (*diffusion(SERVE_PARITY_BATCH,
                                              SERVE_PARITY_STEPS),
                                   "--dtype", "float32")),
        "inpainter": (inverse, (*diffusion(SERVE_INPAINT_BATCH),
                                "--inpaint")),
        "generator": (ar, ("--vocab", str(tvocab), "--batch",
                           str(SERVE_AR_BATCH), "--tokens", str(AR_TOKENS),
                           "--cond-scale", str(AR_COND_SCALE))),
        "encoder": (enc, ("--vocab", str(tvocab), "--batch",
                          str(SERVE_ENCODER_BATCH)))}


def serve_model(dev, task, vocab, seed, dtype):
    """The task's model at ``SERVE_PRESET`` with seeded weights on ``dev``,
    in eval mode (its weights are float32 whatever ``dtype`` computes
    in)."""
    from moleculediffusiontransformer_tpu_torch.train import recipes
    return recipes.build_model(task, vocab, SERVE_PRESET, dtype=dtype,
                               device=dev, seed=seed).eval()


def serve_checkpoint(tmp, model, name):
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, save_checkpoint)
    return save_checkpoint(os.path.join(tmp, name + ".pt"),
                           checkpoint_state(model))


def serve_load(dev, path, checkpoint, what):
    """``ArtifactServer`` on ``dev``: the graph tier must serve, its graph
    holding each kernel the wrappers counted (``graph_kernel_nodes``)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.design import ArtifactServer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with kept_graphs():
        server = ArtifactServer(path, checkpoint, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    phase("serve_load", artifact=what, kind=server.kind, tier=server.tier,
          exec_error=server.exec_error, seconds=seconds,
          startup=server.startup, captured_launches=server.launches,
          batch=server.batch, graph_nodes=len(server.program.graph.nodes),
          programs={k: len(p.graph.nodes) for k, p in
                    server.programs.items()},
          constants={k: [str(v.device), *v.shape] for k, v in
                     server.program.constants.items()
                     if isinstance(v, torch.Tensor)})
    if server.tier != "graph":
        raise AssertionError(f"{what}: the graph tier did not capture: "
                             f"{server.exec_error}")
    graph_kernel_nodes(what, server)
    return server


# a kernel each wrapper launches exactly once a call: K1's GroupNorm (also
# under uniform_ctx), K8's SiLU of the mapping (every served run has FiLM)
GRAPH_KERNELS = {
    "group_norm_kernel": ("LAUNCHES", "UNIFORM_LAUNCHES"),
    "silu_kernel": ("RESNET_LAUNCHES",)}


def graph_kernel_pattern(name: str):
    """``name``, mangled or demangled, a template ``__global__`` of the
    port's libraries in their top-level anonymous namespace (which nvcc
    mangles as ``_GLOBAL__N_`` and a name of the file's own); not ATen's
    kernels of the same name, which are not templates, nor at top level."""
    import re
    return re.compile(r"(?:^|[^:\w])(?:_ZN\d+_GLOBAL__N_\w*?%d%sI|"
                      r"\(anonymous namespace\)::%s<)"
                      % (len(name), name, name), re.M)


@contextlib.contextmanager
def kept_graphs():
    """``torch.cuda.CUDAGraph`` made with ``keep_graph=True`` inside: the
    captured ``cudaGraph_t`` is kept, for ``graph_kernel_names``."""
    import torch
    made = torch.cuda.CUDAGraph

    class Kept(made):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_kernel_names(graph) -> list:
    """The (mangled) function name of every kernel node of a captured
    ``torch.cuda.CUDAGraph`` kept by ``kept_graphs``, read through
    libcuda."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} returned CUresult {err}")

    class Params(ctypes.Structure):        # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3),
                    ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = Params()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(p)),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names


def graph_kernel_nodes(what, server, replayed=False):
    """The kernel nodes of ``server``'s captured graph (kept:
    ``kept_graphs``) that run ``GRAPH_KERNELS``: each count must equal the
    launches the wrappers counted while capturing.  A replay runs every
    node of its graph, so a replay launches exactly those.  The graph is
    instantiated here, before its first replay, unless it has ``replayed``
    already (a replay instantiates a kept graph)."""
    names = graph_kernel_names(server._graph)
    if not replayed:
        server._graph.instantiate()
    nodes, want = {}, {}
    for name, counters in GRAPH_KERNELS.items():
        pattern = graph_kernel_pattern(name)
        nodes[name] = sum(bool(pattern.search(n)) for n in names)
        want[name] = sum(server.launches[k] for k in counters)
    phase("serve_graph_nodes", what=what, kernel_nodes_all=len(names),
          kernel_nodes=nodes, launches_captured=want,
          names_seen={k: sorted({n for n in names if k in n})[:3]
                      for k in GRAPH_KERNELS} if nodes != want else None)
    if nodes != want:
        raise AssertionError(f"{what}: the graph's kernel nodes {nodes}, "
                             f"the launches captured {want}")
    return nodes


SERVED_COUNTS = ("LAUNCHES", "UNIFORM_LAUNCHES", "RESNET_LAUNCHES")


def launches_served(servers):
    """K1, uniform_ctx and K8 launches of the requests the servers answered:
    a request's launches (the capture's, which each eager request also
    makes: ``serve_compare`` checks both, and the graph holds: checked by
    ``graph_kernel_nodes``) times the requests of both tiers."""
    return {k: sum(s.launches[k] * (s.served["graph"] + s.served["eager"])
                   for s in servers) for k in SERVED_COUNTS}


def serve_compare(what, server, live_fn, inputs, draws, tol, want,
                  exact=False, eager=True):
    """The artifact on both tiers (``eager=False``: the graph tier alone)
    against ``live_fn()`` on the same weights and draws: each within
    ``tol`` of the live output's scale (``exact``: equal); K1, uniform_ctx
    and K8 launched ``want`` (the rest 0) by the live request, captured in
    the graph, and launched by the eager tier's request.  Each request is
    timed once (rows a second: molecules, tokens generated, predictions).
    Returns (the graph tier's output, seconds by path)."""
    none = {k: 0 for k in counts()}
    reset_counts()
    live, live_s = timed(live_fn)
    check_launches(f"{what}, live", counts(), dict(none, **want))
    check_launches(f"{what}, captured", {
        k: server.launches[k] for k in SERVED_COUNTS},
        {k: want.get(k, 0) for k in SERVED_COUNTS})
    reset_counts()
    graph, graph_s = timed(lambda: server.call(*inputs, **draws))
    check_launches(f"{what}, a replay", counts(), none)
    outs, seconds = {"graph": graph}, {"live": live_s, "graph": graph_s}
    if eager:
        outs["eager"], seconds["eager"] = timed(
            lambda: server.call(*inputs, eager=True, **draws))
        check_launches(f"{what}, eager", counts(), dict(none, **want))
    if exact:
        errs = {f"{k}_mismatches": int((v != live).sum())
                for k, v in outs.items()}
        ok = not any(errs.values())
    else:
        errs = {f"{k}_rel_err": _rel_err(v, live)
                for k, v in outs.items()}
        ok = all(v <= tol for v in errs.values())
    rows = live.shape[0] * (live.shape[1] - 1 if exact else 1)
    phase("serve_vs_live", what=what, tol=None if exact else tol,
          seconds=seconds, rows=rows,
          rows_per_s={k: rows / v for k, v in seconds.items()},
          launches=want, **errs)
    if not ok:
        raise AssertionError(f"{what}: served vs live {errs}")
    return graph, seconds


def trace_events(prof):
    """(name, on the card, start us, end us) of every event a finished
    ``torch.profiler`` window recorded, read from its kineto results as they
    come, without building ``prof.events()``'s function-event tree; times
    from the window's start in whole nanoseconds, as ``prof.events()``
    takes them."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    for e in results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)


def function_events(prof):
    """The same tuples from ``prof.events()``, the profiler's function-event
    list (slow on a long trace: it builds the event tree)."""
    from torch.autograd import DeviceType
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
               e.time_range.end)


def device_spans(events):
    """The traced request's window, the host's ``served_request`` range
    that starts first (the longest of those that start together, as
    ``prof.events()`` sorts them), and the device's spans, (start, end,
    name) sorted, the range's own mark on the device timeline left out."""
    windows, spans = [], []
    for name, on_card, a, b in events:
        if name == "served_request":
            if not on_card:
                windows.append((a, -b))
        elif on_card:
            spans.append((a, b, name))
    a, b = min(windows)
    return (a, -b), sorted(spans)


def hold_trace_reading(what, prof, events):
    """The device spans and the window read from the kineto events
    (``trace_events``) against those read from ``prof.events()`` on the
    same trace: the same spans, names and times, and the same window."""
    t0 = time.perf_counter()
    window, spans = device_spans(function_events(prof))
    got_window, got_spans = device_spans(events)
    names = collections.Counter(n for _, _, n in spans)
    got_names = collections.Counter(n for _, _, n in got_spans)
    worst = max([abs(x - y) for s, g in zip(spans, got_spans)
                 for x, y in zip(s[:2], g[:2])]
                + [abs(x - y) for x, y in zip(window, got_window)])
    record = {"spans": len(spans), "got_spans": len(got_spans),
              "device_ms": sum(b - a for a, b, _ in spans) / 1e3,
              "got_device_ms": sum(b - a for a, b, _ in got_spans) / 1e3,
              "window_ms": (window[1] - window[0]) / 1e3,
              "got_window_ms": (got_window[1] - got_window[0]) / 1e3,
              "max_abs_us": worst,
              "only_in_events": dict(names - got_names),
              "only_in_kineto": dict(got_names - names)}
    phase("serve_trace_reading", what=what, **record,
          seconds=time.perf_counter() - t0)
    if (names != got_names or worst > 1e-3
            or [n for _, _, n in spans] != [n for _, _, n in got_spans]):
        raise AssertionError(f"{what}: the kineto events' device spans "
                             f"differ from prof.events()': {record}")


def replay_trace(what, server, inputs, hold_reading=False):
    """A graph replay under ``torch.profiler``: the device's kernels and
    copies in it (device ms, and the busy ms: the union of their intervals),
    the host launches, the busy share (busy ms over the traced request's
    own milliseconds, from the same trace), the stack kernels and
    ``GRAPH_KERNELS`` seen running in it (the profiler may lose records of
    a long graph: the graph's own nodes are counted by
    ``graph_kernel_nodes``) and the largest kernels by device ms; the
    seconds of the traced call and of reading its events.  With
    ``hold_reading`` the reading is held to ``prof.events()``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    pattern = stack_kernel_pattern()
    named = {k: graph_kernel_pattern(k) for k in GRAPH_KERNELS}
    _, untraced = timed(lambda: server.call(*inputs, seed=1))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("served_request"):
            server.call(*inputs, seed=1)
            torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    events = list(trace_events(prof))
    request, spans = device_spans(events)
    launches = sum(name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                   for name, _, _, _ in events)
    graph_launches = sum(name == "cudaGraphLaunch"
                         for name, _, _, _ in events)
    stack, by_name = {}, {}
    seen = {k: 0 for k in GRAPH_KERNELS}
    for a, b, name in spans:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (b - a)
        if pattern.match(name):
            stack[name[:60]] = stack.get(name[:60], 0) + 1
        for k, pat in named.items():
            seen[k] += bool(pat.search(name))
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = request[1] - request[0]
    out = {"device_ms": sum(b - a for a, b, _ in spans) / 1e3,
           "busy_ms": busy / 1e3, "traced_request_ms": window / 1e3,
           "busy_share": busy / window, "untraced_ms": untraced * 1e3,
           "kernel_launches": launches, "graph_launches": graph_launches,
           "stack_kernels_run": sum(stack.values()),
           "graph_kernels_run": seen,
           "graph_kernels_captured": {
               k: sum(server.launches[c] for c in counters)
               for k, counters in GRAPH_KERNELS.items()},
           "top_kernels_ms": [[k, v / 1e3] for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8]]}
    if hold_reading:
        hold_trace_reading(what, prof, events)
    phase("serve_replay_trace", what=what,
          seconds=time.perf_counter() - t0, traced_seconds=traced_s,
          events=len(events), **out)
    return out


def http_json(base, route, payload=None):
    """(status, JSON) of a GET (no payload) or POST to the daemon."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def http_daemon(server, data, **kw):
    """``make_httpd`` on localhost (a free port), served from a thread;
    shut down and closed on exit."""
    import threading
    from moleculediffusiontransformer_tpu_torch.design.http_serve import \
        make_httpd
    httpd = make_httpd(server, data.tokenizer, data.scaler, data.smiles,
                       port=0, quiet=True, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def serve_http(servers, inv, tr, ck_b, ck_a):
    """Phase 30's HTTP part: every route against the direct call."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor as Pool
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
        add_start_end_char, one_hot_signed, pad_sequences,
        remove_start_end_token_first)
    from moleculediffusiontransformer_tpu_torch.design import decode_one_hot
    t0 = time.perf_counter()
    checks = {}
    physical = inv.scaler.inverse_transform(
        np.asarray(inv.y_test[:2], np.float32))
    rows = [[float(v) for v in r] for r in physical]
    scaled = np.asarray(inv.scaler.transform(physical.astype(np.float32)),
                        np.float32)[:, :12]
    sampler, inpainter, generator, encoder = servers
    with http_daemon(sampler, inv) as (base, _):
        status, health = http_json(base, "/healthz")
        checks["healthz_tier"] = health["tier"]
        _, out = http_json(base, "/sample", {"properties": rows, "seed": 7})
        direct = decode_one_hot(sampler.call_padded(scaled, seed=7),
                                inv.tokenizer)
        checks["sample"] = out["smiles"] == direct
        status, rep = http_json(base, "/reload", {"checkpoint": ck_b})
        _, out = http_json(base, "/sample", {"properties": rows, "seed": 7})
        direct_b = decode_one_hot(sampler.call_padded(scaled, seed=7),
                                  inv.tokenizer)
        checks["reload"] = (status == 200 and out["smiles"] == direct_b
                            and rep["restored_from"] == ck_b)
        http_json(base, "/reload", {"checkpoint": ck_a})
        _, metrics = http_json(base, "/metrics")
        checks["metrics"] = (metrics["routes"]["/sample"]["count"] == 2
                             and metrics["routes"]["/reload"]["count"] == 2)
    with http_daemon(inpainter, inv) as (base, _):
        draft, fixed = inv.smiles[0], list(INPAINT_FIXED)
        _, out = http_json(base, "/inpaint", {"properties": rows,
                                              "draft": draft,
                                              "fixed": fixed, "seed": 3})
        length, width = inpainter.specs[1].shape[1:]
        ids = pad_sequences(inv.tokenizer.texts_to_sequences([draft]),
                            length)
        source = np.repeat(one_hot_signed(ids, width), 2,
                           axis=0).astype(np.float32)
        mask = np.zeros((2, length, width), bool)
        mask[:, fixed, :] = True
        direct = decode_one_hot(inpainter.call_padded(scaled, source, mask,
                                                      seed=3), inv.tokenizer)
        checks["inpaint"] = out["smiles"] == direct
    tphysical = tr.scaler.inverse_transform(
        np.asarray(tr.y_test[:2], np.float32))
    trows = [[float(v) for v in r] for r in tphysical]
    tscaled = np.asarray(tr.scaler.transform(
        tphysical.astype(np.float32)), np.float32)[:, :12]
    with http_daemon(generator, tr) as (base, _):
        _, out = http_json(base, "/generate", {"properties": trows,
                                               "seed": 11})
        start = np.full((2, 1), tr.tokenizer.word_index.get("@", 1),
                        np.int64)
        ids = generator.call_padded(tscaled, start, seed=11)
        checks["generate"] = out["smiles"] == [
            remove_start_end_token_first(t) for t in tr.tokenizer.decode(ids)]
    with http_daemon(encoder, tr, batch_window_ms=SERVE_WINDOW_MS) as (
            base, _):
        mols = [tr.smiles[i] for i in range(SERVE_PREDICT_CLIENTS)]
        with Pool(SERVE_PREDICT_CLIENTS) as pool:
            answers = list(pool.map(
                lambda m: http_json(base, "/predict", {"smiles": [m]}),
                mols))
        _, metrics = http_json(base, "/metrics")
        ids = pad_sequences(tr.tokenizer.texts_to_sequences(
            add_start_end_char(mols)), encoder.specs[0].shape[1])
        logits = encoder.call_padded(np.asarray(ids, np.int64))
        direct = tr.scaler.inverse_transform(
            logits.reshape(len(mols), -1)[:, :12])
        got = np.asarray([a[1]["properties"][0] for a in answers])
        batching = metrics["predict_batching"]
        checks["predict_status"] = all(a[0] == 200 for a in answers)
        checks["predict_max_abs_diff"] = float(np.abs(got - direct).max())
        checks["predict_coalesced"] = batching["device_calls"] < len(mols)
        checks["predict_batching"] = batching
    seconds = time.perf_counter() - t0
    phase("serve_http", seconds=seconds, **checks)
    bad = [k for k in ("sample", "reload", "metrics", "inpaint", "generate",
                       "predict_status", "predict_coalesced")
           if checks[k] is not True]
    if (bad or checks["healthz_tier"] != "graph"
            or checks["predict_max_abs_diff"] != 0.0):
        raise AssertionError(f"the HTTP routes: {checks}")


def serving_artifacts(dev, inv, tr, tmp):
    """Phase 30: export, load and serve the four artifact kinds on the card
    against the live path, time the tiers, and drive the HTTP routes; the
    artifacts and checkpoints go into the directory ``tmp``.  Returns the
    K1, uniform_ctx and K8 launches of the served requests and the 91M
    sampler's server (phase 34 serves a trained checkpoint on it, phase 35
    its file, ``tmp``/sampler.pt2)."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
        add_start_end_char, one_hot_signed, pad_sequences)
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import (
        inpaint, sample)
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        generate_sequence
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(30)
    bf16, f32 = torch.bfloat16, torch.float32

    def k1(steps, on=False):
        """A request's K1 (and with the switches on, uniform_ctx and K8)
        launches: stacks (runs) x evaluations."""
        evals = 2 * (steps - 1)
        want = {"LAUNCHES": STACKS_PER_EVAL * evals}
        if on:
            want.update(UNIFORM_LAUNCHES=CROSS_STACKS_PER_EVAL * evals,
                        RESNET_LAUNCHES=RESNET_RUNS_PER_EVAL * evals)
        return want
    inv_task, ar_task, enc_task = ("inverse_diffusion", "inverse_transformer",
                                   "forward_transformer")
    exports = serve_artifact_args(inv.vocab_size, tr.vocab_size)

    def export(name):
        return serve_export(dev, tmp, name, exports[name][0],
                            *exports[name][1])

    model_a = serve_model(dev, inv_task, inv.vocab_size, 0, bf16)
    model_b = serve_model(dev, inv_task, inv.vocab_size, 1, bf16)
    ck_a = serve_checkpoint(tmp, model_a, "inverse_a")
    ck_b = serve_checkpoint(tmp, model_b, "inverse_b")

    # the 91M sampler, bf16, batch 512, both switches off (the default)
    sampler = serve_load(dev, export("sampler"), ck_a, "sampler")
    props = torch.rand(SERVE_BATCH, 12, generator=gen, device=dev) * 2 - 1
    track = (SERVE_BATCH, *sampler.meta["shape"])
    draws = dict(noise=torch.randn(track, generator=gen, device=dev),
                 step_noise=torch.randn((NUM_STEPS - 1, *track),
                                        generator=gen, device=dev))

    def live_sample(model, p=props, d=draws):
        return sample(model, p, num_steps=NUM_STEPS, cond_scale=COND_SCALE,
                      **d)

    with torch.no_grad():
        _, sampler_times = serve_compare(
            "sampler bf16 512", sampler, lambda: live_sample(model_a),
            (props,), draws, KERNEL_TOL["bfloat16"], k1(NUM_STEPS))
        sampler_trace = replay_trace("sampler bf16 512", sampler, (props,))
    if sampler_trace["stack_kernels_run"] <= 0:
        raise AssertionError(f"no stack kernel ran in a traced replay: "
                             f"{sampler_trace}")

    # both switches on: bf16 batch 512, then reloaded to second weights;
    # float32 at batch 8 on both tiers, then reloaded
    switches(True)
    try:
        sampler_on = serve_load(dev, export("sampler_switches_on"), ck_a,
                                "sampler switches on")
        with torch.no_grad():
            _, on_times = serve_compare(
                "sampler bf16 512 switches on", sampler_on,
                lambda: live_sample(model_a), (props,), draws,
                KERNEL_TOL["bfloat16"], k1(NUM_STEPS, True), eager=False)
            sampler_on.reload_checkpoint(ck_b)
            serve_compare("sampler bf16 512 switches on, reloaded",
                          sampler_on, lambda: live_sample(model_b), (props,),
                          draws, KERNEL_TOL["bfloat16"],
                          k1(NUM_STEPS, True), eager=False)
        sampler32 = serve_load(dev, export("sampler_fp32"), ck_a,
                               "sampler float32")
        p8 = props[:SERVE_PARITY_BATCH].contiguous()
        d8 = {"noise": draws["noise"][:SERVE_PARITY_BATCH].contiguous(),
              "step_noise": draws["step_noise"][
                  :SERVE_PARITY_STEPS - 1, :SERVE_PARITY_BATCH].contiguous()}
        with torch.no_grad():
            for seed, ck, what in ((0, None, "sampler fp32 8"),
                                   (1, ck_b, "sampler fp32 8, reloaded")):
                if ck:
                    sampler32.reload_checkpoint(ck)
                m32 = serve_model(dev, inv_task, inv.vocab_size, seed, f32)
                serve_compare(what, sampler32, lambda: sample(
                    m32, p8, num_steps=SERVE_PARITY_STEPS,
                    cond_scale=COND_SCALE, **d8), (p8,), d8,
                    KERNEL_TOL["float32"], k1(SERVE_PARITY_STEPS, True))
        del m32
    finally:
        switches(False)
    del model_b

    # the inpainter, bf16, batch 64: a draft's first positions kept
    inpainter = serve_load(dev, export("inpainter"), ck_a, "inpainter")
    length, width = inpainter.specs[1].shape[1:]
    ids = pad_sequences(inv.tokenizer.texts_to_sequences([inv.smiles[0]]),
                        length)
    source = torch.from_numpy(np.repeat(one_hot_signed(ids, width),
                                        SERVE_INPAINT_BATCH, 0)).float()
    mask = torch.zeros(source.shape, dtype=torch.bool)
    mask[:, list(INPAINT_FIXED)] = True
    source, mask = source.to(dev), mask.to(dev)
    ip_props = props[:SERVE_INPAINT_BATCH].contiguous()
    shape = tuple(source.shape)
    ip_draws = dict(
        noise=torch.randn(shape, generator=gen, device=dev),
        source_noise=torch.randn((NUM_STEPS - 1, *shape), generator=gen,
                                 device=dev),
        step_noise=torch.randn((NUM_STEPS - 1, 1, *shape), generator=gen,
                               device=dev))
    with torch.no_grad():
        out, _ = serve_compare("inpainter bf16 64", inpainter, lambda: inpaint(
            model_a, ip_props, source, mask, num_steps=NUM_STEPS,
            cond_scale=COND_SCALE, **ip_draws), (ip_props, source, mask),
            ip_draws, KERNEL_TOL["bfloat16"], k1(NUM_STEPS))
    if not torch.equal(out[mask], source[mask]):
        raise AssertionError("the inpainter changed a kept position")

    # the AR generator, bf16, batch 1,024, 63 tokens: no kernel on its path
    ar_live = serve_model(dev, ar_task, tr.vocab_size, 0, bf16)
    generator = serve_load(dev, export("generator"),
                           serve_checkpoint(tmp, ar_live, "ar"), "generator")
    ar_props = torch.rand(SERVE_AR_BATCH, 12, generator=gen, device=dev)
    start = torch.ones(SERVE_AR_BATCH, 1, dtype=torch.long, device=dev)
    uniforms = torch.rand((AR_TOKENS, SERVE_AR_BATCH, tr.vocab_size),
                          generator=gen, device=dev)
    _, ar_times = serve_compare(
        "generator bf16 1024", generator,
        lambda: generate_sequence(
            ar_live, ar_props, start, uniforms=uniforms,
            tokens_to_generate=AR_TOKENS, cond_scale=AR_COND_SCALE,
            filter_thres=AR_FILTER_THRES),
        (ar_props, start), {"uniforms": uniforms}, None, {}, exact=True)
    ar_trace = replay_trace("generator bf16 1024", generator,
                            (ar_props, start))

    # the encoder, bf16, batch 1,024 SMILES
    enc_live = serve_model(dev, enc_task, tr.vocab_size, 0, bf16)
    encoder = serve_load(dev, export("encoder"),
                         serve_checkpoint(tmp, enc_live, "enc"), "encoder")
    smiles = [tr.smiles[i % len(tr.smiles)]
              for i in range(SERVE_ENCODER_BATCH)]
    enc_ids = torch.as_tensor(np.asarray(pad_sequences(
        tr.tokenizer.texts_to_sequences(add_start_end_char(smiles)),
        encoder.specs[0].shape[1]), np.int64), device=dev)
    with torch.no_grad():
        _, enc_times = serve_compare(
            "encoder bf16 1024", encoder, lambda: enc_live(enc_ids),
            (enc_ids,), {}, KERNEL_TOL["bfloat16"], {})
        enc_trace = replay_trace("encoder bf16 1024", encoder, (enc_ids,),
                                 hold_reading=True)

    serve_http((sampler, inpainter, generator, encoder), inv, tr, ck_b, ck_a)
    served = launches_served((sampler, sampler_on, sampler32, inpainter,
                              generator, encoder))
    phase("serving", seconds=time.perf_counter() - t_phase,
          launches_served=served,
          graph_speedup_over_live={
              name: t["live"] / t["graph"]
              for name, t in (("sampler", sampler_times),
                              ("sampler_switches_on", on_times),
                              ("generator", ar_times),
                              ("encoder", enc_times))},
          busy_share={"sampler": sampler_trace["busy_share"],
                      "generator": ar_trace["busy_share"],
                      "encoder": enc_trace["busy_share"]})
    return served, sampler


def _wave_loss_module(vocoder):
    """``vocoder.loss_from_wave`` as a module whose call is ``(x, generator,
    sigmas=, noise=)``, so that ``make_model1d_train_step`` trains the
    vocoder on waves."""
    import torch

    class WaveLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vocoder = vocoder

        def forward(self, x, generator=None, **kwargs):
            return self.vocoder.loss_from_wave(x, generator, **kwargs)

    return WaveLoss()


def assembly_cases():
    """Phase 31's models: name -> (build(device, dtype), kind).  The audio
    kinds train on (b, 2**15, 1) waves through ``make_model1d_train_step``
    (the vocoder through ``loss_from_wave``), the graph ones on (b, 12)
    property scalars and packed (b, 1,024, 4 + neighbours) tensors through
    ``make_diffusion_train_step``."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio, graph

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    def preset(fn, seed, **kw):
        return lambda dev, dtype: fn(1, dtype=dtype, device=dev,
                                     generator=seeded(seed), **kw)

    def ar(dev, dtype):
        return audio.build_model1d(
            dev, seeded(45), audio.DiffusionAR1d, in_channels=1,
            chunk_length=ASM_AR_CHUNK, context_channels=(1,), dtype=dtype,
            **audio.get_default_model_kwargs())

    def analog(cls, seed, pred_dim):
        return lambda dev, dtype: graph.build_graph_model(
            cls, dev, seeded(seed), pred_dim=pred_dim, dtype=dtype)

    return {
        "upsampler": (preset(audio.AudioDiffusionUpsampler, 41,
                             factor=(2,)), "upsampler"),
        "autoencoder": (preset(audio.AudioDiffusionAE, 42), "autoencoder"),
        "vocoder": (preset(audio.AudioDiffusionVocoder, 43), "vocoder"),
        "upphaser": (preset(audio.AudioDiffusionUpphaser, 44), "upphaser"),
        "ar": (ar, "ar"),
        "graph_sparse": (analog(graph.AnalogDiffusionSparse, 46, 3),
                         "graph"),
        "graph_full": (analog(graph.AnalogDiffusionFull, 47,
                              3 + GRAPH_LENGTH), "graph"),
    }


def assembly_inputs(model, kind, batch, gen, dev):
    """A batch for ``model``: waves in [-1, 1] (b, 2**15, 1); for the graph
    models property scalars (b, 12) and a packed (b, 1,024, 4 + neighbour
    columns) tensor."""
    import torch
    if kind != "graph":
        return (torch.rand(batch, ASM_SAMPLES, 1, generator=gen,
                           device=dev) * 2 - 1,)
    seq = torch.rand(batch, 12, generator=gen, device=dev) * 2 - 1
    cols = model.max_length if model.pred_dim > 3 else model.max_neighbors
    packed = torch.randn(batch, GRAPH_LENGTH, 4 + cols, generator=gen,
                         device=dev)
    return seq, packed


def assembly_request(model, kind, inputs, gen, num_steps=ASM_STEPS):
    """The kind's sampler on ``inputs``: (output, denoise evaluations the
    sampler makes, the output's shape, whether it is clamped to
    [-1, 1])."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    from moleculediffusiontransformer_tpu_torch.models import \
        qm_diffusion as qm
    evals = num_steps - 1
    if kind == "graph":
        seq = inputs[0]
        out = qm.sample(model, seq, gen, num_steps=num_steps,
                        cond_scale=GRAPH_COND_SCALE)
        return out, 2 * evals, (seq.shape[0], model.max_length,
                                model.pred_dim), False
    x = inputs[0]
    shape = tuple(x.shape)
    if kind == "upsampler":
        out = audio.sample_upsampler(model, x[:, ::2], gen,
                                     num_steps=num_steps)
    elif kind == "upphaser":
        out = audio.sample_upsampler(model, x, gen, factor=1,
                                     num_steps=num_steps)
    elif kind == "autoencoder":
        with torch.no_grad():
            latent = model.encode(x)
        out = audio.decode_ae(
            model, latent, gen,
            downsample_factor=model.encoder.downsample_factor,
            num_steps=num_steps)
    elif kind == "vocoder":
        magnitude, _ = model.stft.encode(x)
        out = audio.sample_vocoder(model, magnitude, gen,
                                   num_steps=num_steps)
        return out, evals, shape, False
    else:                                  # ar: chunk after chunk
        out = audio.sample_ar(model, torch.randn(
            shape, generator=gen, device=x.device), gen,
            num_steps=num_steps)
        evals *= shape[1] // model.chunk_length
    return out, evals, shape, True


def assembly_train_step(model, kind):
    """``step(inputs, gen) -> loss``: one Adam step (2e-4, clip 0.5) with
    its own optimizer state."""
    from moleculediffusiontransformer_tpu_torch.train import trainer
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    if kind == "graph":
        step = trainer.make_diffusion_train_step(model, opt)
        return lambda inputs, gen: step(state, *inputs, gen)
    if kind == "vocoder":
        step = trainer.make_model1d_train_step(_wave_loss_module(model), opt)
    else:
        step = trainer.make_model1d_train_step(model, opt)
    return lambda inputs, gen: step(state, inputs[0], gen)


def assembly_stack_kernels(model, run):
    """K1 against its plain version at each stack shape of ``model`` (on
    the activations it gets in ``run()``, bf16), within KERNEL_TOL; one
    stack of each (L, C, layers, context) shape.  Launches here are not the
    main path's.  Returns the shapes and the largest error."""
    import torch
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    shapes, worst = [], 0.0
    for mod, (x, c) in stack_inputs(model, run).items():
        geom = mod._geometry()
        key = [x.shape[1], x.shape[2], geom["num_layers"],
               None if c is None else c.shape[1]]
        if key in shapes:
            continue
        kp = mod.kernel_params()
        with torch.no_grad():
            err = _rel_err(tf.transformer1d_forward(kp, x, c, **geom),
                           tf.transformer1d_reference(kp, x, c, **geom))
        shapes.append(key)
        worst = max(worst, err)
        if not err <= KERNEL_TOL["bfloat16"]:
            raise AssertionError(f"K1 at (L, C, layers, context) {key}: "
                                 f"{err} from the plain version")
    return shapes, worst


def assembly_eval_run(model, kind, inputs, gen):
    """One denoise evaluation of ``model`` at a mid sigma (the sampler's
    closure), for ``stack_inputs``."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    dev = inputs[0].device
    if kind == "graph":
        seq = inputs[0]
        emb = model.embed_conditioning(seq)
        x = torch.randn(seq.shape[0], model.max_length, model.pred_dim,
                        generator=gen, device=dev)
        sig = torch.full((seq.shape[0],), 0.5, device=dev)
        return lambda: model.denoise(x, sig, emb, GRAPH_COND_SCALE)
    x = inputs[0]
    sig = torch.full((x.shape[0],), 0.5, device=dev)
    if kind == "vocoder":
        mag, _ = model.stft.encode(x)
        flat = audio._spectrogram_1d(mag)
        return lambda: model.denoise_vocoder(torch.randn_like(flat), sig,
                                             flat)
    if kind == "autoencoder":
        return lambda: model.denoise_latent(x, sig, model.encode(x))
    if kind == "ar":
        chunk = x[:, :model.chunk_length]
        return lambda: model.denoise_chunk(chunk, sig, chunk)
    return lambda: model.denoise_upsample(x, sig, x)


def assembly_parity_calls(model, kind, inputs, draws):
    """(denoised, loss) of ``model`` on ``inputs`` with every draw handed
    in: one denoise evaluation and the training loss, no grad."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    sig, noise = draws["sigmas"], draws["noise"]
    with torch.no_grad():
        if kind == "graph":
            seq, packed = inputs
            emb = model.embed_conditioning(seq)
            den = model.denoise(draws["x"], sig, emb, GRAPH_COND_SCALE)
            loss = model(seq, packed, sigmas=sig, noise=noise)
            return den, loss
        x = inputs[0]
        if kind == "vocoder":
            mag, phase = model.stft.encode(x)
            flat = audio._spectrogram_1d(mag)
            den = model.denoise_vocoder(draws["x"], sig, flat)
            return den, model(mag, phase, sigmas=sig, noise=noise)
        if kind == "autoencoder":
            den = model.denoise_latent(x, sig, model.encode(x))
            return den, model(x, sigmas=sig, noise=noise)
        if kind == "ar":
            chunk = x[:, :model.chunk_length]
            den = model.denoise_chunk(chunk, sig, draws["x"])
            return den, model(x, chunk_index=1, dropped=draws["dropped"],
                              sigmas=sig, noise=noise)
        index = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        den = model.denoise_upsample(x, sig, draws["x"])
        if kind == "upphaser":
            return den, model(x, phase=draws["phase"], factor_index=index,
                              sigmas=sig, noise=noise)
        return den, model(x, factor_index=index, sigmas=sig, noise=noise)


def assembly_draws(model, kind, inputs, gen):
    """Every draw of ``assembly_parity_calls``, on the CPU: the sigmas (b,),
    the loss's noise (shaped like its target), a denoise input ``x`` (the
    AR model's: its condition), the AR dropout and the upphaser's phase."""
    import math as m
    import torch
    b = inputs[0].shape[0]
    if kind == "graph":
        target = model.pack_target(inputs[1])
        return dict(sigmas=model.sigma_distribution(b, gen),
                    noise=torch.randn(target.shape, generator=gen),
                    x=torch.randn(target.shape, generator=gen) * 0.5)
    x = inputs[0]
    out = dict(sigmas=torch.rand(b, generator=gen))
    if kind == "vocoder":
        mag, _ = model.stft.encode(x)
        out["noise"] = torch.randn(b, mag.shape[-1], mag.shape[2],
                                   generator=gen)
        out["x"] = torch.randn(out["noise"].shape, generator=gen)
    elif kind == "ar":
        out["noise"] = torch.randn(b, model.chunk_length, 1, generator=gen)
        out["x"] = torch.rand(b, model.chunk_length, 1, generator=gen) - 0.5
        out["dropped"] = torch.tensor([False, True])
    else:
        out["noise"] = torch.randn(x.shape, generator=gen)
        out["x"] = torch.rand(x.shape, generator=gen) * 2 - 1
    if kind == "upphaser":
        _, phase = model.stft.encode(x)
        out["phase"] = (torch.rand(phase.shape, generator=gen) - 0.5) \
            * 2 * m.pi
    return out


def assemblies_fp32_vs_cpu(dev, cases):
    """Phase 31: each model in float32 at batch 2, card against CPU on the
    same weights, inputs and draws: a denoise evaluation within
    ASM_PARITY_TOL and the training loss within ASM_PARITY_TOL relative;
    on the card K1 launched exactly stacks x 2 (the evaluation and the
    loss's forward) and nothing else."""
    import torch
    cpu = torch.device("cpu")
    for name, (build, kind) in cases.items():
        model = build(cpu, torch.float32).eval()
        g = torch.Generator().manual_seed(48)
        inputs = assembly_inputs(model, kind, ASM_PARITY_BATCH, g, cpu)
        draws = assembly_draws(model, kind, inputs, g)
        stacks, _ = audio_stacks(model)
        results = []
        for m, d in ((copy.deepcopy(model).to(dev), dev), (model, cpu)):
            reset_counts()
            den, loss = assembly_parity_calls(
                m, kind, [t.to(d) for t in inputs],
                {k: v.to(d) for k, v in draws.items()})
            launched = counts()
            results.append((den.cpu(), loss.item(), launched))
            del m
        (card_den, card_loss, launched), (cpu_den, cpu_loss, _) = results
        den_err = _abs_err(card_den, cpu_den)
        loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
        phase("assembly_fp32_vs_cpu", model=name, batch=ASM_PARITY_BATCH,
              denoise_max_abs_err=den_err, loss=card_loss,
              plain_loss=cpu_loss, loss_rel_err=loss_err, launches=launched,
              tol=ASM_PARITY_TOL)
        check_launches(f"{name} fp32", launched,
                       loop_want(stacks, 0, 0, 2))
        if not (den_err <= ASM_PARITY_TOL and loss_err <= ASM_PARITY_TOL):
            raise AssertionError(f"{name} fp32 card vs CPU: denoise "
                                 f"{den_err}, loss {loss_err}")
        del model
        torch.cuda.empty_cache()


def audio_assemblies(dev):
    """Phase 31: the audio assemblies and the graph analogs (see the
    docstring).  Returns the K1 launches of their requests and the
    training kernels' of their steps, summed over the models."""
    import torch
    t0 = time.perf_counter()
    cases = assembly_cases()
    served, trained = {}, {}
    for name, (build, kind) in cases.items():
        model = build(dev, torch.bfloat16)
        stacks, layers = audio_stacks(model)
        batch = GRAPH_BATCH if kind == "graph" else ASM_BATCH
        gen = torch.Generator(device=dev).manual_seed(49)
        inputs = assembly_inputs(model, kind, batch, gen, dev)
        phase("assembly_model", model=name, dtype="bfloat16",
              parameters=sum(p.numel() for p in model.parameters()),
              stacks=stacks, layers=layers,
              inputs=[list(t.shape) for t in inputs])
        # training: one warm-up and ASM_TRAIN_STEPS timed steps
        step = assembly_train_step(model.train(), kind)
        reset_counts()
        first, first_seconds = timed(lambda: step(inputs, gen).item())
        torch.cuda.reset_peak_memory_stats()
        losses, seconds = timed(lambda: [step(inputs, gen).item()
                                         for _ in range(ASM_TRAIN_STEPS)])
        launched = counts()
        per_step = seconds / ASM_TRAIN_STEPS
        phase("assembly_train", model=name, batch=batch,
              steps=1 + ASM_TRAIN_STEPS, first_step_seconds=first_seconds,
              seconds_per_step=per_step, rows_per_s=batch / per_step,
              losses=[first] + losses,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=launched)
        if not all(map(math.isfinite, [first] + losses)):
            raise AssertionError(f"{name}: losses {[first] + losses}")
        check_launches(f"{name} training", launched,
                       loop_want(stacks, layers, 1 + ASM_TRAIN_STEPS, 0))
        for k, v in launched.items():
            trained[k] = trained.get(k, 0) + v
        del step
        model.eval()
        # a request, after a 2-step one that loads the card's kernels for
        # its shapes: its sampler's evaluations counted at the UNet
        assembly_request(model, kind, inputs, gen, num_steps=2)
        calls, handle = count_calls(model.unet)
        reset_counts()
        (out, evals, shape, clamped), seconds = timed(
            lambda: assembly_request(model, kind, inputs, gen))
        handle.remove()
        launched = counts()
        finite = bool(torch.isfinite(out).all())
        phase("assembly_request", model=name, batch=batch,
              num_steps=ASM_STEPS, evals=len(calls), seconds=seconds,
              rows_per_s=batch / seconds, shape=list(out.shape),
              finite=finite, launches=launched)
        if tuple(out.shape) != shape or not finite or (
                clamped and out.abs().max() > 1):
            raise AssertionError(f"{name}: output {tuple(out.shape)} "
                                 f"(expected {shape}), finite {finite}")
        if len(calls) != evals:
            raise AssertionError(f"{name}: {len(calls)} evaluations, "
                                 f"expected {evals}")
        check_launches(f"{name} request", launched,
                       loop_want(stacks, 0, 0, evals))
        for k, v in launched.items():
            served[k] = served.get(k, 0) + v
        shapes, worst = assembly_stack_kernels(
            model, assembly_eval_run(model, kind, inputs, gen))
        phase("assembly_stack_kernels", model=name, shapes=shapes,
              rel_err=worst, tol=KERNEL_TOL["bfloat16"])
        del model, inputs, out
        torch.cuda.empty_cache()
    assemblies_fp32_vs_cpu(dev, cases)
    phase("assemblies_phase_seconds", seconds=time.perf_counter() - t0)
    return served, trained


# --------------------------------------------------------------------------
# phase 32: the data-parallel layer
# --------------------------------------------------------------------------

def preset_stacks(preset) -> tuple:
    """The Transformer1d stacks of a QM preset, their layers and the
    preset's parameters (a model on the meta device)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    with torch.device("meta"):
        model = QMDiffusion(**preset)
    return (*model_stacks(model), sum(p.numel() for p in model.parameters()))


def parallel_config(dev, inv) -> dict:
    """What the ranks of phase 32 run, as arguments: a spawned rank imports
    this script afresh, so it reads nothing of this process's globals."""
    return {"root": ROOT, "device": dev.type, "ranks": PARALLEL_RANKS,
            "timeout": PARALLEL_TIMEOUT, "flagship": FLAGSHIP,
            "dp_batch": DP_BATCH, "dp_steps": DP_STEPS,
            "fp32_batch": PARALLEL_FP32_BATCH,
            "fp32_steps": PARALLEL_FP32_STEPS, "fp32_lr": PARALLEL_FP32_LR,
            "serve_batch": PARALLEL_SERVE_BATCH, "serve_steps": NUM_STEPS,
            "fp32_serve_steps": PARALLEL_FP32_SERVE_STEPS,
            "cond_scale": COND_SCALE, "dtype": PARALLEL_DTYPE,
            "tokenizer": inv.tokenizer.state_dict()}


def gloo_probe(dev) -> dict:
    """Which collectives the group's backend takes on tensors on ``dev``:
    "takes", or the refusal it raised (a refusal comes before any traffic,
    on every rank alike)."""
    import torch
    import torch.distributed as dist
    n, t = dist.get_world_size(), torch.ones(4, device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(n)], t),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(t), [t.clone() for _ in range(n)]),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, device=dev), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * n, device=dev))}
    out = {}
    for name, op in ops.items():
        try:
            op()
            out[name] = "takes"
        except (RuntimeError, NotImplementedError, ValueError) as e:
            out[name] = f"refuses ({type(e).__name__}: {str(e)[:100]})"
    return out


def seeded_qm(preset, dtype, dev, seed):
    """A QM model of ``preset`` built on ``dev`` and seeded there (phase 32:
    every model of a comparison is seeded alike)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        QMDiffusion
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    with torch.device(dev):
        model = QMDiffusion(**preset, dtype=dtype)
    init_parameters(model, torch.Generator(device=dev).manual_seed(seed))
    return model.to(dev)


def watch_kernel_weights(model) -> list:
    """Forward hooks on every ``Transformer1d`` of ``model`` that record,
    at each call, the parameters whose cached kernel weights differ from
    the weights the stack holds then (FSDP2's free-and-gather cycle could
    hide a change from a cache keyed on storage and version)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    stale = []

    def check(m, args, out):
        cached, casts = m.kernel_params(), m.kernel_casts()
        stale.extend(n for n, p in m.named_parameters()
                     if not torch.equal(cached[n], casts.get(n, p).detach()))

    for m in model.modules():
        if isinstance(m, Transformer1d):
            m.register_forward_hook(check)
    return stale


def flat_params(model):
    import torch
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def same_on_every_rank(mesh, model) -> bool:
    """Rank 0's parameters broadcast and held against each rank's, bit for
    bit; the verdict of every rank, agreed."""
    import torch
    import torch.distributed as dist
    mine = flat_params(model)
    theirs = mine.clone()
    dist.broadcast(theirs, 0)
    ok = torch.tensor([float(torch.equal(mine, theirs))], device=mine.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev, reset: bool = False) -> int:
    import torch
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def dp_train(mesh, dev, cfg) -> dict:
    """The 91M in ``dtype`` at the global batch ``dp_batch`` (this rank's rows
    of it): rank 0's one-card first step on the whole batch and its draws,
    then one warm-up and ``dp_steps`` data-parallel steps, the parameters
    held across ranks after each; the kernels' launches, seconds a step,
    peak memory and the grads' all-reduce alone."""
    import torch
    from moleculediffusiontransformer_tpu_torch.parallel import (
        all_reduce_mean, replicate, shard_batch)
    from moleculediffusiontransformer_tpu_torch.train import trainer
    rank = mesh.get_local_rank()
    model = seeded_qm(cfg["flagship"], getattr(torch, cfg["dtype"]), dev,
                      0).train()
    cond, target = inverse_batch(
        cfg["dp_batch"], torch.Generator(device=dev).manual_seed(3), dev,
        cfg["flagship"])
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    ref_loss = None
    if rank == 0:
        ref = copy.deepcopy(model)
        ref_loss = trainer.make_diffusion_train_step(ref, opt)(
            trainer.TrainState.create(ref, opt), cond, target,
            trainer.step_generator(0, 0, dev)).item()
        del ref
        empty_cache(dev)
    replicate(mesh, model)
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, mesh=mesh)
    c, t = shard_batch(mesh, (cond, target))
    del cond, target
    reset_counts()
    _peak(dev, reset=True)
    losses, seconds, same = [], [], []
    for i in range(1 + cfg["dp_steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(step(state, c, t,
                           trainer.step_generator(0, i, dev)).item())
        seconds.append(time.perf_counter() - t0)
        same.append(same_on_every_rank(mesh, model))
    launched, peak = counts(), _peak(dev)
    grads = [p.grad for p in model.parameters()]
    _sync(dev)
    t0 = time.perf_counter()
    all_reduce_mean(mesh, grads)
    _sync(dev)
    return {"losses": losses, "ref_loss": ref_loss, "seconds": seconds,
            "same": same, "launched": launched, "peak": peak,
            "allreduce_seconds": time.perf_counter() - t0,
            "grad_bytes": sum(4 * g.numel() for g in grads)}


def fsdp_train(mesh, dev, cfg) -> dict:
    """FSDP2 over the two ranks through gloo (which takes all_gather and
    reduce_scatter on CUDA tensors, staged through the host: phase 32's
    probe): ``dp_train``'s model, batch and draws, sharded, one warm-up and
    ``dp_steps`` steps; the stacks' cached kernel weights watched; the
    losses, launches, peak memory and the elements this rank holds; then
    the Orbax tier on the trained shards (``fsdp_orbax``)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.parallel import (
        shard_batch, shard_state_fsdp)
    from moleculediffusiontransformer_tpu_torch.train import trainer
    model = seeded_qm(cfg["flagship"], getattr(torch, cfg["dtype"]), dev,
                      0).train()
    cond, target = inverse_batch(
        cfg["dp_batch"], torch.Generator(device=dev).manual_seed(3), dev,
        cfg["flagship"])
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    shard_state_fsdp(model, state, mesh)
    stale = watch_kernel_weights(model)
    step = trainer.make_diffusion_train_step(model, opt, mesh=mesh)
    c, t = shard_batch(mesh, (cond, target))
    del cond, target
    reset_counts()
    _peak(dev, reset=True)
    losses = [step(state, c, t, trainer.step_generator(0, i, dev)).item()
              for i in range(1 + cfg["dp_steps"])]
    held = sum(x.numel() for x in trainer._local(
        [*model.parameters(), *state.opt_state.mu, *state.opt_state.nu]))
    out = {"losses": losses, "stale": stale, "launched": counts(),
           "peak": _peak(dev), "held_elements": held}
    out["orbax"] = fsdp_orbax(mesh, dev, cfg, model, state, opt,
                              lambda: step(state, c, t, trainer.step_generator(
                                  0, state.step, dev)).item())
    return out


@contextlib.contextmanager
def counted_gathers():
    """The gathers of tensors made inside the block, by name: the calls of
    ``torch.distributed``'s tensor gathers and of ``DTensor.full_tensor``
    and ``redistribute`` (the object collectives that DCP plans with call
    none of them through ``torch.distributed``'s names)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    calls = []
    saved = [(owner, name, getattr(owner, name)) for owner, name in (
        (dist, "all_gather"), (dist, "all_gather_into_tensor"),
        (dist, "gather"), (DTensor, "full_tensor"),
        (DTensor, "redistribute"))]

    def counting(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for owner, name, fn in saved:
        setattr(owner, name, counting(name, fn))
    try:
        yield calls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def fsdp_orbax(mesh, dev, cfg, model, state, opt, step) -> dict:
    """The Orbax checkpoint tier after ``fsdp_train``'s steps: each rank
    saves its shards asynchronously and takes one more step (``step()``)
    while the write is in flight, seeds and shards a fresh model and state
    meanwhile, then restores into them, its gathers counted; every local shard
    against the one saved, bit for bit.  The save's record (hold, seconds
    to commit, bytes), whether the write was still in flight after the
    step, the restore's seconds and gathers."""
    import torch
    from torch.distributed.tensor import DTensor

    from moleculediffusiontransformer_tpu_torch.core.checkpoint_orbax import (
        OrbaxCheckpointer, restore_train_state, shard_restore_target)
    from moleculediffusiontransformer_tpu_torch.parallel import \
        shard_state_fsdp
    from moleculediffusiontransformer_tpu_torch.train import trainer

    def shards(m, st):
        return [(x.to_local() if isinstance(x, DTensor) else x).detach()
                for x in [*m.state_dict().values(), *st.opt_state.mu,
                          *st.opt_state.nu]]

    saved = [x.clone() for x in shards(model, state)]
    ck = OrbaxCheckpointer(os.path.join(cfg["tmp"], "fsdp_orbax"))
    try:
        _sync(dev)
        t0 = time.perf_counter()
        ck.save(state.step, shard_restore_target(model, state))
        save_return = time.perf_counter() - t0
        loss = step()
        in_flight = ck.latest_step() is None
        fresh = seeded_qm(cfg["flagship"], getattr(torch, cfg["dtype"]), dev,
                          1).train()
        fstate = trainer.TrainState.create(fresh, opt)
        shard_state_fsdp(fresh, fstate, mesh)
        ck.wait_until_finished()
        _sync(dev)
        with counted_gathers() as gathers:
            t0 = time.perf_counter()
            restore_train_state(ck, fresh, fstate)
            _sync(dev)
            restore = time.perf_counter() - t0
        restored = shards(fresh, fstate)
        differ = sum(not torch.equal(a, b) for a, b in zip(restored, saved))
        sharded = sum(isinstance(x, DTensor) for x in fresh.parameters())
    finally:
        ck.close()
    return {"save": ck.saves[0], "save_return_seconds": save_return,
            "step_loss_during_write": loss, "in_flight_after_step": in_flight,
            "restore_seconds": restore, "gathers": gathers,
            "tensors": len(saved), "differ": differ,
            "sharded_parameters": sharded}


class SGD:
    """Plain SGD, ``p -= lr g``, for the float32 checks: it moves each
    parameter in proportion to its grad, so a band on the parameters sees
    the update (see PARALLEL_FP32_LR)."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return None

    def update(self, params, grads, state) -> None:
        import torch
        from moleculediffusiontransformer_tpu_torch.train import trainer
        with torch.no_grad():
            torch._foreach_add_(trainer._local(params),
                                trainer._local(grads), alpha=-self.lr)


def moved(model, before) -> float:
    """The most any parameter of ``model`` moved from the flat ``before``:
    what a step that left out the update would miss by."""
    return float((flat_params(model) - before).abs().max())


def dp_fp32(mesh, dev, cfg) -> dict:
    """Float32 at the global batch ``fp32_batch``: ``fp32_steps`` one-card
    steps on rank 0 and as many data-parallel ones, with SGD; rank 0 holds
    the losses, the parameters and the last grads against each other, and
    measures how far the one-card steps moved the parameters."""
    import torch
    from moleculediffusiontransformer_tpu_torch.parallel import (
        replicate, shard_batch)
    from moleculediffusiontransformer_tpu_torch.train import trainer
    rank = mesh.get_local_rank()
    model = seeded_qm(cfg["flagship"], torch.float32, dev, 0).train()
    cond, target = inverse_batch(
        cfg["fp32_batch"], torch.Generator(device=dev).manual_seed(4), dev,
        cfg["flagship"])
    opt = SGD(cfg["fp32_lr"])

    def run(m, mesh_, c, t):
        state = trainer.TrainState.create(m, opt)
        step = trainer.make_diffusion_train_step(m, opt, mesh=mesh_)
        return [step(state, c, t, trainer.step_generator(0, i, dev)).item()
                for i in range(cfg["fp32_steps"])]

    ref = None
    if rank == 0:
        ref = copy.deepcopy(model)
        before = flat_params(ref)
        ref_losses = run(ref, None, cond, target)
        params_moved = moved(ref, before)
        del before
    replicate(mesh, model)
    losses = run(model, mesh, *shard_batch(mesh, (cond, target)))
    out = {"losses": losses}
    if rank == 0:
        out.update(ref_losses=ref_losses,
                   loss_rel_err=max(abs(a - b) / abs(b)
                                    for a, b in zip(losses, ref_losses)),
                   params_max_abs_err=float(
                       (flat_params(model) - flat_params(ref)).abs().max()),
                   params_moved=params_moved,
                   grads_rel_err=max(
                       _rel_err(p.grad, q.grad) for p, q in zip(
                           model.parameters(), ref.parameters())))
    return out


def parallel_serving(mesh, dev, cfg, tmp) -> dict:
    """Serving over the two ranks: ``generate_from_conditioning(mesh=)`` of
    ``serve_batch`` molecules (in ``dtype``, ``serve_steps`` steps under
    CFG) and of ``fp32_batch`` in float32, each held on rank 0 against the
    one-card
    call; then the sampler exported with ``mesh=`` (rank 0 exports), served
    by both ranks on its graph tier, held on rank 0 against the one-card
    sample on the server's own draws (which phase 30 holds bit for bit
    against a one-card artifact)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from moleculediffusiontransformer_tpu_torch import design
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, save_checkpoint)
    from moleculediffusiontransformer_tpu_torch.data.tokenizer import \
        CharTokenizer
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    rank = mesh.get_local_rank()
    tok = CharTokenizer.from_state_dict(cfg["tokenizer"])
    preset = dict(cfg["flagship"], pred_dim=tok.vocab_size)
    batch, steps, scale = (cfg["serve_batch"], cfg["serve_steps"],
                           cfg["cond_scale"])
    out = {}
    for name, dtype, b, n_steps in (
            ("request", getattr(torch, cfg["dtype"]), batch, steps),
            ("request_fp32", torch.float32, cfg["fp32_batch"],
             cfg["fp32_serve_steps"])):
        model = seeded_qm(preset, dtype, dev, 22).eval()
        props = (torch.rand(b, 12, generator=torch.Generator().manual_seed(5))
                 * 2 - 1).numpy()

        def request(mesh_):
            return design.generate_from_conditioning(
                model, props, tok, torch.Generator(device=dev).manual_seed(7),
                cond_scale=scale, timesteps=n_steps, mesh=mesh_)

        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        rep = request(mesh)
        _sync(dev)
        record = {"batch": b, "steps": n_steps,
                  "seconds": time.perf_counter() - t0,
                  "launched": counts(), "rows": len(rep["smiles"]),
                  "finite": bool(np.isfinite(rep["raw_samples"]).all())}
        if rank == 0 and name == "request":
            # the live request was timed alone: phase 32 now starts the
            # CLI under torchrun and the one-rank FSDP beside what follows
            open(os.path.join(tmp, SERVING_FLAG), "w").close()
        if rank == 0:
            want = torch.from_numpy(request(None)["raw_samples"])
            record["rel_err"] = _rel_err(
                torch.from_numpy(rep["raw_samples"]), want)
        out[name] = record
        if name == "request_fp32":
            break
        path, ck = os.path.join(tmp, "mesh.pt2"), os.path.join(tmp, "ck.pt")
        if rank == 0:
            t0 = time.perf_counter()
            dx.save_artifact(dx.export_sampler(
                model, batch=batch, num_steps=steps, cond_scale=scale,
                mesh=mesh, device=dev.type), path)
            save_checkpoint(ck, checkpoint_state(model))
            out["export_seconds"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        server = design.ArtifactServer(path, ck, device=dev.type, mesh=mesh)
        load = time.perf_counter() - t0
        _sync(dev)
        t0 = time.perf_counter()
        served = server.call(props, seed=9)
        _sync(dev)
        record = {"tier": server.tier, "exec_error": server.exec_error,
                  "load_seconds": load, "seconds": time.perf_counter() - t0,
                  "captured": server.launches,
                  "finite": bool(torch.isfinite(served).all())}
        if rank == 0:
            gen = torch.Generator(device=dev).manual_seed(9)
            shape = (batch, preset["max_length"], preset["pred_dim"])
            noise = torch.empty(shape, device=dev).normal_(generator=gen)
            step_noise = torch.empty((steps - 1, *shape),
                                     device=dev).normal_(generator=gen)
            with torch.no_grad():
                want = sample(model, torch.from_numpy(props).to(dev),
                              num_steps=steps, cond_scale=scale, noise=noise,
                              step_noise=step_noise)
            record["rel_err"] = _rel_err(served.float(), want)
        out["served"] = record
        del server, model
        empty_cache(dev)
    return out


def empty_cache(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def parallel_rank(rank, tmp, cfg) -> None:
    """One rank of phase 32 (a spawned process): join the gloo group (two
    ranks on one card, which NCCL refuses), probe it, train and serve; the
    results go to ``tmp/rank{rank}.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, cfg["root"])
    from moleculediffusiontransformer_tpu_torch.parallel import (
        distributed_init, make_mesh)
    from moleculediffusiontransformer_tpu_torch.parallel.mesh import \
        mesh_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (on the CPU, one thread each: the
    # rehearsal's models are tiny and spinning threads starve the peer)
    torch.set_num_threads(1 if cfg["device"] == "cpu" else max(
        1, (os.cpu_count() or 1) // cfg["ranks"]))
    distributed_init(f"file://{os.path.join(tmp, 'rendezvous')}",
                     cfg["ranks"], rank, backend="gloo",
                     device=cfg["device"],
                     timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        mesh = make_mesh(device=cfg["device"])
        dev = mesh_device(mesh)
        cfg = dict(cfg, tmp=tmp)
        out = {"probe": gloo_probe(dev), "seconds": {}}
        for name, body in (("dp", dp_train), ("fsdp", fsdp_train),
                           ("dp_fp32", dp_fp32)):
            t0 = time.perf_counter()
            out[name] = body(mesh, dev, cfg)
            out["seconds"][name] = time.perf_counter() - t0
            empty_cache(dev)
        t0 = time.perf_counter()
        out["serve"] = parallel_serving(mesh, dev, cfg, tmp)
        out["seconds"]["serve"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


class Ranks:
    """``parallel_rank`` on ``cfg["ranks"]`` spawned processes, started at
    once; ``wait_for(name)`` waits until rank 0 has written ``tmp/name``
    (or every rank has ended), ``results()`` for their results.  Both stop
    at ``cfg["timeout"]`` from the start; ``stop()`` ends every process
    still alive."""

    def __init__(self, cfg, tmp):
        import torch.multiprocessing as mp
        self.cfg, self.tmp = cfg, tmp
        self.deadline = time.monotonic() + cfg["timeout"]
        self.ctx = mp.start_processes(parallel_rank, args=(tmp, cfg),
                                      nprocs=cfg["ranks"], join=False,
                                      start_method="spawn")

    def _joined(self, timeout: float) -> bool:
        if time.monotonic() > self.deadline:
            raise AssertionError(f"phase 32's ranks ran past "
                                 f"{self.cfg['timeout']} s")
        return self.ctx.join(timeout=timeout)

    def wait_for(self, name: str) -> None:
        while not os.path.exists(os.path.join(self.tmp, name)):
            if self._joined(0.5):
                return

    def results(self) -> list:
        import torch
        while not self._joined(1):
            pass
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(self.cfg["ranks"])]

    def stop(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def start_cli_under_torchrun(dev, tmp, reference):
    """Start ``python -m torch.distributed.run --standalone --nproc-per-node
    1 -m moleculediffusiontransformer_tpu_torch train`` with phase 27's
    first run's arguments: the CLI joins a one-rank group (NCCL on the card)
    and trains through the data-parallel step.  TF32 is off in it
    (``NVIDIA_TF32_OVERRIDE=0``), as in this process, where phase 27 ran.
    Its output goes to files; ``finish_cli_under_torchrun`` waits."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m",
           "moleculediffusiontransformer_tpu_torch", *reference["argv"],
           "--device", dev.type, "--checkpoint-dir", os.path.join(tmp, "cli")]
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    if dev.type == "cpu":     # the rehearsal's tiny model, beside the ranks
        env["OMP_NUM_THREADS"] = "1"
    out = open(os.path.join(tmp, "cli.out"), "w+")
    err = open(os.path.join(tmp, "cli.err"), "w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err)
    return proc, out, err, time.perf_counter()


def finish_cli_under_torchrun(dev, started, reference) -> dict:
    """Wait for the CLI under ``torchrun`` (stopped at PARALLEL_TIMEOUT);
    its losses and launches against phase 27's first run's."""
    proc, out, err, t0 = started
    try:
        proc.wait(timeout=PARALLEL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    text, errors = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train exited {proc.returncode}:\n"
                             f"{errors[-4000:]}")
    payload = json.loads(text[text.index("{"):text.rindex("}") + 1])
    want = reference["launches"]
    launched = {k: v for k, v in payload["launches"].items() if k in want}
    record = {"seconds": seconds, "world_size": payload["world_size"],
              "losses": payload["losses"],
              "reference_losses": reference["losses"],
              "bitwise": payload["losses"] == reference["losses"],
              "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                  payload["losses"], reference["losses"])),
              "launches": launched}
    phase("parallel_cli_torchrun", backend="nccl" if dev.type == "cuda"
          else "gloo", note="beside the ranks' serving and the one-rank "
                            "FSDP", **record)
    if payload["world_size"] != 1 or len(payload["losses"]) != len(
            reference["losses"]):
        raise AssertionError(f"torchrun train: {record}")
    if not record["loss_rel_err"] <= PARALLEL_FP32_TOL:
        raise AssertionError(f"torchrun train's losses differ from the "
                             f"one-card loop's: {record}")
    check_launches("torchrun train", launched,
                   {k: v for k, v in want.items() if k in launched})
    return launched


def fsdp_one_rank(dev, stacks, layers) -> dict:
    """FSDP over a group of one (NCCL on the card): the 91M sharded with
    FSDP2, ``FSDP_STEPS`` steps against as many unsharded ones on the same
    batch and draws, in bf16 at ``FSDP_BATCH`` (Adam) and float32 at
    ``PARALLEL_FP32_BATCH`` (SGD, whose update the float32 band sees: the
    steps must move the parameters ten times past it); the kernel weight
    caches never stale; each one's peak memory.  Returns the bf16 run's
    launches."""
    import torch
    import torch.distributed as dist
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        checkpoint_state
    from moleculediffusiontransformer_tpu_torch.parallel import (
        distributed_init, make_mesh, shard_state_fsdp)
    from moleculediffusiontransformer_tpu_torch.train import trainer
    distributed_init(device=dev.type)
    launched = None
    try:
        mesh = make_mesh(device=dev.type)
        for dtype, batch, lr, tol, sgd in (
                (PARALLEL_DTYPE, FSDP_BATCH, 2e-4, KERNEL_TOL[PARALLEL_DTYPE],
                 False),
                ("float32", PARALLEL_FP32_BATCH, PARALLEL_FP32_LR,
                 PARALLEL_FP32_TOL, True)):
            cond, target = inverse_batch(batch, torch.Generator(
                device=dev).manual_seed(6), dev)
            opt = SGD(lr) if sgd else trainer.make_optimizer(
                trainer.OptimizerConfig(learning_rate=lr))
            dtype = getattr(torch, dtype)
            model = seeded_qm(FLAGSHIP, dtype, dev, 0).train()
            plain = copy.deepcopy(model)
            before = flat_params(plain)

            def run(m, mesh_):
                state = trainer.TrainState.create(m, opt)
                if mesh_ is not None:
                    shard_state_fsdp(m, None if sgd else state, mesh_)
                step = trainer.make_diffusion_train_step(m, opt, mesh=mesh_)
                _peak(dev, reset=True)
                losses = [step(state, cond, target,
                               trainer.step_generator(0, i, dev)).item()
                          for i in range(FSDP_STEPS)]
                return losses, _peak(dev)

            plain_losses, plain_peak = run(plain, None)
            params_moved = moved(plain, before)
            del before
            stale = watch_kernel_weights(model)
            reset_counts()
            losses, peak = run(model, mesh)
            counted = counts()
            whole = checkpoint_state(model)["model"]
            err = max(float((whole[k] - v).abs().max())
                      for k, v in plain.state_dict().items())
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, plain_losses))
            phase("parallel_fsdp", ranks=1, backend=dist.get_backend(),
                  dtype=str(dtype).split(".")[1], batch=batch,
                  steps=FSDP_STEPS, lr=lr, losses=losses,
                  plain_losses=plain_losses, loss_rel_err=loss_err,
                  params_max_abs_err=err, params_moved=params_moved,
                  optimizer="sgd" if sgd else "adam", tol=tol,
                  stale_kernel_weights=stale,
                  peak_bytes=peak, plain_peak_bytes=plain_peak,
                  launches=counted)
            if stale or not loss_err <= tol or not err <= tol or (
                    sgd and not params_moved >= 10 * tol):
                raise AssertionError(f"FSDP ({dtype}) against the unsharded "
                                     f"steps: losses {loss_err}, parameters "
                                     f"{err} (moved {params_moved}), stale "
                                     f"{stale[:5]}")
            if launched is None:
                launched = counted
                check_launches("FSDP training", counted, loop_want(
                    stacks, layers, FSDP_STEPS, 0))
            del model, plain
            empty_cache(dev)
    finally:
        dist.destroy_process_group()
    return launched


def parallel_layer(dev, inv, loop_first) -> dict:
    """Phase 32 (see the docstring).  Returns the launches of a rank's
    data-parallel steps and of its share of the serving request."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    stacks, layers, parameters = preset_stacks(FLAGSHIP)
    empty_cache(dev)
    cfg = parallel_config(dev, inv)
    with tempfile.TemporaryDirectory() as tmp:
        group = Ranks(cfg, tmp)
        try:
            # when the ranks have trained and timed the live mesh request,
            # the CLI under torchrun and the one-rank FSDP runs start beside
            # them: their numbers are losses, launches and each process's
            # own peak memory; the served artifact's seconds are taken
            # beside them
            group.wait_for(SERVING_FLAG)
            started = start_cli_under_torchrun(dev, tmp, loop_first)
            try:
                fsdp = fsdp_one_rank(dev, stacks, layers)
                ranks = group.results()
            finally:
                cli = finish_cli_under_torchrun(dev, started, loop_first)
        finally:
            group.stop()
    probe = ranks[0]["probe"]
    phase("parallel_probe", torch=torch.__version__, backend="gloo",
          device=dev.type, collectives=probe,
          choice="two ranks on the one card through gloo (NCCL refuses a "
                 "card twice): data parallelism, FSDP and serving; NCCL at "
                 "world size 1: FSDP and the CLI under torchrun",
          seconds=[r["seconds"] for r in ranks])
    refused = [k for k in PARALLEL_COLLECTIVES if probe[k] != "takes"]
    if refused:
        raise AssertionError(f"gloo refuses {refused} on {dev.type} "
                             f"tensors: {probe}")
    want = loop_want(stacks, layers, 1 + DP_STEPS, 0)
    for rank, r in enumerate(ranks):
        dp = r["dp"]
        per_step = statistics.median(dp["seconds"][1:])
        phase("parallel_dp", rank=rank, ranks=PARALLEL_RANKS,
              backend="gloo", dtype=PARALLEL_DTYPE, global_batch=DP_BATCH,
              rank_batch=DP_BATCH // PARALLEL_RANKS, steps=1 + DP_STEPS,
              losses=dp["losses"], one_card_first_loss=dp["ref_loss"],
              seconds=dp["seconds"], seconds_per_step=per_step,
              samples_per_s=DP_BATCH / per_step,
              params_same_bits=dp["same"], peak_bytes=dp["peak"],
              allreduce_seconds=dp["allreduce_seconds"],
              allreduce_bytes=dp["grad_bytes"],
              note="gloo stages CUDA tensors through the host: the "
                   "all-reduce's seconds are no figure of NVLink",
              launches=dp["launched"])
        if not all(dp["same"]):
            raise AssertionError(f"rank {rank}: the parameters differ "
                                 f"between ranks: {dp['same']}")
        if not all(map(math.isfinite, dp["losses"])):
            raise AssertionError(f"DP losses {dp['losses']}")
        check_launches(f"DP training (rank {rank})", dp["launched"], want)
    dp0 = ranks[0]["dp"]
    first_err = abs(dp0["losses"][0] - dp0["ref_loss"]) / abs(
        dp0["ref_loss"])
    f32 = ranks[0]["dp_fp32"]
    phase("parallel_dp_first_step", loss_rel_err=first_err,
          tol=KERNEL_TOL[PARALLEL_DTYPE])
    phase("parallel_dp_fp32", global_batch=PARALLEL_FP32_BATCH,
          steps=PARALLEL_FP32_STEPS, lr=PARALLEL_FP32_LR,
          tol=PARALLEL_FP32_TOL, **f32)
    if not first_err <= KERNEL_TOL[PARALLEL_DTYPE]:
        raise AssertionError(f"DP's first loss against one card's: "
                             f"{first_err}")
    if not (f32["loss_rel_err"] <= PARALLEL_FP32_TOL
            and f32["params_max_abs_err"] <= PARALLEL_FP32_TOL
            and f32["params_moved"] >= 10 * PARALLEL_FP32_TOL
            and f32["grads_rel_err"] <= PARALLEL_FP32_TOL):
        raise AssertionError(f"float32 DP against one card: {f32}")
    served = {}
    for rank, r in enumerate(ranks):
        sv = r["serve"]
        phase("parallel_serve", rank=rank, ranks=PARALLEL_RANKS,
              backend="gloo", cond_scale=COND_SCALE,
              note="the live request timed alone; the float32 one and the "
                   "served artifact beside the CLI under torchrun and the "
                   "one-rank FSDP", **sv)
        for name, tol in (("request", KERNEL_TOL[PARALLEL_DTYPE]),
                          ("request_fp32", PARALLEL_FP32_TOL)):
            rec = sv[name]
            if not rec["finite"] or rec["rows"] != rec["batch"]:
                raise AssertionError(f"rank {rank} {name} request: {rec}")
            if rank == 0 and not rec["rel_err"] <= tol:
                raise AssertionError(f"{name} request over the mesh against "
                                     f"one card: {rec['rel_err']}")
        evals = 2 * (NUM_STEPS - 1)
        check_launches(f"mesh request (rank {rank})",
                       sv["request"]["launched"],
                       loop_want(stacks, 0, 0, evals))
        srv = sv["served"]
        if srv["tier"] != "graph" and dev.type == "cuda":
            raise AssertionError(f"rank {rank}: the mesh artifact served on "
                                 f"{srv['tier']}: {srv['exec_error']}")
        if not srv["finite"] or (rank == 0 and not srv["rel_err"]
                                 <= KERNEL_TOL[PARALLEL_DTYPE]):
            raise AssertionError(f"rank {rank}: served {srv}")
        if dev.type == "cuda" and srv["captured"].get(
                "LAUNCHES") != stacks * evals:
            raise AssertionError(f"rank {rank}: the graph captured "
                                 f"{srv['captured']}")
        if rank == 0:
            served = sv["request"]["launched"]
    for rank, r in enumerate(ranks):
        f2 = r["fsdp"]
        err = max(abs(a - b) / abs(b)
                  for a, b in zip(f2["losses"], r["dp"]["losses"]))
        phase("parallel_fsdp", rank=rank, ranks=PARALLEL_RANKS,
              backend="gloo", dtype=PARALLEL_DTYPE, global_batch=DP_BATCH,
              steps=1 + DP_STEPS, losses=f2["losses"],
              dp_losses=r["dp"]["losses"], loss_rel_err=err,
              tol=KERNEL_TOL[PARALLEL_DTYPE],
              stale_kernel_weights=f2["stale"], peak_bytes=f2["peak"],
              dp_peak_bytes=r["dp"]["peak"],
              held_share=f2["held_elements"] / (3 * parameters),
              launches=f2["launched"])
        if f2["stale"] or not err <= KERNEL_TOL[PARALLEL_DTYPE]:
            raise AssertionError(f"rank {rank}: two-rank FSDP against DP: "
                                 f"{err}, stale {f2['stale'][:5]}")
        check_launches(f"FSDP training (rank {rank})", f2["launched"], want)
        ob = f2["orbax"]
        phase("parallel_fsdp_orbax", rank=rank, ranks=PARALLEL_RANKS,
              backend="gloo", dtype=PARALLEL_DTYPE, **ob,
              note="the save staged into pinned host memory and written by "
                   "this rank on the writer thread (its own shards: "
                   "save.rank_bytes of save.bytes), one step taken while "
                   "the write was in flight, then restored into a fresh "
                   "FSDP model; gathers: tensor gathers during the restore")
        if ob["differ"] or ob["gathers"] or not ob["sharded_parameters"] or \
                not 0 < ob["save"]["rank_bytes"] < ob["save"]["bytes"] or \
                not math.isfinite(ob["step_loss_during_write"]):
            raise AssertionError(f"rank {rank}: the Orbax tier under FSDP: "
                                 f"{ob}")
    seconds = time.perf_counter() - t0
    phase("parallel_phase_seconds", seconds=seconds)
    return {"train": dp0["launched"], "serve": served, "fsdp": fsdp,
            "cli": cli}


# ------------------------------------------------------------- phase 33 --

def axes_config(dev) -> dict:
    """What the ranks of phase 33 run, as arguments (a spawned rank reads
    nothing of this process's globals)."""
    return {"root": ROOT, "device": dev.type, "ranks": PARALLEL_RANKS,
            "timeout": AXES_TIMEOUT, "steps": AXES_STEPS,
            "fp32_steps": AXES_FP32_STEPS, "fp32_batch": AXES_FP32_BATCH,
            "lr": PARALLEL_FP32_LR, "flagship": FLAGSHIP,
            "tp_batch": TP_BATCH, "long": LONG, "sp_samples": SP_SAMPLES,
            "sp_batch": SP_BATCH, "sp_fp32_samples": SP_FP32_SAMPLES,
            "ar": AR_PRESET, "ar_batch": AR_TRAIN_BATCH,
            "ar_tokens": AR_TRAIN_TOKENS, "pp_micro": PP_MICRO,
            "gpt": dict(GPT_PRESET, **GPT_MOE), "gpt_batch": GPT_MOE_BATCH,
            "gpt_tokens": GPT_TRAIN_TOKENS, "gpt_aux": GPT_MOE_AUX,
            "dtype": PARALLEL_DTYPE}


def axes_probe(rank, tmp, cfg) -> None:
    """One of a pair probing what gloo does with ``cfg["collective"]``
    (all_to_all_single, or send/recv through batch_isend_irecv) on tensors
    of the rank's device: "takes" where the right values arrive, else what
    it raised.  A refused send/recv may also end the process (gloo throws
    from its own thread): ``axes_probes`` reads that as a refusal."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, cfg["root"])
    from moleculediffusiontransformer_tpu_torch.parallel import \
        distributed_init
    name = cfg["collective"]
    distributed_init(f"file://{os.path.join(tmp, name + '_rendezvous')}", 2,
                     rank, backend="gloo", device=cfg["device"],
                     timeout=datetime.timedelta(seconds=30))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if cfg["device"] == "cuda" else torch.device("cpu"))
    x = torch.arange(4, device=dev, dtype=torch.float32) + 10 * rank
    got = torch.zeros(4, device=dev)
    if name == "all_to_all_single":
        want = torch.tensor([0., 1., 10., 11.] if rank == 0
                            else [2., 3., 12., 13.])
    else:
        want = torch.arange(4.0) + 10 * (1 - rank)
    try:
        if name == "all_to_all_single":
            dist.all_to_all_single(got, x)
        else:
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, 1 - rank),
                    dist.P2POp(dist.irecv, got, 1 - rank)]):
                work.wait()
        out = ("takes" if torch.equal(got.cpu(), want)
               else f"wrong values {got.tolist()}")
    except RuntimeError as e:
        out = f"refuses (RuntimeError: {str(e)[:120]})"
    torch.save(out, os.path.join(tmp, f"{name}{rank}.pt"))
    dist.destroy_process_group()


def axes_probes(tmp, cfg) -> dict:
    """Each probed collective on a pair of processes of its own, side by
    side: rank 0's answer, or the signal a rank ended with."""
    import torch.multiprocessing as mp
    ctxs = {name: mp.start_processes(
        axes_probe, args=(tmp, dict(cfg, collective=name)), nprocs=2,
        join=False, start_method="spawn")
        for name in ("all_to_all_single", "send_recv")}
    out = {}
    for name, ctx in ctxs.items():
        try:
            out[name] = _joined(ctx, 2, tmp, dict(cfg, timeout=90), name)[0]
        except mp.ProcessExitedException as e:
            out[name] = f"refuses (a rank ended: {e})"
    return out


def whole_params_same(model) -> bool:
    """The parameters every rank holds whole (not a sharded ``DTensor``),
    bit for bit the same on every rank; the verdict of every rank."""
    import torch
    import torch.distributed as dist
    from moleculediffusiontransformer_tpu_torch.parallel import tp
    mine = torch.cat([tp.full(p).detach().reshape(-1)
                      for p in model.parameters()
                      if tp.sharding(p) is None])
    theirs = mine.clone()
    dist.broadcast(theirs, 0)
    ok = torch.tensor([float(torch.equal(mine, theirs))], device=mine.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def whole_state(model, grads: bool = False) -> dict:
    """The model's parameters (or grads) by name, each whole (a collective
    for the sharded ones: every rank calls it); a pipelined model's under
    its unpipelined names."""
    import torch
    from moleculediffusiontransformer_tpu_torch.parallel import pp, tp

    def get(p):
        # the port's gather (dist.all_gather_into_tensor), not
        # DTensor.full_tensor: the functional collectives under it crash
        # in gloo on CUDA tensors (torch 2.11)
        with torch.no_grad():
            t = tp.full(p).detach()
            if grads:
                t = torch.zeros_like(t) if p.grad is None else tp.full(
                    p.grad).detach()
        return t

    out = {n: get(p) for n, p in model.named_parameters()}
    if "stacked_layers" in model._modules:
        stacked = {n[len("stacked_layers."):].replace("/", "."): v
                   for n, v in out.items() if n.startswith("stacked_layers.")}
        out = pp.unstack_layer_params(stacked, {
            n: v for n, v in out.items()
            if not n.startswith("stacked_layers.")})
    return out


def axes_steps(dev, step, state, args, gen_of, steps, model) -> dict:
    """``steps`` steps, then one more with the collectives timed: the
    losses, seconds a step (the last untimed one), the collectives'
    seconds and share of the timed step, the peak memory, the staged
    calls, the launches, and the replicated parameters' agreement."""
    import torch
    from moleculediffusiontransformer_tpu_torch.parallel import collectives
    reset_counts()
    collectives.STAGED.clear()
    _peak(dev, reset=True)
    losses, seconds, same = [], [], []
    for i in range(steps + 1):
        _sync(dev)
        t0 = time.perf_counter()
        if i < steps:
            losses.append(step(state, *args, gen_of(i)).item())
        else:
            with collectives.timing() as spent:
                losses.append(step(state, *args, gen_of(i)).item())
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        same.append(whole_params_same(model))
    spent = dict(spent)
    return {"losses": losses, "seconds": seconds,
            "seconds_per_step": seconds[steps - 1],
            "collective_seconds": spent,
            "collective_share": sum(spent.values()) / seconds[-1],
            "peak_bytes": _peak(dev), "staged": dict(collectives.STAGED),
            "launched": counts(), "same": same,
            "finite": all(map(math.isfinite, losses))}


def axes_fp32(dev, rank, build, shard, make_step, args, gen_of, steps, lr):
    """Float32: ``steps`` SGD steps of the model ``build()`` makes on one
    card (rank 0, a copy) and over the mesh (``shard`` places it, in
    place; ``make_step(model, opt, parallel)``); rank 0 holds the losses,
    the parameters and the last grads against each other, the grads
    against their largest magnitude, and measures how far the one-card
    steps moved the parameters."""
    import torch
    from moleculediffusiontransformer_tpu_torch.train import trainer
    model = build()
    opt = SGD(lr)

    def run(m, parallel):
        state = trainer.TrainState.create(m, opt)
        step = make_step(m, opt, parallel)
        return [step(state, *args, gen_of(i)).item() for i in range(steps)]

    out = {}
    if rank == 0:
        ref = copy.deepcopy(model)
        before = {n: p.detach().clone() for n, p in ref.named_parameters()}
        ref_losses = run(ref, False)
        ref_params, ref_grads = whole_state(ref), whole_state(ref, True)
        moved_by = max(float((ref_params[n] - before[n]).abs().max())
                       for n in before)
        del before, ref
    shard(model)
    losses = run(model, True)
    params, grads = whole_state(model), whole_state(model, True)
    if rank == 0:
        scale = max(float(g.abs().max()) for g in ref_grads.values())
        out.update(
            ref_losses=ref_losses, losses=losses,
            loss_rel_err=max(abs(a - b) / abs(b)
                             for a, b in zip(losses, ref_losses)),
            params_max_abs_err=max(float((params[n] - ref_params[n]).abs(
                ).max()) for n in ref_params),
            params_moved=moved_by,
            grads_rel_err=max(float((grads[n] - ref_grads[n]).abs().max())
                              for n in ref_grads) / scale,
            grads_tensor_rel_err=max(_rel_err(grads[n], ref_grads[n], 1e-30)
                                     for n in ref_grads))
    return out


@contextlib.contextmanager
def watch_stack_weights():
    """Every call of the stack dispatch (``transformer1d``) in the block
    holds its kernel weights against its parameters as the call gathered
    them, cast: the names that differ, collected (a gathered weight is a
    fresh buffer that a cache keyed on storage could mistake)."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    stale, dispatch = [], tf.transformer1d

    def watched(kparams, params, *args, **kwargs):
        for n, p in params.items():
            want = p.detach().to(kparams[n].dtype)
            if not kparams[n].equal(want):
                stale.append(n)
        return dispatch(kparams, params, *args, **kwargs)

    tf.transformer1d = watched
    try:
        yield stale
    finally:
        tf.transformer1d = dispatch


def tp_axis(dev, cfg) -> dict:
    """Tensor parallelism: the 91M in ``dtype`` at ``tp_batch`` (every
    model rank the whole batch: data 1), its weights sharded over 'model';
    then float32 against one card."""
    import torch
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_2d(1, cfg["ranks"], device=dev.type)
    rank = mesh.get_local_rank("model")
    model = seeded_qm(cfg["flagship"], getattr(torch, cfg["dtype"]), dev,
                      0).train()
    specs = parallel.shard_params_tp(model, mesh)
    sharded = [p for n, p in model.named_parameters() if specs[n]]
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_diffusion_train_step(model, opt, mesh=mesh)
    args = inverse_batch(cfg["tp_batch"], torch.Generator(
        device=dev).manual_seed(3), dev, cfg["flagship"])
    with watch_stack_weights() as stale:
        out = axes_steps(dev, step, state, args,
                         lambda i: trainer.step_generator(0, i, dev),
                         cfg["steps"], model)
    out.update(held_share=sum(p.to_local().numel() for p in sharded)
               / sum(p.numel() for p in sharded),
               sharded_leaves=len(sharded), stale_kernel_weights=stale)
    del model, state, step, args
    empty_cache(dev)
    cond, target = inverse_batch(cfg["fp32_batch"], torch.Generator(
        device=dev).manual_seed(4), dev, cfg["flagship"])
    out["fp32"] = axes_fp32(
        dev, rank, lambda: seeded_qm(cfg["flagship"], torch.float32, dev,
                                     0).train(),
        lambda m: parallel.shard_params_tp(m, mesh),
        lambda m, o, par: trainer.make_diffusion_train_step(
            m, o, mesh=mesh if par else None),
        (cond, target), lambda i: trainer.step_generator(0, i, dev),
        cfg["fp32_steps"], cfg["lr"])
    return out


def sp_axis(dev, cfg) -> dict:
    """Sequence parallelism: the long Model1d in ``dtype`` at ``sp_batch``
    x ``sp_samples``, each rank its half of the length; then float32 at
    1 x ``sp_fp32_samples`` against one card."""
    import torch
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.models import audio
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_sp(1, cfg["ranks"], device=dev.type)
    rank = mesh.get_local_rank("seq")

    def build(dtype):
        return audio.build_model1d(
            device=dev, generator=torch.Generator().manual_seed(7),
            dtype=dtype, **cfg["long"]).train()

    def waves(batch, samples, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(batch, samples, cfg["long"]["in_channels"],
                          generator=gen, device=dev) * 2 - 1

    model = build(getattr(torch, cfg["dtype"]))
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_model1d_train_step(model, opt, mesh=mesh)
    seen = []
    for m in model.modules():
        if isinstance(m, Transformer1d):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append((mod.num_layers, a[0].shape[1])))
    x = parallel.shard_seq(mesh, waves(cfg["sp_batch"], cfg["sp_samples"],
                                       9))
    out = axes_steps(dev, step, state, (x,),
                     lambda i: trainer.step_generator(0, i, dev),
                     cfg["steps"], model)
    steps = cfg["steps"] + 1
    out["stacks"] = [(layers, tokens) for layers, tokens in seen[:len(
        seen) // steps]]
    out["local_length"] = x.shape[1]
    del model, state, step, x
    empty_cache(dev)
    x = waves(1, cfg["sp_fp32_samples"], 10)
    out["fp32"] = axes_fp32(
        dev, rank, lambda: build(torch.float32),
        lambda m: None,
        lambda m, o, par: _sp_step(m, o, mesh if par else None),
        (x,), lambda i: trainer.step_generator(0, i, dev),
        cfg["fp32_steps"], cfg["lr"])
    return out


def _sp_step(model, opt, mesh):
    """The Model1d step, over ``mesh`` on this rank's slice of x."""
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.train import trainer
    step = trainer.make_model1d_train_step(model, opt, mesh=mesh)
    if mesh is None:
        return step
    return lambda state, x, gen: step(state, parallel.shard_seq(mesh, x),
                                      gen)


def pp_axis(dev, cfg) -> dict:
    """Pipeline parallelism: the AR transformer in ``dtype``, its 12 layers
    in 2 stages, ``pp_micro`` micro-batches of ``ar_batch`` x
    ``ar_tokens``; then float32 at ``fp32_batch`` against the sequential
    trunk on one card."""
    import torch
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        MoleculeTransformerSequence
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_pp(1, cfg["ranks"], device=dev.type)
    rank = mesh.get_local_rank("stage")

    def build(dtype):
        return MoleculeTransformerSequence(
            device=dev, dtype=dtype, generator=torch.Generator().manual_seed(
                13), **cfg["ar"])

    def batch(b, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        props = torch.rand(b, 12, generator=gen, device=dev) * 2 - 1
        ids = torch.randint(0, cfg["ar"]["logits_dim"], (b, cfg["ar_tokens"]),
                            generator=gen, device=dev)
        return props, ids

    model = build(getattr(torch, cfg["dtype"]))
    parallel.shard_model_pp(model, mesh)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_transformer_train_step(model, opt, mesh=mesh,
                                               n_micro=cfg["pp_micro"])
    out = axes_steps(dev, step, state, batch(cfg["ar_batch"], 11),
                     lambda i: trainer.step_generator(0, i, dev),
                     cfg["steps"], model)
    out["local_layers"] = next(iter(model.stacked_layers.local().values())
                               ).shape[0]
    del model, state, step
    empty_cache(dev)
    props, ids = batch(cfg["fp32_batch"], 12)
    keep = torch.rand(cfg["fp32_batch"], generator=torch.Generator(
        ).manual_seed(14)).to(dev) >= 0.25
    out["fp32"] = axes_fp32(
        dev, rank, lambda: build(torch.float32),
        lambda m: parallel.shard_model_pp(m, mesh),
        lambda m, o, par: (lambda st, p, i, gen: trainer.
                           make_transformer_train_step(
                               m, o, mesh=mesh if par else None,
                               n_micro=cfg["pp_micro"] if par else 1)(
                               st, p, i, keep=keep)),
        (props, ids), lambda i: None, cfg["fp32_steps"], cfg["lr"])
    return out


def ep_axis(dev, cfg) -> dict:
    """Expert parallelism: the MoE GPT in ``dtype`` at ``gpt_batch`` x
    ``gpt_tokens``, half its experts a rank, the aux loss at ``gpt_aux``;
    then float32 at ``fp32_batch`` against one card, the dropped tokens
    counted."""
    import torch
    from moleculediffusiontransformer_tpu_torch import parallel
    from moleculediffusiontransformer_tpu_torch.models.transformers import \
        MoleculeTransformerGPT
    from moleculediffusiontransformer_tpu_torch.nn.moe import MoEFeedForward
    from moleculediffusiontransformer_tpu_torch.train import trainer
    mesh = parallel.make_mesh_ep(1, cfg["ranks"], device=dev.type)
    rank = mesh.get_local_rank("expert")
    experts = cfg["gpt"]["ff_num_experts"]

    def build(dtype):
        return MoleculeTransformerGPT(
            device=dev, dtype=dtype, generator=torch.Generator().manual_seed(
                41), **cfg["gpt"])

    def ids(b, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg["gpt"]["logits_dim"],
                             (b, cfg["gpt_tokens"]), generator=gen,
                             device=dev)

    def make_step(m, o, par):
        step = trainer.make_gpt_train_step(
            m, o, aux_loss_weight=cfg["gpt_aux"], mesh=mesh if par else None)
        return lambda st, i, gen: step(st, i)

    def dropped(m):
        return sum(x.dropped.item() for x in m.modules()
                   if isinstance(x, MoEFeedForward))

    model = build(getattr(torch, cfg["dtype"]))
    parallel.shard_params_ep(mesh, model, experts)
    opt = trainer.make_optimizer(trainer.OptimizerConfig())
    state = trainer.TrainState.create(model, opt)
    out = axes_steps(dev, make_step(model, opt, True), state,
                     (ids(cfg["gpt_batch"], 15),), lambda i: None,
                     cfg["steps"], model)
    out["dropped"] = dropped(model)
    out["experts_held"] = next(
        m for m in model.modules() if isinstance(m, MoEFeedForward)
    ).w_in.to_local().shape[0]
    del model, state
    empty_cache(dev)
    built = []
    out["fp32"] = axes_fp32(
        dev, rank, lambda: built.append(build(torch.float32)) or built[-1],
        lambda m: parallel.shard_params_ep(mesh, m, experts),
        make_step, (ids(cfg["fp32_batch"], 16),), lambda i: None,
        cfg["fp32_steps"], cfg["lr"])
    out["fp32"]["dropped"] = dropped(built[-1])
    return out


def axes_rank(rank, tmp, cfg) -> None:
    """One rank of phase 33 (a spawned process): join the gloo group, then
    tp, sp, pp and ep in turn; the results go to ``tmp/axes{rank}.pt``.  A
    crash prints the rank's Python stack (``faulthandler``)."""
    import datetime
    import faulthandler
    faulthandler.enable()

    import torch
    import torch.distributed as dist
    sys.path.insert(0, cfg["root"])
    from moleculediffusiontransformer_tpu_torch.parallel import \
        distributed_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1 if cfg["device"] == "cpu" else max(
        1, (os.cpu_count() or 1) // cfg["ranks"]))
    distributed_init(f"file://{os.path.join(tmp, 'rendezvous')}",
                     cfg["ranks"], rank, backend="gloo",
                     device=cfg["device"],
                     timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if cfg["device"] == "cuda" else torch.device("cpu"))
        out = {"seconds": {}}
        for name, body in (("tp", tp_axis), ("sp", sp_axis),
                           ("pp", pp_axis), ("ep", ep_axis)):
            print(f"phase 33 rank {rank}: {name}", file=sys.stderr,
                  flush=True)
            t0 = time.perf_counter()
            out[name] = body(dev, cfg)
            out["seconds"][name] = time.perf_counter() - t0
            empty_cache(dev)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"axes{rank}.pt"))


def spawn_ranks(fn, n, tmp, cfg, name):
    """``fn(rank, tmp, cfg)`` on ``n`` spawned processes; waits (stopping
    them at ``cfg["timeout"]``) and returns each rank's ``tmp/{name}{rank}.pt``.
    """
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(tmp, cfg), nprocs=n, join=False,
                             start_method="spawn")
    return ctx, lambda: _joined(ctx, n, tmp, cfg, name)


def _joined(ctx, n, tmp, cfg, name):
    import torch
    deadline = time.monotonic() + cfg["timeout"]
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 33's {name} ranks ran past "
                                     f"{cfg['timeout']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(os.path.join(tmp, f"{name}{r}.pt"),
                       weights_only=False) for r in range(n)]


# the kernels each mode's steps launch, a rank: tensor parallelism runs the
# stacks' training kernels, sequence parallelism the streaming ones
AXES_KERNELS = {"tp": ("STASH_LAUNCHES", "CONV_OUT_BWD_LAUNCHES",
                       "LAYER_BWD_LAUNCHES", "CONV_IN_GN_BWD_LAUNCHES"),
                "sp": ("FLASH_FWD_LAUNCHES", "FLASH_DQ_LAUNCHES",
                       "FLASH_DKV_LAUNCHES")}


def axes_want(mode, r, steps, stacks, layers) -> dict:
    """The launches a rank of ``mode`` must count over ``steps`` steps:
    every count 0 but its kernels'.  tp: K1 stash, K3, K4 a stack a step,
    K2 a layer a step; sp: K5, K6, K7 a streaming layer a step (a layer
    whose whole sequence takes the streaming route, at n = its tokens /
    ranks and m = its tokens), K1 stash, K3, K4 a stack a step where a
    level fuses (at most 64 tokens), K2 a layer."""
    from moleculediffusiontransformer_tpu_torch.ops import \
        flash_attention as fa
    want = {k: 0 for k in r["launched"]}
    if mode == "tp":
        want.update(loop_want(stacks, layers, steps, 0))
    elif mode == "sp":
        import torch
        ranks, dtype = PARALLEL_RANKS, getattr(torch, PARALLEL_DTYPE)
        # the pre-hooks saw each stack's local length; its route is the
        # whole sequence's, its queries this rank's
        streams = sum(n for n, tokens in r["stacks"]
                      if tokens >= fa.LONG_SEQ_THRESHOLD and fa.flash_takes(
                          tokens, tokens * ranks,
                          LONG["attention_features"], dtype))
        fused = [(n, tokens) for n, tokens in r["stacks"]
                 if tokens * ranks <= 64]
        want.update(loop_want(len(fused), sum(n for n, _ in fused), steps,
                              0))
        for k in AXES_KERNELS["sp"]:
            want[k] = streams * steps
    return want


def parallel_axes(dev) -> dict:
    """Phase 33 (see the docstring).  Returns the launches a rank of tp and
    of sp counted (the kernels line's ``launches_parallel_axes``)."""
    import tempfile

    from moleculediffusiontransformer_tpu_torch.parallel import collectives
    t0 = time.perf_counter()
    stacks, layers, _ = preset_stacks(FLAGSHIP)
    empty_cache(dev)
    cfg = axes_config(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ctx, wait = spawn_ranks(axes_rank, PARALLEL_RANKS, tmp, cfg, "axes")
        try:
            probe = axes_probes(tmp, cfg)
            ranks = wait()
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
    staged = sorted(collectives.GLOO_STAGED)
    phase("parallel_axes_probe", backend="gloo", device=dev.type,
          collectives=probe, staged=staged,
          note="each collective on a pair of its own: a refused send/recv "
               "breaks its connections or ends its process")
    refused = sorted(k.replace("_single", "") for k, v in probe.items()
                     if v != "takes")
    if dev.type == "cuda" and refused != staged:
        raise AssertionError(f"gloo refuses {refused} on CUDA tensors; the "
                             f"helpers stage {staged}")
    steps = AXES_STEPS + 1
    launched = {}
    for mode, what in (("tp", "the 91M, data 1 x model 2"),
                       ("sp", f"the long Model1d, {SP_BATCH} x {SP_SAMPLES}"),
                       ("pp", f"the AR transformer, {PP_MICRO} "
                              f"micro-batches"),
                       ("ep", "the MoE GPT, data 1 x expert 2")):
        for rank, r in enumerate(ranks):
            rec = {k: v for k, v in r[mode].items() if k != "fp32"}
            phase(f"parallel_{mode}", rank=rank, ranks=PARALLEL_RANKS,
                  what=what, backend="gloo", dtype=PARALLEL_DTYPE,
                  steps=steps, seconds_total=r["seconds"][mode], **rec)
            if not rec["finite"] or not all(rec["same"]) or rec.get(
                    "stale_kernel_weights"):
                raise AssertionError(f"{mode} rank {rank}: losses "
                                     f"{rec['losses']}, replicated "
                                     f"parameters the same {rec['same']}, "
                                     f"stale kernel weights "
                                     f"{rec.get('stale_kernel_weights')}")
            # send/recv (the halos and the pipeline's hops) is what gloo
            # refuses on the card's tensors; nothing else is staged
            staged_calls = dev.type == "cuda" and mode in ("sp", "pp")
            if set(rec["staged"]) - {"send_recv"} or bool(
                    rec["staged"].get("send_recv")) != staged_calls:
                raise AssertionError(f"{mode} rank {rank}: staged "
                                     f"{rec['staged']}")
            check_launches(f"{mode} (rank {rank})", rec["launched"],
                           axes_want(mode, rec, steps, stacks, layers))
        f32 = ranks[0][mode]["fp32"]
        phase(f"parallel_{mode}_fp32", batch=AXES_FP32_BATCH,
              steps=AXES_FP32_STEPS, lr=PARALLEL_FP32_LR,
              tol=PARALLEL_FP32_TOL, **f32)
        if not (f32["loss_rel_err"] <= PARALLEL_FP32_TOL
                and f32["params_max_abs_err"] <= PARALLEL_FP32_TOL
                and f32["grads_rel_err"] <= PARALLEL_FP32_TOL
                and f32["params_moved"] >= 10 * PARALLEL_FP32_TOL):
            raise AssertionError(f"float32 {mode} against one card: {f32}")
        launched[mode] = ranks[0][mode]["launched"]
    seconds = time.perf_counter() - t0
    phase("parallel_axes_phase_seconds", seconds=seconds,
          target=AXES_TARGET_SECONDS)
    return launched

# ------------------------------------------------------------- phase 34 --

def quality_argv(dev, out, tasks, epochs):
    """Phase 34's arguments of ``tools/quality_convergence_torch.py``:
    ``tasks`` for ``epochs`` epochs in chunks of one, into ``out``."""
    return ["--rows", str(QUALITY_ROWS), "--preset", QUALITY_PRESET,
            "--tasks", tasks, "--chunk-epochs", "1",
            "--max-epochs", str(epochs), "--timesteps", str(NUM_STEPS),
            "--num-generate", str(QUALITY_GENERATE),
            "--num-rescore", str(QUALITY_GENERATE), "--out", out,
            "--device", dev.type]


def quality_run(tool, argv):
    """The tool's ``main(argv)`` in this process: (its summary, the lines it
    printed, host seconds, kernel launches), the counts set to 0 just
    before and read just after."""
    import io

    import torch
    torch.cuda.synchronize()
    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        summary = tool.main(argv)
    torch.cuda.synchronize()
    return summary, printed.getvalue(), time.perf_counter() - t0, counts()


def read_curve(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def quality_tools(dev, sampler):
    """Phase 34: the quality tool on the 91M at full width, killed between
    its checkpoint and its curve line and resumed, every launch counted, and
    its ``best.pt`` served by phase 30's ``sampler`` (bf16, batch 512) after
    ``reload_checkpoint``, against the live sampler on the same draws.
    Returns the launches of the 91M's two runs."""
    import re
    import tempfile

    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        latest_checkpoint
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.design import (
        decode_one_hot, evaluate_generated)
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    from moleculediffusiontransformer_tpu_torch.train import recipes
    t_phase = time.perf_counter()
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import quality_convergence_torch as tool
    task = "inverse_diffusion"
    data = prepare_qm9(*synthetic_qm9(QUALITY_ROWS, seed=0,
                                      chemically_valid=True), mode=task)
    if sampler.meta["shape"][1] != data.vocab_size:
        raise AssertionError(f"phase 30's sampler has {sampler.meta['shape']}"
                             f" channels, the tool's corpus "
                             f"{data.vocab_size}")
    _, stacks, layers = task_stacks(task)
    micro = tool.TASK_PLAN[task][2]
    evals = 2 * (NUM_STEPS - 1)
    # the runs' step checkpoints (~1.1 GB each, with Adam's moments) go
    # with the directory once best.pt is served
    with tempfile.TemporaryDirectory(prefix="quality_", dir=os.path.join(
            ROOT, "moleculediffusiontransformer_tpu_torch", "_build")) as root:
        out = os.path.join(root, "q")
        ckpt_dir = os.path.join(out, "ckpts", task)
        curve_path = os.path.join(out, task + ".jsonl")

        # the forward transformer first (no kernel on its path), then the
        # 91M one epoch: the summary must keep both
        runs = {}
        _, _, runs["forward_transformer"], got = quality_run(
            tool, quality_argv(dev, out, "forward_transformer", 1))
        check_launches("quality tool, forward transformer", got,
                       {k: 0 for k in got})
        _, _, runs["first"], first = quality_run(
            tool, quality_argv(dev, out, task, 1))
        steps = int(re.search(r"step_(\d+)\.pt$",
                              latest_checkpoint(ckpt_dir)).group(1))
        check_launches("quality tool, 91M epoch 1", first,
                       loop_want(stacks, layers, micro * steps + 1, evals))
        # a kill after the checkpoint and before the curve line
        curve = read_curve(curve_path)
        dropped = curve.pop()
        with open(curve_path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in curve)
        summary, printed, runs["resumed"], resumed = quality_run(
            tool, quality_argv(dev, out, task, 2))
        # the checkpoint's epoch 1 evaluated again, then one chunk and its eval
        check_launches("quality tool, 91M resumed", resumed,
                       loop_want(stacks, layers, micro * steps + 1, 2 * evals))
        curve = read_curve(curve_path)
        labels = [r["epoch"] for r in curve]
        seeds = [int(x) for x in re.findall(r"seed (\d+)\)", printed)]
        best = os.path.join(ckpt_dir, "best.pt")
        ends = {"latest": tool.checkpoint_epoch(latest_checkpoint(ckpt_dir)),
                "best": tool.checkpoint_epoch(best)}
        metric = tool.TASK_PLAN[task][0]
        keys = ("validity_fraction", "novelty_fraction", "num_valid")
        record = {"labels": labels, "seeds": seeds, "checkpoint_epochs": ends,
                  "orphan_train_s": curve[0]["train_s"],
                  "orphan_equals_dropped": all(curve[0][k] == dropped[k]
                                               for k in keys),
                  "best_epoch": curve[-1]["best_epoch"],
                  "summary_tasks": sorted(summary["tasks"]),
                  metric: [r[metric] for r in curve]}
        if (labels != [1, 2] or seeds != [1] or ends["latest"] != 2
                or curve[0]["train_s"] is not None
                or ends["best"] != curve[-1]["best_epoch"]
                or record["summary_tasks"] != sorted(
                    ["forward_transformer", task])):
            raise AssertionError(f"the quality tool's resume: {record}")

        # best.pt served: phase 30's artifact, its weights swapped in
        t0 = time.perf_counter()
        sampler.reload_checkpoint(best)
        reload_s = time.perf_counter() - t0
        live = serve_model(dev, task, data.vocab_size, 0, torch.bfloat16)
        recipes.load_params(best, task, live)
        gen = torch.Generator(device=dev).manual_seed(34)
        props = torch.as_tensor(np.resize(
            np.asarray(data.y_test, np.float32),
            (SERVE_BATCH, data.y_test.shape[1])), device=dev)
        track = (SERVE_BATCH, *sampler.meta["shape"])
        draws = dict(noise=torch.randn(track, generator=gen, device=dev),
                     step_noise=torch.randn((NUM_STEPS - 1, *track),
                                            generator=gen, device=dev))
        with torch.no_grad():
            served, _ = serve_compare(
                "sampler bf16 512, the quality tool's best.pt", sampler,
                lambda: sample(live, props, num_steps=NUM_STEPS,
                               cond_scale=COND_SCALE, **draws), (props,),
                draws, KERNEL_TOL["bfloat16"],
                {"LAUNCHES": STACKS_PER_EVAL * evals}, eager=False)
        rep = evaluate_generated(decode_one_hot(served, data.tokenizer),
                                 data.smiles)
        launches = {k: first[k] + resumed[k] for k in first}
        phase("quality_tools", task=task, rows=QUALITY_ROWS,
              preset=QUALITY_PRESET, steps_an_epoch=steps, run_seconds=runs,
              launches=launches, reload_seconds=reload_s,
              served_validity=rep["validity_fraction"],
              served_novelty=rep["novelty_fraction"], **record,
              seconds=time.perf_counter() - t_phase)
    return launches

# ------------------------------------------------------------- phase 35 --

def example_module(name):
    """A module of ``examples/`` (the port's ``*_torch.py``), imported."""
    import importlib
    examples = os.path.join(ROOT, "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(name)


def meta_stacks(build, *args) -> tuple:
    """``model_stacks`` of ``build(*args, "meta")``, built on the meta
    device."""
    import torch
    with torch.device("meta"):
        return model_stacks(build(*args, "meta"))


def example_run(what, fn, want=None):
    """``fn()`` (an example's ``main``) in this process, its printing kept
    out of the output: (its result, host seconds, the launches), the counts
    set to 0 just before and read just after; held to ``want`` when
    given."""
    import io

    import torch
    torch.cuda.synchronize()
    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        out = fn()
    torch.cuda.synchronize()
    seconds, got = time.perf_counter() - t0, counts()
    if want is not None:
        check_launches(what, got, want)
    final = out if isinstance(out, dict) else {}
    phase("example", example=what, seconds=seconds,
          launches={k: v for k, v in got.items() if v},
          final={k: v for k, v in final.items()
                 if isinstance(v, (int, float))})
    return out, seconds, got


def example_data(rows, mode, max_length):
    """The examples' synthetic stand-in of ``rows`` rows, prepared for
    ``mode`` (90% of the rows train, 10% are held out)."""
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    return prepare_qm9(*synthetic_qm9(rows, seed=0, chemically_valid=True),
                       mode=mode, max_length=max_length)


def bench_geometry_checks(dev, qm, seed):
    """The tour's QMDiffusion (the bench geometry under ``--full``): its
    sample again with every stack on its module composition
    (``disable_fusion``) on the same draws (``seed``), within SAMPLE_TOL of
    the tour's through the kernels; then K1 alone against its plain version
    on the longest stack's input of that sample's first evaluation.  Runs
    outside the counted windows."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    model, steps = qm["model"], qm["num_steps"]
    stacks = [m for m in model.modules() if isinstance(m, Transformer1d)]
    seen = {}

    def keep_longest(mod, args, kwargs, out):
        x = args[0]
        if x.shape[1] > seen.get("length", 0):
            ctx = args[1] if len(args) > 1 else kwargs.get("context")
            seen.update(length=x.shape[1], module=mod, x=x.clone(),
                        ctx=None if ctx is None else ctx.clone())

    handles = [m.register_forward_hook(keep_longest, with_kwargs=True)
               for m in stacks]
    for m in stacks:
        m.disable_fusion = True
    try:
        reset_counts()
        plain, plain_s = timed(lambda: sample(
            model, qm["sequences"], torch.Generator(device=dev).manual_seed(
                seed), num_steps=steps, cond_scale=1.0))
        check_no_launches("the bench geometry on its composition")
    finally:
        for m in stacks:
            m.disable_fusion = False
        for h in handles:
            h.remove()
    err = _abs_err(qm["out"], plain)
    mod, x, ctx = seen["module"], seen["x"].contiguous(), seen["ctx"]
    if not mod.context_features:
        ctx = None
    kp, kw = mod.kernel_params(), mod._geometry()
    with torch.no_grad():
        got = tf.transformer1d_forward(kp, x, ctx, **kw)
        want = tf.transformer1d_reference(kp, x, ctx, **kw)
    k1_err = _abs_err(got, want)
    record = dict(batch=qm["sequences"].shape[0], steps=steps,
                  sample_seconds=qm["sample_seconds"],
                  plain_sample_seconds=plain_s, max_abs_err=err,
                  tol=SAMPLE_TOL, k1_stack=list(x.shape),
                  k1_context=None if ctx is None else list(ctx.shape),
                  k1_max_abs_err=k1_err, k1_tol=KERNEL_TOL["float32"])
    phase("bench_geometry_sample", **record)
    if not (err <= SAMPLE_TOL and k1_err <= KERNEL_TOL["float32"]):
        raise AssertionError(f"the bench geometry's sample: {record}")
    return record


def notebook_code(path, device) -> list:
    """The code cells of a notebook, in order, its ``DEVICE`` line naming
    ``device``."""
    with open(path) as f:
        cells = json.load(f)["cells"]
    return ["".join(c["source"]).replace(
        "torch.device('cuda')", f"torch.device('{device.type}')")
        for c in cells if c["cell_type"] == "code"]


def examples_and_notebooks(dev, sampler_path, scratch=None):
    """Phase 35: every example of the port through its ``main(argv)`` on
    ``dev`` at full width, the launches of the task examples and of the
    tour's QMDiffusion held exactly; phase 30's sampler file served with the
    inverse example's checkpoint; the Quickstart notebook's cells.  The
    examples' checkpoints go into a temporary directory under ``scratch``
    (``_build/`` by default), removed with the phase.  Returns the launches
    of the phase's runs, summed."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
        latest_checkpoint
    t_phase = time.perf_counter()
    launched = collections.Counter()
    none = {k: 0 for k in counts()}
    size = ["--tiny"] if EXAMPLES_TINY else []
    scratch = scratch or os.path.join(
        ROOT, "moleculediffusiontransformer_tpu_torch", "_build")
    with tempfile.TemporaryDirectory(prefix="examples_", dir=scratch) as root:
        def argv(name):
            return ["--rows", str(EXAMPLES_ROWS), "--batch-size",
                    str(EXAMPLES_BATCH), "--epochs", "1", "--device",
                    dev.type, "--checkpoint-dir", os.path.join(root, name),
                    *size]

        # the four task examples: one epoch each, its eval after it
        for name, mode, length, diffusion in (
                ("inverse_diffusion", "inverse_diffusion", 32, True),
                ("forward_diffusion", "forward_diffusion", 64, True),
                ("inverse_transformer", "transformer", 64, False),
                ("forward_transformer", "transformer", 64, False)):
            example = example_module(name + "_torch")
            data = example_data(EXAMPLES_ROWS, mode, length)
            want = none
            if diffusion:
                args = (EXAMPLES_TINY,) if name == "forward_diffusion" else (
                    data.vocab_size, EXAMPLES_TINY)
                stacks, layers = meta_stacks(example.build_model, *args)
                steps = len(data.X_train) // EXAMPLES_BATCH
                want = loop_want(stacks, layers, steps + 1,
                                 2 * (example.EVAL_STEPS - 1))
            _, _, got = example_run(name, lambda: example.main(argv(name)),
                                    want)
            launched.update(got)

        # the tour at the notebook sizes: its bench-geometry QMDiffusion and
        # the graph analog train through K1 stash and K2-K4, the sample
        # through K1
        example = example_module("simple_models_torch")
        tour, _, got = example_run("simple_models", lambda: example.main(
            [*(["--full"] if EXAMPLES_FULL else []), "--device", dev.type]))
        trained = [model_stacks(r["model"]) for r in tour.values()]
        qm = tour["demo_qm_diffusion"]
        want = loop_want(sum(s for s, _ in trained),
                         sum(n for _, n in trained), 1, 0)
        want["LAUNCHES"] = model_stacks(qm["model"])[0] * 2 * (
            qm["num_steps"] - 1)
        check_launches("simple_models", got, want)
        launched.update(got)
        bench = bench_geometry_checks(dev, qm, example.SAMPLE_SEED)
        del tour, qm

        # phase 30's 91M sampler, the inverse example's checkpoint swapped in
        example = example_module("serve_artifact_torch")
        ckpt = latest_checkpoint(os.path.join(root, "inverse_diffusion"))
        with kept_graphs():
            served, _, got = example_run(
                "serve_artifact", lambda: example.main(
                    [sampler_path, "--checkpoint", ckpt, "--rows",
                     str(EXAMPLES_ROWS), "--device", dev.type]))
        launched.update(got)
        server = served["server"]
        n = min(server.batch, len(example_data(
            EXAMPLES_ROWS, "inverse_diffusion", 32).y_test))
        stacks, _ = meta_stacks(example_module(
            "inverse_diffusion_torch").build_model, server.meta["shape"][1],
            EXAMPLES_TINY)
        served_want = {"LAUNCHES": stacks * 2 * (
            server.meta["sampler"]["num_steps"] - 1), "UNIFORM_LAUNCHES": 0,
            "RESNET_LAUNCHES": 0}
        if dev.type == "cuda":
            if server.tier != "graph":
                raise AssertionError(f"the served example: the graph tier "
                                     f"did not capture: {server.exec_error}")
            check_launches("the served example, captured", {
                k: server.launches[k] for k in SERVED_COUNTS}, served_want)
            graph_kernel_nodes("the served example", server, replayed=True)
        smiles = served["smiles"]
        if (len(smiles) != n or not all(isinstance(s, str) for s in smiles)
                or not np.isfinite(served["validity_fraction"])):
            raise AssertionError(f"the served example decoded {smiles[:4]}"
                                 f" ({len(smiles)} of {n})")
        serve_record = dict(tier=server.tier, rows=len(smiles),
                            captured=served_want,
                            validity=served["validity_fraction"],
                            novelty=served["novelty_fraction"],
                            startup=server.startup)
        del served, server

        # the audio tour at its tiny sizes (phase 31 runs its presets)
        example = example_module("audio_diffusion_torch")
        _, _, got = example_run("audio_diffusion", lambda: example.main(
            ["--device", dev.type]))
        launched.update(got)

    # the Quickstart notebook, its code cells in order
    ns = {}
    path = os.path.join(ROOT, "notebooks", "Quickstart_torch.ipynb")
    _, _, got = example_run("Quickstart", lambda: [
        exec(compile(src, f"Quickstart cell {i}", "exec"), ns)
        for i, src in enumerate(notebook_code(path, dev))])
    launched.update(got)
    report = ns["evaluate_generated"](ns["generated"], ns["data"].smiles)
    del ns
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    phase("examples_and_notebooks", seconds=seconds,
          target=EXAMPLES_TARGET_SECONDS, launches=dict(launched),
          bench_geometry=bench, served=serve_record,
          quickstart_validity=report["validity_fraction"])
    return dict(launched)


# ------------------------------------------------------------- phase 36 ---

def named_kernels_ms(fn, names, calls: int = 3):
    """Device milliseconds a call of ``fn()`` spends in kernels whose
    profiler name holds one of ``names``, over ``calls`` calls in a
    ``torch.profiler`` window of their own, opened after an empty one;
    None when the profiler saw no such kernel (not measured: a line then
    names the kernels it did see)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    # in the whole script the first window after the timing loops saw none
    # of the forward's kernels (the backward's, in the next window, it saw)
    with profile(activities=activities):
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = sorted(((float(getattr(evt, "self_device_time_total", getattr(
        evt, "self_cuda_time_total", 0.0))), evt.key)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA), reverse=True)
    us = [t for t, key in device if any(n in key for n in names)]
    if not us:
        phase("kernels_not_seen", wanted=list(names),
              seen=[[key[:80], t / 1e3] for t, key in device[:6]])
        return None
    return sum(us) / 1e3 / calls


def check_long_stacks(dev):
    """Phase 36's kernels: K1 (plain, with its stash, with a uniform
    context), K3, K2 and K4 against their plain versions at
    LONG_STACK_SHAPES in float32 and bfloat16, each error relative to the
    plain output's scale within KERNEL_TOL, and each of them and the
    backward chain bitwise equal across two calls; in bfloat16 the card's
    time of each (calls back to back) beside the plain version's, the
    module composition's, and the attention core's beside
    ``scaled_dot_product_attention``'s at the core's (b, h, L, m, d) (a
    yardstick; the port never calls it).  Returns, per kernel, the bf16
    numbers summed over the shapes and their bound."""
    import torch
    import torch.nn.functional as F
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    keys = ("fwd", "stash", "uniform", "conv_out", "layer", "conv_in_gn")
    summary = {k: {"shapes": 0, "max_abs_err": 0.0, "card_ms": 0.0,
                   "plain_ms": 0.0} for k in keys}
    summary["fwd"].update(composition_ms=0.0, core_ms=0.0, sdpa_ms=0.0)
    summary["layer"].update(core_ms=0.0, sdpa_ms=0.0)
    b, c, heads, d = LONG_STACK_BATCH, LONG_STACK_C, 8, 64
    kw = dict(num_layers=1, heads=heads, head_dim=d)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = KERNEL_TOL[dname]
        for length, m in LONG_STACK_SHAPES:
            cross = m is not None
            gen = torch.Generator().manual_seed(36 * length + (m or 0))
            mod = Transformer1d(1, c, heads, d, 2, context_features=(
                CONTEXT[1] if cross else None), dtype=dtype)
            init_parameters(mod, gen)
            mod = mod.to(dev)
            kp = mod.kernel_params()
            x, g = (torch.randn(b, length, c, generator=gen).to(dev, dtype)
                    for _ in range(2))
            ctx = (torch.randn(b, m, CONTEXT[1], generator=gen).to(
                dev, dtype) if cross else None)
            table = ctx[:1] if cross else None
            w = tf._kernel_weights(kp, 1, cross, dtype)
            lw = w[4:4 + (20 if cross else 12)]
            calls = {
                "fwd": (lambda: tf.transformer1d_forward(
                    kp, x, ctx, multiplier=2, **kw),
                    lambda: tf.transformer1d_reference(
                        kp, x, ctx, multiplier=2, **kw)),
                "stash": (lambda: tf.transformer1d_forward(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw),
                    lambda: tf.transformer1d_reference(
                        kp, x, ctx, multiplier=2, with_stash=True, **kw))}
            if cross:
                calls["uniform"] = (
                    lambda: tf.transformer1d_forward(
                        kp, x, table, multiplier=2, uniform_ctx=True, **kw),
                    lambda: tf.transformer1d_reference(
                        kp, x, table, multiplier=2, uniform_ctx=True, **kw))
            with torch.no_grad():
                _, stash = tf.transformer1d_reference(
                    kp, x, ctx, multiplier=2, with_stash=True, **kw)
                layer_args = (g, stash[0], stash[1] if cross else None,
                              stash[-2], ctx, lw)
                calls.update(
                    conv_out=(lambda: tf.bwd_conv_out(g, stash[-1], w[-2]),
                              lambda: tf.bwd_conv_out_reference(
                                  g, stash[-1], w[-2])),
                    layer=(lambda: tf.bwd_layer(*layer_args, heads=heads,
                                                head_dim=d),
                           lambda: tf.bwd_layer_reference(
                               *layer_args, heads=heads, head_dim=d)),
                    conv_in_gn=(lambda: tf.bwd_conv_in_gn(g, x, w[2], w[0],
                                                          w[1]),
                                lambda: tf.bwd_conv_in_gn_reference(
                                    g, x, w[2], w[0], w[1])))
                rel, absolute, repeat = {}, {}, {}
                for key, (kernel, plain) in calls.items():
                    got, again, want = kernel(), kernel(), plain()
                    flat = [got] if torch.is_tensor(got) else list(got)
                    flat_again = ([again] if torch.is_tensor(again)
                                  else list(again))
                    flat_want = [want] if torch.is_tensor(want) else list(
                        want)
                    if key == "layer":     # (dy, dctx, [grads])
                        flat, flat_again, flat_want = (
                            [f[0], *([f[1]] if cross else []), *f[2]]
                            for f in (flat, flat_again, flat_want))
                    rel[key] = max(_rel_err(a, w_) for a, w_ in
                                   zip(flat, flat_want))
                    absolute[key] = max(_abs_err(a, w_) for a, w_ in
                                        zip(flat, flat_want))
                    repeat[key] = all(torch.equal(a, a2) for a, a2 in
                                      zip(flat, flat_again))
                chain = [tf.transformer1d_backward(kp, x, ctx, stash, g,
                                                   multiplier=2, **kw)
                         for _ in range(2)]
                repeat["chain"] = (
                    torch.equal(chain[0][1], chain[1][1])
                    and all(torch.equal(chain[0][0][n], chain[1][0][n])
                            for n in chain[0][0])
                    and (not cross or torch.equal(chain[0][2], chain[1][2])))
                torch.cuda.synchronize()
                timing = {}
                if dtype == torch.bfloat16:
                    timing = {k: {"card_ms": device_ms(kernel, reps=10,
                                                       rounds=3),
                                  "plain_ms": cuda_ms(plain, reps=5)}
                              for k, (kernel, plain) in calls.items()}
                    mod.disable_fusion = True
                    timing["fwd"]["composition_ms"] = device_ms(
                        lambda: mod(x, ctx), reps=10, rounds=3)
                    mod.disable_fusion = False
                    timing["fwd"]["core_ms"] = named_kernels_ms(
                        calls["fwd"][0], ("attention_tiled_kernel",))
                    timing["layer"]["core_ms"] = named_kernels_ms(
                        calls["layer"][0], ("attention_bwd_dq_tiled_kernel",
                                            "attention_bwd_dkv_tiled_kernel"))
                    q = torch.randn(b, heads, length, d, generator=gen).to(
                        dev, dtype)
                    k, v = (torch.randn(b, heads, m or length, d,
                                        generator=gen).to(dev, dtype)
                            for _ in range(2))
                    timing["fwd"]["sdpa_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v),
                        reps=10, rounds=3)
                    q, k, v = (t.requires_grad_() for t in (q, k, v))
                    with torch.enable_grad():
                        o = F.scaled_dot_product_attention(q, k, v)
                    do = torch.randn_like(o)
                    timing["layer"]["sdpa_ms"] = device_ms(
                        lambda: torch.autograd.grad(o, (q, k, v), do,
                                                    retain_graph=True),
                        reps=10, rounds=3)
            phase("long_stack_kernels", dtype=dname, batch=b, L=length,
                  m=m, C=c, rel_err=rel, max_abs_err=absolute, tol=tol,
                  bitwise_repeat=repeat, **({"bf16": timing} if timing
                                            else {}))
            bad = {k: v for k, v in rel.items() if not v <= tol}
            if bad:
                raise AssertionError(f"L {length}, m {m}, {dname}: kernels "
                                     f"differ from their plain versions: "
                                     f"{bad}")
            if not all(repeat.values()):
                raise AssertionError(f"L {length}, m {m}, {dname}: two "
                                     f"calls differ: {repeat}")
            if dtype != torch.bfloat16:
                continue
            conv = 4 * b * length * c * c
            grad32 = 4 * (c * c + 3 * c)
            flops = stack_flops(b, length, c, 1, cross, m or 0, CONTEXT[1])
            out_bytes = nbytes(x)
            limits = {
                "fwd": bound(flops, nbytes(x, ctx, *w) + out_bytes),
                "stash": bound(flops, nbytes(x, ctx, stash, *w) + out_bytes),
                "conv_out": bound(conv, nbytes(g, g, g, w[-2]) + grad32),
                "layer": bound(
                    3 * stack_layer_flops(b, length, c, cross, m or 0,
                                          CONTEXT[1]),
                    (2 + (3 if cross else 2)) * nbytes(g) + 2 * nbytes(ctx)
                    + nbytes(*lw) + 4 * sum(t.numel() for t in lw)),
                "conv_in_gn": bound(conv, nbytes(g, x, g, w[2]) + grad32)}
            if cross:
                limits["uniform"] = bound(
                    stack_flops(b, length, c, 1, True, m, CONTEXT[1],
                                kv_rows=m),
                    nbytes(x, table, *w) + out_bytes)
            for key, t in timing.items():
                row = summary[key]
                row["shapes"] += 1
                row["max_abs_err"] = max(row["max_abs_err"], absolute[key])
                for name, ms in t.items():
                    # a core the profiler missed leaves its sum not measured
                    row[name] = (None if ms is None or row[name] is None
                                 else row[name] + ms)
                add_bound(row, limits[key])
    return {k: close_bound(v) for k, v in summary.items()}


def set_stack_fusion(model, on: bool) -> None:
    """Every Transformer1d of ``model`` on the stack kernels (``on``) or on
    its module composition."""
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    for mod in model.modules():
        if isinstance(mod, Transformer1d):
            mod.disable_fusion = not on


def stack_lengths(model, samples: int) -> list:
    """The L of each Transformer1d stack of ``model`` on a waveform of
    ``samples`` (one no-grad denoise at batch 1, hooked)."""
    import torch
    from moleculediffusiontransformer_tpu_torch.nn.attention import \
        Transformer1d
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[1]))
        for m in model.modules() if isinstance(m, Transformer1d)]
    dev = next(model.parameters()).device
    try:
        with torch.no_grad():
            model.denoise(torch.zeros(1, samples, model.in_channels,
                                      device=dev), torch.ones(1, device=dev))
    finally:
        for hook in hooks:
            hook.remove()
    return seen


def audio_long_path(dev):
    """Phase 36's path: the default audio preset at AUDIO_LONG, each
    request and step on the stack kernels (launches exactly stacks x
    evaluations, or stacks and layers x steps, and nothing else) and on the
    module composition (no stack kernel; its attention streams through K5
    to K7 where ``nn.attention.sdpa`` routes it).  A two-step request on
    each route first warms both up.  Returns the kernels' launches on that
    path."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    model = audio.AudioDiffusionModel(
        in_channels=1, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(61))
    stacks, layers = audio_stacks(model)
    if stacks != AUDIO_LONG_STACKS:
        raise AssertionError(f"the audio preset has {stacks} stacks")
    gen = torch.Generator(device=dev).manual_seed(62)
    sampling = audio.get_default_sampling_kwargs()
    total = dict.fromkeys(counts(), 0)
    for samples, batch in AUDIO_LONG:
        lengths = stack_lengths(model, samples)
        for route in ("kernels", "composition"):
            set_stack_fusion(model, route == "kernels")
            audio.sample_model1d(model, shape=(batch, samples, 1),
                                 generator=gen, num_steps=2, **sampling)
        for route in ("kernels", "composition"):
            set_stack_fusion(model, route == "kernels")
            calls, handle = count_calls(model.unet)
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            out, seconds = timed(lambda: audio.sample_model1d(
                model, shape=(batch, samples, 1), generator=gen,
                num_steps=AUDIO_LONG_STEPS, **sampling))
            handle.remove()
            launched = counts()
            evals = len(calls)
            want = (loop_want(stacks, 0, 0, evals) if route == "kernels"
                    else composed(launched))
            phase("audio_long_request", route=route, samples=samples,
                  batch=batch, num_steps=AUDIO_LONG_STEPS, evals=evals,
                  stack_lengths=lengths, seconds=seconds,
                  waveforms_per_s=batch / seconds,
                  samples_per_s=batch * samples / seconds,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches=launched["LAUNCHES"],
                  want_launches=want["LAUNCHES"])
            if tuple(out.shape) != (batch, samples, 1) or not (
                    torch.isfinite(out).all() and out.abs().max() <= 1):
                raise AssertionError(f"audio request at {samples}: output "
                                     f"{tuple(out.shape)}")
            check_launches(f"audio request at {samples}, {route}", launched,
                           want)
            if route == "kernels":
                total = {k: total[k] + launched[k] for k in total}
        for route in ("kernels", "composition"):
            set_stack_fusion(model, route == "kernels")
            step = audio_train_step(model)
            x = torch.rand(batch, samples, 1, generator=gen,
                           device=dev) * 2 - 1
            reset_counts()
            first, first_seconds = timed(lambda: step(x, gen))
            torch.cuda.reset_peak_memory_stats()
            loss, seconds = timed(lambda: step(x, gen))
            launched = counts()
            want = (loop_want(stacks, layers, 2, 0) if route == "kernels"
                    else composed(launched))
            losses = [first.item(), loss.item()]
            phase("audio_long_train", route=route, samples=samples,
                  batch=batch, first_step_seconds=first_seconds,
                  seconds_per_step=seconds, waveforms_per_s=batch / seconds,
                  samples_per_s=batch * samples / seconds, losses=losses,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches={k: v for k, v in launched.items() if v})
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"audio step at {samples}: {losses}")
            check_launches(f"audio step at {samples}, {route}", launched,
                           want)
            if route == "kernels":
                total = {k: total[k] + launched[k] for k in total}
    set_stack_fusion(model, True)
    return total


def composed(launched: dict) -> dict:
    """The launches a call on the module composition may make: ``launched``
    with every stack kernel's count 0."""
    return {k: 0 if k in _COUNTERS["transformer_fusion"] else v
            for k, v in launched.items()}


def audio_long_fp32_vs_cpu(dev):
    """Phase 36: one float32 denoise of the preset at
    AUDIO_LONG_PARITY_SAMPLES, batch 1, through K1 on the card against the
    plain versions on the CPU, within SAMPLE_TOL."""
    import torch
    from moleculediffusiontransformer_tpu_torch.models import audio
    model = audio.AudioDiffusionModel(
        in_channels=1, device="cpu",
        generator=torch.Generator().manual_seed(63)).eval()
    g = torch.Generator().manual_seed(64)
    x = torch.randn(1, AUDIO_LONG_PARITY_SAMPLES, 1, generator=g)
    sigma = torch.tensor([0.5])
    with torch.no_grad():
        want = model.denoise(x, sigma)
        model = model.to(dev)
        reset_counts()
        got = model.denoise(x.to(dev), sigma.to(dev)).cpu()
    launched = counts()
    err = _abs_err(got, want)
    phase("audio_long_fp32_vs_cpu", samples=AUDIO_LONG_PARITY_SAMPLES,
          batch=1, max_abs_err=err, tol=SAMPLE_TOL,
          launches=launched["LAUNCHES"])
    check_launches("audio fp32 denoise", launched,
                   loop_want(AUDIO_LONG_STACKS, 0, 0, 1))
    if not err <= SAMPLE_TOL:
        raise AssertionError(f"audio fp32 denoise: card vs CPU {err}")


def native_data_path(dev):
    """Phase 36: ``load_qm9`` and ``prepare_qm9`` on a QM9_ROWS-row
    ``synthetic_qm9`` CSV through the native library and through the
    Python and numpy paths: equal, each one's host seconds, the native
    calls counted."""
    import numpy as np
    import torch
    from moleculediffusiontransformer_tpu_torch.data import native, qm9
    # QM9_ROWS rows cycled from 8,192 synthetic molecules, each row's
    # properties scaled by its own seeded factor (``synthetic_qm9`` itself
    # takes ~10 s a 133,885 rows on the host)
    base_smiles, base_props = qm9.synthetic_qm9(8192, seed=0,
                                                chemically_valid=True)
    rows = np.arange(QM9_ROWS) % len(base_smiles)
    smiles = [base_smiles[i] for i in rows]
    props = (base_props[rows] * np.random.default_rng(36).uniform(
        0.5, 1.5, (QM9_ROWS, 1))).astype(np.float32)
    head = "smiles," + ",".join(qm9.PROPERTY_NAMES)
    out = {"rows": QM9_ROWS, "card": torch.cuda.get_device_name(dev)}
    native.build()
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "qm9.csv")
        with open(path, "w") as f:
            f.write(head + "\n" + "\n".join(
                s + "," + ",".join(map(repr, p.tolist()))
                for s, p in zip(smiles, props)) + "\n")

        def both(name, fn, patched, call):
            before = native.CALLS[call]
            t0 = time.perf_counter()
            got = fn()
            t_native = time.perf_counter() - t0
            if native.CALLS[call] != before + 1:
                raise AssertionError(f"{name}: the native {call} ran "
                                     f"{native.CALLS[call] - before} times")
            saved = {n: getattr(native, n) for n in patched}
            for n in patched:
                setattr(native, n, lambda *a, **k: None)
            try:
                t0 = time.perf_counter()
                want = fn()
                t_python = time.perf_counter() - t0
            finally:
                for n, f in saved.items():
                    setattr(native, n, f)
            out[name] = {"native_seconds": t_native,
                         "python_seconds": t_python}
            return got, want

        got, want = both("load_qm9", lambda: qm9.load_qm9(path),
                         ("load_csv",), "load_csv")
        same = got[0] == want[0] and np.array_equal(got[1], want[1])
        equal = {"load_qm9": same and got[0] == list(smiles)
                 and np.array_equal(got[1], props)}
        for mode, call in (("inverse_diffusion", "tokenize_one_hot"),
                           ("transformer", "tokenize_pad")):
            got, want = both(f"prepare_qm9 {mode}", lambda: qm9.prepare_qm9(
                smiles, props, mode=mode),
                ("tokenize_pad", "tokenize_one_hot"), call)
            equal[mode] = all(np.array_equal(getattr(got, n),
                                             getattr(want, n))
                              for n in ("X_train", "X_test", "y_train",
                                        "y_test"))
    phase("native_data_path", equal=equal, calls=dict(native.CALLS), **out)
    if not all(equal.values()):
        raise AssertionError(f"native data path differs from the Python "
                             f"path: {equal}")


def long_stacks_phase(dev):
    """Phase 36 as a whole: the kernels at the tiled lengths, the audio
    preset's path, its float32 parity, the native data path.  Returns
    (the kernels' bf16 summary, the path's launches)."""
    seconds = {}
    t0 = time.perf_counter()
    kernels = check_long_stacks(dev)
    seconds["kernels"] = time.perf_counter() - t0
    launched = audio_long_path(dev)
    seconds["path"] = time.perf_counter() - t0 - sum(seconds.values())
    audio_long_fp32_vs_cpu(dev)
    seconds["fp32_vs_cpu"] = time.perf_counter() - t0 - sum(seconds.values())
    native_data_path(dev)
    seconds["native"] = time.perf_counter() - t0 - sum(seconds.values())
    phase("long_stacks_seconds", **seconds)
    return kernels, launched


class PhaseClock:
    """Host seconds of each numbered phase: ``start(n)`` prints the seconds
    of the phase that ran since the last call and starts phase ``n``."""

    def __init__(self, number):
        self.number, self.t0 = number, time.perf_counter()

    def start(self, number):
        now = time.perf_counter()
        phase("phase_seconds", number=self.number, seconds=now - self.t0)
        self.number, self.t0 = number, now


def main() -> int:
    t_script = time.perf_counter()
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
    clock = PhaseClock(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    clock.start(2)
    # 2. build, every source at once (phases 5, 8, 14 and 20 report the
    # others); each phase waits only for the libraries it calls, so the
    # slowest nvcc runs on beside the first phases
    at = attention_ops()
    sources = (tf.SOURCE, tf.BWD_SOURCE, rf.SOURCE, fa.SOURCE, fa.BWD_SOURCE,
               at.SOURCE)
    pool = ThreadPoolExecutor(len(sources))
    builds = {source: pool.submit(cuda_build.build, source)
              for source in sources}
    pool.shutdown(wait=False)
    path, seconds = builds[tf.SOURCE].result()
    phase("build", library=os.path.relpath(path, ROOT), seconds=seconds)

    clock.start(3)
    # 3. kernel against its plain version
    worst, stack_sums = check_stacks(dev)

    clock.start(4)
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

    clock.start(5)
    # 5. build of the backward kernels (started in phase 2)
    path, seconds = builds[tf.BWD_SOURCE].result()
    phase("build_bwd", library=os.path.relpath(path, ROOT), seconds=seconds)

    clock.start(6)
    # 6. the training kernels against their plain versions
    train_kernels, train_chains = check_backward(dev)
    phase("train_chain", **train_chains)

    clock.start(7)
    # 7. the training path
    train_launches = train_path(dev)
    fp32_step_vs_plain(dev)

    clock.start(8)
    # 8. K8 against its plain version (built in phase 2)
    path, seconds = builds[rf.SOURCE].result()
    phase("build_resnet", library=os.path.relpath(path, ROOT),
          seconds=seconds)
    resnet = check_resnet(dev)

    clock.start(9)
    # 9. the uniform-context stack kernel against its plain version
    uniform = check_uniform(dev)

    clock.start(10)
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

    clock.start(11)
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

    clock.start(12)
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

    clock.start(13)
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

    clock.start(14)
    # 14. build of the streaming-attention kernels (started in phase 2)
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        path, seconds = builds[source].result()
        phase("build_flash", library=os.path.relpath(path, ROOT),
              seconds=seconds)

    clock.start(15)
    # 15. K5, K6, K7 against their plain versions; 16. the crossover
    flash = check_flash(dev)
    check_crossover(dev)

    clock.start(17)
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

    clock.start(18)
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

    clock.start(19)
    # 19. float32 parity of the long model, card against CPU
    long_fp32_vs_plain(dev)

    clock.start(20)
    # 20. build of the resident-KV attention kernels (started in phase 2)
    path, seconds = builds[at.SOURCE].result()
    phase("build_attention", library=os.path.relpath(path, ROOT),
          seconds=seconds)

    clock.start(21)
    # 21. K9 and K10 against their plain version, then their main path
    attention = check_attention(dev)
    attention_launched = drive_attention_entry_points(dev)

    clock.start(22)
    # 22. the inverse AR transformer serving
    ar_serve(dev)
    ar_fp32_request_vs_cpu(dev)

    clock.start(23)
    # 23. the inverse AR transformer training
    ar_train(dev)
    ar_fp32_step_vs_cpu(dev)

    clock.start(24)
    # 24. the forward transformer
    inv, tr = design_data()
    encoder = encoder_serve_and_train(dev, tr)
    encoder_fp32_vs_cpu(dev, tr)

    clock.start(25)
    # 25. the inverse-design pipeline on the 91M model
    design_pipeline(dev, inv, tr, encoder)

    clock.start(26)
    # 26. float32 parity of the pipeline, card against CPU
    design_fp32_vs_cpu(dev, inv)

    clock.start(27)
    # 27. the training loop, checkpoints and resume, the recipes, the CLI
    loop_launches, loop_first = train_loop(dev)

    clock.start(28)
    # 28. the diffusion options on the audio preset
    audio_launches = audio_options(dev)

    clock.start(29)
    # 29. the GPT family
    gpt_family(dev)

    clock.start(30)
    # 30. serving: the artifacts, both tiers, the HTTP front end; its
    # directory (the artifacts and 91M checkpoints) goes once phases 34 and
    # 35 are done with the sampler, whether or not they pass
    serve_dir = tempfile.mkdtemp(prefix="serve_", dir=os.path.join(
        ROOT, "moleculediffusiontransformer_tpu_torch", "_build"))
    try:
        served, sampler = serving_artifacts(dev, inv, tr, serve_dir)

        clock.start(31)
        # 31. the audio assemblies and the graph analogs
        asm_served, asm_trained = audio_assemblies(dev)

        clock.start(32)
        # 32. the data-parallel layer: two ranks through gloo, then NCCL at
        # one
        parallel = parallel_layer(dev, inv, loop_first)

        clock.start(33)
        # 33. the other axes: tensor, sequence, pipeline and expert
        # parallelism
        axes = parallel_axes(dev)

        clock.start(34)
        # 34. the quality tools on the 91M, its best checkpoint served
        quality = quality_tools(dev, sampler)
        del sampler

        clock.start(35)
        # 35. the examples and the notebooks at full width, phase 30's
        # sampler file served with the inverse example's checkpoint
        examples = examples_and_notebooks(
            dev, os.path.join(serve_dir, "sampler.pt2"))
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)

    clock.start(36)
    # 36. the stack kernels past 64 rows, the audio preset at 2**18 and
    # 2**20 samples through them, the native data path
    long_kernels, audio_long = long_stacks_phase(dev)

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
        **stack_sums["bfloat16"],
        "library_ms": None,
        "products": TC_PRODUCTS,
        "float32": {"max_abs_err": worst["float32"],
                    **stack_sums["float32"]},
        "launches_cli_train": loop_launches["LAUNCHES"],
        "launches_served": served["LAUNCHES"],
        "launches_assemblies": asm_served["LAUNCHES"],
        "launches_parallel": parallel["serve"]["LAUNCHES"],
        "launches_quality": quality["LAUNCHES"],
        "launches_examples": examples["LAUNCHES"],
        "launches_audio_long": audio_long["LAUNCHES"],
        "long": long_kernels["fwd"],
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
                        **train_kernels["bfloat16"][key],
                        "library_ms": None,
                        "products": TC_PRODUCTS,
                        "float32": train_kernels["float32"][key],
                        "launches_cli_train": loop_launches[count],
                        "launches_audio_all_train": audio_launches[count],
                        "launches_assemblies_train": asm_trained[count],
                        "launches_parallel": parallel["train"][count],
                        "launches_parallel_axes": axes["tp"][count],
                        "launches_quality": quality[count],
                        "launches_examples": examples[count],
                        "launches_audio_long_train": audio_long[count],
                        "long": long_kernels[key]})
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
        "products": TC_PRODUCTS,
        "launches_served": served["RESNET_LAUNCHES"]})
    kernels.append({
        "name": "transformer1d_stack_fwd_uniform_ctx", "route": "cuda",
        "source": csrc + "transformer1d_fwd.cu",
        "replaces": jax_ops + ":449",
        "launches": served_on["UNIFORM_LAUNCHES"],
        "max_abs_err": uniform["max_abs_err"], "ms": uniform["ms"],
        "card_ms": uniform["card_ms"],
        "plain_ms": uniform["plain_ms"], "bound_ms": uniform["bound_ms"],
        "bound_by": uniform["bound_by"], "library_ms": None,
        "float32": uniform["float32"],
        "products": TC_PRODUCTS,
        "launches_served": served["UNIFORM_LAUNCHES"],
        "long": long_kernels["uniform"]})
    # the streaming-attention kernels: bf16 at bh 16, n = m = 4096, d 64
    # from phase 15 (plain_ms and library_ms of the dq and the dk/dv kernel
    # are those of the whole backward, which computes all three grads);
    # K5's launches from the 2**17-sample requests of phase 17, K6's and
    # K7's from the batch-2 training steps of phase 18
    jax_flash = "moleculediffusiontransformer_tpu/ops/flash_attention.py"
    for key, name, source, line, count, launched in (
            ("fwd", "flash_attention_fwd", fa.SOURCE, 89,
             "FLASH_FWD_LAUNCHES", long_served["FLASH_FWD_LAUNCHES"]),
            ("dq", "flash_attention_bwd_dq", fa.BWD_SOURCE, 185,
             "FLASH_DQ_LAUNCHES", long_trained["FLASH_DQ_LAUNCHES"]),
            ("dkv", "flash_attention_bwd_dkv", fa.BWD_SOURCE, 220,
             "FLASH_DKV_LAUNCHES", long_trained["FLASH_DKV_LAUNCHES"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": f"{jax_flash}:{line}",
                        "launches": launched, **flash[key],
                        "launches_parallel_axes": axes["sp"][count]})
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
    clock.start(None)
    phase("script_seconds", seconds=time.perf_counter() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
