"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Card: name and power limit (nvidia-smi); TF32 off for matmuls.  cuDNN's
   flags stay torch's defaults (TF32 allowed): the port's float32
   convolutions run at float32 under them (phase 18a).
2. Kernels: build every CUDA source (all at once; the build time and the
   flash instantiations' registers and spills from ``-Xptxas -v`` are
   printed, and those of the FFN's designs and the LayerNorm forward),
   read the flash and FFN libraries' machine code (`cuobjdump -sass`:
   all 24 instantiations of the bf16 forward (D 64, 128 and 256), all 16
   each of dQ and dK/dV, of the fp32 split-TF32 forward, dQ and dK/dV (the
   tensor-core kernels) and all 16 of each of the FFN's two tensor-core
   designs' products must hold HGMMA, the CUDA-core fp32 forward, dQ and
   dK/dV of before must be gone, and the fp32 forward at D = 256 must be
   the CUDA-core kernel, FFMA and no HGMMA), then hold each kernel
   against its plain PyTorch version on the card, in float32 and bfloat16,
   and time kernel, plain version and a PyTorch yardstick (SDPA, and for
   the backward `torch.autograd.grad` through SDPA).  Forward kernels run
   at the serving path's shapes and (flash) the training shape; the two
   backward kernels at the training shape (B=8 S=1024 H=12 D=64, q, k, v
   slices of one fused [B, S, 3, H, D] tensor), a ragged S=200 and S=512
   H=16 D=128; in bfloat16 also the forward, dQ and dK/dV at GPT-3 1.3B's
   training shape (phase 9c: B=2 S=2048 H=16 D=128).  Tolerances
   (`paddle_tpu_torch.ops.tolerance` derives the bf16 ones):
   - forward, float32: max absolute error 2e-5 — both sides accumulate in
     fp32 and differ only in summation order (the kernel's products are
     split TF32, as accurate as fp32 products: `flash_tc.cuh`).  bfloat16, per element
     |out - ref| <= 2^-7 max(|out|, |ref|) + c (P |V|): one bf16 step
     of the output (both sides round it once), plus the most that the
     rounding of the probabilities to bf16 (at most 2^-8 of each, the
     bf16 unit roundoff) can move the value product, P |V| being that
     product over |V| in fp32: c = 2^-8 for the ragged kernels (only the
     plain version rounds p), 2^-7 for the flash forward (its
     tensor-core kernel rounds p at the running max of each key tile, as
     the TPU kernel does, and the plain version at the final max).  So
     the limit follows each output's own magnitude: at rows of hundreds
     of keys it is ~3e-3, not the ~2e-2 a short row needs.  Pool writes
     must be bitwise equal.  Each flash case (dQ and dK/dV apart) also
     prints its achieved TFLOP/s (the FLOPs its bound counts over its
     time); a float32 one its bound with the products as three TF32
     passes on the tensor cores (165 TFLOP/s) and, beside it, with the
     CUDA cores' 67 TFLOP/s.
   - backward, float32: max |err| <= 1e-4 max |ref| per gradient — both
     sides accumulate in fp32 over up to 1024 keys or queries, in
     different orders (the kernels' products split TF32).  bfloat16, per
     element |out - ref| <= 2^-7 max(|out|, |ref|) + 2^-7 mag: one bf16
     step of the output, plus the
     rounding of p (for dV) and ds (for dK, dQ) to bf16, which both sides
     make at the same points but from fp32 values that differ in their
     last bits, so a value at a rounding boundary may round apart by up
     to 2^-8 of it on each side; mag is the gradient's sum over
     magnitudes in fp32 (P^T |dO|, scale W^T |Q|, scale W |K|), with
     W = P (|dO|.|V|^T + |dO|.|out|) bounding ds = P (dP - delta) also
     where the difference cancels to fp32 noise (a query's first key).
   - the generate kernels, at GPT-2 124M's decode shapes (B=8, H=12, D=64,
     S_max=1024), each with its length or t in device memory as a
     captured decode step passes it (and bitwise the int form's output):
     flash decode at lengths 1, 2, 128, 129, 130, 255, 257, 512 and 1024
     (t = 1, 127-129, 511 and 1023 among them; and H=16 D=128), with its
     split count and achieved GB/s (the bytes its bound counts over its
     time), yardstick SDPA over the prefix; the fused decode layer at
     t = 1, 127, 128, 129 (the edges of its runs of 32 keys), 511 and 1023
     without and with a row mask, and at H=16 D=128 t=1023 (no
     yardstick), whose other ring rows must stay bitwise unchanged; LayerNorm at 8 and 8192 rows of 768 and of 1002 (rows that
     do not fall into 16-byte chunks), yardstick `F.layer_norm`, with its
     GB/s; FFN at 8, 256, 512, 1024 and 8192 rows, H=768 I=3072 gelu_tanh,
     gelu and relu at 8 and 512 rows, and at 1024 rows with I=3008 (a width
     off 128), each on the design `ffn_design` picks (bf16 below 24 rows
     and fp32 up to `FFN_DECODE_MAX_ROWS`: the decode design; bf16 from 24
     rows: the tensor cores; fp32 above: the tensor cores in split TF32;
     widths off 128: the CUDA cores), both launches counted under it alone,
     a second launch bitwise the first, with its TFLOP/s and GB/s, its
     bound (fp32: split TF32, the CUDA cores' beside it) and the cuBLAS
     composite addmm + activation + mm beside it (three calls, not one: no
     yardstick). float32: 2e-5 absolute (FFN 1e-5 max|ref|; LN statistics
     1e-5 relative). bfloat16: one bf16 step of each output plus what each
     side rounds, weighted by what it multiplies (the `tolerance` module
     docstring).
   - the LayerNorm backward at the training shape, 8192 rows of 768, in
     fp32, bf16 and bf16 x with fp32 w and b, and in bf16 at 8 and 200
     rows; yardstick `torch.autograd.grad` through `F.layer_norm`.  dx,
     dw and db within 1e-5 of each output's sum over term magnitudes,
     plus one bf16 step for a bf16 output; two launches bitwise equal.
   - the masked flash forward at the padded prefill's shape, B=8 H=12
     D=64 S=896: the stride-0 [B, 1, S, S] view of a left-pad row (pads
     0-300), an additive [B, H, S, S], an additive [1, 1, S, S], and
     kv_lens S .. S-259; yardstick SDPA with the same mask plus causal.
     Every row is compared, left-pad rows (all keys masked) included.
   - the variants of the three flash kernels, each against its plain
     version with the limits above, every row: segment ids on the packed
     training batch's own ids (phase 6b's, B=8 S=1024 H=12 D=64; its
     allowed-pair fraction printed), forward, dQ and dK/dV; the
     non-causal forward at B=1 S=384 and B=8 S=1024; the backward with
     the pad mask (pad rows whose every key is masked too: the masked
     statistic is the (row max, log l) pair), with kv_lens and
     non-causal at the padded shape B=8 S=896.  Yardstick SDPA with the
     call's mask (bool, or additive with a mask; SDPA has no segment
     argument) and `torch.autograd.grad` through it.  Each bound counts
     only the pairs the call allows (causal, same segment, kv_len) and
     the mask entries those pairs touch.
   - the int8 ragged kernel at the engine's decode step and at a C=512
     chunk from position 188 (33 blocks written), on int8 pools whose
     scales the writes grow: codes and scales bitwise equal to the plain
     version's, out within the forward limit (no yardstick).  Each timed
     call (kernel and plain version) starts from the pools and scales
     before the write, restored outside the timed region, so it grows
     the same scales and rescales the same codes.  Both ragged kernels
     also at the split-K attend's edges (rows of 127, 128 and 129 keys,
     one at the table's full width of 1024, a padding row, a 1-key row)
     and at the decode step with H=16 D=128, and at speculative decoding's
     verify shape (8, 5): rows of 1-5 queries (0-4 drafts; query
     positions past a row's drafts and a padding row on the dropped
     slot; the int8 scales grow); each ragged case times its
     write and its attend launch alone too, and prints the attend's
     splits per (row, query, head).
3. Engine: GPT-2 124M (full width, 12 layers, random weights from seed 0)
   served by `LLMEngine` with block_size 16, max_num_seqs 8,
   max_num_batched_tokens 512: five greedy prompts of 7, 64, 200, 384 and
   700 tokens, 32 new tokens each (the 700-token prompt runs as a (1, 512)
   then a (1, 188) ragged chunk).  The decode steps run as one captured
   CUDA graph (``("ragged", 8, 1)``; prefill and chunk steps eager).  The
   float32 run on the card must give exactly the tokens of the same
   engine on the CPU (plain versions), each kernel's launch count over
   the run (replays counted) must equal its expected count, and the run
   must capture exactly one graph.  A bfloat16 run, captured and again
   eager (``PTPU_CUDA_GRAPHS=0``), must give identical tokens, each its
   expected launches, one capture and none; it reports its agreement
   with float32 and its prefill and decode tokens per second; 8 bfloat16
   decode steps (after the step's warm-up and capture), timed alone and
   then under torch.profiler, eager and captured in turns (eager,
   captured, captured, eager), give wall and device ms a step, the
   device's busy share and the top kernels.  Then the same with
   ``kv_cache_dtype="int8"``: fp32 card tokens equal to the CPU int8
   run's, the int8 kernel launched 12 x (decode + chunk steps) and the fp
   one never; bf16 captured against eager, its token agreement with the
   bf16 fp engine, num_blocks at equal pool bytes, tokens/s and the
   profiled decode windows in turns.
4. Generate: GPT-2 124M, weights from seed 0, greedy, each decode step
   one captured CUDA graph, in six paths (`GEN_PATHS`): the stacked
   layout in the default mode (flash decode per step) and the fused mode
   (PTPU_FUSED_DECODE=1 PTPU_PALLAS_FFN=1: fused layer, LN and FFN -- its
   decode design -- per step), each with prompts of one length and
   padded (`pad_token_id`; row r holds P - r (P // 8) tokens, even rows
   right-, odd rows left-padded: the masked forward launched 12 times
   per generate, the decode kernel never -- the masked branch, as in JAX
   -- the fused kernels 12 x steps), and the per-layer layout (the JAX
   default) without flags and under PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1
   (25 LN and 12 FFN launches a forward besides 12 decode kernels a
   step).  float32, B=8, prompt 256, 32 new tokens: the card's tokens
   must equal the CPU run's on every path, each kernel's launches
   (replays counted) the expected count, each path one capture, padded
   buffers left-aligned; the fused-vs-default agreement is reported, not
   checked (the arithmetic differs).  bfloat16, B=8, prompt 896, 128 new
   tokens (S_max = 1024), eager and captured in turns (eager, captured,
   captured, eager): identical tokens, launches as expected in every
   turn, one capture a path (its host ms), decode tokens/s and ms per
   step (the time of a prefill-only generate taken off), and 8 decode
   steps as `generate` runs them (after the warm-up and capture) timed
   alone and under torch.profiler, eager and captured: wall and device
   ms a step and busy share.
5. Training, float32, card against CPU: GPT-2 124M at full width and
   depth, weights from seed 0, one fixed random batch of B=1 S=1024,
   3 AdamW steps (lr 1e-4) through `model(ids)` ->
   `GPTPretrainingCriterion` -> `backward` -> `AdamW.step`, on the card
   (kernels) and on the CPU (plain versions).  Step-1 losses agree to
   1e-5 relative, each step-1 gradient to 1e-3 max |g|, step-3 losses to
   1e-4 relative; each flash kernel (forward, dQ, dK/dV) launches 12
   times per step on the card (fp32: all three on the tensor cores,
   split TF32, counted once more under ``:tc32``).
6. Training, bfloat16, full size: B=8 S=1024, bf16 params with fp32
   AdamW masters (lr 1e-4), 2 warm-up steps then 10 timed steps on one
   repeated batch.  Every loss finite, step 12's below step 1's, 12
   launches of each flash kernel per step, all three on the tensor cores
   (12 each per step); prints tokens/s and ms per
   step, then profiles one step with torch.profiler (device ms, busy
   share, top kernels).
6b. Packed training (stacked): documents of 16-1024 tokens
   (``default_rng(0)``, tokens uniform in [3, vocab)) packed into
   1024-token rows by a copy of the example's ``pack_documents``, the
   example's loss mask, ``pretrain_loss(ids, labels, mask, segment_ids,
   position_ids)``: 3 fp32 steps at B=1 on the card against the CPU (the
   limits of phase 5; 12 launches of each segment-variant flash kernel
   per step, none on the CPU), then 12 bf16 steps at B=8 as phase 6,
   with tokens/s over all positions and over loss-mask positions, beside
   the unpacked step.
6c. Entry-point autograd, fp32: gradients of q, k and v through
   `flash_attention_arrays` for a non-causal, a pad-masked and a
   kv_lens call at B=8 S=896 H=12 D=64 on the card against the CPU,
   within 1e-4 max|ref|; the card launches the non-causal forward, dQ
   and dK/dV once each and the mask ones twice each.  Then the gradients
   of x, w1, b1 and w2 through `fused_ffn_arrays` at 1024 rows, H=768,
   I=3008 (a width off 128: the CUDA-core FFN, which no GPT-2 path
   reaches) against the CPU, within 1e-4 max|ref|, one launch.
   Phases 3-6c run the stacked-blocks layout (``stacked_blocks=True``).
7. Training of the per-layer layout (the JAX default) under
   PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1: first one fp32 step of the stacked
   model under PTPU_PALLAS_LN=1, whose ``ln_f`` launches the LayerNorm
   forward and backward once each; then GPT-2 124M per-layer, fp32 card
   against CPU as phase 5 (same limits), with 12 launches of each flash
   kernel, 25 of the LayerNorm forward and backward and 12 of the FFN per
   step (fp32 at 1024 rows: the split-TF32 design) and none on the CPU;
   then bf16 as phase 6 with the flags (the FFN's 144 launches all on
   the tensor cores) and without them.
9. The training recipe (run after phase 7, before the summary's lines):
   configuration A's optimizer, GPT-3's (Brown et al. 2020, App. B):
   AdamW(beta2=0.95, weight_decay=0.1 but for biases and LayerNorms,
   ClipGradByGlobalNorm(1.0)) under LinearWarmup(CosineAnnealingDecay(lr,
   steps - 2, eta_min=lr / 10), 2, 0, lr) (`make_step`).
   9a. fp32, card against CPU, GPT-2 124M at B=1 S=1024, 3 steps, dropout
   0, stacked and per-layer (the latter under the LN and FFN flags):
   phase 5's limits and launches.  Then the stacked model with
   ``recompute`` against without, on the card: losses and step-1
   gradients (expected bitwise; the max differences printed, phase 5's
   limits checked), the flash forward 24 launches a step under
   recompute, dQ and dK/dV 12.
   9b. Configuration A: per-layer GPT-2 124M, fp32 weights under
   ``auto_cast(level="O1", dtype="bfloat16")`` with
   ``GradScaler(init_loss_scaling=2**15)``, dropout 0.1 at every site
   (GPT-2's), the recipe at lr 6e-4, both flags, B=8 S=1024, 2 warm-up and
   10 timed steps as phase 6: losses finite and falling, the scale and
   skipped steps, launches (the flash kernels on ``:tc``, the FFN on its
   bf16 tensor-core design, the LayerNorm kernels fp32), ms per step,
   tokens/s, peak memory and the profiled step.  One more forward at B=2
   records each dropout site's keep mask: kept fraction within 5 sigma of
   0.9; the eval-mode logits bitwise those of p = 0.
   9c. Configuration B: GPT-3 1.3B stacked (H=2048, 24 layers, 16 heads,
   D=128, I=8192, full depth), bf16 weights and AdamW moments
   (``multi_precision=False``), the recipe at lr 2e-4, B=2 S=2048
   (`bench.py:258-273`), ``ln_f`` under PTPU_PALLAS_LN: 2 warm-up and 5
   timed steps without, then with ``recompute`` from the same weights:
   finite losses, step-1 losses equal, launches (the flash forward 48 a
   step under recompute, 24 without), ms per step, tokens/s and peak
   memory of each.
10. The high-level API (run after phase 9, before the summary's lines):
   `paddle_tpu_torch.Model` over the per-layer GPT-2 124M (12 layers,
   768, vocab 50257, weights from seed 0) under PTPU_PALLAS_LN=1
   PTPU_PALLAS_FFN=1, ``prepare(AdamW(lr 1e-4), GPTPretrainingCriterion())``
   (`fit_phase`).  fp32: ``fit`` of 2 batches at B=2 S=256 on the card
   and on the CPU from the same weights and batches, losses within phase
   5's limits; each card step launches one training step's kernels
   (flash forward, dQ and dK/dV 12 each on ``:tc32``, LN 25 and 25, the
   FFN 12 on the design of 512 fp32 rows), the CPU none.  bf16 (fp32
   masters), B=8 S=1024, phase 6's batch as 12 rows of a
   ``TensorDataset`` a batch: turns of the bare step (`make_step`) and
   of ``fit`` (bare, fit, fit, bare; ms per step after 2 steps, from the
   steps' end times), the first fit with 2 eval batches,
   ``ModelCheckpoint`` and PTPU_MONITOR=1: losses finite and falling,
   each step's launches one bf16 training step's (``:tc``, the FFN's
   tensor-core design), the eval's two forwards', the checkpoint files,
   ``train/goodput_examples_per_s`` and ``train/data_wait_frac``; then
   ``save`` -> a new ``Model`` -> ``load`` -> ``predict`` (2 rows of 128
   tokens) bitwise equal to ``predict`` before the save.  Then steps of
   the bare model with PTPU_TRAIN_STATS=1 sampling every second step
   (sampled against unsampled ms, each step synced alone), and the host
   µs of one step's telemetry hooks with the gates off and on.
11. Serving completeness (run after phase 10, before the summary's
   lines): GPT-2 124M stacked, weights from seed 0, `LLMEngine` with
   block 16 and 8 sequences (`serving_phase`).  float32: seeded sampling
   (T 0.8, top-k 50, top-p 0.95, seeds 7-10; prompts of 7, 64, 200 and
   384 tokens, 32 new), the card's tokens equal to the CPU engine's and
   each row to the card's solo dense ``generate(seed=7+i)`` (the
   threefry streams of `core.random`); prefix caching (8 requests, a
   256-token shared prefix and tails of 8-72, 16 new, greedy) with the
   tokens of caching off, 7 hits of 256 tokens and the parked blocks
   printed, one ``ragged`` capture; speculative decoding at k = 4 (8
   greedy prompts of distinct tokens, 64 new) equal to spec off on fp
   pools and agreeing on at least 0.9 of the tokens on int8 pools (JAX's
   tolerance), accept rate printed, one ``ragged`` and one ``verify``
   capture each (a seeded request after them, which never drafts, runs
   the plain step); fork (a 200-token prompt, three seeded children after
   its first token) with the parent's tokens equal to an unforked run and
   the peak blocks below four unshared copies; export after 8 tokens and
   adopt in another engine, greedy and seeded, equal to a run that never
   migrated.  bfloat16, in turns: prefix caching off, on, on, off (16
   requests, a 512-token shared prefix, tails 16-64, 32 new): wall,
   prefill ms and prompt tokens computed, first-token ms per request;
   speculative decoding plain, k = 4, k = 4, plain (8 greedy prompts, 128
   new): wall ms per emitted token, tokens a step, accept rate, and the
   device ms of a captured verify step (8, 5) and plain step (8, 1) (CUDA
   events around 20 graph replays); the sampler's host ms over eight
   seeded rows (threefry over 8 x 50304 values) against eight greedy
   rows.  Each turn's tokens equal the other turn of its kind.
12. float16 (run after phase 11, before the summary's lines).  12a:
   every fp16 kernel against its fp16 plain version at the
   fp16 limits of `ops/tolerance.py` (`fp16_kernel_cases`): the flash
   forward at S=384, the training shape and H=16 D=128, dQ and dK/dV at
   the training shape, the masked forward (pad, kv_lens) at B=8 S=896,
   the segment and non-causal variants forward and backward at B=8
   S=1024 / 896, the ragged kernel at the decode step, the verify step
   (8, 5) and a chunk of 512 on fp16 pools and at the decode step and
   C=512 on int8 pools with fp16 q, flash decode at full context (H=12
   D=64, H=16 D=128), the LayerNorm forward at 8192 and 8 rows (fp16 x
   and w; fp16 x, fp32 w), its backward at 8192 (both) and 200 rows, the
   FFN at 8 rows (decode design), 2048 and 8192 (tensor cores) and
   I=3008 (CUDA cores); times, bounds and SDPA / ``F.layer_norm`` times
   as phase 2.  12b:
   GPT-2 124M stacked, weights from seed 0, cast to fp16 by
   ``amp.decorate(level="O2", dtype="float16")``, served by `LLMEngine`
   (block 16, 8 sequences) on fp16 and on int8 pools: five greedy
   prompts (`PROMPT_LENS`) and two seeded ones (100, 300 tokens; T 0.8,
   top-k 50, top-p 0.95), 32 new, eager and captured: identical tokens,
   the launches (the flash prefill on ``:tc16``, the ragged kernel on
   ``:fp16`` / ``:int8:fp16``, nothing else), one ``ragged`` capture, and
   each greedy token teacher-forced under the same weights in fp32 on
   the card within `NEAR_ARGMAX` of its top logit (2^-10 on fp16 pools,
   3 * 2^-7 on int8 pools); then three short requests (7, 24 greedy, 16
   seeded, 8 new) on the card and on the CPU engine (plain versions; the
   host's fp16 GEMMs are far slower than fp32), held as the fp32 phases
   hold card against CPU: each row identical, except at most one greedy
   row that parts at a near-tie (both tokens within `NEAR_ARGMAX` of the
   fp32 model's top logit there; `cpu_differences`).  12c: default-mode
   ``generate`` of the same fp16 model, B=8 256 + 32 greedy, eager and
   captured (identical tokens, one capture, 12 fp16 flash decode launches
   a step), teacher-forced as 12b; then once more under PTPU_PALLAS_LN=1
   (a second capture; ``ln_f`` on the fp16 LayerNorm, one launch a
   forward), teacher-forced too.  12d: configuration A's recipe (phase
   9b) under ``auto_cast(level="O1", dtype="float16")`` over fp32
   weights and under O2 after ``decorate(dtype="float16")``, each with
   ``GradScaler(init_loss_scaling=2**15)``, without and then with the LN
   and FFN flags, B=8 S=1024, 2 warm-up and 6 timed steps: losses finite
   and falling, the scale and skipped steps (with the flags: the scale
   stays, no step skipped), launches (``:tc16``; with the flags the LN
   kernels in fp32, the black list, and the FFN's tensor cores in fp16
   under O1 only: under O2 its gate refuses the fp32 LN output beside
   fp16 weights, as JAX's does), ms per step and the profiled step.
   12e: ``generate`` of the O2-cast per-layer model under both flags,
   B=8 256 + 32, eager and captured (identical tokens, one capture): the
   fp16 LayerNorm (25 a forward), the FFN's tensor cores at the
   prefill's 2048 rows and decode design at 8 (12 a step), teacher-forced
   under the per-layer fp32 model within ``NEAR_ARGMAX["fp16"]``.  12f:
   pure fp16 (`pure_fp16`): the ``.to(float16)`` per-layer model stepped
   without ``auto_cast`` (AdamW, a static GradScaler of 2^10), 4 steps
   at B=8 S=1024, without the flags and under both (the fp16 LayerNorm
   forward and backward, 25 each a step, and the FFN's tensor cores):
   losses finite, no step skipped, step 1's loss and gradients under the
   flags within the stated fp16 limits of the step without them.  12g:
   the FFN's CUDA-core design in fp16 through ``fused_ffn_arrays`` at
   I=3008 (`ffn_entry_fp16`).
13. head_dim 256 (run after phase 12, before the summary's lines).
   13a: the forward attention kernels at D = 256, H = 8, against their
   plain versions at the limits of `ops/tolerance.py` (fp32 ``FP32_FWD``,
   2e-5, derived there for D = 256), timed as phase 2 with their bounds
   and SDPA where one call computes the function (`head256_kernel_cases`):
   the flash forward (bf16 and fp16 on the tensor cores, key tiles of 32;
   fp32 on the CUDA cores, `FWD_SIMT`) causal at the prefill B=1 S=2048
   and at B=8 S=1024, with the pad mask and kv_lens at B=8 S=896, the
   packed batch's segment ids and non-causal at B=8 S=1024; the ragged
   kernel at the decode step on fp32, bf16 and fp16 pools and on int8
   pools (growing scales) with q of each type, and a chunk of C=512 (bf16,
   both pool kinds); flash decode at S_max 2048 (full context in the three
   types; 1152 keys in bf16); the fused decode layer at t = 1023, hidden
   2048 (fp32; bf16 without and with a row mask); the flash dQ and dK/dV
   (`head256_bwd_cases`; fp32 1e-4 max|ref|, on the CUDA cores,
   `DQ_SIMT`, `DKV_SIMT`) causal at recipe B's B=2 S=2048 in the three
   types and at B=8 S=1024 in bf16 in every branch (causal, pad mask,
   kv_lens, the packed batch's ids, non-causal), SDPA's whole backward
   the library call.  13b: a GPT of GPT-3
   1.3B's widths with 8 heads of 256 (``gpt3_1p3b_config(
   num_attention_heads=8)``, stacked), 2 layers, fp32, on the card and on
   the CPU: the engine on fp and int8 pools (phase 3's prompts) and
   ``generate`` B=8 256 + 32 in the default and fused modes, captured:
   tokens identical, launches as expected (every D = 256 counter), one
   capture each; and fp32 training of 2 layers of two heads of 256
   (hidden 512), stacked and per-layer, 3 AdamW steps at B=1 S=1024,
   losses within 1e-5 of the CPU's, the backward on its CUDA-core
   kernels.  13c: the same widths at a third of the depth (`H256_LAYERS`,
   8 of 24, so that the run with phase 19 stays near 1000 s) in bf16,
   8 heads of 256 and the preset's 16 of 128 (the same FLOPs) in turns
   (256, 128, 128, 256): the engine (five greedy prompts of 7-1500
   tokens, 32 new) on fp and int8 pools and ``generate`` B=8 1024 + 128 in
   the default and fused modes, all decode steps captured: ms a decode
   step, tokens/s, captures, the launches (every D = 256 variant on its
   path), each cell's tokens the same in every turn of its geometry, and
   a profiled window per cell and geometry (device ms, busy share).  13d:
   recipe B (GPT-3 1.3B stacked, bf16, B=2 S=2048, ``ln_f`` under
   PTPU_PALLAS_LN; `H256_LAYERS` deep) at 8 heads of 256 in turns with the
   preset's 16 of 128 (`head256_train`): losses finite, ms a step,
   tokens/s, peak memory, the launches (at 256 the forward, dQ and dK/dV
   one a layer and step each on `:d256`).
14. HTTP serving (`http_phase`): bf16 GPT-2 124M behind ``ApiServer``,
   19 requests at once (16 streamed of 7-700 tokens, 2 chats, 1 seeded;
   32 new) in turns api, direct, direct, api: tokens equal to
   ``engine.generate``'s, ``/metrics`` counters equal to the client's,
   scrapes during the first capture, TTFT / TPOT p50 / p95, the decode
   step's wall ms with the telemetry gates off and on.
15. Weight-only low-bit generate (`lowbit_phase`): bf16 per-layer GPT-2
   124M captures its decode step, then `quantize_for_inference` copies it
   at int8 and at int4 (per channel): 48 linears swapped, the linears'
   dense and packed bytes, the bytes each copy asked of the caching
   allocator within 1 MiB of its tensors' bytes (its blocks' bytes
   printed), no captured step carried over; ``generate`` B=8 896
   + 128 captured in turns fp, int8, int4, int4, int8, fp (ms a decode
   step, launches as expected, each model's tokens the same in both its
   turns, one capture each), a profiled window each (device ms by group),
   greedy agreement with fp (printed: random weights); under both kernel
   flags the int8 copy launches no FFN and 25 LayerNorms a forward, the
   fp model the FFN; the original still generates its tokens; a 2-layer
   fp32 model at GPT-2's widths quantized on the card and on the CPU:
   codes and scales bitwise, tokens identical.
16. Mixture of experts (`moe_phase`): a 2-layer fp32 MoE GPT at GPT-2's
   widths (block 1 with 8 experts) on the card and on the CPU, 2 AdamW
   steps at B=1 S=1024 (losses within 1e-5 relative, step-1 gradients
   within 1e-3 max|g|), greedy tokens identical; then
   ``gpt2_124m_config(moe_every_n=2, moe_num_experts=8)`` (six MoE blocks,
   top-2, capacity factor 1.25) in bf16 with fp32 masters, AdamW at B=8
   S=1024, routing telemetry on then off: losses finite and falling,
   every ``aux_loss`` finite, ms a step, peak GB, a profiled step, the
   flash forward, dQ and dK/dV 12 a step each; an eager forward's
   ``moe/*`` series consistent (48 observations, kept + dropped = the
   slots); ``generate`` B=8 128 + 32 eager and captured, tokens identical,
   no routing recorded inside it.
17. BERT fine-tuning (`bert_kernel_cases`, `bert_phase`): 17a the
   non-causal flash forward, dQ and dK/dV at BERT-base's shapes (H=12
   D=64; B=32 S=128 and B=8 S=512) without a mask and with BERT's
   [B, 1, 1, S] padding mask (seeded lengths 16-S, read as a stride-0
   view over the queries), fp32 and bf16, against their plain versions
   with phase 2's limits, timed beside SDPA given the same mask, with
   their bounds, and the dropout kernel (`ops.threefry`: JAX's threefry
   keep mask, no Pallas counterpart) at BERT-base's dropout shapes,
   bitwise against its plain version, timed with its bound (no PyTorch
   call draws JAX's bits; `torch.rand` < keep printed beside it as a
   yardstick); 17b a 2-layer fp32 BERT at BERT-base's widths, B=2
   S=128, dropout 0.1 (on the key stack: the same masks on both devices)
   and the padding mask, 3 AdamW steps on the card and on the CPU: losses
   within 1e-5 relative, step-1 gradients within 1e-3 max|g|; 17c
   BERT-base (12 layers, random weights from seed 0) fine-tuned in bf16
   with fp32 masters at B=32 S=128 (`bench.py:276-313`: AdamW lr 2e-5,
   cross entropy over 2 classes), turns the bench's form (dropout 0, no
   mask), dropout 0.1 with the padding mask, and that under
   ``PTPU_PALLAS_LN=1``: 2 + 10 steps each, ms a step, tokens/s, a
   profiled step's device ms by group and busy share, peak GB, and the
   launches a step checked (flash forward, dQ, dK/dV 12 each, under
   ``:noncausal`` or ``:mask``; LayerNorm forward and backward 25 each
   under the flag; the dropout kernel 50 a step with dropout: the
   embeddings, four sites a layer and the pooled output).
18. The conv path (`conv_phase`; no kernel of the port's own: cuDNN's
   convolutions, torch's pools and BatchNorm's composite, as JAX runs
   them outside Pallas): 18a under torch's default cuDNN flags (TF32
   allowed), fp32 ResNet-18 (10 classes, B=4, 64 x 64) and the ResNeXt
   bottleneck (32 groups of 4, stride 2, [4, 256, 16, 16]) in NCHW and
   NHWC, two Momentum(0.01, 0.9) steps on the card and on the CPU: step-1
   losses within 1e-5 relative, later ones 1e-3, step-1 gradients within
   5e-3 of their norm (a ReLU input within rounding of 0 may take the
   other branch on one device), running statistics after step 1 within
   1e-5 and after step 2 within 1e-3; 18b `bench.py:316-365`'s ResNet-50
   (1000 classes, random weights from seed 0) in bf16 with fp32 masters,
   bf16 images 224 x 224, B=64, Momentum(0.1, 0.9), turns NCHW, NHWC,
   NHWC, NCHW of 2 + 10 steps: ms a step, images/s, model TFLOP/s
   (bench.py's 3 x 4.1 G an image) against the bf16 peak, peak GB, a
   profiled step's device ms by group (conv, BN and elementwise, layout
   transforms, other), busy share, device ops and layout-transform
   kernels, the port's launches (none) checked, ``cudnn.benchmark`` left
   at torch's default; 18c LeNet through ``Model.fit`` on the synthetic
   ``MNIST(size=256)``, two epochs of 4 batches, the loss falling.
19. head_dim 384, 512, ... (run after phase 18, before the summary's
   lines): 19a the flash forward, dQ and dK/dV at D = 384, 512 and 1024
   (bf16 and fp16 forward and dK/dV on the tensor cores,
   ``csrc/flash_wide_tc.cu``: a cluster of D / 128 blocks, each owning
   128 columns, the scores' parts summed across it; fp32, and dQ in every
   type, on the CUDA cores, ``csrc/flash_wide_fwd.cu``,
   ``csrc/flash_wide_bwd.cu``: D a runtime argument, a grid axis of D /
   128 output slices; each case's tensor-core counters checked) against
   their plain versions at the limits of
   `ops/tolerance.py` (fp32 ``FP32_FWD`` forward, derived there for
   D = 512 and 1024, 1e-4 max|ref| backward), timed beside SDPA with their
   bounds (`head512_kernel_cases`): causal at recipe B's B=2 S=2048 H=4
   D=512 in bf16, fp16 and fp32, every other branch (pad mask, kv_lens,
   the packed batch's ids, non-causal) in bf16 at B=2 S=1024, D = 384 in
   the three types and its masked branches in fp32 and fp16, D = 1024
   causal in bf16, segments in fp16 and non-causal in fp32 (the SASS
   check: HGMMA in all 16 instantiations of each tensor-core kernel,
   FFMA and no HGMMA in the CUDA-core ones, whose 16-bit instantiations
   serve D past 1024); 19b a GPT of
   hidden 1024 with two heads of 512 (GPT-3 1.3B's vocab and positions,
   stacked), 2 layers, fp32, on the card and on the CPU: the engine on fp
   and int8 pools (phase 3's prompts) and ``generate`` B=8 256 + 32 in the
   default and fused modes, captured: tokens identical, the prefill on
   the wide forward, every decode step on the plain attention by the
   decode gates (counted under JAX's names), one capture each; fp32
   training of the same widths, stacked and per-layer, 3 AdamW steps at
   B=1 S=512 (losses within 1e-5 of the CPU's); 19c GPT-3 1.3B's widths
   at full depth with 4 heads of 512 in bf16: the engine (five greedy
   prompts of 7-1500 tokens, 32 new) on fp and int8 pools and
   ``generate`` B=8 1024 + 128 in the default and fused modes, decode
   steps captured: ms a decode step, tokens/s, the gates' counts, the
   launches (the prefill on the tensor-core forward); 19d recipe B at 4
   heads of 512 (B=2 S=2048, 2 + 5 steps): losses finite, ms a step,
   tokens/s, peak memory, the wide forward, dQ and dK/dV 24 a step each,
   the forward and dK/dV on the tensor cores.
8. Summary: one JSON line of fifty-five entries: thirty-nine (the nine kernels,
   the int8 variant, the mask, segment and non-causal variants of the
   flash kernels, the tensor-core forward, dQ and dK/dV -- every bf16
   launch of those three, timed at the bf16 training shape -- the fp32
   split-TF32 forward, dQ and dK/dV -- every fp32 launch of those three,
   timed at the fp32 training shape, launches from phase 5 -- and the
   FFN's bf16 and fp32 tensor-core designs and decode design, counted
   apart; the FFN's own entry is its CUDA-core design, timed at I=3008,
   launches from phase 6c; the fp16 launches of the flash forward, dQ
   and dK/dV (timed at the fp16 training shape, launches from phase
   12d's O1 run), of the ragged kernel on fp16 and on int8 pools (the
   decode step, launches from phase 12b) and of flash decode (full
   context, launches from phase 12c); the fp16 launches of the
   LayerNorm forward and backward (timed at 8192 rows, launches from
   12f's run under the flags) and of the FFN's tensor cores (8192 rows,
   launches from 12d's O1 run with the flags), decode design (8 rows,
   launches from 12e) and CUDA cores (I=3008, launches from 12g); each
   entry also carries its launches in phase 7's per-layer bf16 run, in
   phase 10's bf16 fit, in phase 11 and in phase 12); and the six D = 256
   entries: the flash forward's (timed at the bf16 prefill B=1 S=2048,
   launches from 13c's fp engine), its fp32 CUDA-core kernel's (fp32
   prefill; 13b's fp32 engine), the ragged kernel's on fp and int8 pools
   (the bf16 decode step; 13c's engines), flash decode's (bf16 full
   context; 13c's default generate) and the fused layer's (bf16 t = 1023;
   13c's fused generate); and the four backward D = 256 entries: dQ's
   and dK/dV's (timed at recipe B's bf16 B=2 S=2048, launches from 13d's
   first 8 x 256 turn) and their fp32 CUDA-core kernels' (fp32 at the
   same shape, launches from 13b's stacked fp32 training), each D = 256
   entry with its launches in phase 13 as a whole (and every entry its
   launches in phases 14 to 18); and the dropout kernel's
   (`threefry_bernoulli`, timed at BERT-base's FFN dropout [32, 128,
   3072], launches from 17c's dropout turn; it replaces no Pallas kernel:
   its "replaces" names the JAX draw XLA fuses); and the five entries at
   head_dim 384, 512, ... (all at recipe B's B=2 S=2048 H=4 D=512): the
   tensor-core forward and dK/dV (`FWD_WIDE_TC`, `DKV_WIDE_TC`: bf16,
   launches from 19c's fp engine and 19d), the CUDA-core dQ (`DQ_WIDE`:
   bf16, launches from 19d) and the CUDA-core forward and dK/dV
   (`FWD_WIDE`, `DKV_WIDE`: fp32, launches from 19b's fp32 engine and
   stacked training), each entry with its launches in phase 19 as a
   whole; it fails if an entry's main path launched it no time; the card
   line, then the result line.

Every time is a median of CUDA-event timings (L2 flushed before each
launch, the host's enqueue hidden behind a spin on the stream); every
bound is max(bytes / 3.35 TB/s, FLOPs / peak for the type: 989 TFLOP/s
bf16 and fp16, 67 TFLOP/s fp32; fp32 flash and FFN 495 / 3 TFLOP/s,
split TF32),
from this run's shapes and data.
Details go to chiprun_out/chip_smoke.json.

Two measuring modes, not part of the check:

    python3 chip_smoke.py --probe [--quick] [--parent DIR]
    python3 chip_smoke.py --paths DIR [--train]

``--probe`` checks and times the FFN's designs and the LayerNorm forward
at GPT-2 124M's MLP, and the alternatives they were measured against,
built from edited copies of their sources (`probe`).  ``--paths`` checks
and times the ragged, fused-layer and flash decode kernels (their int
lengths, which a tree from before takes too) and the LayerNorm backward
at the kernel phase's shapes (with a digest of the decode kernel's
outputs), times
fused-mode bf16 ``generate`` and the bf16 engine's decode steps (fp and
int8 pools), host and device, and with ``--train`` the stacked bf16 and
fp32 training steps and the per-layer fp32 step under the LN and FFN
flags, all with the ``paddle_tpu_torch`` of DIR (`time_paths`): run it on
two trees in turns in one call to compare them.
"""
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BPS = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
# TF32 on the tensor cores: a split-TF32 fp32 product is three TF32 ones
PEAK_TF32, TF32_PASSES = 495e12, 3
TOL_FP32 = 2e-5
BWD_REL_FP32 = 1e-4
FFN_REL_FP32 = 1e-5
# an intermediate width that is no multiple of 128 (but of 64): the widths
# only the FFN's CUDA-core design takes
FFN_ODD_INTER = 3008
FWD, DQ, DKV, RAGGED = ("flash_fwd_causal", "flash_bwd_dq_causal",
                        "flash_bwd_dkv_causal", "ragged_paged_attention")
DECODE, FUSED, LN, LN_BWD, FFN = ("flash_decode", "fused_decode_layer",
                                  "fused_layernorm", "fused_layernorm_bwd",
                                  "fused_ffn")
# the FFN's four designs, each counted apart: FFN the CUDA-core kernel
# (widths off multiples of 128), FFN_TC bf16 on the tensor cores, FFN_TC32
# fp32 on the tensor cores (split TF32), FFN_DEC few rows
FFN_TC, FFN_TC32, FFN_DEC = ("fused_ffn_tc", "fused_ffn_tc32",
                             "fused_ffn_decode")
FFN_COUNTER = {"cuda_core": FFN, "tc": FFN_TC, "tc32": FFN_TC32,
               "decode": FFN_DEC}
FWD_MASK, RAGGED8 = "flash_fwd_causal:mask", "ragged_paged_attention:int8"
# the variants of the flash kernels (segment ids, non-causal, and the
# backward's mask / kv_lens), each counted apart
FWD_SEGS, FWD_NC = FWD + ":segs", FWD + ":noncausal"
DQ_MASK, DQ_SEGS, DQ_NC = (DQ + ":mask", DQ + ":segs", DQ + ":noncausal")
DKV_MASK, DKV_SEGS, DKV_NC = (DKV + ":mask", DKV + ":segs",
                              DKV + ":noncausal")
# the bf16 launches of the three flash kernels, any branch: the
# tensor-core kernels (counted once more, apart from the counters above);
# their fp32 launches: the split-TF32 kernels
FWD_TC, DQ_TC, DKV_TC = FWD + ":tc", DQ + ":tc", DKV + ":tc"
FWD_TC32, DQ_TC32, DKV_TC32 = FWD + ":tc32", DQ + ":tc32", DKV + ":tc32"
# their fp16 launches (the same kernels instantiated in fp16), and the fp16
# launches of the ragged (fp16 pools; int8 pools with fp16 q) and decode
# kernels, each counted once more
FWD_TC16, DQ_TC16, DKV_TC16 = FWD + ":tc16", DQ + ":tc16", DKV + ":tc16"
RAGGED16, RAGGED8_16, DECODE16 = (RAGGED + ":fp16", RAGGED + ":int8:fp16",
                                  "flash_decode:fp16")
# ... and those of the LayerNorm forward and backward and of each FFN design
# (a launch with a float16 x or w), each counted once more
LN16, LN_BWD16, FFN16, FFN_TC16, FFN_DEC16 = (
    k + ":fp16" for k in (LN, LN_BWD, FFN, FFN_TC, FFN_DEC))
FFN_COUNTER16 = {"cuda_core": FFN16, "tc": FFN_TC16, "decode": FFN_DEC16}
# head_dim 256 (phase 13): every launch at D = 256 of the flash forward,
# the ragged kernel (fp and int8 pools), flash decode and the fused layer,
# each counted once more; and the fp32 flash forward at 256 (the CUDA-core
# kernel, counted in place of FWD_TC32)
FWD_D256, FWD_SIMT = FWD + ":d256", FWD + ":simt"
RAGGED_D256, RAGGED8_D256 = RAGGED + ":d256", RAGGED + ":int8:d256"
DECODE_D256, FUSED_D256 = DECODE + ":d256", FUSED + ":d256"
D256_ALL = (FWD_D256, FWD_SIMT, RAGGED_D256, RAGGED8_D256, DECODE_D256,
            FUSED_D256)
# ... and of the flash dQ and dK/dV (phase 13a, 13b, 13d): every launch at
# D = 256 once more, and the fp32 ones (the CUDA-core kernels) in place
# of DQ_TC32 and DKV_TC32
DQ_D256, DQ_SIMT = DQ + ":d256", DQ + ":simt"
DKV_D256, DKV_SIMT = DKV + ":d256", DKV + ":simt"
D256_BWD = (DQ_D256, DQ_SIMT, DKV_D256, DKV_SIMT)
# head_dim 384, 512, ... (phase 19): every launch of the flash forward, dQ
# and dK/dV at a multiple of 128 past 256 (the kernels of
# csrc/flash_wide_fwd.cu and csrc/flash_wide_bwd.cu, any type), counted in
# place of the type's counter
FWD_WIDE, DQ_WIDE, DKV_WIDE = FWD + ":wide", DQ + ":wide", DKV + ":wide"
WIDE_ALL = (FWD_WIDE, DQ_WIDE, DKV_WIDE)
# ... and, once more, the bf16 and fp16 forward and dK/dV launches there up
# to WIDE_TC_MAX_D, the tensor-core kernels of csrc/flash_wide_tc.cu
FWD_WIDE_TC, DKV_WIDE_TC = FWD + ":wide_tc", DKV + ":wide_tc"
WIDE_TC_ALL = (FWD_WIDE_TC, DKV_WIDE_TC)
WIDE_TC, WIDE_TC_MAX_D = "flash_wide_tc", 1024     # their source, largest D
# dropout's keep masks on JAX's keys (`ops.threefry`)
THREEFRY = "threefry_bernoulli"
# its integer operations an element (`csrc/threefry_bernoulli.cu`: 20
# rounds of add, rotate and xor, 10 key injections, 2 counter adds, the
# bits' xor, shift, or, subtract and compare), and the most instructions
# the card issues: 4 warp instructions a clock an SM, 128 lanes, 132 SMs
# at 1.98 GHz (the lanes behind the 67 TFLOP/s of fp32, 2 FLOP an FMA)
THREEFRY_OPS, INT32_OPS = 78, 33.45e12
HALF_AND_FP32 = (torch.bfloat16, torch.float16, torch.float32)
FWD_ALL = (FWD, FWD_MASK, FWD_SEGS, FWD_NC)
DQ_ALL = (DQ, DQ_MASK, DQ_SEGS, DQ_NC)
DKV_ALL = (DKV, DKV_MASK, DKV_SEGS, DKV_NC)
KERNELS = (FWD, FWD_MASK, FWD_SEGS, FWD_NC, FWD_TC, FWD_TC32, RAGGED,
           RAGGED8, DQ, DQ_MASK, DQ_SEGS, DQ_NC, DQ_TC, DQ_TC32, DKV,
           DKV_MASK, DKV_SEGS, DKV_NC, DKV_TC, DKV_TC32, DECODE, FUSED, LN,
           LN_BWD, FFN, FFN_TC, FFN_TC32, FFN_DEC, FWD_TC16, DQ_TC16,
           DKV_TC16, RAGGED16, RAGGED8_16, DECODE16, LN16, LN_BWD16, FFN16,
           FFN_TC16, FFN_DEC16, *D256_ALL, *D256_BWD, THREEFRY,
           *WIDE_ALL, *WIDE_TC_ALL)
REPLACES = {
    FWD: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_MASK: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_SEGS: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_NC: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_TC: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_TC32: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_TC16: "paddle_tpu/ops/pallas_ops.py:135",
    RAGGED8: "paddle_tpu/ops/ragged_paged_attention.py:125",
    RAGGED16: "paddle_tpu/ops/ragged_paged_attention.py:125",
    RAGGED8_16: "paddle_tpu/ops/ragged_paged_attention.py:125",
    DQ_TC16: "paddle_tpu/ops/pallas_ops.py:210",
    DKV_TC16: "paddle_tpu/ops/pallas_ops.py:272",
    DECODE16: "paddle_tpu/ops/pallas_ops.py:1008",
    DQ: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_MASK: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_SEGS: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_NC: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_TC: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_TC32: "paddle_tpu/ops/pallas_ops.py:210",
    DKV: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_MASK: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_SEGS: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_NC: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_TC: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_TC32: "paddle_tpu/ops/pallas_ops.py:272",
    RAGGED: "paddle_tpu/ops/ragged_paged_attention.py:125",
    DECODE: "paddle_tpu/ops/pallas_ops.py:1008",
    FUSED: "paddle_tpu/ops/pallas_ops.py:1186",
    LN: "paddle_tpu/ops/pallas_ops.py:1391",
    LN_BWD: "paddle_tpu/ops/pallas_ops.py:1404",
    FFN: "paddle_tpu/ops/pallas_ops.py:1548",
    FFN_TC: "paddle_tpu/ops/pallas_ops.py:1548",
    FFN_TC32: "paddle_tpu/ops/pallas_ops.py:1548",
    FFN_DEC: "paddle_tpu/ops/pallas_ops.py:1548",
    LN16: "paddle_tpu/ops/pallas_ops.py:1391",
    LN_BWD16: "paddle_tpu/ops/pallas_ops.py:1404",
    FFN16: "paddle_tpu/ops/pallas_ops.py:1548",
    FFN_TC16: "paddle_tpu/ops/pallas_ops.py:1548",
    FFN_DEC16: "paddle_tpu/ops/pallas_ops.py:1548",
    FWD_D256: "paddle_tpu/ops/pallas_ops.py:135",
    FWD_SIMT: "paddle_tpu/ops/pallas_ops.py:135",
    RAGGED_D256: "paddle_tpu/ops/ragged_paged_attention.py:125",
    RAGGED8_D256: "paddle_tpu/ops/ragged_paged_attention.py:125",
    DECODE_D256: "paddle_tpu/ops/pallas_ops.py:1008",
    FUSED_D256: "paddle_tpu/ops/pallas_ops.py:1186",
    DQ_D256: "paddle_tpu/ops/pallas_ops.py:210",
    DQ_SIMT: "paddle_tpu/ops/pallas_ops.py:210",
    DKV_D256: "paddle_tpu/ops/pallas_ops.py:272",
    DKV_SIMT: "paddle_tpu/ops/pallas_ops.py:272",
    # no Pallas kernel: the JAX package's dropout draw, which XLA fuses
    THREEFRY: "paddle_tpu/nn/functional/__init__.py:903",
    FWD_WIDE: "paddle_tpu/ops/pallas_ops.py:135",
    DQ_WIDE: "paddle_tpu/ops/pallas_ops.py:210",
    DKV_WIDE: "paddle_tpu/ops/pallas_ops.py:272",
    FWD_WIDE_TC: "paddle_tpu/ops/pallas_ops.py:135",
    DKV_WIDE_TC: "paddle_tpu/ops/pallas_ops.py:272",
}
# the __global__ functions of paddle_tpu_torch/csrc, as the profiler names
# (template names: the flash variants are instantiations of the flash
# kernels, the int8 one of ragged_attend_kernel)
PORT_SYMBOLS = ("flash_fwd_tc32_kernel", "flash_fwd_tc_kernel",
                "flash_fwd_simt_kernel",
                "flash_bwd_dq_tc32_kernel", "flash_bwd_dq_tc_kernel",
                "flash_bwd_dq_simt_kernel", "flash_bwd_dkv_tc32_kernel",
                "flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_simt_kernel",
                "ragged_write_kernel",
                "ragged_attend_kernel", "ragged_write_int8_kernel",
                "flash_decode_kernel", "fused_decode_layer_kernel",
                "ln_fwd_kernel", "ln_fwd_wide_kernel", "ln_bwd_kernel",
                "ln_bwd_wide_kernel", "fused_ffn_kernel", "ffn_tc_kernel",
                "ffn_tc32_kernel", "wt_split_kernel", "ffn_dec_kernel",
                "threefry_bernoulli_kernel", "flash_wide_fwd_kernel",
                "flash_wide_dq_kernel", "flash_wide_dkv_kernel",
                "flash_wide_tc_fwd_kernel", "flash_wide_tc_dkv_kernel")
# ... and those a tree from before has, so that `--paths` groups a
# parent's profile as its own (the CUDA-core fp32 forward, dQ and dK/dV;
# the LayerNorm backward's second launch)
PARENT_SYMBOLS = ("flash_fwd_causal_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel", "ln_bwd_sum_kernel")
TRAIN_LR = 1e-4
# the training recipe (phase 9): warm-up steps of the schedule, the peak
# rates of GPT-3 Small (A, GPT-2 124M's width) and GPT-3 XL (B, 1.3B),
# Brown et al. 2020, App. B, and GPT-2's dropout (resid / embd / attn 0.1)
RECIPE_WARMUP = 2
RECIPE_LR, RECIPE_LR_1P3B = 6e-4, 2e-4
DROPOUT = {"hidden_dropout_prob": 0.1, "attention_dropout_prob": 0.1}
# the environment flags that select the decode kernels, by generate mode
GEN_MODES = {"default": {},
             "fused": {"PTPU_FUSED_DECODE": "1", "PTPU_PALLAS_FFN": "1"}}
# ... and the training kernels of the per-layer model, by training mode
TRAIN_MODES = {"flags": {"PTPU_PALLAS_LN": "1", "PTPU_PALLAS_FFN": "1"},
               "no_flags": {}}
FLAGS = ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN", "PTPU_PALLAS_LN")
# the switch of the captured decode steps (paddle_tpu_torch.graphs)
GRAPHS = "PTPU_CUDA_GRAPHS"
# the dense generate paths: layout (stacked?), kernel flags (a key of
# GEN_MODES, or "flags": TRAIN_MODES["flags"]), padded prompts
GEN_PATHS = {"stacked default": (True, "default", False),
             "stacked fused": (True, "fused", False),
             "stacked default padded": (True, "default", True),
             "stacked fused padded": (True, "fused", True),
             "per-layer default": (False, "default", False),
             "per-layer flags": (False, "flags", False)}
# eager and captured decode steps, in turns
TURNS = ("eager", "captured", "captured", "eager")


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each.  A spin
    of ~1 ms on the stream before the start event lets the host enqueue
    the call while the card is busy, so the time is the card's and not the
    host's launch overhead (which would dominate calls of a few us).
    ``reset``, if given, runs before each call's flush, outside the timed
    region: it restores state that the call changes."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=25, warmup=3, reset=None):
        for _ in range(warmup):
            if reset:
                reset()
            fn()
        times = []
        for _ in range(reps):
            if reset:
                reset()
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def check_close(tol, out, want, limit, what):
    """Hold `out` against `want` at `limit` (a number, or a per-element
    tensor).  Returns the max absolute error and the largest ratio of
    error to limit."""
    err, worst, ok = tol.compare(out, want, limit)
    if not ok:                                 # NaN fails too
        fail(f"{what}: max error {err}, {worst:.3g}x its limit")
    return err, worst


def bound_ms(nbytes, flops, dtype):
    return max(nbytes / HBM_BPS, flops / PEAK[dtype]) * 1e3, \
        "bytes" if nbytes / HBM_BPS >= flops / PEAK[dtype] else "operations"


def flash_bound(nbytes, flops, dtype):
    """``bound_ms`` and ``bound_by`` of a flash or FFN call: in fp32 the
    least time of fp32-accurate products, three TF32 passes on the tensor
    cores (``PEAK_TF32 / TF32_PASSES``, 165 TFLOP/s), with the CUDA cores'
    bound (67 TFLOP/s) beside it as ``cuda_core_bound_ms``."""
    if dtype != torch.float32:
        bms, by = bound_ms(nbytes, flops, dtype)
        return dict(bound_ms=bms, bound_by=by)
    t_ops = TF32_PASSES * flops / PEAK_TF32
    t_bytes = nbytes / HBM_BPS
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                cuda_core_bound_ms=bound_ms(nbytes, flops, dtype)[0])


def tflops(flops, ms):
    """The rate a call of `ms` achieves on `flops` useful operations."""
    return flops / (ms * 1e-3) / 1e12


def with_tc(want, dtype, ln_dtype=None, d=64):
    """`want` with the counts by type: in bf16 every forward, dQ and dK/dV
    launch counts once more under FWD_TC, DQ_TC and DKV_TC; in fp32 under
    FWD_TC32, DQ_TC32 and DKV_TC32; in fp16 under FWD_TC16, DQ_TC16 and
    DKV_TC16, and every ragged, decode and FFN launch once more under
    RAGGED16, RAGGED8_16, DECODE16 and the FFN design's fp16 counter.
    ``dtype``: the torch type the kernels ran in; ``ln_dtype`` (default
    ``dtype``) the LayerNorms' (float32 under ``auto_cast``, whose black
    list holds ``layer_norm``): in fp16 each LayerNorm launch counts once
    more under LN16 and LN_BWD16.  ``d``: the head dim; at 256 every
    forward, dQ, dK/dV, ragged, decode and fused-layer launch counts once
    more under its D = 256 counter, and an fp32 forward, dQ or dK/dV under
    FWD_SIMT, DQ_SIMT or DKV_SIMT in place of FWD_TC32, DQ_TC32 or
    DKV_TC32.  At a larger multiple of 128 (384, 512, ...) every forward,
    dQ and dK/dV launch counts once more under FWD_WIDE, DQ_WIDE or
    DKV_WIDE in place of its type's counter, in bf16 and fp16 up to
    `WIDE_TC_MAX_D` every forward and dK/dV launch once more under
    FWD_WIDE_TC or DKV_WIDE_TC (the tensor-core kernels), and the ragged,
    decode and fused-layer kernels, which take 64, 128 and 256 only,
    launch nothing: their gates send the step to the plain versions."""
    wide = d not in (64, 128, 256)
    if wide:
        for name in (RAGGED, RAGGED8, DECODE, FUSED):
            want[name] = 0
    for counters, names, counter_wide in (
            ((FWD_TC, FWD_TC16, FWD_TC32), FWD_ALL, FWD_WIDE),
            ((DQ_TC, DQ_TC16, DQ_TC32), DQ_ALL, DQ_WIDE),
            ((DKV_TC, DKV_TC16, DKV_TC32), DKV_ALL, DKV_WIDE)):
        n = sum(want[name] for name in names)
        for dt, counter in zip(HALF_AND_FP32, counters):
            want[counter] = n if dtype == dt and not wide else 0
        want[counter_wide] = n if wide else 0
    wide_tc = wide and dtype != torch.float32 and d <= WIDE_TC_MAX_D
    for counter, names in ((FWD_WIDE_TC, FWD_ALL), (DKV_WIDE_TC, DKV_ALL)):
        want[counter] = sum(want[name] for name in names) if wide_tc else 0
    fp16 = dtype == torch.float16
    for counter, name in ((RAGGED16, RAGGED), (RAGGED8_16, RAGGED8),
                          (DECODE16, DECODE), (FFN16, FFN),
                          (FFN_TC16, FFN_TC), (FFN_DEC16, FFN_DEC)):
        want[counter] = want[name] if fp16 else 0
    ln16 = (dtype if ln_dtype is None else ln_dtype) == torch.float16
    for counter, name in ((LN16, LN), (LN_BWD16, LN_BWD)):
        want[counter] = want[name] if ln16 else 0
    big = d == 256
    for simt, tc32, d256, names in (
            (FWD_SIMT, FWD_TC32, FWD_D256, FWD_ALL),
            (DQ_SIMT, DQ_TC32, DQ_D256, DQ_ALL),
            (DKV_SIMT, DKV_TC32, DKV_D256, DKV_ALL)):
        want[simt] = want[tc32] if big else 0
        if big:
            want[tc32] = 0
        want[d256] = sum(want[name] for name in names) if big else 0
    for counter, name in ((RAGGED_D256, RAGGED), (RAGGED8_D256, RAGGED8),
                          (DECODE_D256, DECODE), (FUSED_D256, FUSED)):
        want[counter] = want[name] if big else 0
    return want


def _sass_functions(lib):
    """{function name: its SASS} of a built library (`cuobjdump -sass`,
    from the toolkit of the `nvcc` that built it)."""
    from paddle_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(body) for n, body in funcs.items()}


def check_sass(paths):
    """The design behind each flash entry and the FFN's tensor-core
    designs, from the built libraries' machine code: every instantiation
    of the bf16 and fp16 forward, dQ and dK/dV kernels
    (``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel``,
    ``flash_bwd_dkv_tc_kernel``: 48 each, 2 types x 8 flag combinations x
    D 64, 128 and 256), of the fp32
    split-TF32 forward, dQ and dK/dV (``flash_fwd_tc32_kernel``,
    ``flash_bwd_dq_tc32_kernel``, ``flash_bwd_dkv_tc32_kernel``; 16 each,
    8 flag combinations x D 64 and 128) and of the FFN's products
    (``ffn_tc_kernel``: 32, bf16 and fp16 x 4 tiles x 3 activations and
    the plain second product; ``ffn_tc32_kernel``: 16, 4 tiles x 4)
    contains HGMMA (warpgroup
    tensor-core products); and the CUDA-core fp32 forward, dQ and dK/dV
    (``flash_fwd_causal_kernel``, ``flash_bwd_dq_kernel``,
    ``flash_bwd_dkv_kernel``) are gone; the fp32 forward, dQ and dK/dV at
    D = 256 (``flash_fwd_simt_kernel``, ``flash_bwd_dq_simt_kernel``,
    ``flash_bwd_dkv_simt_kernel``: 8 each, the flag combinations) are on
    the CUDA cores: FFMA and no HGMMA, and so are the forward, dQ and
    dK/dV at 384, 512, ... (``flash_wide_fwd_kernel``,
    ``flash_wide_dq_kernel``, ``flash_wide_dkv_kernel``: 24 each, 3 types
    x 8 flag combinations; float32 at every such D, 16-bit past
    `WIDE_TC_MAX_D`, dQ in every type), while every instantiation of the
    bf16 and fp16 forward and dK/dV there up to `WIDE_TC_MAX_D`
    (``flash_wide_tc_fwd_kernel``, ``flash_wide_tc_dkv_kernel``: 16 each,
    2 types x 8 flag combinations, D a runtime argument) contains HGMMA.
    Returns {kernel: [instantiations, of them with HGMMA, with FFMA]}."""
    fwd, bwd = "flash_fwd_causal", "flash_bwd_causal"
    # kernel: (library, instantiations on the tensor cores, or None: gone)
    wants = {"flash_fwd_tc_kernel": (fwd, 48),
             "flash_fwd_tc32_kernel": (fwd, 16),
             "flash_fwd_causal_kernel": (fwd, None),
             "flash_bwd_dq_tc_kernel": (bwd, 48),
             "flash_bwd_dq_tc32_kernel": (bwd, 16),
             "flash_bwd_dq_kernel": (bwd, None),
             "flash_bwd_dkv_tc_kernel": (bwd, 48),
             "flash_bwd_dkv_tc32_kernel": (bwd, 16),
             "flash_bwd_dkv_kernel": (bwd, None),
             "ffn_tc_kernel": (FFN_TC, 32),
             "ffn_tc32_kernel": (FFN_TC32, 16),
             "flash_wide_tc_fwd_kernel": (WIDE_TC, 16),
             "flash_wide_tc_dkv_kernel": (WIDE_TC, 16)}
    wfwd, wbwd = "flash_wide_fwd", "flash_wide_bwd"
    funcs = {src: _sass_functions(paths[src])
             for src in (fwd, bwd, FFN_TC, FFN_TC32, wfwd, wbwd, WIDE_TC)}
    counts = {}
    for kernel, (lib, tensor_cores) in wants.items():
        # mangled: ..._kernel I <template arguments> E
        found = {n: body for n, body in funcs[lib].items()
                 if f"{len(kernel)}{kernel}I" in n}
        hgmma = sum("HGMMA" in body for body in found.values())
        ffma = sum("FFMA" in body for body in found.values())
        counts[kernel] = [len(found), hgmma, ffma]
        ok = (not found) if tensor_cores is None else (
            len(found) == tensor_cores and hgmma == tensor_cores)
        if not ok:
            fail(f"SASS of {kernel}: {len(found)} instantiations, {hgmma} "
                 f"with HGMMA, {ffma} with FFMA ({sorted(found)[:4]} ...)")
    # the CUDA-core fp32 forward, dQ and dK/dV at D = 256: fp32 FMAs, no
    # tensor cores
    # ... and every instantiation at D = 384, 512, ...
    for lib, kernel, count in ((fwd, "flash_fwd_simt_kernel", 8),
                               (bwd, "flash_bwd_dq_simt_kernel", 8),
                               (bwd, "flash_bwd_dkv_simt_kernel", 8),
                               (wfwd, "flash_wide_fwd_kernel", 24),
                               (wbwd, "flash_wide_dq_kernel", 24),
                               (wbwd, "flash_wide_dkv_kernel", 24)):
        found = {n: body for n, body in funcs[lib].items()
                 if f"{len(kernel)}{kernel}I" in n}
        hgmma = sum("HGMMA" in body for body in found.values())
        ffma = sum("FFMA" in body for body in found.values())
        counts[kernel] = [len(found), hgmma, ffma]
        if len(found) != count or hgmma or ffma != count:
            fail(f"SASS of {kernel}: {len(found)} instantiations, {hgmma} "
                 f"with HGMMA, {ffma} with FFMA ({sorted(found)[:4]} ...)")
    return counts


def short_name(mangled):
    """``flash_fwd_tc_kernel<64,1,0,1>`` from a mangled kernel name (the
    template arguments: for the flash kernels element type, D, MASKED,
    SEGS, CAUSAL; ``ffn_tc_kernel<type, warpgroups, BN, epilogue>``,
    ``ffn_dec_kernel<type, loads, epilogue, dependent>``,
    ``ln_fwd_kernel<x, w, y types, chunks, early>``)."""
    m = re.search(r"\d+((?:flash|ffn|ln|fused|ragged)_\w+?_kernel)I(.*?E)E",
                  mangled)
    if not m:
        return mangled
    # a substitution (S_, S0_, ...) can only repeat a 16-bit type named
    # before it (__nv_bfloat16 or __half): float is a builtin type and
    # never substituted; a: int8_t (signed char)
    args, named = [], "bf16"
    for t in re.findall(r"13__nv_bfloat16|6__half|S\d*_|L[ib]\d+E|f|a",
                        m.group(2)):
        if t[0] in "16":
            named = "bf16" if t[0] == "1" else "f16"
        args.append(named if t[0] in "16S" else "f32" if t == "f"
                    else "i8" if t == "a" else t[2:-1])
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_table(log):
    """[(function, registers, spill stores, spill loads)] from one
    ``-Xptxas -v`` log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit("for ", 1)[1].strip()
        elif "bytes spill stores" in line and name:
            parts = line.replace(",", "").split()
            spills = (int(parts[parts.index("spill") - 2]),
                      int(parts[parts.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used", 1)[1].split()[0])
            rows.append((name, regs, *spills))
            name, spills = None, (0, 0)
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(fa, tol, timer, s, h, d, dtype, seed, b=1):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
               for _ in range(3))
    out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    want = fa.mha_reference(q, k, v, is_causal=True)
    limit = TOL_FP32 if dtype == torch.float32 else tol.flash_fwd_limit(
        out, want, q, k, v)
    torch.cuda.synchronize()
    err, ratio = check_close(tol, out, want, limit,
                             f"flash S={s} H={h} D={d} {dtype}")
    ms = timer(lambda: fa.flash_attention_arrays(q, k, v, is_causal=True))
    plain_ms = timer(lambda: fa.mha_reference(q, k, v, is_causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    item = q.element_size()
    nbytes = b * (4 * s * h * d * item + 4 * h * s)
    flops = 2 * b * d * h * s * (s + 1)   # 4*D per (query, visible key)
    return dict(shape=f"B={b} S={s} H={h} D={d}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, **flash_bound(nbytes, flops, dtype),
                library_ms=lib_ms, tflops=tflops(flops, ms))


def check_flash_bwd(fa, tol, timer, b, s, h, d, dtype, seed):
    """Both backward kernels against the plain backward at one shape, q, k
    and v slices of one fused [B, S, 3, H, D] tensor.  Returns one case
    per kernel; ``plain_ms`` and ``library_ms`` are of the whole backward
    (dQ, dK and dV together), since neither splits."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    scale = d ** -0.5
    out, lse = fa.flash_attention_arrays(q, k, v, is_causal=True,
                                         return_lse=True)
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    limits = ([BWD_REL_FP32 * ref.abs().max().item() for ref in want]
              if dtype == torch.float32 else tol.flash_bwd_limits(
                  (dq, dk, dv), want, q, k, v, out, lse, do, scale))
    torch.cuda.synchronize()
    ref_max = _nonzero_refs(want, f"flash backward B={b} S={s} H={h} D={d} "
                                  f"{dtype}")
    checks = {}
    for name, got, ref, limit in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                     limits):
        checks[name] = check_close(
            tol, got, ref, limit,
            f"flash backward {name} B={b} S={s} H={h} D={d} {dtype}")
    del limits
    ms_dq = timer(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale))
    ms_dkv = timer(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale))
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, scale), reps=10)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = timer(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True))
    item = q.element_size()
    slab = b * s * h * d * item                # one [B, S, H, D] tensor
    stats = 2 * b * h * s * 4                  # lse and delta, fp32
    pairs = b * h * s * (s + 1) // 2           # visible (query, key) pairs
    shape = f"B={b} S={s} H={h} D={d} fused qkv"
    cases = {}
    for kernel, ms, n_out, fl, errs in (
            (fa.flash_bwd_dq.KERNEL, ms_dq, 1, 6, ("dq",)),
            (fa.flash_bwd_dkv.KERNEL, ms_dkv, 2, 8, ("dk", "dv"))):
        cases[kernel] = dict(
            shape=shape, dtype=str(dtype),
            max_abs_err=max(checks[e][0] for e in errs),
            err_over_limit=max(checks[e][1] for e in errs), ms=ms,
            plain_ms=plain_ms,
            **flash_bound((4 + n_out) * slab + stats, fl * d * pairs, dtype),
            library_ms=lib_ms, tflops=tflops(fl * d * pairs, ms),
            ref_abs_max=ref_max)
    return cases


def _nonzero_refs(refs, what):
    """The largest |value| of the plain backward's (dq, dk, dv); fails if
    one of them is all zeros (a check against it, at a limit relative to
    its largest value, would hold for a kernel that wrote zeros)."""
    maxes = [r.abs().max().item() for r in refs]
    if not min(maxes) > 0:
        fail(f"{what}: a plain gradient is all zeros ({maxes})")
    return max(maxes)


def ragged_case(rows, c, nb, bs, h, d, dtype, seed):
    """rows: list of (kv_len after the write, valid queries) or None for a
    padding row.  Returns kernel inputs, the valid query counts, and the
    bytes/FLOPs this data needs."""
    rng = np.random.RandomState(seed)
    b, maxb = len(rows), 1024 // bs
    tables = np.full((b, maxb), nb, np.int32)
    pos0 = np.zeros(b, np.int32)
    lens = np.zeros(b, np.int32)
    slots = np.full((b, c), nb * bs, np.int32)
    free = list(rng.permutation(nb))
    qlens, keys_read, flops = [], 0, 0
    for r, row in enumerate(rows):
        if row is None:
            qlens.append(0)
            continue
        kv_len, nq = row
        nblk = -(-kv_len // bs)
        tables[r, :nblk] = [free.pop() for _ in range(nblk)]
        pos0[r], lens[r] = kv_len - nq, kv_len
        for j in range(nq):
            p = pos0[r] + j
            slots[r, j] = tables[r, p // bs] * bs + p % bs
            flops += 4 * (p + 1) * h * d
        qlens.append(nq)
        keys_read += kv_len
    g = torch.Generator().manual_seed(seed)
    q, kn, vn = (torch.randn(b, c, h, d, generator=g).to("cuda", dtype)
                 for _ in range(3))
    kb, vb = (torch.randn(nb, bs, h, d, generator=g).to("cuda", dtype)
              for _ in range(2))
    idx = [torch.from_numpy(a).cuda() for a in (tables, pos0, lens, slots)]
    item = q.element_size()
    writes = sum(qlens)
    nbytes = (2 * keys_read * h * d * item        # K and V, read once
              + 2 * writes * h * d * item         # the new rows written
              + 4 * b * c * h * d * item          # q, k_new, v_new, out
              + 4 * (tables.size + 2 * b + slots.size))
    return (q, kn, vn, kb, vb, *idx), qlens, nbytes, flops


def ragged_subnormal(rpa, args, kr, vr, mag, dtype):
    """fp16: [B, C, H, D], the sum of |v| over each query's keys, which a
    subnormal fp16 p of the plain version may weight (`tolerance`): the
    mean of |v| (the reference with q = 0, `mag`'s pools after the write)
    times the query's key count; None in bf16."""
    if dtype != torch.float16:
        return None
    q, kn, vn, _, _, tables, pos0, lens, slots = args
    mean, _, _ = rpa.ragged_paged_attention_reference(
        torch.zeros_like(q, dtype=torch.float32), kn.float(),
        vn.float().abs(), kr.float(), vr.float().abs(), tables, pos0, lens,
        slots)
    keys = pos0[:, None] + 1 + torch.arange(q.shape[1], device=q.device)
    return mean * keys[:, :, None, None].float()


def check_ragged(rpa, tol, timer, rows, c, dtype, seed, h=12, d=64):
    nb, bs = 512, 16                        # the GPT-2 engine's pool
    args, qlens, nbytes, flops = ragged_case(rows, c, nb, bs, h, d, dtype,
                                             seed)
    q, kn, vn, kb, vb, tables, pos0, lens, slots = args
    kr, vr = kb.clone(), vb.clone()
    out, _, _ = rpa.ragged_paged_attention_arrays(*args)
    want, _, _ = rpa.ragged_paged_attention_reference(
        q, kn, vn, kr, vr, tables, pos0, lens, slots)
    torch.cuda.synchronize()
    if not (torch.equal(kb, kr) and torch.equal(vb, vr)):
        fail(f"ragged C={c} {dtype}: pool writes differ from the plain "
             "version")
    limits = [TOL_FP32] * len(qlens)
    if dtype != torch.float32:
        m, _, _ = rpa.ragged_paged_attention_reference(
            q.float(), kn.float(), vn.float().abs(), kr.float(),
            vr.float().abs(), tables, pos0, lens, slots)
        sub = ragged_subnormal(rpa, args, kr, vr, m, dtype)
        limits = [tol.half_limit(out[r, :n], want[r, :n], m[r, :n], "fwd",
                                 None if sub is None else sub[r, :n])
                  for r, n in enumerate(qlens)]
    checks = [check_close(tol, out[r, :n], want[r, :n], limits[r],
                          f"ragged C={c} {dtype} row {r}")
              for r, n in enumerate(qlens) if n]
    err, ratio = max(e for e, _ in checks), max(w for _, w in checks)
    # both write the same values to the same slots: repeating is idempotent
    ms = timer(lambda: rpa.ragged_paged_attention_arrays(*args))
    plain_ms = timer(lambda: rpa.ragged_paged_attention_reference(
        q, kn, vn, kr, vr, tables, pos0, lens, slots))
    parts = ragged_parts_ms(rpa, timer, args)
    bms, by = bound_ms(nbytes, flops, dtype)
    lens_s = ",".join(str(r[0]) if r else "pad" for r in rows)
    return dict(shape=f"B={len(rows)} C={c} kv_lens=[{lens_s}] H={h} D={d} "
                f"block_size={bs}", dtype=str(dtype), max_abs_err=err,
                err_over_limit=ratio, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None, **parts,
                max_splits=ragged_grid_splits(rpa, rows, c, h, 1024))


def ragged_parts_ms(rpa, timer, args, reset=None):
    """{write_ms, attend_ms}: the write and the attend launch of the call,
    each timed alone (`ragged_paged_attention_part`), where the tree has
    them; {} for a tree from before the split."""
    part = getattr(rpa, "ragged_paged_attention_part", None)
    if part is None:
        return {}
    return {f"{name}_ms": timer(lambda: part(name, *args), reset=reset)
            for name in ("write", "attend")}


def ragged_grid_splits(rpa, rows, c, h, width):
    """The attend launch's blocks per (row, query, head), or None for a
    tree from before the split."""
    splits = getattr(rpa, "ragged_splits", None)
    return None if splits is None else splits(
        len(rows), c, h, width, torch.cuda.get_device_properties(
            0).multi_processor_count)


def check_ragged_int8(rpa, tol, timer, rows, c, dtype, seed, h=12, d=64):
    """The int8 entry against its plain version on int8 pools whose small
    scales (< 0.005) the new rows grow: codes and scales bitwise, out
    within the forward limit.  Each timed call starts from the state
    before the write (restored untimed), so it rescales as the first
    did; the write and the attend are also timed alone."""
    nb, bs = 512, 16
    args, qlens, _, flops = ragged_case(rows, c, nb, bs, h, d, dtype, seed)
    q, kn, vn, _, _, tables, pos0, lens, slots = args
    g = torch.Generator().manual_seed(seed)
    kc, vc = (torch.randint(-127, 128, (nb, bs, h, d), generator=g,
                            dtype=torch.int8).cuda() for _ in range(2))
    ks, vs = ((torch.rand(nb, h, generator=g) * 0.005).cuda()
              for _ in range(2))
    init = [t.clone() for t in (kc, vc, ks, vs)]
    before = ks.clone(), vs.clone()
    ref = [t.clone() for t in (kc, vc, ks, vs)]
    idx = (tables, pos0, lens, slots)
    out, *got = rpa.ragged_paged_attention_arrays(q, kn, vn, kc, vc, *idx,
                                                  ks, vs)
    want, *wref = rpa.ragged_paged_attention_reference(q, kn, vn, ref[0],
                                                       ref[1], *idx, ref[2],
                                                       ref[3])
    torch.cuda.synchronize()
    what = f"ragged int8 C={c} {dtype}"
    if not all(torch.equal(a, b) for a, b in zip(got, wref)):
        fail(f"{what}: codes or scales differ from the plain version")
    grown = sum(int((a != b).sum()) for a, b in zip(before, (ks, vs)))
    if not grown:
        fail(f"{what}: no scale grew")
    limits = [TOL_FP32] * len(qlens)
    if dtype != torch.float32:
        m = rpa.folded_quant_attention(q.float(), ref[0], ref[1].abs(),
                                       ref[2], ref[3], tables, pos0,
                                       d ** -0.5)
        limits = [tol.half_limit(out[r, :n], want[r, :n], m[r, :n], "fwd")
                  for r, n in enumerate(qlens)]
    checks = [check_close(tol, out[r, :n], want[r, :n], limits[r],
                          f"{what} row {r}")
              for r, n in enumerate(qlens) if n]
    def restore(state):
        return lambda: [t.copy_(i) for t, i in zip(state, init)]

    ms = timer(lambda: rpa.ragged_paged_attention_arrays(
        q, kn, vn, kc, vc, *idx, ks, vs), reset=restore((kc, vc, ks, vs)))
    plain_ms = timer(lambda: rpa.ragged_paged_attention_reference(
        q, kn, vn, *ref[:2], *idx, *ref[2:]), reset=restore(ref))
    parts = ragged_parts_ms(rpa, timer, (q, kn, vn, kc, vc, *idx, ks, vs),
                            reset=restore((kc, vc, ks, vs)))
    # what this data needs: each code of the rows' keys and each (block,
    # head) scale they use read once, the new rows' codes written, each
    # grown (block, head) slice of codes read and written, its scale
    # written; q, k_new, v_new read and out written; the index arrays
    keys = sum(r[0] for r in rows if r)
    blocks = sum(-(-r[0] // bs) for r in rows if r)
    writes = sum(qlens)
    item = q.element_size()
    nbytes = (2 * keys * h * d + 2 * blocks * h * 4 + 2 * writes * h * d
              + grown * (2 * bs * d + 4) + 4 * len(rows) * c * h * d * item
              + 4 * (tables.numel() + 2 * len(rows) + slots.numel()))
    bms, by = bound_ms(nbytes, flops, dtype)
    lens_s = ",".join(str(r[0]) if r else "pad" for r in rows)
    return dict(shape=f"B={len(rows)} C={c} kv_lens=[{lens_s}] H={h} D={d} "
                f"block_size={bs} int8 pools", dtype=str(dtype),
                max_abs_err=max(e for e, _ in checks),
                err_over_limit=max(w for _, w in checks), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, scales_grown=grown, **parts,
                max_splits=ragged_grid_splits(rpa, rows, c, h, 1024))


# the LayerNorm backward's rows and types at H = 768 (x, w/b): training
# rows in each type, the decode step's rows, a count between
LN_BWD_CASES = ((8192, torch.float32, torch.float32),
                (8192, torch.bfloat16, torch.bfloat16),
                (8192, torch.bfloat16, torch.float32),
                (8, torch.bfloat16, torch.bfloat16),
                (200, torch.bfloat16, torch.bfloat16))


# the engine's decode step (lens after the write; None: a padding row),
# and rows at the ragged kernel's split edges and the table's full width
DECODE_ROWS = [(1024, 1), (700, 1), (513, 1), (384, 1), (200, 1), (64, 1),
               (7, 1), None]
EDGE_ROWS = [(127, 1), (128, 1), (129, 1), (1024, 1), None, (1, 1)]


# left-pad counts of the padded prefill's eight rows
PAD_COUNTS = (0, 43, 86, 129, 171, 214, 257, 300)


def masked_inputs(kind, b, s, h, d, dtype, seed):
    """q, k, v (slices of one fused qkv tensor), the mask and kv_lens of a
    masked-forward case: ``pad`` the stride-0 [B, 1, S, S] view of a
    [B, 1, 1, S] left-pad row (padded `generate`'s prefill), ``full`` an
    additive [B, H, S, S], ``shared`` an additive [1, 1, S, S], ``lens``
    kv_lens spread over S .. S - 259."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    mask = lens = None
    if kind == "pad":
        pads = torch.tensor(PAD_COUNTS[:b])
        row = torch.where(torch.arange(s)[None] < pads[:, None], -1e30, 0.0)
        mask = row.cuda()[:, None, None, :].expand(b, 1, s, s)
    elif kind == "full":
        mask = (torch.randn(b, h, s, s, generator=g) * 2).cuda()
    elif kind == "shared":
        mask = (torch.randn(1, 1, s, s, generator=g) * 2).cuda()
    else:
        lens = torch.tensor([s - 37 * i for i in range(b)],
                            dtype=torch.int32).cuda()
    return q, k, v, mask, lens


def mask_entries_needed(mask, causal, klen):
    """The distinct entries of a [B|1, H|1, S|1, S] mask (read through its
    strides, 0 broadcasting) that the pairs causal and kv_lens allow touch:
    a pair (b, q, k) is allowed if k <= q and k < klen[b], for every head;
    a broadcast dimension counts the union of what it covers once."""
    b, s = len(klen), causal.shape[0]
    lens = torch.tensor(klen, device=causal.device)
    keys = torch.arange(s, device=causal.device)
    need = causal[None] & (keys < lens[:, None])[:, None, :]   # [B, S, S]
    for dim, size, stride in ((0, mask.shape[0], mask.stride(0)),
                              (1, mask.shape[2], mask.stride(2)),
                              (2, mask.shape[3], mask.stride(3))):
        if size == 1 or stride == 0:
            need = need.any(dim, keepdim=True)
    heads = 1 if mask.shape[1] == 1 or mask.stride(1) == 0 else mask.shape[1]
    return int(need.sum()) * heads


def check_flash_masked(fa, tol, timer, kind, dtype, seed, b=8, s=896, h=12,
                       d=64):
    """The masked / kv_lens flash forward against `mha_reference`, every
    row (left-pad rows included); yardstick SDPA with the same additive
    mask plus causal (and kv_lens as a mask)."""
    q, k, v, mask, lens = masked_inputs(kind, b, s, h, d, dtype, seed)
    out = fa.flash_attention_arrays(q, k, v, mask, True, kv_lens=lens)
    want = fa.mha_reference(q, k, v, is_causal=True, mask=mask, kv_lens=lens)
    limit = TOL_FP32
    if dtype != torch.float32:
        limit = tol.flash_fwd_limit(out, want, q, k, v, True, mask, lens)
    torch.cuda.synchronize()
    err, ratio = check_close(tol, out, want, limit,
                             f"masked flash {kind} B={b} S={s} {dtype}")
    del want, limit
    ms = timer(lambda: fa.flash_attention_arrays(q, k, v, mask, True,
                                                 kv_lens=lens))
    plain_ms = timer(lambda: fa.mha_reference(q, k, v, is_causal=True,
                                              mask=mask, kv_lens=lens),
                     reps=10)
    keys = torch.arange(s, device="cuda")
    causal = keys[None, :] <= keys[:, None]
    lib_mask = torch.where(causal, 0.0, -1e30)
    if mask is not None:
        lib_mask = lib_mask + mask
    if lens is not None:
        lib_mask = lib_mask + torch.where(
            keys[None, :] < lens[:, None], 0.0, -1e30)[:, None, None, :]
    lib_mask = lib_mask.to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=lib_mask))
    del lib_mask
    item = q.element_size()
    klen = [s] * b if lens is None else lens.tolist()
    pairs = h * sum(n * (n + 1) // 2 + (s - n) * n for n in klen)
    nbytes = (2 * b * s * h * d * item               # q read, out written
              + 2 * sum(klen) * h * d * item         # the keys it needs
              + 3 * 4 * b * h * s                    # lse, m and log l
              + (0 if mask is None else 4 * mask_entries_needed(
                  mask, causal, klen))
              + (0 if lens is None else 4 * b))
    return dict(shape=f"B={b} S={s} H={h} D={d} {kind}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, **flash_bound(nbytes, 4 * d * pairs, dtype),
                library_ms=lib_ms, tol=_tol_text(dtype, TOL_FP32),
                tflops=tflops(4 * d * pairs, ms))


# ---------------------------------------------------------------------------
# packed documents (a copy of examples/packed_pretraining.py's packer, so
# that this script imports nothing of the JAX package)
# ---------------------------------------------------------------------------

def pack_documents(docs, row_len):
    """Greedy-pack variable-length docs into fixed rows; returns
    (ids, segment_ids, position_ids) — the packed pretraining triple.
    Documents longer than row_len must be split by the caller first."""
    rows, segs, poss = [], [], []
    row, seg, pos, seg_id = [], [], [], 0
    for doc in docs:
        if len(doc) > row_len:
            raise ValueError(
                f"document of length {len(doc)} exceeds row_len {row_len}; "
                "chunk long documents before packing")
        if len(row) + len(doc) > row_len:
            pad = row_len - len(row)
            row += [0] * pad
            seg += [seg_id + 1] * pad          # padding = its own segment
            pos += list(range(pad))
            rows.append(row), segs.append(seg), poss.append(pos)
            row, seg, pos, seg_id = [], [], [], 0
        row += list(doc)
        seg += [seg_id] * len(doc)
        pos += list(range(len(doc)))
        seg_id += 1
    if row:
        pad = row_len - len(row)
        rows.append(row + [0] * pad)
        segs.append(seg + [seg_id + 1] * pad)
        poss.append(pos + list(range(pad)))
    return (np.asarray(rows, np.int32), np.asarray(segs, np.int32),
            np.asarray(poss, np.int32))


def packed_batch(vocab, batch, seq):
    """The first `batch` full rows of packed documents: lengths from
    ``numpy.random.default_rng(0).integers(16, 1025)``, tokens uniform in
    [3, vocab).  Returns (ids, labels, loss_mask, segment_ids,
    position_ids) as CPU tensors: labels the next token, the loss mask the
    example's ``(segs == roll(segs, -1)) & (ids != 0)``."""
    rng = np.random.default_rng(0)
    docs = []
    while True:
        n = int(rng.integers(16, 1025))
        docs.append(rng.integers(3, vocab, n))
        if sum(len(d) for d in docs) < batch * seq:
            continue
        ids, segs, pos = pack_documents(docs, seq)
        if len(ids) > batch:                 # the last row may be filling
            break
    ids, segs, pos = ids[:batch], segs[:batch], pos[:batch]
    labels = np.roll(ids, -1, axis=1)
    mask = ((segs == np.roll(segs, -1, axis=1)) & (ids != 0)).astype(
        np.float32)
    return tuple(torch.from_numpy(a) for a in (ids, labels, mask, segs, pos))


def allowed_pairs(segs, causal, klen, sq, sk):
    """[B, Sq, Sk] bool on the card: the (query, key) pairs a call allows
    (causal, kv_lens, same segment)."""
    dev = "cuda"
    qi = torch.arange(sq, device=dev)[:, None]
    kj = torch.arange(sk, device=dev)[None, :]
    ok = (kj <= qi + sk - sq) if causal else torch.ones(
        sq, sk, dtype=torch.bool, device=dev)
    ok = ok[None] & (kj[None] < torch.tensor(klen, device=dev)[:, None, None])
    if segs is not None:
        ok = ok & (segs[:, :, None] == segs[:, None, :])
    return ok


def variant_inputs(kind, b, s, h, d, dtype, seed, segs=None):
    """q, k, v (slices of one fused [B, S, 3, H, D] tensor), dO and the
    branches (causal, attn_mask, kv_lens, segment ids) of a variant case:
    ``segs`` the given packed ids, causal; ``nc`` non-causal; ``pad`` the
    stride-0 [B, 1, S, S] view of a left-pad key row (`PAD_COUNTS`; its
    pad queries have every key masked), causal; ``key`` BERT's additive
    [B, 1, 1, S] padding mask (`bert_key_mask`), non-causal; ``lens``
    kv_lens S .. S - 37 (B - 1), causal.  Everything but the packed ids is
    drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    mask = lens = None
    if kind == "pad":
        pads = torch.tensor(PAD_COUNTS[:b])
        row = torch.where(torch.arange(s)[None] < pads[:, None], -1e30, 0.0)
        mask = row.cuda()[:, None, None, :].expand(b, 1, s, s)
    if kind == "key":
        mask = torch.where(bert_key_mask(b, s, seed), 0.0, -1e30)
    if kind == "lens":
        lens = torch.tensor([s - 37 * i for i in range(b)],
                            dtype=torch.int32).cuda()
    return (q, k, v, do, kind not in ("nc", "key"), mask, lens,
            None if segs is None else segs.cuda().int())


def _library_mask(allowed, mask, dtype):
    """SDPA's mask for a variant call: bool where no additive mask is
    given, else additive (-1e30 outside ``allowed``, plus the mask)."""
    if mask is None:
        return allowed[:, None]
    if mask.shape[2] == 1 and bool(allowed.all()):
        return mask.to(dtype)          # a key mask: SDPA broadcasts it
    return (torch.where(allowed[:, None], 0.0, -1e30) + mask).to(dtype)


def check_flash_variant(fa, tol, timer, kind, b, s, h, d, dtype, seed,
                        segs=None, fwd=True, bwd=True):
    """The variant forward and both variant backward kernels against their
    plain versions on one input, every row (pad rows, whose every key the
    mask closes, too): {kernel name: case} for the timed ones
    (``fwd``, ``bwd``).  The yardstick is SDPA with the call's mask (a
    bool [B, 1, S, S] of the allowed pairs, or additive with a mask; SDPA
    has no segment argument), and for the backward `torch.autograd.grad`
    through it.  Each bound counts only the pairs the call allows, and of
    a mask only the entries those pairs touch."""
    q, k, v, do, causal, mask, lens, sid = variant_inputs(
        kind, b, s, h, d, dtype, seed, segs)
    scale = d ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    name = fa.variant_name(causal, m4, lens, sid)
    br = dict(causal=causal, mask=m4, lens=lens, segs=sid)
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, sid)
    want = fa.mha_reference(q, k, v, m4, causal, scale, lens, sid)
    limit = TOL_FP32
    if dtype != torch.float32:
        limit = tol.flash_fwd_limit(out, want, q, k, v, causal, m4, lens,
                                    sid)
    torch.cuda.synchronize()
    what = f"flash {name} {kind} B={b} S={s} H={h} D={d} {dtype}"
    fwd_check = check_close(tol, out, want, limit, what)
    del want, limit
    klen = [s] * b if lens is None else lens.tolist()
    allowed = allowed_pairs(sid, causal, klen, s, s)
    pairs = h * int(allowed.sum())
    keys = torch.arange(s, device="cuda")
    needed = (0 if mask is None else mask_entries_needed(
        mask, keys[None, :] <= keys[:, None] if causal
        else torch.ones(s, s, dtype=torch.bool, device="cuda"), klen))
    extra = 4 * needed + (0 if lens is None else 4 * b) \
        + (0 if sid is None else 4 * b * s)       # mask, lens, ids read once
    item = q.element_size()
    slab = b * s * h * d * item
    lib_mask = _library_mask(allowed, mask, dtype)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = (f"B={b} S={s} H={h} D={d} {kind}"
             + (f" allowed {pairs / (h * b * s * s):.4f} of all pairs"
                if sid is not None else ""))
    cases = {}
    if fwd:
        ms = timer(lambda: fa.flash_attention_arrays(
            q, k, v, mask, causal, kv_lens=lens, segment_ids=sid))
        plain_ms = timer(lambda: fa.mha_reference(q, k, v, m4, causal, scale,
                                                  lens, sid), reps=10)
        lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=lib_mask))
        nstat = 1 if pair is None else 3          # lse (and m, log l)
        cases[f"{fa.KERNEL}:{name}"] = dict(
            shape=shape, dtype=str(dtype), max_abs_err=fwd_check[0],
            err_over_limit=fwd_check[1], ms=ms, plain_ms=plain_ms,
            **flash_bound(4 * slab + nstat * 4 * b * h * s + extra,
                          4 * d * pairs, dtype), library_ms=lib_ms,
            tol=_tol_text(dtype, TOL_FP32), tflops=tflops(4 * d * pairs, ms))
    if not bwd:
        return cases
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, row_max=row_max,
                         **br)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                              row_max=row_max, **br)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=sid, row_max=row_max)
    limits = ([BWD_REL_FP32 * r.abs().max().item() for r in ref]
              if dtype == torch.float32 else tol.flash_bwd_limits(
                  (dq, dk, dv), ref, q, k, v, out, stat, do, scale,
                  row_max=row_max, **br))
    torch.cuda.synchronize()
    ref_max = _nonzero_refs(ref, f"backward {what}")
    checks = {}
    for which, got, r, limit in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                    limits):
        checks[which] = check_close(tol, got, r, limit,
                                    f"backward {which} {what}")
    del ref, limits
    ms_dq = timer(lambda: fa.flash_bwd_dq(q, k, v, do, stat, delta, scale,
                                          row_max=row_max, **br))
    ms_dkv = timer(lambda: fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                                            row_max=row_max, **br))
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=sid, row_max=row_max), reps=10)
    ot = sdpa(qt, kt, vt, attn_mask=lib_mask)
    dot = do.transpose(1, 2)
    lib_ms = timer(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True))
    stats = (3 if pair is not None else 2) * b * h * s * 4
    for kernel, ms, n_out, fl, errs in (
            (fa.flash_bwd_dq, ms_dq, 1, 6, ("dq",)),
            (fa.flash_bwd_dkv, ms_dkv, 2, 8, ("dk", "dv"))):
        cases[f"{kernel.KERNEL}:{name}"] = dict(
            shape=shape, dtype=str(dtype),
            max_abs_err=max(checks[e][0] for e in errs),
            err_over_limit=max(checks[e][1] for e in errs), ms=ms,
            plain_ms=plain_ms,
            **flash_bound((4 + n_out) * slab + stats + extra,
                          fl * d * pairs, dtype),
            library_ms=lib_ms, tflops=tflops(fl * d * pairs, ms),
            ref_abs_max=ref_max)
    return cases


def device_int(n, on):
    """``n`` as the int32 [1] tensor on the card that the decode steps
    pass the kernels (``on``), else the int."""
    return torch.tensor([n], dtype=torch.int32, device="cuda") if on else n


def check_decode(fd, tol, timer, b, s_max, h, d, length, dtype, seed,
                 device_len=True):
    """The flash-decode kernel against its plain version; q is the
    [B, 1, H, D] slice of a fused qkv projection, as in the GPT block.
    With ``device_len`` the kernel reads the length from the card, as in
    a captured decode step, and must give the int form's bits too."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, 3, h, d, generator=g).to("cuda", dtype)[:, :, 0]
    kc, vc = (torch.randn(b, s_max, h * d, generator=g).to("cuda", dtype)
              for _ in range(2))
    n = device_int(length, device_len)
    out = fd.flash_decode_arrays(q, kc, vc, n)
    if device_len and not torch.equal(
            out, fd.flash_decode_arrays(q, kc, vc, length)):
        fail(f"decode B={b} length={length} H={h} D={d} {dtype}: the "
             f"device length's output differs from the int length's")
    want = fd.flash_decode_reference(q, kc, vc, length)
    limit = TOL_FP32 if dtype == torch.float32 else tol.decode_limit(
        out, want, q, kc, vc, length, d ** -0.5)
    torch.cuda.synchronize()
    err, ratio = check_close(tol, out, want, limit,
                             f"decode B={b} length={length} H={h} D={d} "
                             f"{dtype}")
    ms = timer(lambda: fd.flash_decode_arrays(q, kc, vc, n))
    plain_ms = timer(lambda: fd.flash_decode_reference(q, kc, vc, length))
    qt = q.transpose(1, 2)
    kt, vt = (c[:, :length].view(b, length, h, d).transpose(1, 2)
              for c in (kc, vc))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    item = q.element_size()
    nbytes = 2 * b * h * d * item * (length + 1)   # K, V prefix; q, out
    bms, by = bound_ms(nbytes, 4 * b * h * d * length, dtype)
    splits = fd._lib().flash_decode_splits(length)
    return dict(shape=f"B={b} S_max={s_max} length={length} H={h} D={d}"
                + (" device length" if device_len else ""),
                dtype=str(dtype), max_abs_err=err, err_over_limit=ratio,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, tol=_tol_text(dtype, TOL_FP32),
                splits=splits, blocks=splits * b * h,
                gb_per_s=nbytes / (ms * 1e-3) / 1e9)


def _tol_text(dtype, fp32):
    return f"tol {fp32}" if dtype == torch.float32 \
        else "tol scaled to each output"


def check_fused_layer(fdl, tol, timer, b, h, d, s_max, t, masked, dtype,
                      seed, device_len=True):
    """The fused decode layer against its plain version: y and the
    written rows within their limits, every other ring row bitwise
    unchanged.  With ``device_len`` the kernel reads t from the card, as
    in a captured decode step, and must give the int form's bits too."""
    hd = h * d
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    args = (rnd(b, hd), 1 + rnd(hd, scale=0.1), rnd(hd, scale=0.1),
            rnd(hd, 3 * hd, scale=hd ** -0.5), rnd(3 * hd, scale=0.1),
            rnd(hd, hd, scale=hd ** -0.5), rnd(hd, scale=0.1))
    kc, vc = rnd(b, s_max, hd), rnd(b, s_max, hd)
    mask = None
    if masked:
        mask = torch.where(torch.rand(b, s_max, generator=g) < 0.3, -1e30,
                           0.0).cuda()
    kr, vr = kc.clone(), vc.clone()
    ki, vi = kc.clone(), vc.clone()
    n = device_int(t, device_len)
    y, _, _ = fdl.fused_decode_layer_arrays(*args, kc, vc, n, h,
                                            cache_mask=mask)
    if device_len:
        yi, _, _ = fdl.fused_decode_layer_arrays(*args, ki, vi, t, h,
                                                 cache_mask=mask)
        if not (torch.equal(y, yi) and torch.equal(kc, ki)
                and torch.equal(vc, vi)):
            fail(f"fused layer B={b} hd={hd} t={t} {dtype}: the device "
                 f"t's output differs from the int t's")
    del ki, vi
    plain = fdl.fused_decode_plain(*args, kr, vr, t, h, cache_mask=mask)
    yr, _, _ = fdl.fused_decode_layer_reference(*args, kr, vr, t, h,
                                                cache_mask=mask)
    torch.cuda.synchronize()
    what = f"fused layer B={b} hd={hd} t={t} mask={masked} {dtype}"
    for c, r in ((kc, kr), (vc, vr)):
        if not (torch.equal(c[:, :t], r[:, :t])
                and torch.equal(c[:, t + 1:], r[:, t + 1:])):
            fail(f"{what}: ring rows other than t changed")
    if dtype == torch.float32:
        limits = dict(y=TOL_FP32, k=TOL_FP32, v=TOL_FP32)
    else:
        limits = tol.fused_decode_limits(plain, args, kr, vr, t, h,
                                         d ** -0.5)
    checks = [check_close(tol, got, ref, limits[name], f"{what} {name}")
              for name, got, ref in (("y", y, yr), ("k", kc[:, t], kr[:, t]),
                                     ("v", vc[:, t], vr[:, t]))]
    # repeating writes the same row: idempotent
    ms = timer(lambda: fdl.fused_decode_layer_arrays(
        *args, kc, vc, n, h, cache_mask=mask))
    plain_ms = timer(lambda: fdl.fused_decode_layer_reference(
        *args, kr, vr, t, h, cache_mask=mask))
    item = y.element_size()
    nbytes = ((4 * hd * hd + 6 * hd) * item      # weights, biases, LN
              + 2 * b * hd * item                # x, y
              + 2 * b * (t + 1) * hd * item      # prefix read, row written
              + (4 * b * t if masked else 0))    # the mask's prefix
    flops = 8 * b * hd * hd + 4 * b * t * hd
    bms, by = bound_ms(nbytes, flops, dtype)
    return dict(shape=f"B={b} hd={hd} H={h} S_max={s_max} t={t} "
                f"mask={masked}" + (" device t" if device_len else ""),
                dtype=str(dtype),
                max_abs_err=max(e for e, _ in checks),
                err_over_limit=max(r for _, r in checks), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, tol=_tol_text(dtype, TOL_FP32))


def check_ln(fm, tol, timer, n, hidden, dtype, seed, pdt=None):
    """The LayerNorm kernel against its plain version: y (within
    `tolerance.ln_limit`, or TOL_FP32 where y is fp32), and mu and rstd
    to 1e-5 relative; x in ``dtype``, w and b in ``pdt`` (default
    ``dtype``).  A width whose rows do not fall into 16-byte chunks (1002)
    takes the kernel's scalar head and tail.  The yardstick is
    ``F.layer_norm`` (on x cast to y's type where x and w differ)."""
    pdt = pdt or dtype
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, hidden, generator=g) * 2 + 0.5).to("cuda", dtype)
    w = (1 + 0.1 * torch.randn(hidden, generator=g)).to("cuda", pdt)
    b = (0.1 * torch.randn(hidden, generator=g)).to("cuda", pdt)
    y, mu, rs = fm.fused_layernorm_arrays(x, w, b, return_stats=True)
    yr, mur, rsr = fm.fused_layernorm_reference(x, w, b)
    torch.cuda.synchronize()
    types = str(dtype) if pdt == dtype else f"x {dtype}, w/b {pdt}"
    what = f"layernorm n={n} H={hidden} {types}"
    for name, got, ref in (("mu", mu, mur), ("rstd", rs, rsr)):
        check_close(tol, got, ref, 1e-5 * ref.abs() + 1e-6, f"{what} {name}")
    limit = TOL_FP32 if y.dtype == torch.float32 else tol.ln_limit(
        y, yr, x, w, b)
    err, ratio = check_close(tol, y, yr, limit, what)
    ms = timer(lambda: fm.fused_layernorm_arrays(x, w, b))
    plain_ms = timer(lambda: fm.fused_layernorm_reference(x, w, b))
    xl = x if pdt == dtype else x.to(y.dtype)     # F.layer_norm: one type
    lib_ms = timer(lambda: torch.nn.functional.layer_norm(
        xl, (hidden,), w, b, 1e-5))
    # x read and y written once, w and b read, mu and rstd written
    nbytes = (n * hidden * (x.element_size() + y.element_size())
              + 2 * hidden * w.element_size() + 8 * n)
    bms, by = bound_ms(nbytes, 8 * n * hidden, dtype)
    return dict(shape=f"n={n} H={hidden}", dtype=types,
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, tol=_tol_text(y.dtype, TOL_FP32),
                gb_per_s=nbytes / (ms * 1e-3) / 1e9)


def check_ln_bwd(fm, tol, timer, n, hidden, xdt, pdt, seed):
    """The LayerNorm backward kernel against its plain version: dx, dw and
    db within `tolerance.ln_bwd_limits`, and a second launch bitwise equal
    to the first (no atomics).  The yardstick is `torch.autograd.grad`
    through `F.layer_norm` (on fp32 x where x and w differ in dtype)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, hidden, generator=g) * 2 + 0.5).to("cuda", xdt)
    w = (1 + 0.1 * torch.randn(hidden, generator=g)).to("cuda", pdt)
    b = (0.1 * torch.randn(hidden, generator=g)).to("cuda", pdt)
    dy = torch.randn(n, hidden, generator=g).to(
        "cuda", torch.promote_types(xdt, pdt))
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    got = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    again = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    dtype = str(xdt) if xdt == pdt else f"x {xdt}, w/b {pdt}"
    what = f"layernorm backward n={n} H={hidden} {dtype}"
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"{what}: two launches differ")
    limits = tol.ln_bwd_limits(got, want, x, w, mu, rs, dy)
    checks = [check_close(tol, gv, wv, lim, f"{what} {name}")
              for name, gv, wv, lim in zip(("dx", "dw", "db"), got, want,
                                           limits)]
    ms = timer(lambda: fm.fused_layernorm_bwd(x, w, mu, rs, dy))
    plain_ms = timer(lambda: fm.fused_layernorm_bwd_reference(
        x, w, mu, rs, dy))
    xl = (x if xdt == pdt else x.float()).detach().requires_grad_()
    wl, bl = (t.detach().requires_grad_() for t in (w, b))
    yl = torch.nn.functional.layer_norm(xl, (hidden,), wl, bl, 1e-5)
    dyl = dy.to(yl.dtype)
    lib_ms = timer(lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl,
                                               retain_graph=True))
    # x, dy read and dx written once; w, mu, rstd read, dw, db written
    nbytes = (n * hidden * (2 * x.element_size() + dy.element_size())
              + 3 * hidden * w.element_size() + 8 * n)
    # ~14 fp32 operations per element, on the CUDA cores in every dtype
    bms, by = bound_ms(nbytes, 14 * n * hidden, torch.float32)
    return dict(shape=f"n={n} H={hidden}", dtype=dtype,
                max_abs_err=max(e for e, _ in checks),
                err_over_limit=max(r for _, r in checks), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms,
                tol=f"tol {tol.LN_BWD_COEF} of each output's magnitude"
                    + {torch.float32: "", torch.bfloat16: ", + 1 bf16 step",
                       torch.float16: ", + 1 fp16 step + 2^-24"}[xdt]
                    + ("" if xdt == torch.float32 else " of dx"
                       if pdt == torch.float32 else " of each output"))


_ACT_FN = {"gelu": torch.nn.functional.gelu,
           "gelu_tanh": lambda u: torch.nn.functional.gelu(
               u, approximate="tanh"),
           "relu": torch.relu}


def check_ffn(fm, ops, tol, timer, n, hidden, inter, act, dtype, seed):
    """The FFN against its plain version, within `tolerance.ffn_limit`
    (bf16, fp16) or 1e-5 max|ref| (fp32); a second launch bitwise equal to
    the first; both launches on the design `ffn_design` picks and counted
    under it alone (and, in fp16, its fp16 counter).  Times kernel, plain
    version and the cuBLAS composite
    ``addmm`` + activation + ``mm`` (three calls, not one: it is no
    ``library_ms``).  The fp32 bound is that of split-TF32 products on
    the tensor cores, the CUDA cores' beside it (`flash_bound`)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    args = (rnd(n, hidden), rnd(hidden, inter, scale=hidden ** -0.5),
            rnd(inter, scale=0.1), rnd(inter, hidden, scale=inter ** -0.5))
    what = f"ffn n={n} H={hidden} I={inter} {act} {dtype}"
    design = fm.ffn_design(n, hidden, inter, dtype)
    ops.reset_launch_counts()
    y = fm.fused_ffn_arrays(*args, act=act)
    again = fm.fused_ffn_arrays(*args, act=act)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    yr = fm.fused_ffn_reference(*args, act=act)
    limit = (FFN_REL_FP32 * yr.abs().max().item() if dtype == torch.float32
             else tol.ffn_limit(*args, act))
    torch.cuda.synchronize()
    want = {FFN_COUNTER[design]: 2}
    if dtype == torch.float16:
        want[FFN_COUNTER16[design]] = 2
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want} ({design} "
             f"design)")
    if not torch.equal(y, again):
        fail(f"{what}: two launches differ")
    err, ratio = check_close(tol, y, yr, limit, what)
    ms = timer(lambda: fm.fused_ffn_arrays(*args, act=act))
    plain_ms = timer(lambda: fm.fused_ffn_reference(*args, act=act))
    x, w1, b1, w2 = args
    fn = _ACT_FN[act]
    composite_ms = timer(lambda: torch.mm(fn(torch.addmm(b1, x, w1)), w2))
    item = y.element_size()
    nbytes = (2 * hidden * inter + inter + 2 * n * hidden) * item
    flops = 4 * n * hidden * inter
    return dict(shape=f"n={n} H={hidden} I={inter} {act}", dtype=str(dtype),
                design=design, max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, **flash_bound(nbytes, flops, dtype),
                library_ms=None, composite_ms=composite_ms,
                tflops=tflops(flops, ms),
                gb_per_s=nbytes / (ms * 1e-3) / 1e9,
                tol=_tol_text(dtype, f"{FFN_REL_FP32} max|ref|"))


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (7, 64, 200, 384, 700)
NEW_TOKENS = 32


@contextlib.contextmanager
def graphs_env(on):
    """Decode steps captured as CUDA graphs (``on``) or run eagerly
    (``PTPU_CUDA_GRAPHS=0``)."""
    saved = os.environ.get(GRAPHS)
    os.environ[GRAPHS] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(GRAPHS, None)
        else:
            os.environ[GRAPHS] = saved


def serve(model, prompts, device, dtype, ops=None, kv_cache_dtype=None):
    """Run the engine to completion; returns (outputs, engine, launches,
    per-kind seconds and tokens)."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine, \
        SamplingParams
    eng = LLMEngine(model, EngineConfig(
        block_size=16, max_num_seqs=8, max_num_batched_tokens=512,
        device=device, dtype=dtype, kv_cache_dtype=kv_cache_dtype))
    sp = SamplingParams(max_new_tokens=NEW_TOKENS)
    ids = [eng.add_request(p, sp) for p in prompts]
    stats = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
             "decode_tokens": 0}
    if ops is not None:
        ops.reset_launch_counts()
    while eng.has_unfinished():
        reqs = list(eng._requests.values())
        computed = sum(r.num_computed for r in reqs)
        emitted = sum(len(r.output_ids) for r in reqs)
        decodes = eng.step_counts["decode"]
        t0 = time.perf_counter()
        eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if eng.step_counts["decode"] > decodes:
            stats["decode_s"] += dt
            stats["decode_tokens"] += sum(
                len(r.output_ids) for r in reqs) - emitted
        else:
            stats["prefill_s"] += dt
            stats["prefill_tokens"] += sum(
                r.num_computed for r in reqs) - computed
    launches = ops.launch_counts() if ops is not None else None
    outs = [eng.request_output(i) for i in ids]
    for i in ids:
        eng.release_request(i)
    step = getattr(eng, "_steps", {}).get(("ragged", 8, 1))
    stats["captures"] = dict(getattr(eng, "compiles", {}))
    stats["capture_ms"] = None if step is None else step.run.capture_ms
    return outs, eng, launches, stats


def serve_turns(model, prompts, dtype, ops, kv_cache_dtype, what):
    """The engine's bf16 run eager and captured on the card: identical
    tokens, each the expected launches (replays counted), one capture in
    the captured run and none in the eager one.  Returns the captured
    run's (outputs, engine, launches, stats) and the eager run's stats."""
    runs = {}
    for turn in ("eager", "captured"):
        with graphs_env(turn == "captured"):
            runs[turn] = serve(model, prompts, "cuda", dtype, ops,
                               kv_cache_dtype)
        check_launches(runs[turn][1], runs[turn][2], f"{what} ({turn})",
                       dtype=dtype, captured=turn == "captured")
    for i, (a, b) in enumerate(zip(runs["eager"][0], runs["captured"][0])):
        if not np.array_equal(a, b):
            first = int(np.nonzero(a != b)[0][0]) if a.shape == b.shape \
                else -1
            fail(f"{what} request {i}: captured tokens differ from the "
                 f"eager run at position {first}")
    return runs["captured"], runs["eager"][3]


def device_table(prof, steps):
    """Device ms per step, device ops (kernels, copies) per step, the top
    ten by device time, and ms per step by group (the port's kernels,
    cuBLAS matrix products, everything else), from a torch.profiler run
    over `steps` steps.  Device-side events only: a host op's device time
    repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    kernels = [(ev.self_device_time_total, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(reverse=True)
    groups = {"port_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for us, _, name in kernels:
        low = name.lower()
        if any(n in name for n in PORT_SYMBOLS + PARENT_SYMBOLS):
            group = "port_kernels"
        elif any(n in low for n in ("nvjet", "gemm", "xmma", "cutlass")):
            group = "matmul"
        else:
            group = "other"
        groups[group] += us / 1e3 / steps
    return (sum(k[0] for k in kernels) / 1e3 / steps,
            sum(k[1] for k in kernels) / steps,
            [{"name": k[2][:90], "ms_per_step": k[0] / 1e3 / steps,
              "launches_per_step": k[1] / steps} for k in kernels[:10]],
            groups)


def profile_decode(model, prompts, dtype, steps=8, kv_cache_dtype=None):
    """Decode steps 3..`steps` + 2 (all prompts already prefilled; the
    first two are the captured step's warm-up and capture), run twice on
    fresh engines: once timed on the host clock alone, once under
    torch.profiler.  Returns wall ms per step both ways, the device ms per
    step and device ops (kernels, copies) per step from the profile, the
    top ones by device time, and the device's busy share of the
    unprofiled step (the profiler's own host cost lengthens its steps),
    with the engine's captures."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine, \
        SamplingParams
    wall = {}
    for profiled in (False, True):
        eng = LLMEngine(model, EngineConfig(
            block_size=16, max_num_seqs=8, max_num_batched_tokens=512,
            device="cuda", dtype=dtype, kv_cache_dtype=kv_cache_dtype))
        ids = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
               for p in prompts]
        while eng.step_counts["decode"] < 2:
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) if profiled \
                else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall[profiled] = (time.perf_counter() - t0) * 1e3 / steps
        for i in ids:
            eng.release_request(i)
    device_ms, n_ops, top, groups = device_table(prof, steps)
    return {"steps": steps, "wall_ms_per_step": wall[False],
            "profiled_wall_ms_per_step": wall[True],
            "device_busy_share": device_ms / wall[False],
            "device_ms_per_step": device_ms,
            "device_ops_per_step": n_ops, "top": top,
            "ms_per_step_by_group": groups,
            "captures": dict(getattr(eng, "compiles", {}))}


def profile_turns(profile, what, card):
    """``profile()`` (a `profile_decode` or `profile_generate`) eager and
    captured in `TURNS`; prints and returns the turns."""
    turns = []
    for turn in TURNS:
        with graphs_env(turn == "captured"):
            pr = profile()
        pr["turn"] = turn
        turns.append(pr)
        if pr["device_ms_per_step"] > 0:
            print(f"{what} {turn}: wall {pr['wall_ms_per_step']:.3f} ms a "
                  f"step ({pr['profiled_wall_ms_per_step']:.3f} under the "
                  f"profiler), device {pr['device_ms_per_step']:.3f} ms, busy "
                  f"{pr['device_busy_share']:.3f}, "
                  f"{pr['device_ops_per_step']:.1f} device ops a step, "
                  f"captures {pr['captures']} ({card}); by group (ms) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              pr["ms_per_step_by_group"].items())
                  + "; top: " + "; ".join(
                      f"{t['name'][:40]} {t['ms_per_step']:.4f} ms"
                      for t in pr["top"][:5]), flush=True)
        else:
            print(f"{what} {turn}: wall {pr['wall_ms_per_step']:.3f} ms a "
                  f"step; the profiler recorded no device time (not "
                  f"measured)", flush=True)
    return turns


def check_launches(eng, launches, what, dtype=torch.float32, captured=True):
    """One flash prefill per layer and prefill step (in bf16 the
    tensor-core kernel), one ragged launch per layer and decode or chunk
    step, of the int8 entry for int8 pools and of the fp one otherwise;
    nothing else.  The decode steps ran as one captured graph (its
    replays counted) where ``captured``, eagerly otherwise."""
    want = engine_launches(eng, dtype)
    # at a head dim the ragged kernel does not take, its gate sends every
    # decode and chunk step to the plain version
    ragged = (want[RAGGED8 if eng.kv_quant else RAGGED]
              or eng.head_dim not in (64, 128, 256))
    if launches != want or not (want[FWD] and ragged):
        fail(f"{what}: launches {launches}, expected {want} "
             f"({eng.step_counts})")
    if eng.step_counts["chunk"] != 2:
        fail(f"{what}: expected the 700-token prompt in 2 ragged chunks, "
             f"got {eng.step_counts}")
    if eng.compiles != ({"ragged": 1} if captured else {}):
        fail(f"{what}: captures {eng.compiles}, expected "
             f"{'one decode graph' if captured else 'none'}")
    return want


# ---------------------------------------------------------------------------
# phase 4: dense generate
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def flag_env(env):
    """Set the kernel flags in ``env`` and unset the other `FLAGS`."""
    saved = {k: os.environ.get(k) for k in FLAGS}
    for k in FLAGS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ffn_counter(rows, cfg, dtype):
    """The launch counter of the FFN design that ``rows`` rows of ``cfg``'s
    MLP in ``dtype`` take (`fused_mlp.ffn_design`)."""
    from paddle_tpu_torch.ops import fused_mlp as fm
    return FFN_COUNTER[fm.ffn_design(rows, cfg.hidden_size,
                                     cfg.intermediate_size, dtype)]


def check_gen_launches(launches, mode, cfg, batch, steps, what, padded=False,
                       dtype=torch.float32, prompt=None, ln_f=False):
    """One flash prefill per layer (the masked branch for padded prompts;
    in bf16 the tensor-core kernel); per decode step and layer the decode
    kernel (default) or the fused layer, LN and FFN (fused; the FFN's
    design for ``batch`` rows: the decode design); nothing else.  A padded
    default step takes the masked branch, as in JAX: no decode kernel.
    Mode "flags" (the per-layer layout under the LN and FFN flags): the
    default's launches, and per forward (the prefill of ``prompt`` rows a
    batch row, then each step) two LayerNorms a layer and ``ln_f`` and
    the FFN of each layer, the FFN on the design its rows take.  ``ln_f``:
    a stacked model under PTPU_PALLAS_LN alone, whose ``ln_f`` launches
    the LayerNorm once a forward.  At a head dim the decode kernels do
    not take (384, 512, ...) a decode step launches nothing: the decode
    gates send it to the plain path in either mode."""
    layers = cfg.num_hidden_layers
    want = dict.fromkeys(KERNELS, 0)
    want[FWD_MASK if padded else FWD] = layers
    ffn = ffn_counter(batch, cfg, dtype)
    names = (FUSED, LN, ffn) if mode == "fused" else (
        () if padded else (DECODE,))
    if cfg.hidden_size // cfg.num_attention_heads not in (64, 128, 256):
        names = ()     # the decode gates send the steps to the plain path
    for name in names:
        want[name] = layers * steps
    if mode == "flags":
        want[LN] = (2 * layers + 1) * (steps + 1)
        want[ffn] += layers * steps
        want[ffn_counter(batch * prompt, cfg, dtype)] += layers
    if ln_f:
        want[LN] = steps + 1
    with_tc(want, dtype, d=cfg.hidden_size // cfg.num_attention_heads)
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    return want


def _agreement(a, b, prompt):
    return float((a[:, prompt:] == b[:, prompt:]).float().mean())


PAD = 0


def padded_ids(rng, vocab, batch, prompt):
    """[batch, prompt] ids in 1..vocab-1, row r holding prompt - r
    (prompt // 8) real tokens; even rows right-padded, odd rows
    left-padded with PAD."""
    ids = np.full((batch, prompt), PAD, np.int32)
    for r in range(batch):
        n = prompt - r * (prompt // 8)
        toks = rng.randint(1, vocab, n)
        if r % 2:
            ids[r, prompt - n:] = toks
        else:
            ids[r, :n] = toks
    return torch.from_numpy(ids)


def gen_env(mode):
    """The kernel flags of a generate mode (`GEN_PATHS`)."""
    return TRAIN_MODES["flags"] if mode == "flags" else GEN_MODES[mode]


def _captures(model):
    return dict(getattr(model, "compiles", {}))


def generate_fp32_card_vs_cpu(ops, cfg, cfg_pl, batch=8, prompt=256,
                              new=32):
    """Greedy fp32 generate of every `GEN_PATHS` path (the stacked
    ``cfg`` and the per-layer ``cfg_pl``) on the card, its decode steps
    captured, and on the CPU (plain versions), padded paths on
    `padded_ids` with pad_token_id=PAD: the tokens must be identical, the
    card's launches (replays counted) as expected, and each path one
    capture."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    pids = padded_ids(rng, cfg.vocab_size, batch, prompt)
    models = {}
    rec, toks = {}, {}
    for path, (stacked, mode, padded) in GEN_PATHS.items():
        if stacked not in models:
            models.clear()
            models[stacked] = {dev: GPTForCausalLM(
                cfg if stacked else cfg_pl, device=dev,
                generator=torch.Generator().manual_seed(0))
                for dev in ("cuda", "cpu")}
        out, secs, launches = {}, {}, {}
        kw = {"pad_token_id": PAD} if padded else {}
        before = _captures(models[stacked]["cuda"])
        with flag_env(gen_env(mode)):
            for dev, model in models[stacked].items():
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out[dev] = model.generate((pids if padded else ids).to(dev),
                                          max_new_tokens=new, **kw).cpu()
                secs[dev] = time.perf_counter() - t0
                launches[dev] = ops.launch_counts()
        what = f"float32 generate ({path})"
        after = _captures(models[stacked]["cuda"])
        if after.get("decode", 0) != before.get("decode", 0) + 1:
            fail(f"{what}: captures {before} -> {after}, expected one")
        want = check_gen_launches(launches["cuda"], mode, cfg, batch,
                                  new - 1, what, padded, prompt=prompt)
        if set(launches["cpu"].values()) != {0}:
            fail(f"{what} on the CPU launched kernels: {launches['cpu']}")
        g, c = out["cuda"], out["cpu"]
        if g.shape != (batch, prompt + new) or g.dtype != torch.int32:
            fail(f"{what}: output {tuple(g.shape)} {g.dtype}")
        if not torch.equal(g, c):
            r, j = (int(i) for i in torch.nonzero(g != c)[0])
            fail(f"{what}: card tokens differ from the CPU run at row {r} "
                 f"position {j} (card {int(g[r, j])}, CPU {int(c[r, j])})")
        toks[path] = g
        rec[path] = {"card_s": secs["cuda"], "cpu_s": secs["cpu"],
                     "launches": launches["cuda"], "expected": want}
    for r, row in enumerate(pids):                # [pads | prompt | new]
        real = row[row != PAD]
        got = toks["stacked default padded"][r, :prompt]
        if not (torch.equal(got[prompt - len(real):], real)
                and bool((got[:prompt - len(real)] == PAD).all())):
            fail(f"float32 padded generate: row {r} is not left-aligned")
    rec["fused_vs_default_token_agreement"] = _agreement(
        toks["stacked fused"], toks["stacked default"], prompt)
    rec["padded_fused_vs_default_token_agreement"] = _agreement(
        toks["stacked fused padded"], toks["stacked default padded"],
        prompt)
    rec["batch"] = f"B={batch} prompt={prompt} new={new}"
    return rec


def profile_generate(model, ids, steps=8, pad_token_id=None):
    """Decode steps 3..`steps` + 2 after a prefill, as `generate` runs
    them (the key's static-buffer step, then greedy argmax; the first two
    steps are its warm-up and capture), twice: timed alone on the host
    clock, then under torch.profiler.  Returns wall ms per step both
    ways and the device table of the profiled window; the busy share is
    of the unprofiled step.  A tree from before the captured steps steps
    `_forward_cached` itself (unpadded only)."""
    from torch.profiler import ProfilerActivity, profile
    b, p = ids.shape
    wall = {}
    decode_step = getattr(model, "_decode_step", None)
    for profiled in (False, True):
        with torch.no_grad():
            if decode_step is None:
                caches = model.init_caches(b, p + steps + 2)
                logits = model._forward_cached(ids, caches, 0, True)

                def one(tok, i):
                    return model._forward_cached(tok[:, None], caches,
                                                 p + i, False)
            else:
                from paddle_tpu_torch.models.gpt import _left_pad
                st = decode_step(b, p + steps + 2, pad_token_id is not None)
                x, pos, mask = ids, None, None
                if pad_token_id is not None:
                    x, shift, pos, mask = _left_pad(
                        ids, pad_token_id, st.caches[0][0].shape[1])
                    st.shift.copy_(shift)
                    st.mask.copy_(mask)
                logits = model._forward_cached(x, st.caches, 0, True, pos,
                                               mask)
                st.t.fill_(p)

                def one(tok, i):
                    st.tok.copy_(tok[:, None])
                    return st.run()
            tok = torch.argmax(logits, -1)
            for i in range(2):
                tok = torch.argmax(one(tok, i), -1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) if profiled \
                    else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                for i in range(2, steps + 2):
                    tok = torch.argmax(one(tok, i), -1)
                torch.cuda.synchronize()
                wall[profiled] = (time.perf_counter() - t0) * 1e3 / steps
    device_ms, n_ops, top, groups = device_table(prof, steps)
    return {"steps": steps, "wall_ms_per_step": wall[False],
            "profiled_wall_ms_per_step": wall[True],
            "device_busy_share": device_ms / wall[False],
            "device_ms_per_step": device_ms,
            "device_ops_per_step": n_ops, "top": top,
            "ms_per_step_by_group": groups, "captures": _captures(model)}


def generate_bf16(ops, cfg, cfg_pl, card, batch=8, prompt=896, new=128):
    """bf16 generate at GPT-2's full context, every `GEN_PATHS` path
    (per-layer: ``cfg_pl``), eager and captured in `TURNS`: decode ms per
    step (the time of a prefill-only generate taken off), launches as
    expected in every turn (replays counted), captured tokens identical
    to eager ones, one capture per path (its capture ms), and a profiled
    window per path and turn kind.  Returns the record and the launches
    of each path's captured run."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32)).cuda()
    pids = padded_ids(rng, cfg.vocab_size, batch, prompt).cuda()
    models = {}
    rec, toks, path_launches = {}, {}, {}
    for path, (stacked, mode, padded) in GEN_PATHS.items():
        if stacked not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[stacked] = GPTForCausalLM(
                cfg if stacked else cfg_pl, device="cuda",
                dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0))
        model = models[stacked]
        x = pids if padded else ids
        kw = {"pad_token_id": PAD} if padded else {}
        what = f"bfloat16 generate ({path})"
        r = rec[path] = {"turns": []}
        before = _captures(model)
        with flag_env(gen_env(mode)):
            model.generate(x, max_new_tokens=3, **kw)   # warm-up, capture
            for turn in TURNS:
                with graphs_env(turn == "captured"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.generate(x, max_new_tokens=1, **kw)
                    torch.cuda.synchronize()
                    prefill_s = time.perf_counter() - t0
                    ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    out = model.generate(x, max_new_tokens=new, **kw)
                    torch.cuda.synchronize()
                    total_s = time.perf_counter() - t0
                    launches = ops.launch_counts()
                check_gen_launches(launches, mode, cfg, batch, new - 1,
                                   f"{what} {turn}", padded,
                                   dtype=torch.bfloat16,
                                   prompt=prompt)
                if out.shape != (batch, prompt + new):
                    fail(f"{what}: output {tuple(out.shape)}")
                first = toks.setdefault(path, out)     # the eager turn's
                if not torch.equal(out, first):
                    r_, j = (int(i) for i in torch.nonzero(out != first)[0])
                    fail(f"{what}: {turn} tokens differ from the eager "
                         f"run's at row {r_} position {j}")
                if turn == "captured":
                    path_launches[path] = launches
                decode_s = total_s - prefill_s
                r["turns"].append({
                    "turn": turn, "total_s": total_s,
                    "prefill_s": prefill_s,
                    "decode_ms_per_step": decode_s * 1e3 / (new - 1),
                    "decode_tok_s": batch * (new - 1) / decode_s})
            r["profile"] = {}
            for turn in ("eager", "captured"):
                with graphs_env(turn == "captured"):
                    r["profile"][turn] = profile_generate(
                        model, x, pad_token_id=kw.get("pad_token_id"))
            step = model._decode_step(batch, prompt + new, padded)
        after = _captures(model)
        if after.get("decode", 0) != before.get("decode", 0) + 1:
            fail(f"{what}: captures {before} -> {after}, expected one")
        r["capture_ms"] = step.run.capture_ms
        r["launches"] = path_launches[path]
        r["replay_launches"] = step.run.launches
        ms = {t: [x_["decode_ms_per_step"] for x_ in r["turns"]
                  if x_["turn"] == t] for t in ("eager", "captured")}
        pe, pc = r["profile"]["eager"], r["profile"]["captured"]
        print(f"{what} B={batch} {prompt}+{new}: decode ms a step eager "
              + " / ".join(f"{v:.3f}" for v in ms["eager"]) + ", captured "
              + " / ".join(f"{v:.3f}" for v in ms["captured"])
              + f"; profiled window wall {pe['wall_ms_per_step']:.3f} / "
              f"{pc['wall_ms_per_step']:.3f}, device "
              f"{pe['device_ms_per_step']:.3f} / "
              f"{pc['device_ms_per_step']:.3f} ms, busy "
              f"{pe['device_busy_share']:.3f} / "
              f"{pc['device_busy_share']:.3f} (eager / captured); 1 "
              f"capture of {r['capture_ms']:.1f} ms; tokens identical; "
              f"launches {{{', '.join(f'{k}: {n}' for k, n in r['launches'].items() if n)}}} "
              f"({card})", flush=True)
    rec["fused_vs_default_token_agreement"] = _agreement(
        toks["stacked fused"], toks["stacked default"], prompt)
    rec["padded_fused_vs_default_token_agreement"] = _agreement(
        toks["stacked fused padded"], toks["stacked default padded"],
        prompt)
    rec["per_layer_flags_vs_default_token_agreement"] = _agreement(
        toks["per-layer flags"], toks["per-layer default"], prompt)
    rec["batch"] = f"B={batch} prompt={prompt} new={new} (S_max=1024)"
    return rec, path_launches


# ---------------------------------------------------------------------------
# phases 5 and 6: training
# ---------------------------------------------------------------------------

def no_decay(name):
    """The recipe's parameters without weight decay: biases and LayerNorms
    (the port's names: per-layer ``...ln_1.weight``, ``...bias``; stacked
    ``ln1_w``, ``qkv_b``, ``lnf_b``)."""
    return "ln" in name or name.endswith(("bias", "_b"))


def make_step(model, lr=TRAIN_LR, recipe=None):
    """The JAX package's pretraining step on `model` with a fresh AdamW:
    ``model.pretrain_loss(*batch)`` -> backward -> step -> clear_grad, the
    batch ``(ids, labels)`` or the packed ``(ids, labels, loss_mask,
    segment_ids, position_ids)``.  Returns the step function, which
    returns the loss (a tensor, not synced) and fills `grads` (when given)
    with the gradients on the host in fp32, and the optimizer.

    ``recipe`` (a dict: ``steps`` the run's length, ``amp`` None or an
    `auto_cast` level, ``multi_precision``) makes it configuration A's
    recipe, GPT-3's (Brown et al. 2020, App. B): AdamW(beta2=0.95,
    weight_decay=0.1 but for biases and LayerNorms, ClipGradByGlobalNorm
    (1.0), parameters named) under LinearWarmup(CosineAnnealingDecay(lr,
    steps - RECIPE_WARMUP, eta_min=lr / 10), RECIPE_WARMUP, 0, lr), the
    schedule stepped after each step; with ``amp`` the forward runs under
    ``auto_cast(level=amp, dtype=amp_dtype)`` (``amp_dtype`` "bfloat16"
    unless the recipe names "float16") and the loss through a
    GradScaler(init_loss_scaling=2**15): ``step.scales`` gets the scale
    after each step and ``step.skipped`` each skipped step's index."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr as L
    scaler = sched = None
    if recipe is None:
        opt = AdamW(learning_rate=lr, parameters=model.parameters())
    else:
        sched = L.LinearWarmup(L.CosineAnnealingDecay(
            lr, max(recipe["steps"] - RECIPE_WARMUP, 1), eta_min=lr / 10),
            RECIPE_WARMUP, 0.0, lr)
        opt = AdamW(learning_rate=sched, beta2=0.95, weight_decay=0.1,
                    apply_decay_param_fun=lambda n: not no_decay(n),
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    parameters=model.named_parameters(),
                    multi_precision=recipe.get("multi_precision", True))
        if recipe.get("amp"):
            scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    scales, skipped = [], []

    def step(batch, grads=None):
        if scaler is None:
            loss = model.pretrain_loss(*batch)
            loss.backward()
        else:
            with amp.auto_cast(level=recipe["amp"],
                               dtype=recipe.get("amp_dtype", "bfloat16")):
                loss = model.pretrain_loss(*batch)
            scaler.scale(loss).backward()
        if grads is not None:
            grads.update({n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()})
        if scaler is None:
            opt.step()
        else:
            before = opt._step_count
            scaler.step(opt)
            if opt._step_count == before:
                skipped.append(len(scales))
            scales.append(scaler._scale)
        opt.clear_grad()
        if sched is not None:
            sched.step()
        return loss.detach()

    step.scales, step.skipped = scales, skipped
    return step, opt


def train_launches(cfg, steps, env, packed=False, dtype=torch.float32,
                   rows=1024, amp=None):
    """Expected launches of `steps` training steps of ``rows`` tokens under
    the flags `env`: each flash kernel once per layer (its segment variant
    on packed rows; in bf16 all three are the tensor-core kernels, so 12
    of each per step, in fp32 the forward and dK/dV, `:tc32`), the
    forward twice per layer of a stacked model under ``recompute``; under
    PTPU_PALLAS_LN the LayerNorm
    forward and backward once per LayerNorm layer (2L+1 per-layer, ``ln_f``
    alone stacked); under PTPU_PALLAS_FFN the FFN once per per-layer
    block (the stacked blocks keep their own MLP), of the design its rows
    and dtype take (bf16 8192 rows: the tensor cores; fp32 1024 rows: the
    CUDA cores); with dropout the keep-mask kernel once a site (the
    embeddings and two a block, and each flash output); nothing else.
    Under ``auto_cast`` (``amp`` its level)
    the LayerNorms run in fp32 (its black list), and under O2 the FFN
    gate refuses the fp32 LayerNorm output beside the cast weights, as
    the JAX gate does (``x.dtype == w1.dtype``): no FFN launch.  At
    head_dim 256 the flash launches count once more under their D = 256
    counters, and in fp32 under their CUDA-core ones (`with_tc`)."""
    layers = cfg.num_hidden_layers
    want = dict.fromkeys(KERNELS, 0)
    for name in (FWD_SEGS, DQ_SEGS, DKV_SEGS) if packed else (FWD, DQ, DKV):
        want[name] = layers * steps
    if cfg.stacked_blocks and cfg.recompute:
        want[FWD_SEGS if packed else FWD] *= 2
    if env.get("PTPU_PALLAS_LN") == "1":
        per_step = 1 if cfg.stacked_blocks else 2 * layers + 1
        want[LN] = want[LN_BWD] = per_step * steps
    if env.get("PTPU_PALLAS_FFN") == "1" and not cfg.stacked_blocks \
            and amp != "O2":
        want[ffn_counter(rows, cfg, dtype)] = layers * steps
    # dropout's keep masks: the embeddings' and two a block (hidden), the
    # flash output's (attention)
    want[THREEFRY] = steps * (
        (1 + 2 * layers if cfg.hidden_dropout_prob else 0)
        + (layers if cfg.attention_dropout_prob else 0))
    return with_tc(want, dtype, torch.float32 if amp else None,
                   d=cfg.hidden_size // cfg.num_attention_heads)


def check_train_launches(launches, want, what):
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")


def train_fp32_card_vs_cpu(ops, cfg, env, steps=3, seq=1024, packed=False,
                           recipe=False):
    """`steps` fp32 AdamW steps on the card and on the CPU under the flags
    `env`, on one random row or (``packed``) one row of packed documents;
    with ``recipe`` configuration A's optimizer, clip and schedule
    (`make_step`): losses, step-1 gradients and launches checked."""
    from paddle_tpu_torch.models import GPTForCausalLM
    if packed:
        batch = packed_batch(cfg.vocab_size, 1, seq)
    else:
        rng = np.random.RandomState(1)
        batch = tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                   (1, seq)))
                      for _ in range(2))
    runs = {}
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=device,
                               generator=torch.Generator().manual_seed(0))
        step, _ = make_step(model, recipe={"steps": steps} if recipe
                            else None)
        grads = {}
        with flag_env(env):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [step([t.to(device) for t in batch],
                           grads if i == 0 else None).item()
                      for i in range(steps)]
            runs[device] = dict(losses=losses, grads=grads,
                                launches=ops.launch_counts(),
                                seconds=time.perf_counter() - t0)
        del model
    gpu, cpu = runs["cuda"], runs["cpu"]
    check_train_launches(gpu["launches"],
                         train_launches(cfg, steps, env, packed, rows=seq),
                         "float32 training")
    if set(cpu["launches"].values()) != {0}:
        fail(f"float32 training on the CPU launched kernels: "
             f"{cpu['launches']}")
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu["losses"], cpu["losses"])]
    if not all(np.isfinite(gpu["losses"])) or rel[0] > 1e-5 \
            or rel[-1] > 1e-4:
        fail(f"float32 training: card losses {gpu['losses']} vs CPU "
             f"{cpu['losses']} (relative {rel}; limits 1e-5 at step 1, "
             f"1e-4 at step {steps})")
    grad_ratio = {}
    for name, gc in cpu["grads"].items():
        err = (gpu["grads"][name] - gc).abs().max().item()
        limit = 1e-3 * gc.abs().max().item()
        grad_ratio[name] = err / limit if limit else float(err > 0)
        if not err <= limit:
            fail(f"float32 training: step-1 gradient of {name} differs by "
                 f"{err} (limit {limit})")
    return {"steps": steps,
            "batch": f"B=1 S={seq}" + (" packed" if packed else ""),
            "card_losses": gpu["losses"], "cpu_losses": cpu["losses"],
            "loss_rel_diff": rel, "grad_err_over_limit": grad_ratio,
            "launches": gpu["launches"], "card_s": gpu["seconds"],
            "cpu_s": cpu["seconds"]}


def train_bf16(ops, cfg, env, batch=8, seq=1024, warmup=2, timed=10,
               packed=False, dtype=torch.bfloat16, recipe=None, lr=TRAIN_LR):
    """The full-size bf16 run under the flags `env`, on random rows or
    (``packed``) rows of packed documents: bf16 weights with fp32 masters,
    or ``dtype`` weights and the optimizer of ``recipe`` (`make_step`;
    with its ``amp``, O1's compute in its ``amp_dtype``, bf16 unless
    named, over fp32 weights; O2 after `amp.decorate` to that type, fp32
    masters); returns its record and the launches of all its steps."""
    from paddle_tpu_torch.models import GPTForCausalLM
    if packed:
        data = [t.cuda() for t in packed_batch(cfg.vocab_size, batch, seq)]
    else:
        rng = np.random.RandomState(2)
        data = [torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                             (batch, seq))).cuda()
                for _ in range(2)]
    model = GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                           generator=torch.Generator().manual_seed(0))
    half = dtype                    # the type the flash kernels run in
    if recipe is not None:
        recipe = dict(recipe, steps=warmup + timed)
        if recipe.get("amp"):
            from paddle_tpu_torch import amp
            half = {"bfloat16": torch.bfloat16, "float16": torch.float16}[
                recipe.get("amp_dtype", "bfloat16")]
            if recipe["amp"] == "O2":
                amp.decorate(model, level="O2", dtype=half)
                dtype = half
    step, opt = make_step(model, lr, recipe)   # fp32 masters of bf16
    with flag_env(env):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(data) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(data) for _ in range(timed)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / timed
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile_rec = profile_step(step, data)
    losses = [x.item() for x in losses]
    check_train_launches(launches,
                         train_launches(cfg, warmup + timed, env, packed,
                                        dtype=half, rows=batch * seq,
                                        amp=(recipe or {}).get("amp")),
                         f"{half} training")
    if not all(np.isfinite(losses)):
        fail(f"bfloat16 training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"bfloat16 training: loss did not fall, {losses}")
    masters = (dtype in (torch.bfloat16, torch.float16)
               and opt._multi_precision) * len(list(model.parameters()))
    if not all(p.dtype == dtype for p in model.parameters()) or \
            len(opt._master_weights) != masters:
        fail(f"bfloat16 training: params are not {dtype} with {masters} "
             f"fp32 masters")
    tokens = batch * seq
    rec = {"batch": f"B={batch} S={seq}" + (" packed" if packed else ""),
           "warmup": warmup, "timed_steps": timed, "losses": losses,
           "ms_per_step": step_ms, "tokens_per_s": tokens * 1e3 / step_ms,
           "peak_memory_gb": peak_gb, "profile": profile_rec,
           "scales": step.scales, "skipped_steps": step.skipped}
    if packed:
        trained = float(data[2].sum())
        rec.update(loss_tokens=trained,
                   loss_tokens_per_s=trained * 1e3 / step_ms,
                   segments=int(sum(len(torch.unique(r))
                                    for r in data[3].cpu())))
    return rec, launches


def profile_step(step, batch):
    """One more step timed alone, then one under torch.profiler: wall ms
    both ways, device ms, busy share, device ops, top kernels and ms by
    group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device_ms, n_ops, top, groups = device_table(prof, 1)
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_ops": n_ops, "top": top, "ms_by_group": groups}


def train_stacked_ln_step(ops, cfg, seq=1024):
    """One fp32 training step of the stacked model at B=1 under
    PTPU_PALLAS_LN=1: its ``ln_f`` launches the LayerNorm forward and
    backward once each, the blocks keep `_stacked_ln`."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(5)
    batch = [torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (1, seq))).cuda()
             for _ in range(2)]
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    step, _ = make_step(model)
    env = {"PTPU_PALLAS_LN": "1"}
    with flag_env(env):
        ops.reset_launch_counts()
        loss = step(batch).item()
        launches = ops.launch_counts()
    check_train_launches(launches, train_launches(cfg, 1, env),
                         "stacked float32 training under PTPU_PALLAS_LN=1")
    if not np.isfinite(loss):
        fail(f"stacked training under PTPU_PALLAS_LN=1: loss {loss}")
    return {"loss": loss, "launches": launches, "batch": f"B=1 S={seq}"}


def entry_autograd_card_vs_cpu(ops, b=8, s=896, h=12, d=64):
    """fp32 gradients of q, k and v through `flash_attention_arrays` on the
    card (the variant kernels) against the same calls on the CPU (the plain
    forward and backward): non-causal, the pad mask (`variant_inputs`:
    its pad queries have every key masked) and kv_lens, at the padded
    prefill's shape, each gradient within 1e-4 max|ref| (`BWD_REL_FP32`).
    Returns the record and the launches of the three card calls."""
    kinds = ("nc", "pad", "lens")
    inputs = {kind: variant_inputs(kind, b, s, h, d, torch.float32, 11)
              for kind in kinds}

    def grads(kind, dev):
        q, k, v, do, causal, mask, lens, _ = inputs[kind]
        qt, kt, vt = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        out = ops.flash_attention_arrays(
            qt, kt, vt, None if mask is None else mask.to(dev), causal,
            kv_lens=None if lens is None else lens.to(dev))
        out.backward(do.to(dev))
        return [t.grad.cpu() for t in (qt, kt, vt)]

    ops.reset_launch_counts()
    card = {kind: grads(kind, "cuda") for kind in kinds}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update({FWD_NC: 1, DQ_NC: 1, DKV_NC: 1, FWD_MASK: 2, DQ_MASK: 2,
                 DKV_MASK: 2})
    with_tc(want, torch.float32)
    if launches != want:
        fail(f"entry-point autograd: launches {launches}, expected {want}")
    rec = {"batch": f"B={b} S={s} H={h} D={d}", "launches": launches}
    for kind in kinds:
        ratios = {}
        for what, g, r in zip(("dq", "dk", "dv"), card[kind],
                              grads(kind, "cpu")):
            err = (g - r).abs().max().item()
            limit = BWD_REL_FP32 * r.abs().max().item()
            if not err <= limit:
                fail(f"entry-point autograd {kind}: {what} differs from the "
                     f"CPU run by {err} (limit {limit})")
            ratios[what] = err / limit
        rec[kind] = ratios
    return rec, launches


def ffn_entry_card_vs_cpu(ops, n=1024, hidden=768, inter=FFN_ODD_INTER):
    """fp32 gradients of x, w1, b1 and w2 through `fused_ffn_arrays`
    (gelu_tanh) at an intermediate width off 128 -- the CUDA-core design's
    rows, which no GPT-2 path reaches (`maybe_fused_ffn` gates on widths of
    128) -- on the card against the CPU, each within 1e-4 max|ref|, one
    launch of the CUDA-core design.  Returns the record and the card's
    launches."""
    from paddle_tpu_torch.ops import fused_mlp as fm
    g = torch.Generator().manual_seed(17)
    ins = (torch.randn(n, hidden, generator=g),
           torch.randn(hidden, inter, generator=g) * hidden ** -0.5,
           torch.randn(inter, generator=g) * 0.1,
           torch.randn(inter, hidden, generator=g) * inter ** -0.5)
    dy = torch.randn(n, hidden, generator=g)
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).requires_grad_() for t in ins]
        ops.reset_launch_counts()
        fm.fused_ffn_arrays(*ts, "gelu_tanh").backward(dy.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        grads[dev] = [t.grad.cpu() for t in ts]
    want = dict.fromkeys(KERNELS, 0)
    want[FFN] = 1
    if launches != want:
        fail(f"entry-point FFN autograd: launches {launches}, expected "
             f"{want}")
    ratios = {}
    for name, gc, gr in zip(("dx", "dw1", "db1", "dw2"), grads["cuda"],
                            grads["cpu"]):
        err = (gc - gr).abs().max().item()
        limit = BWD_REL_FP32 * gr.abs().max().item()
        if not err <= limit:
            fail(f"entry-point FFN autograd: {name} differs from the CPU "
                 f"run by {err} (limit {limit})")
        ratios[name] = err / limit
    return {"shape": f"n={n} H={hidden} I={inter}",
            "grad_err_over_limit": ratios, "launches": launches}, launches


# ---------------------------------------------------------------------------
# phase 9: the training recipe
# ---------------------------------------------------------------------------

def train_recompute_card(ops, cfg, steps=3, seq=1024):
    """The stacked fp32 model under the recipe with ``recompute`` against
    without, on the card, B=1: losses of `steps` steps and the step-1
    gradients, expected bitwise equal (the same kernels on the same
    inputs), held at least to phase 5's limits; launches (the forward
    twice a layer under recompute) and the peak memory each adds to what
    was allocated before it (the weights included)."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(1)
    batch = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq)))
             .cuda() for _ in range(2)]
    runs = {}
    for rc in (False, True):
        c = dataclasses.replace(cfg, recompute=rc)
        model = GPTForCausalLM(c, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        step, _ = make_step(model, recipe={"steps": steps})
        grads = {}
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = [step(batch, grads if i == 0 else None).item()
                  for i in range(steps)]
        runs[rc] = dict(losses=losses, grads=grads,
                        launches=ops.launch_counts(),
                        peak_gb=(torch.cuda.max_memory_allocated() - base)
                        / 1e9)
        check_train_launches(runs[rc]["launches"],
                             train_launches(c, steps, {}),
                             f"float32 stacked recipe, recompute={rc}")
        del model, step
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    loss_diff = max(abs(a - b) for a, b in zip(on["losses"], off["losses"]))
    grad_diff, grad_ratio = 0.0, 0.0
    for name, g in off["grads"].items():
        err = (on["grads"][name] - g).abs().max().item()
        grad_diff = max(grad_diff, err)
        grad_ratio = max(grad_ratio, err / (1e-3 * g.abs().max().item()
                                            or 1.0))
    rel = [abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"])]
    if not (np.isfinite(on["losses"]).all() and rel[0] <= 1e-5
            and rel[-1] <= 1e-4 and grad_ratio <= 1.0):
        fail(f"recompute against none: losses {on['losses']} vs "
             f"{off['losses']}, step-1 gradients {grad_ratio:.3g} of 1e-3 "
             f"max|g|")
    return {"batch": f"B=1 S={seq}", "steps": steps,
            "losses_recompute": on["losses"], "losses": off["losses"],
            "max_loss_diff": loss_diff, "max_grad_diff": grad_diff,
            "bitwise": loss_diff == 0.0 and grad_diff == 0.0,
            "launches_recompute": on["launches"], "launches": off["launches"],
            "peak_gb_recompute": on["peak_gb"], "peak_gb": off["peak_gb"]}


def dropout_sites(ops, cfg, batch=2, seq=1024):
    """Configuration A's dropout on the card, apart from the timed run: one
    forward of the per-layer model in training mode under O1, each site's
    keep mask recorded (1 + 3 per layer); its kept fraction must lie within
    5 sigma of 0.9 (sigma = sqrt(0.9 * 0.1 / n) over the n entries of the
    mask).  Then the logits with dropout 0 in training mode against the
    dropout model in eval mode: bitwise equal (p = 0 and eval draw
    nothing)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn import functional as PF
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                           ).cuda()
    keep_mask, masks = PF._keep_mask, []

    def spy(shape, keep, device, generator=None):
        m = keep_mask(shape, keep, device, generator)
        masks.append((m.float().mean(), m.numel(), keep))
        return m
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    zero = GPTForCausalLM(dataclasses.replace(
        cfg, hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
        device="cuda", generator=torch.Generator().manual_seed(0))
    with flag_env(TRAIN_MODES["flags"]), torch.no_grad(), \
            amp.auto_cast(level="O1", dtype="bfloat16"):
        PF._keep_mask = spy
        try:
            model(ids)
        finally:
            PF._keep_mask = keep_mask
        model.eval()
        same = torch.equal(model(ids), zero(ids))
    sites = []
    for kept, n, keep in masks:
        sigma = (keep * (1 - keep) / n) ** 0.5
        sites.append({"kept": kept.item(), "n": n,
                      "sigmas": (kept.item() - keep) / sigma})
    if len(sites) != 1 + 3 * cfg.num_hidden_layers:
        fail(f"dropout: {len(sites)} sites drew, expected "
             f"{1 + 3 * cfg.num_hidden_layers}")
    worst = max(abs(x["sigmas"]) for x in sites)
    if worst > 5:
        fail(f"dropout: a site kept a fraction {worst:.2f} sigma from 0.9")
    if not same:
        fail("dropout: eval-mode logits differ from p = 0's")
    del model, zero
    torch.cuda.empty_cache()
    return {"sites": sites, "max_abs_sigmas": worst,
            "p0_bitwise_eval": same, "batch": f"B={batch} S={seq}"}


def step_memory(model, opt, batch):
    """One more step with its peak memory split: through the forward and
    backward, then in the optimizer step, each beside what was allocated
    when it began (GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model.pretrain_loss(*batch).backward()
    backward = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.cuda.memory_allocated()
    opt.step()
    opt.clear_grad()
    return {"before_step_gb": before / 1e9,
            "forward_backward_peak_gb": backward / 1e9,
            "before_update_gb": grads / 1e9,
            "update_peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def timed_steps(ops, step, data, warmup, timed):
    """``warmup`` then ``timed`` steps of `step` on ``data``, the launch
    counts reset before them: (losses, ms a timed step on the host clock
    after a sync, the launches, peak GB, GB allocated before)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    losses = [step(data) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(data) for _ in range(timed)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    return ([x.item() for x in losses], step_ms, ops.launch_counts(),
            torch.cuda.max_memory_allocated() / 1e9, before / 1e9)


def train_1p3b(ops, warmup=2, timed=5, batch=2, seq=2048):
    """Configuration B: GPT-3 1.3B stacked, bf16 weights and AdamW moments
    (``multi_precision=False``), the recipe at lr 2e-4, B=2 S=2048 (the
    JAX bench's settings), ``ln_f`` under PTPU_PALLAS_LN, without and then
    with ``recompute`` from the same weights and batch: losses finite,
    step-1 losses equal, launches as `train_launches` (recompute: the
    flash forward twice a layer), ms per step, tokens/s and peak memory of
    each, beside what was allocated before the run (the weights and what
    earlier phases keep); then one more step's peaks (`step_memory`)."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    cfg = gpt3_1p3b_config(stacked_blocks=True)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    rng = np.random.RandomState(3)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(2)]
    env = TRAIN_MODES["flags"]
    recs = {}
    for rc in (False, True):
        model.cfg = dataclasses.replace(cfg, recompute=rc)
        if rc:
            model.load_params(init)
        step, opt = make_step(model, RECIPE_LR_1P3B,
                              {"steps": warmup + timed,
                               "multi_precision": False})
        with flag_env(env):
            losses, step_ms, launches, peak_gb, base_gb = timed_steps(
                ops, step, data, warmup, timed)
            weights_gb = sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9
            split = step_memory(model, opt, data)
        check_train_launches(launches, train_launches(
            model.cfg, warmup + timed, env, dtype=torch.bfloat16,
            rows=batch * seq),
            f"GPT-3 1.3B training, recompute={rc}")
        if not all(np.isfinite(losses)) or opt._master_weights:
            fail(f"GPT-3 1.3B training, recompute={rc}: losses {losses}, "
                 f"{len(opt._master_weights)} masters")
        recs[rc] = {"losses": losses, "ms_per_step": step_ms,
                    "tokens_per_s": batch * seq * 1e3 / step_ms,
                    "peak_memory_gb": peak_gb,
                    "before_run_gb": base_gb, "weights_gb": weights_gb,
                    "step_memory": split, "launches": launches}
        del step, opt
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    first = (recs[True]["losses"][0], recs[False]["losses"][0])
    if abs(first[0] - first[1]) > 1e-5 * abs(first[1]):
        fail(f"GPT-3 1.3B: step-1 loss with recompute {first[0]}, "
             f"without {first[1]}")
    return {"batch": f"B={batch} S={seq}", "warmup": warmup,
            "timed_steps": timed, "recompute": recs[True],
            "no_recompute": recs[False],
            "step1_bitwise": first[0] == first[1]}


# ---------------------------------------------------------------------------
# phase 10: the high-level Model API
# ---------------------------------------------------------------------------

# the timed fit: train batches (one epoch), the first of them warm-up,
# eval batches
FIT_STEPS, FIT_WARMUP, FIT_EVAL = 12, 2, 2
# the checkpoints phase 10 writes, removed at its end
FIT_DIR = os.path.join("chiprun_out", "fit_checkpoints")


def step_log(ops):
    """A `hapi` callback that keeps each train step's loss, the time it
    ended (`Model.train_batch` reads the loss back, so the card is done)
    and the launch counts then."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepLog(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.ends, self.launches = [], [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.ends.append(time.perf_counter())
            self.launches.append(ops.launch_counts())

    return StepLog()


def step_launches(log):
    """The launches of each logged step (counts reset before the run)."""
    prev = dict.fromkeys(log.launches[0], 0)
    out = []
    for counts in log.launches:
        out.append({k: counts[k] - prev[k] for k in counts})
        prev = counts
    return out


def forward_launches(cfg, env, dtype, rows):
    """One forward of the per-layer model of ``rows`` tokens under the
    flags `env`: a flash forward a layer, 2L+1 LayerNorm forwards and an
    FFN a layer (the design its rows take)."""
    layers = cfg.num_hidden_layers
    want = dict.fromkeys(KERNELS, 0)
    want[FWD] = layers
    if env.get("PTPU_PALLAS_LN") == "1":
        want[LN] = 2 * layers + 1
    if env.get("PTPU_PALLAS_FFN") == "1":
        want[ffn_counter(rows, cfg, dtype)] = layers
    return with_tc(want, dtype)


def fit_model(cfg, device, dtype, lr=TRAIN_LR):
    """A per-layer GPT from seed 0 in a prepared `Model`: AdamW (fp32
    masters of bf16 weights) and `GPTPretrainingCriterion`, as
    `make_step`'s optimizer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    net = GPTForCausalLM(cfg, device=device, dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    model = pt.Model(net)
    model.prepare(AdamW(learning_rate=lr, parameters=net.parameters()),
                  GPTPretrainingCriterion())
    return model


def fit_fp32_card_vs_cpu(ops, cfg, batch=2, seq=256, steps=2):
    """`Model.fit` of ``steps`` fp32 batches (B=``batch``, S=``seq``) on
    the card and on the CPU from the same weights and batches, under the
    LN and FFN flags: losses within phase 5's limits, each card step's
    launches one training step's, none on the CPU."""
    from paddle_tpu_torch import io
    env = TRAIN_MODES["flags"]
    rng = np.random.RandomState(7)
    rows = [rng.randint(0, cfg.vocab_size, (batch * steps, seq))
            for _ in range(2)]
    runs = {}
    for device in ("cuda", "cpu"):
        model = fit_model(cfg, device, torch.float32)
        log = step_log(ops)
        with flag_env(env):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            model.fit(io.TensorDataset(rows), batch_size=batch, epochs=1,
                      shuffle=False, verbose=0, callbacks=[log])
            runs[device] = dict(losses=log.losses, log=log,
                                seconds=time.perf_counter() - t0)
        del model
    gpu, cpu = runs["cuda"], runs["cpu"]
    want = train_launches(cfg, 1, env, rows=batch * seq)
    for i, got in enumerate(step_launches(gpu["log"])):
        check_train_launches(got, want, f"float32 fit, step {i + 1}")
    if set(cpu["log"].launches[-1].values()) != {0}:
        fail(f"float32 fit on the CPU launched kernels: "
             f"{cpu['log'].launches[-1]}")
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu["losses"], cpu["losses"])]
    if len(rel) != steps or not all(np.isfinite(gpu["losses"])) \
            or rel[0] > 1e-5 or rel[-1] > 1e-4:
        fail(f"float32 fit: card losses {gpu['losses']} vs CPU "
             f"{cpu['losses']} (relative {rel}; limits 1e-5 at step 1, "
             f"1e-4 at step {steps})")
    return {"batch": f"B={batch} S={seq}", "steps": steps,
            "card_losses": gpu["losses"], "cpu_losses": cpu["losses"],
            "loss_rel_diff": rel, "launches_per_step": want,
            "card_s": gpu["seconds"], "cpu_s": cpu["seconds"]}


def bare_turn(step, data, warmup=FIT_WARMUP, timed=FIT_STEPS - FIT_WARMUP):
    """ms per step of the bare training step (`make_step`), timed after
    ``warmup`` steps with the host clock between syncs."""
    for _ in range(warmup):
        step(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step(data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / timed


def fit_turn(ops, model, dataset, eval_data=None, callbacks=()):
    """One epoch of `Model.fit` on ``dataset`` (batch 8, in order): its
    ms per train step after `FIT_WARMUP` steps, from the steps' end
    times, and the step log."""
    log = step_log(ops)
    model.fit(dataset, eval_data, batch_size=8, epochs=1, shuffle=False,
              verbose=0, callbacks=[log, *callbacks])
    ends = log.ends
    ms = (ends[-1] - ends[FIT_WARMUP - 1]) * 1e3 / (len(ends) - FIT_WARMUP)
    return ms, log


def train_stats_cost(step, data, steps=8):
    """ms of steps sampled by ``PTPU_TRAIN_STATS`` (every second step)
    against those not sampled, each step synced alone; medians."""
    from paddle_tpu_torch.monitor import train as mtrain
    saved = os.environ.get("PTPU_TRAIN_STATS_EVERY")
    os.environ["PTPU_TRAIN_STATS_EVERY"] = "2"
    mtrain.enable(True)
    try:
        times, sampled = [], []
        for _ in range(steps):
            before = mtrain.layer_stats()[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            sampled.append(mtrain.layer_stats()[1] != before)
    finally:
        mtrain.enable(False)
        mtrain.reset()
        if saved is None:
            os.environ.pop("PTPU_TRAIN_STATS_EVERY")
        else:
            os.environ["PTPU_TRAIN_STATS_EVERY"] = saved
    on = [t for t, s in zip(times, sampled) if s]
    off = [t for t, s in zip(times, sampled) if not s]
    if len(on) != steps // 2 or len(off) != steps - steps // 2:
        fail(f"PTPU_TRAIN_STATS sampled {sampled}, expected every second "
             f"step")
    return {"sampled_ms": statistics.median(on),
            "unsampled_ms": statistics.median(off), "steps": steps,
            "all_ms": times}


def telemetry_host_us():
    """Host µs of one step's telemetry hooks (`Model`'s three perf
    segments, the optimizer's counter, gauge and gates), gates off and
    on."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import perf as mperf
    from paddle_tpu_torch.monitor import train as mtrain

    def hooks():
        for name in ("forward", "backward", "optimizer"):
            with mperf.segment("train", name) as s:
                s.sync()
        monitor.counter("optimizer/steps").inc()
        monitor.gauge("optimizer/lr").set(1e-4)
        mtrain.enabled()
        monitor.enabled()
    out = {}
    for on in (False, True):
        monitor.enable(on)
        mperf.enable(on)
        out["on" if on else "off"] = host_us(hooks, calls=2000, warmup=200)
    mperf.enable(False)
    mperf.reset()
    monitor.enable(True)
    return out


def fit_phase(ops, cfg, card):
    """Phase 10 (module docstring): `Model.fit` of the per-layer GPT-2 124M
    under the LN and FFN flags.  Returns its record and the launches of
    the bf16 fit turn (train and eval)."""
    import shutil

    from paddle_tpu_torch import io, monitor
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
    env = TRAIN_MODES["flags"]
    rec = {"fp32": fit_fp32_card_vs_cpu(ops, cfg)}
    torch.cuda.empty_cache()
    # bf16: phase 6's repeated batch, as dataset rows in fit's order
    rng = np.random.RandomState(2)
    data = [rng.randint(0, cfg.vocab_size, (8, 1024)) for _ in range(2)]
    train = io.TensorDataset([np.tile(d, (FIT_STEPS, 1)) for d in data])
    evals = io.TensorDataset([np.tile(d, (FIT_EVAL, 1)) for d in data])
    card_data = [torch.from_numpy(d).cuda() for d in data]
    with flag_env(env):
        bare = fit_model(cfg, "cuda", torch.bfloat16).network
        step, _ = make_step(bare)
        fit = fit_model(cfg, "cuda", torch.bfloat16)
        turns = {"bare": [bare_turn(step, card_data)]}
        monitor.enable(True)
        monitor.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fit_ms, log = fit_turn(ops, fit, train, evals,
                               [ModelCheckpoint(save_freq=FIT_STEPS,
                                                save_dir=FIT_DIR)])
        fit_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        snap = monitor.snapshot()
        turns["fit"] = [fit_ms, fit_turn(ops, fit, train)[0]]
        turns["bare"].append(bare_turn(step, card_data))
        # save -> a new Model -> load -> predict: the same logits
        probe = [d[:2, :128] for d in data[:1]]
        (before,) = fit.predict_batch(probe)
        fit.save(os.path.join(FIT_DIR, "probe"))
        again = fit_model(cfg, "cuda", torch.bfloat16)   # seed-0 weights
        again.load(os.path.join(FIT_DIR, "probe"))
        (after,) = again.predict_batch(probe)
        stats = train_stats_cost(step, card_data)
    files = sorted(os.listdir(FIT_DIR))
    shutil.rmtree(FIT_DIR)
    del bare, step, fit, again
    torch.cuda.empty_cache()
    losses = log.losses
    if len(losses) != FIT_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        fail(f"bfloat16 fit: losses {losses} (finite and falling expected)")
    want = train_launches(cfg, 1, env, dtype=torch.bfloat16, rows=8 * 1024)
    per_step = step_launches(log)
    for i, got in enumerate(per_step):
        check_train_launches(got, want, f"bfloat16 fit, step {i + 1}")
    eval_want = {k: FIT_EVAL * n for k, n in
                 forward_launches(cfg, env, torch.bfloat16, 8 * 1024).items()}
    eval_got = {k: launches[k] - log.launches[-1][k] for k in launches}
    check_train_launches(eval_got, eval_want, "bfloat16 fit's evaluation")
    if files != ["final.pdopt", "final.pdparams", "probe.pdopt",
                 "probe.pdparams"]:
        fail(f"bfloat16 fit: checkpoints {files}")
    if before.dtype != np.float32 or not np.array_equal(before, after):
        fail(f"bfloat16 fit: logits after save / load differ by "
             f"{np.abs(before - after).max()}")
    goodput = snap.get("train/goodput_examples_per_s", 0.0)
    if not goodput > 0:
        fail(f"bfloat16 fit: no goodput recorded ({snap})")
    rec.update(
        batch="B=8 S=1024", steps=FIT_STEPS, eval_batches=FIT_EVAL,
        losses=losses, fit_s=fit_s, ms_per_step=turns,
        fit_minus_bare_ms=(statistics.mean(turns["fit"])
                           - statistics.mean(turns["bare"])),
        launches_per_step=per_step[-1], eval_launches=eval_got,
        goodput_examples_per_s=goodput,
        data_wait_frac=snap.get("train/data_wait_frac"),
        step_time_s=snap.get("train/step_time"),
        checkpoints=files, predict_after_load_bitwise=True,
        train_stats=stats, telemetry_host_us=telemetry_host_us())
    return rec, launches


# ---------------------------------------------------------------------------
# phase 11: serving completeness
# ---------------------------------------------------------------------------

# seeded sampling: temperature, top-k, top-p of phase 11's sampling rows
SERVE_SAMPLE = {"do_sample": True, "temperature": 0.8, "top_k": 50,
                "top_p": 0.95}
SEEDED_LENS = (7, 64, 200, 384)
# the distinct-token prompts of the spec runs (no draft at their first
# decode step, so both the plain and the verify step run)
SPEC_LENS = (7, 32, 64, 100, 128, 200, 256, 384)
SPEC_K = 4
# verify-shape rows of the kernel phase: (kv_len after the write, 1 + the
# row's drafts), 0-4 drafts, one padding row
VERIFY_ROWS = [(1024, 5), (700, 4), (513, 3), (384, 2), (200, 1),
               (64, 5), (7, 3), None]


def engine11(model, device, dtype, **kw):
    """Phase 11's engine: block 16, 8 sequences, whole prompts a step."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    return LLMEngine(model, EngineConfig(block_size=16, max_num_seqs=8,
                                         device=device, dtype=dtype, **kw))


def run_steps(eng, prompts, params):
    """Run requests to completion a step at a time (each step synced on
    the card).  Returns the outputs and the run's record: wall seconds,
    prefill seconds and the prompt tokens prefill computed (adopted
    prefix tokens not counted), decode seconds, steps (verify steps
    apart) and the tokens they emitted, and each request's first-token
    ms from the start."""
    cuda = eng.device.type == "cuda"
    ids = [eng.add_request(p, sp) for p, sp in zip(prompts, params)]
    st = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
          "decode_steps": 0, "verify_steps": 0, "decode_tokens": 0}
    first = {}
    t_start = time.perf_counter()
    while eng.has_unfinished():
        reqs = [eng._requests[i] for i in ids]
        computed = sum(r.num_computed for r in reqs)
        emitted = sum(len(r.output_ids) for r in reqs)
        hits = eng.cache.prefix_hit_tokens
        decodes, verifies = eng.step_counts["decode"], eng.verify_steps
        t0 = time.perf_counter()
        eng.step()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if eng.step_counts["decode"] > decodes:
            st["decode_s"] += t1 - t0
            st["decode_steps"] += 1
            st["verify_steps"] += eng.verify_steps - verifies
            st["decode_tokens"] += sum(len(r.output_ids)
                                       for r in reqs) - emitted
        else:
            st["prefill_s"] += t1 - t0
            st["prefill_tokens"] += (sum(r.num_computed for r in reqs)
                                     - computed
                                     - (eng.cache.prefix_hit_tokens - hits))
        for i, r in zip(ids, reqs):
            if i not in first and r.output_ids:
                first[i] = (t1 - t_start) * 1e3
    st["wall_s"] = time.perf_counter() - t_start
    st["first_token_ms"] = [first[i] for i in ids]
    outs = [eng.request_output(i) for i in ids]
    for i in ids:
        eng.release_request(i)
    return outs, st


def same_tokens(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None or x.shape != y.shape \
                or not np.array_equal(x, y):
            first = (int(np.nonzero(x != y)[0][0])
                     if x is not None and y is not None
                     and x.shape == y.shape else -1)
            fail(f"{what}: request {i} differs at position {first}")


def agreement(a, b, prompts):
    """Fraction of generated tokens that agree."""
    return float(np.mean([float((x[len(p):] == y[len(p):]).mean())
                          for x, y, p in zip(a, b, prompts)]))


def graph_ms(step, reps=20):
    """Device ms of one replay of a captured step (`StepGraph`), CUDA
    events around ``reps`` replays after three."""
    g = step.run.graph
    if g is None:
        fail(f"{step.KIND} step was never captured")
    for _ in range(3):
        g.replay()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def sampler_ms(eng, vocab, sample, reps=20):
    """Host ms of the engine's sampler over eight rows of random fp32
    logits [8, vocab] (it ends in a copy of the tokens to the host):
    seeded sampling rows (threefry over 8 x vocab values) or greedy
    rows."""
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.serving.scheduler import Request
    logits = torch.randn(8, vocab, generator=torch.Generator().manual_seed(
        1)).cuda() * 3
    rows = []
    for i in range(8):
        sp = (SamplingParams(seed=i, **SERVE_SAMPLE) if sample
              else SamplingParams())
        r = Request(i, [1], sp)
        r.key = eng._init_key(sp)
        rows.append(r)
    times = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._sample_tokens(rows, logits)
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serving_phase(ops, card):
    """Phase 11 (module docstring): serving completeness at GPT-2 124M.
    Returns its record and the launches of the phase."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.serving import SamplingParams
    cfg = gpt2_124m_config(stacked_blocks=True)
    v = cfg.vocab_size
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(11)
    rec = {}
    ops.reset_launch_counts()

    # (a) float32: seeded sampling, card against CPU and solo generate
    prompts = [rng.randint(0, v, (n,)).astype(np.int32) for n in SEEDED_LENS]
    params = [SamplingParams(max_new_tokens=NEW_TOKENS, seed=7 + i,
                             **SERVE_SAMPLE) for i in range(len(prompts))]
    card_out = engine11(model, "cuda", f32).generate(prompts, params)
    cpu_out = engine11(model, "cpu", f32).generate(prompts, params)
    same_tokens(card_out, cpu_out, "phase 11 seeded fp32, card vs CPU")
    dense = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    solo = [dense.generate(torch.from_numpy(p[None]).cuda(),
                           max_new_tokens=NEW_TOKENS, seed=7 + i,
                           **SERVE_SAMPLE)[0].cpu().numpy()
            for i, p in enumerate(prompts)]
    same_tokens(card_out, solo, "phase 11 seeded fp32, engine vs solo "
                "generate(seed=7+i)")
    del dense
    print(f"serving fp32 seeded sampling (T 0.8, top-k 50, top-p 0.95, "
          f"seeds 7-10, prompts {SEEDED_LENS}, {NEW_TOKENS} new): card "
          f"tokens equal the CPU engine's and each row its solo dense "
          f"generate(seed)", flush=True)

    # prefix caching: a 256-token shared prefix, tails of 8-72
    shared = rng.randint(0, v, (256,)).astype(np.int32)
    tails = np.linspace(8, 72, 8).astype(int)
    pre = [np.concatenate([shared, rng.randint(0, v, (t,)).astype(np.int32)])
           for t in tails]
    sp = SamplingParams(max_new_tokens=16)
    off = engine11(model, "cuda", f32).generate(pre, sp)
    eng = engine11(model, "cuda", f32, enable_prefix_caching=True)
    on = eng.generate(pre, sp)
    same_tokens(on, off, "phase 11 prefix caching fp32, on vs off")
    c = eng.cache
    if c.prefix_hit_tokens != 7 * 256 or c.prefix_hits != 7:
        fail(f"phase 11 prefix caching: {c.prefix_hits} hits, "
             f"{c.prefix_hit_tokens} hit tokens, expected 7 and 7 x 256")
    if eng.compiles != {"ragged": 1}:
        fail(f"phase 11 prefix caching: captures {eng.compiles}")
    rec["prefix_fp32"] = {"hits": c.prefix_hits,
                          "hit_tokens": c.prefix_hit_tokens,
                          "parked_blocks": c.num_parked_blocks,
                          "blocks_in_use": c.blocks_in_use}
    print(f"serving fp32 prefix caching (8 requests, 256-token shared "
          f"prefix, tails {tails.tolist()}, 16 new): tokens equal with it "
          f"off; {c.prefix_hits} hits, {c.prefix_hit_tokens} hit tokens, "
          f"{c.num_parked_blocks} parked blocks at idle", flush=True)

    # speculative decoding, k = 4: greedy, fp32 and int8 pools
    perm = rng.permutation(v).astype(np.int32)
    spec_prompts = [np.roll(perm, 97 * i)[:n] for i, n in enumerate(SPEC_LENS)]
    sp = SamplingParams(max_new_tokens=64)
    rec["spec_fp32"] = {}
    for kv in (None, "int8"):
        plain = engine11(model, "cuda", f32, kv_cache_dtype=kv).generate(
            spec_prompts, sp)
        eng = engine11(model, "cuda", f32, kv_cache_dtype=kv,
                       speculative_tokens=SPEC_K)
        spec = eng.generate(spec_prompts, sp)
        # a sampling row never drafts: its steps take the plain step
        eng.generate(spec_prompts[:1], SamplingParams(
            max_new_tokens=4, seed=1, **SERVE_SAMPLE))
        agree = agreement(spec, plain, spec_prompts)
        if kv is None:
            same_tokens(spec, plain, "phase 11 spec fp32, k=4 vs off")
        elif agree < 0.9:
            fail(f"phase 11 spec int8: agreement {agree} with plain int8 "
                 "decoding, below JAX's 0.9")
        if eng.compiles != {"ragged": 1, "verify": 1}:
            fail(f"phase 11 spec {kv}: captures {eng.compiles}, expected "
                 "one ragged and one verify")
        rate = eng._spec_accepted_total / max(eng._spec_proposed_total, 1)
        rec["spec_fp32"][kv or "fp"] = {
            "proposed": eng._spec_proposed_total,
            "accepted": eng._spec_accepted_total, "accept_rate": rate,
            "verify_steps": eng.verify_steps,
            "decode_steps": eng.step_counts["decode"],
            "agreement_with_plain": agree, "captures": dict(eng.compiles)}
        print(f"serving fp32 spec decoding k={SPEC_K}, {kv or 'fp'} pools "
              f"(8 greedy prompts {SPEC_LENS}, 64 new): "
              + ("tokens equal spec off" if kv is None else
                 f"{agree:.4f} of the tokens agree with spec off")
              + f"; accept rate {rate:.4f} ({eng._spec_accepted_total}/"
              f"{eng._spec_proposed_total}), {eng.verify_steps} verify of "
              f"{eng.step_counts['decode']} decode steps; captures "
              f"{eng.compiles}", flush=True)

    # fork: three seeded children of a 200-token prompt
    prompt = rng.randint(0, v, (200,)).astype(np.int32)
    greedy = SamplingParams(max_new_tokens=NEW_TOKENS)
    [solo_parent] = engine11(model, "cuda", f32).generate([prompt], greedy)
    eng = engine11(model, "cuda", f32)
    parent = eng.add_request(prompt, greedy)
    eng.step()
    kids = [eng.fork_request(parent, SamplingParams(
        max_new_tokens=NEW_TOKENS, seed=20 + j, **SERVE_SAMPLE))
        for j in range(3)]
    while eng.has_unfinished():
        eng.step()
    got = eng.request_output(parent)
    kid_out = [eng.request_output(k) for k in kids]
    same_tokens([got], [solo_parent], "phase 11 fork: the parent")
    unshared = 4 * eng.cache.blocks_needed(len(prompt) + 1 + NEW_TOKENS)
    peak = eng.cache.peak_blocks_in_use
    if peak >= unshared or any(len(k) != len(prompt) + 1 + NEW_TOKENS
                               for k in kid_out):
        fail(f"phase 11 fork: peak {peak} blocks (unshared {unshared}), "
             f"children {[len(k) for k in kid_out]}")
    rec["fork_fp32"] = {"peak_blocks": peak, "unshared_blocks": unshared}
    print(f"serving fp32 fork: parent of 200 tokens equal to an unforked "
          f"run; three seeded children; peak {peak} blocks against "
          f"{unshared} unshared", flush=True)

    # export / adopt after 8 tokens, greedy and seeded
    mig = [rng.randint(0, v, (n,)).astype(np.int32) for n in (100, 150)]
    params = [SamplingParams(max_new_tokens=NEW_TOKENS),
              SamplingParams(max_new_tokens=NEW_TOKENS, seed=5,
                             **SERVE_SAMPLE)]
    ref = engine11(model, "cuda", f32).generate(mig, params)
    src, dst = engine11(model, "cuda", f32), engine11(model, "cuda", f32)
    rids = [src.add_request(p, s) for p, s in zip(mig, params)]
    while min(len(src._requests[r].output_ids) for r in rids) < 8:
        src.step()
    hands = [src.export_request(r) for r in rids]
    new = [dst.adopt_request(h["prompt_ids"], s, h["output_ids"], h["key"],
                             h["kv"]) for h, s in zip(hands, params)]
    while dst.has_unfinished():
        dst.step()
    same_tokens([dst.request_output(r) for r in new], ref,
                "phase 11 export / adopt")
    print("serving fp32 export after 8 tokens / adopt in another engine: "
          "greedy and seeded tokens equal a run that never migrated",
          flush=True)
    del src, dst, eng
    torch.cuda.empty_cache()

    # (b) bfloat16, timed in turns: prefix caching off / on
    shared = rng.randint(0, v, (512,)).astype(np.int32)
    tails = np.linspace(16, 64, 16).astype(int)
    pre = [np.concatenate([shared, rng.randint(0, v, (t,)).astype(np.int32)])
           for t in tails]
    sp = [SamplingParams(max_new_tokens=NEW_TOKENS)] * len(pre)
    engine11(model, "cuda", bf16).generate(pre[:2], sp[:2])     # warm-up
    turns, outs = [], {}
    for on in (False, True, True, False):
        eng = engine11(model, "cuda", bf16, enable_prefix_caching=on)
        out, st = run_steps(eng, pre, sp)
        st.update(prefix_caching=on, hits=eng.cache.prefix_hits,
                  parked_blocks=eng.cache.num_parked_blocks)
        if on in outs:
            same_tokens(out, outs[on], "phase 11 bf16 prefix turns")
        outs[on] = out
        turns.append(st)
    rec["prefix_bf16"] = {"turns": turns, "agreement_on_vs_off": agreement(
        outs[True], outs[False], pre)}
    for st in turns:
        print(f"serving bf16 prefix caching {'on' if st['prefix_caching'] else 'off'}"
              f" (16 requests, 512-token shared prefix, tails 16-64, "
              f"{NEW_TOKENS} new): wall {st['wall_s'] * 1e3:.1f} ms, "
              f"prefill {st['prefill_s'] * 1e3:.1f} ms for "
              f"{st['prefill_tokens']} prompt tokens, decode "
              f"{st['decode_s'] * 1e3:.1f} ms, first token ms per request "
              f"{[round(t, 1) for t in st['first_token_ms']]}, hits "
              f"{st['hits']} ({card})", flush=True)
    print(f"serving bf16 prefix caching: on vs off, "
          f"{rec['prefix_bf16']['agreement_on_vs_off']:.4f} of the tokens "
          f"agree", flush=True)

    # speculative decoding, plain against k = 4
    sp = [SamplingParams(max_new_tokens=128)] * len(spec_prompts)
    turns, outs, engines = [], {}, {}
    for k in (0, SPEC_K, SPEC_K, 0):
        eng = engine11(model, "cuda", bf16, speculative_tokens=k)
        out, st = run_steps(eng, spec_prompts, sp)
        st.update(spec_tokens=k, accept_rate=(
            eng._spec_accepted_total / max(eng._spec_proposed_total, 1)),
            ms_per_token=st["decode_s"] * 1e3 / st["decode_tokens"],
            tokens_per_step=st["decode_tokens"] / st["decode_steps"])
        if k in outs:
            same_tokens(out, outs[k], "phase 11 bf16 spec turns")
        outs[k], engines[k] = out, eng
        turns.append(st)
    plain_ms = graph_ms(engines[0]._steps[("ragged", 8, 1)])
    verify_ms = graph_ms(engines[SPEC_K]._steps[("verify", 8, SPEC_K + 1)])
    rec["spec_bf16"] = {"turns": turns, "agreement": agreement(
        outs[SPEC_K], outs[0], spec_prompts),
        "captured_plain_step_device_ms": plain_ms,
        "captured_verify_step_device_ms": verify_ms}
    for st in turns:
        print(f"serving bf16 spec k={st['spec_tokens']} (8 greedy prompts, "
              f"128 new): {st['ms_per_token']:.4f} wall ms per emitted "
              f"token, {st['tokens_per_step']:.3f} tokens a step, accept "
              f"rate {st['accept_rate']:.4f}, {st['decode_steps']} steps "
              f"({st['verify_steps']} verify), wall {st['wall_s'] * 1e3:.1f}"
              f" ms ({card})", flush=True)
    print(f"serving bf16 captured steps: verify (8, {SPEC_K + 1}) "
          f"{verify_ms:.4f} device ms, plain (8, 1) {plain_ms:.4f}; spec vs "
          f"plain tokens agree {rec['spec_bf16']['agreement']:.4f} ({card})",
          flush=True)
    del engines

    # the sampler: eight seeded rows against eight greedy rows
    eng = engine11(model, "cuda", bf16)
    rec["sampler_ms"] = {"seeded": sampler_ms(eng, v, True),
                         "greedy": sampler_ms(eng, v, False)}
    print(f"serving sampler, 8 rows of {v} logits: seeded (threefry) "
          f"{rec['sampler_ms']['seeded']:.3f} ms, greedy "
          f"{rec['sampler_ms']['greedy']:.3f} ms a step ({card})", flush=True)
    launches = ops.launch_counts()
    if not (launches[RAGGED] and launches[RAGGED8] and launches[FWD]):
        fail(f"phase 11: launches {launches}")
    rec["launches"] = launches
    del model, eng
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# phase 12: float16
# ---------------------------------------------------------------------------

# the largest gap allowed between the fp32 model's top logit and its
# logit of a token the fp16 model chose (teacher forcing;
# `near_argmax_gap`), by pool type: about four times this phase's largest
# reading (NVIDIA H100 80GB HBM3, 700.00 W): 0.0002 on fp16 pools and
# 0.0000 in `generate` -> 2^-10; 0.0058 on int8 pools, whose codes round K
# and V to 2^-8 of a row's largest |value| (fp16: 2^-11 of each) ->
# 3 * 2^-7
NEAR_ARGMAX = {"fp16": 2.0 ** -10, "int8": 3 * 2.0 ** -7}
FP16_SEEDED_LENS = (100, 300)
# the requests held against the CPU engine: greedy prompt lengths, seeded
# prompt lengths, new tokens (the CPU's fp16 GEMMs are slow)
FP16_CPU_REQUESTS = ((7, 24), (16,), 8)
FP16_GEN = dict(batch=8, prompt=256, new=32)


def fp16_kernel_cases(fa, fd, rpa, fm, ops, tol, timer, cases,
                      kernel_segs):
    """Phase 12a: every fp16 kernel against its fp16 plain version at the
    limits of `tolerance` (fp16), at the shapes of the main path: the
    forward at S=384, at the training shape and at H=16 D=128; dQ and
    dK/dV at the training shape; the masked forward (pad, kv_lens) at
    the padded prefill's shape; the segment and non-causal variants,
    forward and backward, at the training shape and the padded one; the
    ragged kernel at the decode step, the verify step (8, 5) and a chunk
    of 512 on fp16 pools, and on int8 pools with fp16 q at the decode
    step and C=512; flash decode at full context (H=12 D=64, H=16 D=128);
    the LayerNorm forward at the training and decode rows (8192, 8) with
    fp16 x and w and with fp16 x and fp32 w, its backward at 8192 rows
    (both) and 200; the FFN at a decode step (8 rows, the decode design),
    the prefill and training rows (2048, 8192: the tensor cores) and the
    CUDA-core width (`FFN_ODD_INTER`).  The cases go into ``cases`` under
    the fp16 counters (`FWD_TC16`, ...) or, for the flash variants, the
    variant's own."""
    f16 = torch.float16
    cases[FWD_TC16].append(check_flash(fa, tol, timer, 384, 12, 64, f16,
                                       seed=384))
    cases[FWD_TC16].append(check_flash(fa, tol, timer, 1024, 12, 64, f16,
                                       seed=4, b=8))    # training shape
    cases[FWD_TC16].append(check_flash(fa, tol, timer, 512, 16, 128, f16,
                                       seed=1))
    for name, c in check_flash_bwd(fa, tol, timer, 8, 1024, 12, 64, f16,
                                   seed=1088).items():
        cases[{DQ: DQ_TC16, DKV: DKV_TC16}[name]].append(c)
    torch.cuda.empty_cache()
    for kind in ("pad", "lens"):
        cases[FWD_MASK].append(check_flash_masked(fa, tol, timer, kind, f16,
                                                  seed=7))
        torch.cuda.empty_cache()
    for kind, b, s, fwd, bwd in (("segs", 8, 1024, True, True),
                                 ("nc", 8, 1024, True, False),
                                 ("pad", 8, 896, False, True),
                                 ("lens", 8, 896, False, True),
                                 ("nc", 8, 896, True, True)):
        for name, c in check_flash_variant(
                fa, tol, timer, kind, b, s, 12, 64, f16, seed=s + b,
                segs=kernel_segs if kind == "segs" else None, fwd=fwd,
                bwd=bwd).items():
            cases[name].append(c)
        torch.cuda.empty_cache()
    cases[RAGGED16].append(check_ragged(rpa, tol, timer, DECODE_ROWS, 1, f16,
                                        seed=2))
    cases[RAGGED16].append(check_ragged(rpa, tol, timer, VERIFY_ROWS,
                                        SPEC_K + 1, f16, seed=8))
    cases[RAGGED16].append(check_ragged(rpa, tol, timer, [(700, 512)], 512,
                                        f16, seed=3))
    cases[RAGGED8_16].append(check_ragged_int8(rpa, tol, timer, DECODE_ROWS,
                                               1, f16, seed=2))
    cases[RAGGED8_16].append(check_ragged_int8(rpa, tol, timer, [(700, 512)],
                                               512, f16, seed=3))
    cases[DECODE16].append(check_decode(fd, tol, timer, 8, 1024, 12, 64,
                                        1024, f16, 1024))
    cases[DECODE16].append(check_decode(fd, tol, timer, 8, 1024, 16, 128,
                                        1024, f16, 5))
    for n in (8192, 8):
        for pdt in (f16, torch.float32):
            cases[LN16].append(check_ln(fm, tol, timer, n, 768, f16,
                                        n + 16, pdt))
    for n, pdt in ((8192, f16), (8192, torch.float32), (200, f16)):
        cases[LN_BWD16].append(check_ln_bwd(fm, tol, timer, n, 768, f16, pdt,
                                            seed=n + 16))
    for n, inter in ((8, 3072), (2048, 3072), (8192, 3072),
                     (1024, FFN_ODD_INTER)):
        c = check_ffn(fm, ops, tol, timer, n, 768, inter, "gelu_tanh", f16,
                      n + 16)
        cases[FFN_COUNTER16[c["design"]]].append(c)
    torch.cuda.empty_cache()


def near_argmax_gap(model, outs, prompts):
    """The largest gap, over every generated token of ``outs`` (greedy
    sequences after ``prompts``), between ``model``'s largest logit and its
    logit of the token chosen, teacher-forced on the whole sequence (one
    forward a sequence, on the model's device)."""
    gap = 0.0
    dev = next(iter(model.parameters())).device
    with torch.no_grad():
        for out, p in zip(outs, prompts):
            ids = torch.as_tensor(np.asarray(out, np.int64))[None].to(dev)
            logits = model(ids)[0, len(p) - 1:-1].float()
            tok = ids[0, len(p):]
            g = logits.max(-1).values - logits.gather(-1, tok[:, None])[:, 0]
            gap = max(gap, float(g.max()))
    return gap


def engine_launches(eng, dtype):
    """The launches of an engine's run: one flash prefill per layer and
    prefill step, one ragged launch per layer and decode or chunk step (of
    the int8 entry for int8 pools), counted by type (`with_tc`)."""
    layers = eng.cfg.num_hidden_layers
    want = dict.fromkeys(KERNELS, 0)
    want[FWD] = layers * eng.step_counts["prefill"]
    want[RAGGED8 if eng.kv_quant else RAGGED] = layers * (
        eng.step_counts["decode"] + eng.step_counts["chunk"])
    return with_tc(want, dtype, d=eng.head_dim)


def cpu_differences(ref32, card, cpu, prompts, params, limit, what):
    """The card engine's rows ``card`` against the CPU engine's ``cpu``:
    each identical, except at most one greedy row whose first difference
    j is a near-tie: the card's and the CPU's token at j both within
    ``limit`` of ``ref32``'s top logit on the common prefix.  Returns
    [(row, j, the two gaps)] of the rows that differ."""
    dev = next(iter(ref32.parameters())).device
    differ = []
    for i, (a, b, p, sp) in enumerate(zip(card, cpu, prompts, params)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape == b.shape and np.array_equal(a, b):
            continue
        if a.shape != b.shape or sp.do_sample:
            fail(f"{what}: row {i} ({'seeded' if sp.do_sample else 'greedy'}"
                 f") differs from the CPU engine's")
        j = int(np.nonzero(a != b)[0][0])
        with torch.no_grad():
            logits = ref32(torch.as_tensor(a[None, :j].astype(np.int64))
                           .to(dev))[0, -1].float()
        gaps = [float(logits.max() - logits[int(t)]) for t in (a[j], b[j])]
        if j < len(p) or max(gaps) > limit:
            fail(f"{what}: row {i} parts from the CPU engine's at {j}, "
                 f"tokens {a[j]} / {b[j]} {gaps} below the fp32 model's "
                 f"top logit (limit {limit})")
        differ.append((i, j, gaps))
    if len(differ) > 1:
        fail(f"{what}: {len(differ)} rows differ from the CPU engine's "
             f"({differ})")
    return differ


def fp16_engine(ops, model16, ref32, requests, cpu_requests, kv, card):
    """Phase 12b on one pool type (``kv``: None or "int8"): the fp16
    engine's run of ``requests`` (prompts, params) eager and captured
    (identical tokens, the expected launches, one ``ragged`` capture),
    the teacher-forced gap of its greedy tokens under ``ref32`` (the same
    weights in fp32, on the card); then ``cpu_requests`` on the card and
    on the CPU (plain versions; the host's fp16 GEMMs are far slower than
    its fp32 ones, so these are short) and the share of generated tokens
    that agree, held by `cpu_differences`."""
    f16 = torch.float16
    limit = NEAR_ARGMAX[kv or "fp16"]
    prompts, params = requests
    runs = {}
    for turn in ("eager", "captured"):
        with graphs_env(turn == "captured"):
            eng = engine11(model16, "cuda", f16, kv_cache_dtype=kv)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            outs = eng.generate(prompts, params)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = ops.launch_counts()
        what = f"float16 engine, {kv or 'fp16'} pools ({turn})"
        want = engine_launches(eng, f16)
        if launches != want or not want[RAGGED8_16 if kv else RAGGED16]:
            fail(f"{what}: launches {launches}, expected {want} "
                 f"({eng.step_counts})")
        if eng.compiles != ({"ragged": 1} if turn == "captured" else {}):
            fail(f"{what}: captures {eng.compiles}")
        runs[turn] = (outs, launches, secs, dict(eng.step_counts))
    same_tokens(runs["eager"][0], runs["captured"][0],
                f"float16 engine, {kv or 'fp16'} pools, captured vs eager")
    outs, launches, secs, steps = runs["captured"]
    greedy = [i for i, sp in enumerate(params) if not sp.do_sample]
    gap = near_argmax_gap(ref32, [outs[i] for i in greedy],
                          [prompts[i] for i in greedy])
    short, short_params = cpu_requests
    on_card = engine11(model16, "cuda", f16, kv_cache_dtype=kv).generate(
        short, short_params)
    t0 = time.perf_counter()
    cpu = engine11(model16, "cpu", f16, kv_cache_dtype=kv).generate(
        short, short_params)
    cpu_s = time.perf_counter() - t0
    rec = {"pools": kv or "fp16", "card_s": secs, "eager_s": runs["eager"][2],
           "cpu_s": cpu_s, "steps": steps, "launches": launches,
           "agreement_with_cpu": agreement(on_card, cpu, short),
           "cpu_differences": cpu_differences(
               ref32, on_card, cpu, short, short_params, limit,
               f"float16 engine, {kv or 'fp16'} pools, card vs CPU"),
           "near_argmax_gap": gap}
    print(f"engine float16 GPT-2 124M (O2), {rec['pools']} pools, "
          f"{len(greedy)} greedy and {len(prompts) - len(greedy)} seeded "
          f"requests, {NEW_TOKENS} new: captured tokens identical to the "
          f"eager run; the fp32 model's top logit over the card's greedy "
          f"token at most {gap:.6f} (limit {limit}); against the CPU "
          f"engine (plain versions, prompts {[len(p) for p in short]}) "
          f"{rec['agreement_with_cpu']:.4f} of the tokens agree, rows "
          f"parting at a near-tie {rec['cpu_differences']} (CPU "
          f"{cpu_s:.1f} s); launches "
          f"{ {k: n for k, n in launches.items() if n} }; card "
          f"{secs:.2f} s captured, {runs['eager'][2]:.2f} s eager ({card})",
          flush=True)
    if not gap <= limit:
        fail(f"float16 engine, {rec['pools']} pools: a greedy token "
             f"{gap:.6f} below the fp32 model's top logit")
    return rec


def fp16_generate(ops, cfg, ref32, card):
    """Phase 12c: default-mode ``generate`` of the O2-fp16 stacked GPT-2
    124M, B=8, 256 + 32 greedy, captured and eager (identical tokens),
    the decode kernel's fp16 launches (12 a step, replays counted), and
    the card's tokens teacher-forced under ``ref32`` (fp32, the card);
    then once more, captured, under PTPU_PALLAS_LN=1: its ``ln_f`` on the
    fp16 LayerNorm forward (one launch a forward, a second capture), the
    tokens teacher-forced too."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM
    b, p, new = FP16_GEN["batch"], FP16_GEN["prompt"], FP16_GEN["new"]
    rng = np.random.RandomState(12)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, p))
                           .astype(np.int32)).cuda()
    model = amp.decorate(GPTForCausalLM(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0)),
        level="O2", dtype="float16")
    with flag_env({}):
        model.generate(ids, max_new_tokens=3)          # warm-up, capture
        outs, launches = {}, {}
        for turn in ("eager", "captured"):
            with graphs_env(turn == "captured"):
                ops.reset_launch_counts()
                outs[turn] = model.generate(ids, max_new_tokens=new).cpu()
                torch.cuda.synchronize()
                launches[turn] = ops.launch_counts()
            check_gen_launches(launches[turn], "default", cfg, b, new - 1,
                               f"float16 generate ({turn})",
                               dtype=torch.float16, prompt=p)
    if not torch.equal(outs["eager"], outs["captured"]):
        fail("float16 generate: captured tokens differ from the eager run")
    if _captures(model).get("decode") != 1:
        fail(f"float16 generate: captures {_captures(model)}")
    env = {"PTPU_PALLAS_LN": "1"}
    with flag_env(env), graphs_env(True):
        model.generate(ids, max_new_tokens=3)          # warm-up, capture
        ops.reset_launch_counts()
        outs["ln_f"] = model.generate(ids, max_new_tokens=new).cpu()
        torch.cuda.synchronize()
        launches["ln_f"] = ops.launch_counts()
    check_gen_launches(launches["ln_f"], "default", cfg, b, new - 1,
                       "float16 generate under PTPU_PALLAS_LN=1",
                       dtype=torch.float16, prompt=p, ln_f=True)
    if _captures(model).get("decode") != 2:
        fail(f"float16 generate: captures {_captures(model)}, expected a "
             f"second under PTPU_PALLAS_LN=1")
    gap_ln = near_argmax_gap(ref32, list(outs["ln_f"].numpy()),
                             list(ids.cpu().numpy()))
    print(f"generate float16 GPT-2 124M (O2) B={b} {p}+{new} under "
          f"PTPU_PALLAS_LN=1: ln_f on the fp16 LayerNorm, the fp32 model's "
          f"top logit over the card's token at most {gap_ln:.6f}; "
          f"agreement with the flag-less run "
          f"{_agreement(outs['ln_f'], outs['captured'], p):.4f}; launches "
          f"{ {k: n for k, n in launches['ln_f'].items() if n} }", flush=True)
    if not gap_ln <= NEAR_ARGMAX["fp16"]:
        fail(f"float16 generate under PTPU_PALLAS_LN=1: a token "
             f"{gap_ln:.6f} below the fp32 model's top logit")
    gap = near_argmax_gap(ref32, list(outs["captured"].numpy()),
                          list(ids.cpu().numpy()))
    print(f"generate float16 GPT-2 124M (O2) B={b} {p}+{new}, default "
          f"mode: captured tokens identical to the eager run, one capture; "
          f"the fp32 model's top logit over the card's token at most "
          f"{gap:.6f} "
          f"(limit {NEAR_ARGMAX['fp16']}); launches "
          f"{ {k: n for k, n in launches['captured'].items() if n} } "
          f"({card})", flush=True)
    if not gap <= NEAR_ARGMAX["fp16"]:
        fail(f"float16 generate: a token {gap:.6f} below the fp32 model's "
             f"top logit")
    del model
    torch.cuda.empty_cache()
    return {"batch": f"B={b} prompt={p} new={new}", "near_argmax_gap": gap,
            "near_argmax_gap_ln_f": gap_ln,
            "launches": launches["captured"],
            "launches_ln_f": launches["ln_f"]}, launches


def fp16_generate_flags(ops, ref32, card):
    """Phase 12e: ``generate`` of the O2-cast (``amp.decorate``) per-layer
    GPT-2 124M under PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1, outside
    ``auto_cast``, B=8, 256 + 32 greedy, eager and captured (identical
    tokens, one capture): the fp16 LayerNorm forward (25 a forward: the
    prefill's 2048 rows and each step's 8), the FFN on the tensor cores at
    the prefill's 2048 rows and on the decode design at 8, the fp16 flash
    forward and flash decode; every token teacher-forced under ``ref32``
    (the per-layer model in fp32, the card) within ``NEAR_ARGMAX["fp16"]``
    of its top logit.  Returns the record and the captured run's
    launches."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM
    cfg = ref32.cfg
    b, p, new = FP16_GEN["batch"], FP16_GEN["prompt"], FP16_GEN["new"]
    rng = np.random.RandomState(12)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, p))
                           .astype(np.int32)).cuda()
    model = amp.decorate(GPTForCausalLM(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0)),
        level="O2", dtype="float16")
    outs, launches, secs = {}, {}, {}
    with flag_env(TRAIN_MODES["flags"]):
        model.generate(ids, max_new_tokens=3)          # warm-up, capture
        for turn in ("eager", "captured"):
            with graphs_env(turn == "captured"):
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[turn] = model.generate(ids, max_new_tokens=new).cpu()
                torch.cuda.synchronize()
                secs[turn] = time.perf_counter() - t0
                launches[turn] = ops.launch_counts()
            check_gen_launches(launches[turn], "flags", cfg, b, new - 1,
                               f"float16 per-layer generate under both "
                               f"flags ({turn})", dtype=torch.float16,
                               prompt=p)
    if not torch.equal(outs["eager"], outs["captured"]):
        fail("float16 per-layer generate under both flags: captured tokens "
             "differ from the eager run")
    if _captures(model).get("decode") != 1:
        fail(f"float16 per-layer generate: captures {_captures(model)}")
    gap = near_argmax_gap(ref32, list(outs["captured"].numpy()),
                          list(ids.cpu().numpy()))
    got = launches["captured"]
    print(f"generate float16 per-layer GPT-2 124M (O2) B={b} {p}+{new} "
          f"under PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1: captured tokens "
          f"identical to the eager run, one capture; the fp32 model's top "
          f"logit over the card's token at most {gap:.6f} (limit "
          f"{NEAR_ARGMAX['fp16']}); {secs['captured']:.3f} s captured, "
          f"{secs['eager']:.3f} s eager; launches "
          f"{ {k: n for k, n in got.items() if n} } ({card})", flush=True)
    if not gap <= NEAR_ARGMAX["fp16"]:
        fail(f"float16 per-layer generate under both flags: a token "
             f"{gap:.6f} below the fp32 model's top logit")
    del model
    torch.cuda.empty_cache()
    return {"batch": f"B={b} prompt={p} new={new}", "near_argmax_gap": gap,
            "seconds": secs, "launches": got}, got


# pure fp16 (phase 12f): steps, the GradScaler's static scale, and the
# limits of the flags step against the step without them, both fp16 on the
# card.  Loss: one fp16 step (2^-10) relative -- a mean over 8192 tokens of
# fp32 cross entropies whose fp16 logits the two paths round at other
# points.  Gradients: each of the 3L + 1 sites where the paths round
# differently (2L + 1 LayerNorms: y rounded once from fp32 against the
# normalised x, times w, plus b each rounded; L FFNs: h rounded from fp32
# against u and gelu(u) each rounded) moves what flows through it by at
# most one fp16 step (2^-10) relative, to first order additively through
# the backward: (3L + 1) 2^-10 of each tensor's largest gradient.
PURE_FP16_STEPS = 4
PURE_FP16_SCALE = 2.0 ** 10
PURE_FP16_LOSS_REL = 2.0 ** -10


def pure_fp16(ops, card, batch=8, seq=1024, steps=PURE_FP16_STEPS):
    """Phase 12f: the per-layer GPT-2 124M cast by ``.to(float16)`` and
    stepped without ``auto_cast`` (AdamW with fp32 masters, a static
    `GradScaler` of `PURE_FP16_SCALE`), B=8 S=1024, `PURE_FP16_STEPS`
    steps, without the flags (torch LayerNorm and matmuls) and under
    PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1 (the fp16 LayerNorm forward and
    backward, 25 each a step at 8192 rows, and the FFN on the tensor
    cores, 12 a step): losses finite, no step skipped, the launches; the
    flags step's first loss and gradients against the other's within the
    limits above; ms per step over steps 2 on, without and with them.
    Returns the record and the launches of each run."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_124m_config()
    rng = np.random.RandomState(2)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         (batch, seq))).cuda()
            for _ in range(2)]
    runs, launches = {}, {}
    for mode in ("no_flags", "flags"):
        model = GPTForCausalLM(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        model.to(torch.float16)
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=PURE_FP16_SCALE,
                                use_dynamic_loss_scaling=False)
        losses, skipped, grads = [], [], None
        with flag_env(TRAIN_MODES[mode]):
            ops.reset_launch_counts()
            for i in range(steps):
                if i == 1:        # steps after the first (and its copy)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                loss = model.pretrain_loss(*data)
                scaler.scale(loss).backward()
                if i == 0:
                    grads = {n: p.grad.float() / PURE_FP16_SCALE
                             for n, p in model.named_parameters()}
                before = opt._step_count
                scaler.step(opt)
                if opt._step_count == before:
                    skipped.append(i)
                opt.clear_grad()
                losses.append(loss.detach())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
            launches[mode] = ops.launch_counts()
        losses = [x.item() for x in losses]
        check_train_launches(launches[mode], train_launches(
            cfg, steps, TRAIN_MODES[mode], dtype=torch.float16,
            rows=batch * seq), f"pure float16 training ({mode})")
        if not all(np.isfinite(losses)) or skipped:
            fail(f"pure float16 training ({mode}): losses {losses}, skipped "
                 f"steps {skipped}")
        if not all(p.dtype == torch.float16 for p in model.parameters()):
            fail(f"pure float16 training ({mode}): parameters left fp16")
        runs[mode] = {"losses": losses, "ms_per_step": ms, "grads": grads}
        del model, opt
        torch.cuda.empty_cache()
    plain, flags = runs["no_flags"], runs["flags"]
    loss_rel = abs(flags["losses"][0] - plain["losses"][0]) / abs(
        plain["losses"][0])
    if not loss_rel <= PURE_FP16_LOSS_REL:
        fail(f"pure float16 training: first loss {flags['losses'][0]} under "
             f"the flags against {plain['losses'][0]} without (relative "
             f"{loss_rel}, limit {PURE_FP16_LOSS_REL})")
    coef = (3 * cfg.num_hidden_layers + 1) * 2.0 ** -10
    ratios = {}
    for name, gp in plain["grads"].items():
        err = (flags["grads"][name] - gp).abs().max().item()
        limit = coef * gp.abs().max().item()
        ratios[name] = err / limit if limit else float(err > 0)
        if not err <= limit:
            fail(f"pure float16 training: step-1 gradient of {name} under "
                 f"the flags differs by {err} (limit {limit})")
    rec = {"batch": f"B={batch} S={seq}", "steps": steps,
           "scale": PURE_FP16_SCALE,
           "losses": {m: r["losses"] for m, r in runs.items()},
           "ms_per_step": {m: r["ms_per_step"] for m, r in runs.items()},
           "loss_rel_diff": loss_rel, "grad_limit_coef": coef,
           "grad_err_over_limit": ratios, "launches": launches}
    print(f"train pure float16 per-layer GPT-2 124M B={batch} S={seq}, "
          f"{steps} steps (AdamW, static scale {PURE_FP16_SCALE:.0f}): "
          f"losses {plain['losses']} without the flags, {flags['losses']} "
          f"under both; first loss relative {loss_rel:.3g} (limit "
          f"{PURE_FP16_LOSS_REL}); step-1 gradients within "
          f"{max(ratios.values()):.3g} of {coef:.4g} max|g|; ms per step "
          f"{plain['ms_per_step']:.3f} / {flags['ms_per_step']:.3f} (host "
          f"clock, steps 2-{steps}; {card}); launches under the "
          f"flags { {k: n for k, n in launches['flags'].items() if n} }",
          flush=True)
    return rec, launches


def ffn_entry_fp16(fm, ops, tol, n=1024, hidden=768, inter=FFN_ODD_INTER):
    """Phase 12g: the FFN's CUDA-core design in fp16, the one no GPT-2
    path reaches (`maybe_fused_ffn` gates on widths of 128), through the
    entry point `fused_ffn_arrays` with autograd at I=3008: y within
    `tolerance.ffn_limit` of the plain version, the gradients (plain
    recompute on both sides) bitwise those of the plain version's
    autograd through `_ffn_vjp_ref`, one launch.  Returns the record and
    the launches."""
    g = torch.Generator().manual_seed(19)
    f16 = torch.float16
    ins = (torch.randn(n, hidden, generator=g),
           torch.randn(hidden, inter, generator=g) * hidden ** -0.5,
           torch.randn(inter, generator=g) * 0.1,
           torch.randn(inter, hidden, generator=g) * inter ** -0.5)
    ins = [t.to("cuda", f16) for t in ins]
    dy = torch.randn(n, hidden, generator=g).to("cuda", f16)
    ts = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    y = fm.fused_ffn_arrays(*ts, "gelu_tanh")
    y.backward(dy)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = with_tc(dict.fromkeys(KERNELS, 0) | {FFN: 1}, f16)
    if launches != want:
        fail(f"entry-point FFN float16: launches {launches}, expected "
             f"{want}")
    ref = [t.clone().requires_grad_() for t in ins]
    fm._ffn_vjp_ref(*ref, "gelu_tanh").backward(dy)
    err, ratio = check_close(tol, y, fm.fused_ffn_reference(
        *ins, "gelu_tanh"), tol.ffn_limit(*ins, "gelu_tanh"),
        "entry-point FFN float16")
    for name, a, r in zip(("dx", "dw1", "db1", "dw2"), ts, ref):
        if not torch.equal(a.grad, r.grad):
            fail(f"entry-point FFN float16: {name} differs from the plain "
                 f"autograd's")
    return {"shape": f"n={n} H={hidden} I={inter}", "max_abs_err": err,
            "err_over_limit": ratio, "launches": launches}, launches


def fp16_phase(ops, card):
    """Phase 12b-g (module docstring): the fp16 engine on fp16 and int8
    pools, fp16 ``generate`` (stacked, and its ``ln_f`` under
    PTPU_PALLAS_LN), configuration A's recipe under fp16 O1 and O2
    without and with the LN and FFN flags, per-layer fp16 ``generate``
    under both flags, pure fp16 training and the CUDA-core FFN's fp16
    entry.  Returns the record and the launches of the phase's runs by
    name (``engine``, ``engine_int8``, ``generate``, ``generate_ln_f``,
    ``O1``, ``O2``, ``O1_flags``, ``O2_flags``, ``generate_flags``,
    ``pure``, ``pure_no_flags``, ``ffn_entry``)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.ops import fused_mlp as fm
    from paddle_tpu_torch.ops import tolerance as tol
    from paddle_tpu_torch.serving import SamplingParams
    cfg = gpt2_124m_config(stacked_blocks=True)
    model16 = amp.decorate(GPTForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
        level="O2", dtype="float16")
    rng = np.random.RandomState(0)

    def requests(greedy, seeded, new):
        prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in greedy + seeded]
        return prompts, (
            [SamplingParams(max_new_tokens=new)] * len(greedy)
            + [SamplingParams(max_new_tokens=new, seed=7 + i,
                              **SERVE_SAMPLE) for i in range(len(seeded))])

    card_requests = requests(PROMPT_LENS, FP16_SEEDED_LENS, NEW_TOKENS)
    cpu_requests = requests(*FP16_CPU_REQUESTS)
    ref32 = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    rec, launches, secs = {}, {}, {}
    for kv, key in ((None, "engine"), ("int8", "engine_int8")):
        t0 = time.perf_counter()
        rec[key] = fp16_engine(ops, model16, ref32, card_requests,
                               cpu_requests, kv, card)
        launches[key] = rec[key]["launches"]
        secs[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["generate"], gen = fp16_generate(ops, cfg, ref32, card)
    launches["generate"], launches["generate_ln_f"] = (gen["captured"],
                                                       gen["ln_f"])
    secs["generate"] = time.perf_counter() - t0
    del model16, ref32
    torch.cuda.empty_cache()
    cfg_a = gpt2_124m_config(**DROPOUT)        # per-layer, configuration A
    for flags in (False, True):
        for level in ("O1", "O2"):
            key = f"{level}_flags" if flags else level
            t0 = time.perf_counter()
            r, launches[key] = train_bf16(
                ops, cfg_a, TRAIN_MODES["flags" if flags else "no_flags"],
                warmup=2, timed=6, dtype=torch.float32,
                recipe={"amp": level, "amp_dtype": "float16"}, lr=RECIPE_LR)
            rec[f"recipe_A_{key}"] = r
            print_train(f"per-layer, configuration A under {level} "
                        f"(GradScaler, dropout 0.1, recipe; "
                        + ("LN and FFN flags" if flags else "no LN / FFN flags")
                        + ")", r, launches[key], card, "float16")
            print(f"recipe A fp16 {key}: loss scale {r['scales'][0]:.0f} -> "
                  f"{r['scales'][-1]:.0f}, skipped steps "
                  f"{r['skipped_steps']}", flush=True)
            if flags and (r["skipped_steps"] or len(set(r["scales"])) != 1):
                fail(f"recipe A fp16 {key}: scales {r['scales']}, skipped "
                     f"steps {r['skipped_steps']}")
            torch.cuda.empty_cache()
            secs[key] = time.perf_counter() - t0
    print("recipe A fp16 ms per step, no flags / LN and FFN flags: "
          + ", ".join(f"{lv} {rec[f'recipe_A_{lv}']['ms_per_step']:.3f} / "
                      f"{rec[f'recipe_A_{lv}_flags']['ms_per_step']:.3f}"
                      for lv in ("O1", "O2")) + f" ({card})", flush=True)
    t0 = time.perf_counter()
    cfg_pl = gpt2_124m_config()
    ref32 = GPTForCausalLM(cfg_pl, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    rec["generate_flags"], launches["generate_flags"] = fp16_generate_flags(
        ops, ref32, card)
    del ref32
    torch.cuda.empty_cache()
    secs["generate_flags"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["pure"], pure = pure_fp16(ops, card)
    launches["pure"], launches["pure_no_flags"] = (pure["flags"],
                                                   pure["no_flags"])
    secs["pure"] = time.perf_counter() - t0
    rec["ffn_entry"], launches["ffn_entry"] = ffn_entry_fp16(fm, ops, tol)
    print(f"entry-point FFN float16 {rec['ffn_entry']['shape']} (the "
          f"CUDA-core design): y within {rec['ffn_entry']['err_over_limit']:.3g}"
          f" of its limit, gradients bitwise the plain autograd's; launches "
          f"{ {k: n for k, n in launches['ffn_entry'].items() if n} }",
          flush=True)
    rec["seconds"] = secs
    print("fp16 phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in secs.items()),
          flush=True)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 13: head_dim 256
# ---------------------------------------------------------------------------

H256 = 8                     # GPT-3 1.3B's widths with 8 heads of 256
# the serving cell's greedy prompts (the 900- and 1500-token ones prefill
# 512 and go on in ragged chunks) and the dense generate cell
PROMPT_LENS_13 = (7, 100, 400, 900, 1500)
GEN_BATCH_13, GEN_PROMPT_13, GEN_NEW_13 = 8, 1024, 128
# the two head geometries of GPT-3 1.3B's widths (hidden 2048), run in
# turns: 8 heads of 256 (this phase's) and the preset's 16 heads of 128
GEOMETRIES = {"8x256": 8, "16x128": 16}
GEO_TURNS = ("8x256", "16x128", "16x128", "8x256")
# the fp32 training of phase 13b: 2 layers of two heads of 256
TRAIN_H256_HIDDEN = 512
# the depth of phases 13c and 13d: a third of GPT-3 1.3B's 24 layers, so
# that the whole run, phase 19 included, stays near 1000 of its 1200 s
H256_LAYERS = 8


def head256_kernel_cases(fa, fd, fdl, rpa, tol, timer, cases, kernel_segs):
    """Phase 13a: every D = 256 kernel against its plain version at the
    limits of `tolerance` (fp32 ``FP32_FWD``, derived there for D = 256),
    H = 8, timed as phase 2 with its bound and SDPA where one call
    computes the function: the flash forward at the prefill B=1 S=2048 and
    at B=8 S=1024, its masked (pad, kv_lens; B=8 S=896), segment (the
    packed batch's ids) and non-causal (B=8 S=1024) branches, each in
    bf16, fp16 and fp32 (fp32 on the CUDA cores, under `FWD_SIMT`); the
    ragged kernel at the decode step on fp32, bf16 and fp16 pools and on
    int8 pools with q of each type, and a chunk of C = 512 (bf16, both
    pool kinds); flash decode at S_max 2048 (full context in the three
    types, the generate cell's 1152 in bf16); the fused decode layer at
    t = 1023, hidden 2048 (fp32, bf16, bf16 with a row mask)."""
    h, d, bf16 = H256, 256, torch.bfloat16
    for dtype in HALF_AND_FP32:
        fwd = FWD_SIMT if dtype == torch.float32 else FWD_D256
        cases[fwd].append(check_flash(fa, tol, timer, 2048, h, d, dtype,
                                      seed=2048))
        cases[fwd].append(check_flash(fa, tol, timer, 1024, h, d, dtype,
                                      seed=1024, b=8))
        for kind in ("pad", "lens"):
            cases[fwd].append(check_flash_masked(fa, tol, timer, kind, dtype,
                                                 seed=9, b=8, s=896, h=h,
                                                 d=d))
        for kind in ("segs", "nc"):
            cases[fwd] += check_flash_variant(
                fa, tol, timer, kind, 8, 1024, h, d, dtype, seed=1032,
                segs=kernel_segs if kind == "segs" else None,
                bwd=False).values()
        torch.cuda.empty_cache()
        cases[RAGGED_D256].append(check_ragged(rpa, tol, timer, DECODE_ROWS,
                                               1, dtype, seed=2, h=h, d=d))
        cases[RAGGED8_D256].append(check_ragged_int8(
            rpa, tol, timer, DECODE_ROWS, 1, dtype, seed=2, h=h, d=d))
        cases[DECODE_D256].append(check_decode(fd, tol, timer, 8, 2048, h, d,
                                               2048, dtype, seed=2048))
    cases[RAGGED_D256].append(check_ragged(rpa, tol, timer, [(700, 512)],
                                           512, bf16, seed=3, h=h, d=d))
    cases[RAGGED8_D256].append(check_ragged_int8(
        rpa, tol, timer, [(700, 512)], 512, bf16, seed=3, h=h, d=d))
    cases[DECODE_D256].append(check_decode(fd, tol, timer, 8, 2048, h, d,
                                           GEN_PROMPT_13 + GEN_NEW_13, bf16,
                                           seed=1152))
    for dtype, masked in ((torch.float32, False), (bf16, False),
                          (bf16, True)):
        cases[FUSED_D256].append(check_fused_layer(
            fdl, tol, timer, 8, h, d, 2048, 1023, masked, dtype,
            seed=1023 + masked))
    torch.cuda.empty_cache()
    head256_bwd_cases(fa, tol, timer, cases, kernel_segs)


def _bwd_d256(dtype, kernel):
    """The D = 256 counter a backward case of `kernel` (DQ or DKV, or one
    of their variant names) is filed under: the CUDA-core kernel's in
    fp32, else the D = 256 one."""
    dq = kernel.startswith(DQ)
    if dtype == torch.float32:
        return DQ_SIMT if dq else DKV_SIMT
    return DQ_D256 if dq else DKV_D256


def head256_bwd_cases(fa, tol, timer, cases, kernel_segs):
    """Phase 13a's backward: the flash dQ and dK/dV kernels at D = 256, H =
    8, against the plain backward (`check_flash_bwd`, fp32 1e-4 max|ref|,
    bf16 / fp16 `flash_bwd_limits`), q, k and v slices of one fused qkv
    tensor: causal at recipe B's shape B=2 S=2048 in bf16, fp16 and fp32
    (the CUDA-core kernels, `DQ_SIMT`, `DKV_SIMT`); and at B=8 S=1024 in
    bf16, every branch (`check_flash_variant`: causal, the pad mask,
    kv_lens, the packed batch's segment ids, non-causal).  Each with its
    bound, the plain backward's time and SDPA's whole backward as the
    library call."""
    h, d, bf16 = H256, 256, torch.bfloat16
    for dtype in HALF_AND_FP32:
        for kernel, c in check_flash_bwd(fa, tol, timer, 2, 2048, h, d,
                                         dtype, seed=4096).items():
            cases[_bwd_d256(dtype, kernel)].append(c)
        torch.cuda.empty_cache()
    for kernel, c in check_flash_bwd(fa, tol, timer, 8, 1024, h, d, bf16,
                                     seed=8192).items():
        cases[_bwd_d256(bf16, kernel)].append(c)
    for kind in ("pad", "lens", "segs", "nc"):
        for kernel, c in check_flash_variant(
                fa, tol, timer, kind, 8, 1024, h, d, bf16, seed=1033,
                segs=kernel_segs if kind == "segs" else None,
                fwd=False).items():
            cases[_bwd_d256(bf16, kernel)].append(c)
        torch.cuda.empty_cache()


def head256_fp32_card_vs_cpu(ops, card):
    """Phase 13b: the GPT of GPT-3 1.3B's widths with 8 heads of 256
    (``gpt3_1p3b_config(num_attention_heads=8)``, stacked), 2 layers,
    weights from seed 0, fp32, on the card and on the CPU (plain
    versions): the engine (phase 3's prompts and settings; decode steps
    captured) on fp and int8 pools, and ``generate`` B=8, 256 + 32 in the
    default and the fused mode (captured): the card's tokens identical to
    the CPU's, its launches as expected (the flash prefill on the CUDA
    cores, `FWD_SIMT`; every D = 256 counter), one capture each.  Then
    fp32 training at D = 256 (`train_fp32_card_vs_cpu`): 2 layers of two
    heads of 256 (hidden `TRAIN_H256_HIDDEN`, I = 4 x hidden, GPT-3
    1.3B's vocab and positions), stacked and per-layer, 3 AdamW steps at
    B=1 S=1024 on the card and on the CPU: losses within 1e-5 relative at
    every step, step-1 gradients within 1e-3 max|g|, the launches on the
    CUDA-core forward, dQ and dK/dV (`FWD_SIMT`, `DQ_SIMT`, `DKV_SIMT`).
    Returns the record and the launches by run."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    f32 = torch.float32
    cfg = gpt3_1p3b_config(num_attention_heads=H256, num_hidden_layers=2,
                           stacked_blocks=True)
    models = {dev: GPTForCausalLM(cfg, device=dev,
                                  generator=torch.Generator().manual_seed(0))
              for dev in ("cuda", "cpu")}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    rec, launches = {}, {}
    for kv, key in ((None, "engine"), ("int8", "engine_int8")):
        what = f"float32 head_dim 256 engine, {kv or 'fp'} pools"
        with graphs_env(True):
            outs, eng, lc, stats = serve(models["cuda"], prompts, "cuda",
                                         f32, ops, kv)
        check_launches(eng, lc, what)
        t0 = time.perf_counter()
        cpu = serve(models["cpu"], prompts, "cpu", f32, None, kv)[0]
        cpu_s = time.perf_counter() - t0
        same_tokens(outs, cpu, f"{what}: card vs CPU")
        launches[key] = lc
        rec[key] = {"steps": dict(eng.step_counts), "cpu_s": cpu_s,
                    "launches": lc}
        print(f"{what}: the card's tokens equal the CPU run's (prompts "
              f"{list(PROMPT_LENS)}, {NEW_TOKENS} new; steps "
              f"{eng.step_counts}); launches "
              f"{ {k: n for k, n in lc.items() if n} } ({card})", flush=True)
    batch, prompt, new = 8, 256, 32
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    for mode in ("default", "fused"):
        what = f"float32 head_dim 256 generate ({mode})"
        before = _captures(models["cuda"])
        out = {}
        with flag_env(GEN_MODES[mode]), graphs_env(True):
            for dev, model in models.items():
                ops.reset_launch_counts()
                out[dev] = model.generate(ids.to(dev),
                                          max_new_tokens=new).cpu()
                if dev == "cuda":
                    lc = ops.launch_counts()
        check_gen_launches(lc, mode, cfg, batch, new - 1, what,
                           prompt=prompt)
        after = _captures(models["cuda"])
        if after.get("decode", 0) != before.get("decode", 0) + 1:
            fail(f"{what}: captures {before} -> {after}, expected one")
        if not torch.equal(out["cuda"], out["cpu"]):
            r, j = (int(i) for i in torch.nonzero(out["cuda"] != out["cpu"])
                    [0])
            fail(f"{what}: card tokens differ from the CPU run at row {r} "
                 f"position {j}")
        launches[mode] = lc
        rec[mode] = {"launches": lc}
        print(f"{what} B={batch} {prompt}+{new}: the card's tokens equal the "
              f"CPU run's; 1 capture; launches "
              f"{ {k: n for k, n in lc.items() if n} } ({card})", flush=True)
    del models
    torch.cuda.empty_cache()
    for layout, stacked in (("stacked", True), ("per-layer", False)):
        tcfg = gpt3_1p3b_config(hidden_size=TRAIN_H256_HIDDEN,
                                num_attention_heads=2, num_hidden_layers=2,
                                intermediate_size=4 * TRAIN_H256_HIDDEN,
                                stacked_blocks=stacked)
        tr = train_fp32_card_vs_cpu(ops, tcfg, {}, steps=3)
        rel = tr["loss_rel_diff"]
        if not max(rel) <= 1e-5:
            fail(f"float32 head_dim 256 training ({layout}): card losses "
                 f"{tr['card_losses']} vs CPU {tr['cpu_losses']} (relative "
                 f"{rel}; limit 1e-5 at every step)")
        key = f"train_{layout}"
        launches[key] = tr["launches"]
        rec[key] = tr
        print(f"float32 head_dim 256 training, {layout}, 2 layers of 2 heads "
              f"of 256 (hidden {TRAIN_H256_HIDDEN}), {tr['batch']}, 3 AdamW "
              f"steps: card losses {tr['card_losses']} vs CPU "
              f"{tr['cpu_losses']} (relative {rel}, limit 1e-5); step-1 "
              f"gradients at most {max(tr['grad_err_over_limit'].values()):.3g}"
              f" of 1e-3 max|g|; launches "
              f"{ {k: n for k, n in tr['launches'].items() if n} } ({card})",
              flush=True)
        torch.cuda.empty_cache()
    return rec, launches


def _serve_cell(ops, model, prompts, kv, what):
    """One captured run of the bf16 engine (``serve``): the launches as
    expected, one ``ragged`` capture, the longest prompt in ragged
    chunks.  Returns (outputs, launches, the run's numbers)."""
    with graphs_env(True):
        outs, eng, lc, stats = serve(model, prompts, "cuda", torch.bfloat16,
                                     ops, kv)
    want = engine_launches(eng, torch.bfloat16)
    if lc != want or eng.compiles != {"ragged": 1} \
            or not eng.step_counts["chunk"]:
        fail(f"{what}: launches {lc}, expected {want}; captures "
             f"{eng.compiles}; steps {eng.step_counts}")
    steps = eng.step_counts["decode"]
    return outs, lc, {
        "steps": dict(eng.step_counts), "capture_ms": stats["capture_ms"],
        "prefill_tok_s": stats["prefill_tokens"] / stats["prefill_s"],
        "decode_tok_s": stats["decode_tokens"] / stats["decode_s"],
        "decode_ms_per_step": stats["decode_s"] * 1e3 / steps}


def _generate_cell(ops, model, cfg, ids, mode, what):
    """One captured bf16 ``generate`` of ``ids`` (`GEN_NEW_13` new) in
    ``mode``: decode ms a step as phase 4 takes it (a prefill-only
    generate's time taken off), the launches as expected.  Returns (tokens,
    launches, the run's numbers)."""
    b, p = ids.shape
    new = GEN_NEW_13
    with flag_env(GEN_MODES[mode]), graphs_env(True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        lc = ops.launch_counts()
    check_gen_launches(lc, mode, cfg, b, new - 1, what, dtype=torch.bfloat16,
                       prompt=p)
    decode_s = total_s - prefill_s
    return out, lc, {"prefill_s": prefill_s, "total_s": total_s,
                     "decode_ms_per_step": decode_s * 1e3 / (new - 1),
                     "decode_tok_s": b * (new - 1) / decode_s}


def head256_bf16(ops, card):
    """Phase 13c: GPT-3 1.3B's widths (hidden 2048, I=8192, vocab 50304)
    at `H256_LAYERS` layers, stacked, bf16 weights from seed 0, in two
    head geometries run in turns (`GEO_TURNS`): 8 heads of 256 and the
    preset's 16 of 128 (the same FLOPs).  Each turn: the engine (block 16,
    8 sequences, 512 batched tokens; `PROMPT_LENS_13`, 32 new, greedy) on
    fp and int8 pools, decode steps captured; dense ``generate`` B=8,
    1024 + 128 in the default and the fused mode, captured (warmed up and
    captured before the first turn).  Each run's launches as expected
    (at 256 every D = 256 counter, the ``ragged`` and ``decode`` captures
    one each), each cell's tokens the same in every turn of its geometry.
    Then one profiled window a cell and geometry (`profile_decode`,
    `profile_generate`): device ms and busy share.  Returns the record and
    the launches of the 8 x 256 runs by cell."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    bf16 = torch.bfloat16
    cfgs = {g: gpt3_1p3b_config(num_attention_heads=n, stacked_blocks=True,
                                num_hidden_layers=H256_LAYERS)
            for g, n in GEOMETRIES.items()}
    models = {g: GPTForCausalLM(cfg, device="cuda", dtype=bf16,
                                generator=torch.Generator().manual_seed(0))
              for g, cfg in cfgs.items()}
    rng = np.random.RandomState(13)
    vocab = cfgs["8x256"].vocab_size
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS_13]
    ids = torch.from_numpy(rng.randint(
        0, vocab, (GEN_BATCH_13, GEN_PROMPT_13)).astype(np.int32)).cuda()
    for g, model in models.items():          # warm-up and capture
        for mode in ("default", "fused"):
            with flag_env(GEN_MODES[mode]), graphs_env(True):
                model.generate(ids, max_new_tokens=3)
    cells = ("engine", "engine_int8", "default", "fused")
    rec = {g: {c: [] for c in cells} for g in GEOMETRIES}
    toks, launches = {}, {}
    for g in GEO_TURNS:
        model, cfg = models[g], cfgs[g]
        for cell in cells:
            what = f"bfloat16 GPT-3 1.3B widths {g} {cell}"
            if cell.startswith("engine"):
                out, lc, r = _serve_cell(
                    ops, model, prompts,
                    "int8" if cell == "engine_int8" else None, what)
                if (g, cell) in toks:
                    same_tokens(toks[g, cell], out, f"{what}: turns")
            else:
                out, lc, r = _generate_cell(ops, model, cfg, ids, cell, what)
                if (g, cell) in toks and not torch.equal(toks[g, cell], out):
                    fail(f"{what}: tokens differ between turns")
            toks.setdefault((g, cell), out)
            r["launches"] = {k: n for k, n in lc.items() if n}
            rec[g][cell].append(r)
            if g == "8x256":
                launches[cell] = lc
    for g, model in models.items():
        for cell in cells:
            if cell.startswith("engine"):
                kv = "int8" if cell == "engine_int8" else None
                with graphs_env(True):
                    pr = profile_decode(model, prompts, bf16,
                                        kv_cache_dtype=kv)
            else:
                with flag_env(GEN_MODES[cell]), graphs_env(True):
                    pr = profile_generate(model, ids)
            rec[g][f"{cell}_profile"] = pr
    print_head256(rec, card)
    captures = {g: _captures(m) for g, m in models.items()}
    for g, c in captures.items():
        if c.get("decode") != 2:
            fail(f"bfloat16 GPT-3 1.3B widths {g}: generate captures {c}, "
                 f"expected one a mode")
    rec["captures"] = captures
    del models
    torch.cuda.empty_cache()
    return rec, launches


def head256_train(ops, card, warmup=2, timed=5, batch=2, seq=2048):
    """Phase 13d: configuration B's recipe (`train_1p3b`: GPT-3 1.3B
    stacked, bf16 weights and AdamW moments, ``multi_precision=False``, lr
    2e-4, B=2 S=2048, ``ln_f`` under PTPU_PALLAS_LN; `H256_LAYERS` deep)
    in the two head geometries in turns (`GEO_TURNS`): 8 heads of 256 and
    the preset's 16
    of 128 (the same FLOPs outside attention, and the same attention
    FLOPs), each model from seed 0 with its own optimizer and schedule
    over all its turns' steps, one batch.  Each turn: ``warmup`` +
    ``timed`` steps; losses finite, the launches as `train_launches` (at
    256 the flash forward, dQ and dK/dV one a layer and step each, all on
    `:d256` and `:tc`), ms a step (host clock over the timed steps, synced), tokens
    per second and peak memory beside what was allocated when the turn
    began.  Returns the record and the launches of the 8 x 256 turns."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    bf16 = torch.bfloat16
    env = TRAIN_MODES["flags"]
    steps = warmup + timed
    cfgs = {g: gpt3_1p3b_config(num_attention_heads=n, stacked_blocks=True,
                                num_hidden_layers=H256_LAYERS)
            for g, n in GEOMETRIES.items()}
    rng = np.random.RandomState(3)
    data = [torch.from_numpy(rng.randint(0, cfgs["8x256"].vocab_size,
                                         (batch, seq))).cuda()
            for _ in range(2)]
    models, steppers = {}, {}
    for g, cfg in cfgs.items():
        models[g] = GPTForCausalLM(cfg, device="cuda", dtype=bf16,
                                   generator=torch.Generator().manual_seed(0))
        steppers[g] = make_step(models[g], RECIPE_LR_1P3B,
                                {"steps": GEO_TURNS.count(g) * steps,
                                 "multi_precision": False})
    rec = {g: [] for g in GEOMETRIES}
    launches = {}
    for turn, g in enumerate(GEO_TURNS, 1):
        step, opt = steppers[g]
        with flag_env(env):
            losses, step_ms, lc, peak_gb, before_gb = timed_steps(
                ops, step, data, warmup, timed)
        what = f"recipe B at GPT-3 1.3B widths, {g}, turn {turn}"
        check_train_launches(lc, train_launches(
            cfgs[g], steps, env, dtype=bf16, rows=batch * seq), what)
        if not all(np.isfinite(losses)) or opt._master_weights:
            fail(f"{what}: losses {losses}, {len(opt._master_weights)} "
                 f"masters")
        rec[g].append({"turn": turn, "losses": losses, "ms_per_step": step_ms,
                       "tokens_per_s": batch * seq * 1e3 / step_ms,
                       "peak_memory_gb": peak_gb,
                       "before_turn_gb": before_gb,
                       "launches": {k: n for k, n in lc.items() if n}})
        if g == "8x256":
            launches[f"turn{turn}"] = lc
    del models, steppers
    torch.cuda.empty_cache()
    for g, runs in rec.items():
        print(f"head256 train {g}: recipe B, GPT-3 1.3B widths at "
              f"{H256_LAYERS} layers, bf16, "
              f"B={batch} S={seq}, {warmup} + {timed} steps a turn (turns "
              f"{', '.join(str(r['turn']) for r in runs)}): ms a step "
              + " / ".join(f"{r['ms_per_step']:.3f}" for r in runs)
              + ", tokens/s " + " / ".join(f"{r['tokens_per_s']:.1f}"
                                           for r in runs)
              + "; losses " + " / ".join(
                  f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}"
                  for r in runs)
              + "; peak GB " + " / ".join(
                  f"{r['peak_memory_gb']:.2f} (before {r['before_turn_gb']:.2f})"
                  for r in runs)
              + f"; launches {runs[0]['launches']} ({card})", flush=True)
    return {"batch": f"B={batch} S={seq}", "warmup": warmup,
            "timed_steps": timed, "turns": list(GEO_TURNS), **rec}, launches


def print_head256(rec, card):
    """Phase 13c's lines: a cell and geometry each, its turns' ms a decode
    step and tokens/s, the profiled window's device ms and busy share."""
    for g in GEOMETRIES:
        for cell in ("engine", "engine_int8", "default", "fused"):
            runs, pr = rec[g][cell], rec[g][f"{cell}_profile"]
            busy = ("not measured" if pr["device_ms_per_step"] <= 0 else
                    f"device {pr['device_ms_per_step']:.3f} ms a step, busy "
                    f"{pr['device_busy_share']:.3f}")
            kind = ("engine, " + ("int8" if cell == "engine_int8" else "fp")
                    + f" pools, prompts {list(PROMPT_LENS_13)}, "
                    f"{NEW_TOKENS} new" if cell.startswith("engine") else
                    f"generate {cell}, B={GEN_BATCH_13} "
                    f"{GEN_PROMPT_13}+{GEN_NEW_13}")
            extra = ""
            if cell.startswith("engine"):
                extra = ("; prefill tokens/s " + " / ".join(
                    f"{r['prefill_tok_s']:.1f}" for r in runs)
                    + f"; steps {runs[0]['steps']}")
            print(f"head256 {g} {kind} ({H256_LAYERS} layers, captured, "
                  f"turns): decode ms a step "
                  + " / ".join(f"{r['decode_ms_per_step']:.3f}" for r in runs)
                  + ", decode tokens/s " + " / ".join(
                      f"{r['decode_tok_s']:.1f}" for r in runs)
                  + f"{extra}; profiled window wall "
                  f"{pr['wall_ms_per_step']:.3f} ms a step, {busy}; "
                  f"launches {runs[0]['launches']} ({card})", flush=True)


# ---------------------------------------------------------------------------
# phase 19: head_dim 384, 512, ... (any multiple of 128 past 256)
# ---------------------------------------------------------------------------

H512 = 4                     # GPT-3 1.3B's widths with 4 heads of 512
# the fp32 model of phase 19b: 2 layers of two heads of 512
H512_HIDDEN = 1024
# the decode paths the gates count under PTPU_ATTN_DEBUG=1 (JAX's names)
DECODE_PATHS = ("decode_fallback:head_geometry",
                "ragged_fallback:head_geometry",
                "fused_decode_fallback:head_geometry")


def _wide_counter(kernel, tc):
    """The counter a phase 19a case of `kernel` (a flash kernel or one of
    its variant names) is filed under: the tensor-core forward or dK/dV
    (``tc``: bf16 or fp16 up to `WIDE_TC_MAX_D`), else the CUDA cores'."""
    if kernel.startswith(DQ):
        return DQ_WIDE
    if kernel.startswith(DKV):
        return DKV_WIDE_TC if tc else DKV_WIDE
    return FWD_WIDE_TC if tc else FWD_WIDE


def head512_kernel_cases(fa, tol, timer, cases, kernel_segs):
    """Phase 19a: the flash forward, dQ and dK/dV at D = 384, 512 and 1024
    against their plain versions at the limits of `tolerance` (fp32
    forward ``FP32_FWD``, backward 1e-4 max|ref|), q, k and v slices of
    one fused qkv tensor, each timed with its bound, the plain version's
    time and SDPA's (its whole backward for dQ and dK/dV).  The bf16 and
    fp16 forward and dK/dV run on the tensor cores
    (``csrc/flash_wide_tc.cu``, filed under `FWD_WIDE_TC` and
    `DKV_WIDE_TC`; each such case must move their counters, and no other
    case may), fp32 and dQ on the CUDA cores (``csrc/flash_wide_fwd.cu``,
    ``csrc/flash_wide_bwd.cu``: `FWD_WIDE`, `DQ_WIDE`, `DKV_WIDE`):

    - D = 512, H = 4 (GPT-3 1.3B's widths): causal forward and backward
      at recipe B's B=2 S=2048 in bf16, fp16 and fp32; in bf16 at B=2
      S=1024 every other branch forward and backward (the pad mask,
      kv_lens, the packed batch's segment ids, non-causal);
    - D = 384, H = 4: causal forward and backward at B=2 S=1024 in the
      three types, the pad mask (forward and backward) in fp32 and fp16,
      kv_lens in fp16;
    - D = 1024, H = 2: causal forward and backward in bf16 at B=1 S=1024,
      the segment ids in fp16 and non-causal in fp32 at B=2 S=1024."""
    h = H512
    segs2 = kernel_segs[:2]
    tc_counters = (fa.wide_tc, fa.flash_bwd_dkv.wide_tc)

    def run(d, dtype, check):
        """File the cases of one check ({kernel: case}, or the forward's
        case) and hold the tensor-core counters to its type."""
        before = [c.launches for c in tc_counters]
        found = check()
        if "shape" in found:
            found = {FWD: found}
        tc = dtype != torch.float32 and d <= WIDE_TC_MAX_D
        for kernel, c in found.items():
            cases[_wide_counter(kernel, tc)].append(c)
        moved = [c.launches > n for c, n in zip(tc_counters, before)]
        want = [tc, tc and any(k.startswith(DKV) for k in found)]
        if moved != want:
            fail(f"head_dim {d} {dtype} {sorted(found)}: the tensor-core "
                 f"forward / dK/dV launched {moved}, expected {want}")

    for dtype in HALF_AND_FP32:
        run(512, dtype, lambda: check_flash(fa, tol, timer, 2048, h, 512,
                                            dtype, seed=512, b=2))
        run(512, dtype, lambda: check_flash_bwd(fa, tol, timer, 2, 2048, h,
                                                512, dtype, seed=4097))
        torch.cuda.empty_cache()
    for kind in ("pad", "lens", "segs", "nc"):
        run(512, torch.bfloat16, lambda: check_flash_variant(
            fa, tol, timer, kind, 2, 1024, h, 512, torch.bfloat16,
            seed=1034, segs=segs2 if kind == "segs" else None))
    for dtype in HALF_AND_FP32:
        run(384, dtype, lambda: check_flash(fa, tol, timer, 1024, h, 384,
                                            dtype, seed=384, b=2))
        run(384, dtype, lambda: check_flash_bwd(fa, tol, timer, 2, 1024, h,
                                                384, dtype, seed=3840))
    variants = ((384, "pad", torch.float32), (384, "pad", torch.float16),
                (384, "lens", torch.float16), (1024, "segs", torch.float16),
                (1024, "nc", torch.float32))
    for d, kind, dtype in variants:
        run(d, dtype, lambda: check_flash_variant(
            fa, tol, timer, kind, 2, 1024, 2 if d == 1024 else h, d,
            dtype, seed=d + 1, segs=segs2 if kind == "segs" else None))
    run(1024, torch.bfloat16, lambda: check_flash(
        fa, tol, timer, 1024, 2, 1024, torch.bfloat16, seed=1024))
    run(1024, torch.bfloat16, lambda: check_flash_bwd(
        fa, tol, timer, 1, 1024, 2, 1024, torch.bfloat16, seed=10240))
    torch.cuda.empty_cache()


@contextlib.contextmanager
def path_counts():
    """``PTPU_ATTN_DEBUG=1`` and the attention path counts reset inside;
    yields the dict they are copied into at the end."""
    from paddle_tpu_torch.ops import flash_attention as fa
    saved = os.environ.get("PTPU_ATTN_DEBUG")
    os.environ["PTPU_ATTN_DEBUG"] = "1"
    fa.reset_attention_path_counts()
    counts = {}
    try:
        yield counts
    finally:
        counts.update(fa.attention_path_counts())
        if saved is None:
            os.environ.pop("PTPU_ATTN_DEBUG", None)
        else:
            os.environ["PTPU_ATTN_DEBUG"] = saved


def check_paths(counts, want, what):
    """The decode gates' counts of a run hold exactly the ``want`` names
    (each counted at least once) among `DECODE_PATHS`."""
    got = {n for n, c in counts.items() if n in DECODE_PATHS and c}
    if got != set(want):
        fail(f"{what}: decode paths {counts}, expected {sorted(want)}")


def head512_fp32_card_vs_cpu(ops, card):
    """Phase 19b: a GPT of hidden `H512_HIDDEN` with two heads of 512
    (GPT-3 1.3B's vocab and positions, I = 4 x hidden, stacked), 2
    layers, weights from seed 0, fp32, on the card and on the CPU: the
    engine (phase 3's prompts and settings; decode steps captured) on fp
    and int8 pools, and ``generate`` B=8, 256 + 32 in the default and the
    fused mode (captured): the card's tokens identical to the CPU's; the
    prefill on the wide forward (`FWD_WIDE`), every decode and chunk step
    on the plain attention by the decode gates (their counts under JAX's
    names: the ragged gate's in the engine, the decode gate's, and in the
    fused mode the fused layer's too, in ``generate``), one capture each.
    Then fp32 training of the same widths, stacked and per-layer, 3 AdamW
    steps at B=1 S=512 (`train_fp32_card_vs_cpu`): losses within 1e-5 of
    the CPU's at every step, step-1 gradients within 1e-3 max|g|, the
    launches on the wide forward, dQ and dK/dV.  Returns the record and
    the launches by run."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    f32 = torch.float32
    cfg = gpt3_1p3b_config(hidden_size=H512_HIDDEN, num_attention_heads=2,
                           num_hidden_layers=2,
                           intermediate_size=4 * H512_HIDDEN,
                           stacked_blocks=True)
    models = {dev: GPTForCausalLM(cfg, device=dev,
                                  generator=torch.Generator().manual_seed(0))
              for dev in ("cuda", "cpu")}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    rec, launches = {}, {}
    for kv, key in ((None, "engine"), ("int8", "engine_int8")):
        what = f"float32 head_dim 512 engine, {kv or 'fp'} pools"
        with graphs_env(True), path_counts() as paths:
            outs, eng, lc, stats = serve(models["cuda"], prompts, "cuda",
                                         f32, ops, kv)
        check_launches(eng, lc, what)
        check_paths(paths, ("ragged_fallback:head_geometry",), what)
        cpu = serve(models["cpu"], prompts, "cpu", f32, None, kv)[0]
        same_tokens(outs, cpu, f"{what}: card vs CPU")
        launches[key] = lc
        rec[key] = {"steps": dict(eng.step_counts), "paths": paths,
                    "launches": lc}
        print(f"{what}: the card's tokens equal the CPU run's (prompts "
              f"{list(PROMPT_LENS)}, {NEW_TOKENS} new; steps "
              f"{eng.step_counts}); captures {eng.compiles}; paths {paths}; "
              f"launches { {k: n for k, n in lc.items() if n} } ({card})",
              flush=True)
    batch, prompt, new = 8, 256, 32
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    for mode in ("default", "fused"):
        what = f"float32 head_dim 512 generate ({mode})"
        before = _captures(models["cuda"])
        out = {}
        with flag_env(GEN_MODES[mode]), graphs_env(True):
            for dev, model in models.items():
                ops.reset_launch_counts()
                with path_counts() as paths:
                    out[dev] = model.generate(ids.to(dev),
                                              max_new_tokens=new).cpu()
                if dev == "cuda":
                    lc, card_paths = ops.launch_counts(), paths
        check_gen_launches(lc, mode, cfg, batch, new - 1, what,
                           prompt=prompt)
        check_paths(card_paths, ("decode_fallback:head_geometry",) + (
            ("fused_decode_fallback:head_geometry",) if mode == "fused"
            else ()), what)
        after = _captures(models["cuda"])
        if after.get("decode", 0) != before.get("decode", 0) + 1:
            fail(f"{what}: captures {before} -> {after}, expected one")
        if not torch.equal(out["cuda"], out["cpu"]):
            r, j = (int(i) for i in torch.nonzero(out["cuda"] != out["cpu"])
                    [0])
            fail(f"{what}: card tokens differ from the CPU run at row {r} "
                 f"position {j}")
        launches[mode] = lc
        rec[mode] = {"launches": lc, "paths": card_paths}
        print(f"{what} B={batch} {prompt}+{new}: the card's tokens equal the "
              f"CPU run's; 1 capture; paths {card_paths}; launches "
              f"{ {k: n for k, n in lc.items() if n} } ({card})", flush=True)
    del models
    torch.cuda.empty_cache()
    for layout, stacked in (("stacked", True), ("per-layer", False)):
        tcfg = dataclasses.replace(cfg, stacked_blocks=stacked)
        tr = train_fp32_card_vs_cpu(ops, tcfg, {}, steps=3, seq=512)
        rel = tr["loss_rel_diff"]
        if not max(rel) <= 1e-5:
            fail(f"float32 head_dim 512 training ({layout}): card losses "
                 f"{tr['card_losses']} vs CPU {tr['cpu_losses']} (relative "
                 f"{rel}; limit 1e-5 at every step)")
        key = f"train_{layout}"
        launches[key] = tr["launches"]
        rec[key] = tr
        print(f"float32 head_dim 512 training, {layout}, 2 layers of 2 heads "
              f"of 512 (hidden {H512_HIDDEN}), {tr['batch']}, 3 AdamW "
              f"steps: card losses {tr['card_losses']} vs CPU "
              f"{tr['cpu_losses']} (relative {rel}, limit 1e-5); step-1 "
              f"gradients at most {max(tr['grad_err_over_limit'].values()):.3g}"
              f" of 1e-3 max|g|; launches "
              f"{ {k: n for k, n in tr['launches'].items() if n} } ({card})",
              flush=True)
        torch.cuda.empty_cache()
    return rec, launches


def head512_bf16(ops, card):
    """Phase 19c: GPT-3 1.3B's widths at full depth (24 layers, hidden
    2048, I=8192, vocab 50304) with 4 heads of 512 (``gpt3_1p3b_config(
    num_attention_heads=4)``, stacked), bf16 weights from seed 0: the
    engine (block 16, 8 sequences, 512 batched tokens; `PROMPT_LENS_13`,
    32 new, greedy) on fp and int8 pools, its prefill on the wide forward,
    its decode steps captured with the plain attention by the ragged gate;
    dense ``generate`` B=8, 1024 + 128 in the default and the fused mode,
    warmed up and captured first (one capture a mode), each decode step
    on the plain attention by the decode gates.  Each run's launches as
    expected, its gate counts (JAX's names; ``generate``'s from its
    warm-up, whose steps run the gates eagerly and in the capture, the
    timed ones replaying them) and its wall ms a decode step.
    Returns the record and the launches by cell."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    cfg = gpt3_1p3b_config(num_attention_heads=H512, stacked_blocks=True)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(19)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS_13]
    ids = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (GEN_BATCH_13, GEN_PROMPT_13)).astype(
            np.int32)).cuda()
    warm_paths = {}
    for mode in ("default", "fused"):          # warm-up and capture
        with flag_env(GEN_MODES[mode]), graphs_env(True), \
                path_counts() as warm_paths[mode]:
            model.generate(ids, max_new_tokens=3)
        check_paths(warm_paths[mode], ("decode_fallback:head_geometry",) + (
            ("fused_decode_fallback:head_geometry",) if mode == "fused"
            else ()), f"bfloat16 GPT-3 1.3B widths 4x512 {mode} warm-up")
    rec, launches = {}, {}
    for cell in ("engine", "engine_int8", "default", "fused"):
        what = f"bfloat16 GPT-3 1.3B widths 4x512 {cell}"
        if cell.startswith("engine"):
            # a new engine: its first decode step runs eagerly, the second
            # is captured, both through the gate
            with path_counts() as paths:
                _, lc, r = _serve_cell(
                    ops, model, prompts,
                    "int8" if cell == "engine_int8" else None, what)
            check_paths(paths, ("ragged_fallback:head_geometry",), what)
        else:
            # the captured steps replay: the gate ran in the warm-up
            _, lc, r = _generate_cell(ops, model, cfg, ids, cell, what)
            paths = warm_paths[cell]
        r["launches"] = {k: n for k, n in lc.items() if n}
        r["paths"] = paths
        rec[cell] = r
        launches[cell] = lc
        kind = ("engine, " + ("int8" if cell == "engine_int8" else "fp")
                + f" pools, prompts {list(PROMPT_LENS_13)}, {NEW_TOKENS} "
                f"new: prefill tokens/s {r['prefill_tok_s']:.1f}, steps "
                f"{r['steps']}" if cell.startswith("engine") else
                f"generate {cell}, B={GEN_BATCH_13} "
                f"{GEN_PROMPT_13}+{GEN_NEW_13}: prefill "
                f"{r['prefill_s'] * 1e3:.1f} ms")
        print(f"head512 4x512 {kind} (captured): decode ms a step "
              f"{r['decode_ms_per_step']:.3f}, decode tokens/s "
              f"{r['decode_tok_s']:.1f}; paths {paths}; launches "
              f"{r['launches']} ({card})", flush=True)
    captures = _captures(model)
    if captures.get("decode") != 2:
        fail(f"bfloat16 GPT-3 1.3B widths 4x512: generate captures "
             f"{captures}, expected one a mode")
    rec["captures"] = captures
    del model
    torch.cuda.empty_cache()
    return rec, launches


def head512_train(ops, card, warmup=2, timed=5, batch=2, seq=2048):
    """Phase 19d: configuration B's recipe (as `head256_train`: GPT-3 1.3B
    stacked, bf16 weights and AdamW moments, lr 2e-4, B=2 S=2048,
    ``ln_f`` under PTPU_PALLAS_LN) at 4 heads of 512, from seed 0:
    ``warmup`` + ``timed`` steps; losses finite, the launches as
    `train_launches` (the wide forward, dQ and dK/dV 24 a step each), ms a
    step (host clock over the timed steps, synced), tokens per second and
    peak memory.  Returns the record and the launches."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b_config
    bf16 = torch.bfloat16
    env = TRAIN_MODES["flags"]
    cfg = gpt3_1p3b_config(num_attention_heads=H512, stacked_blocks=True)
    rng = np.random.RandomState(3)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         (batch, seq))).cuda()
            for _ in range(2)]
    model = GPTForCausalLM(cfg, device="cuda", dtype=bf16,
                           generator=torch.Generator().manual_seed(0))
    step, opt = make_step(model, RECIPE_LR_1P3B,
                          {"steps": warmup + timed, "multi_precision": False})
    with flag_env(env):
        losses, step_ms, lc, peak_gb, before_gb = timed_steps(
            ops, step, data, warmup, timed)
    what = "recipe B at GPT-3 1.3B widths, 4x512"
    check_train_launches(lc, train_launches(
        cfg, warmup + timed, env, dtype=bf16, rows=batch * seq), what)
    if not all(np.isfinite(losses)) or opt._master_weights:
        fail(f"{what}: losses {losses}, {len(opt._master_weights)} masters")
    del model, step, opt
    torch.cuda.empty_cache()
    rec = {"batch": f"B={batch} S={seq}", "warmup": warmup,
           "timed_steps": timed, "losses": losses, "ms_per_step": step_ms,
           "tokens_per_s": batch * seq * 1e3 / step_ms,
           "peak_memory_gb": peak_gb, "before_gb": before_gb,
           "launches": {k: n for k, n in lc.items() if n}}
    print(f"head512 train 4x512: recipe B, GPT-3 1.3B widths, bf16, "
          f"B={batch} S={seq}, {warmup} + {timed} steps: ms a step "
          f"{step_ms:.3f}, tokens/s {rec['tokens_per_s']:.1f}; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak GB {peak_gb:.2f} "
          f"(before {before_gb:.2f}); launches {rec['launches']} ({card})",
          flush=True)
    return rec, lc


# ---------------------------------------------------------------------------

def print_cases(cases):
    for name, rows in cases.items():
        for c in rows:
            lib = ("" if c["library_ms"] is None
                   else f" library_ms={c['library_ms']:.4f}")
            if "tol" in c:
                tol = c["tol"]
            elif c["dtype"] != str(torch.float32):
                tol = "tol scaled to each output"
            elif name in (FWD, RAGGED, RAGGED8, FWD_WIDE, *D256_ALL):
                tol = f"tol {TOL_FP32}"
            else:
                tol = f"tol {BWD_REL_FP32} max|ref|"
            rate = ("" if "tflops" not in c
                    else f" {c['tflops']:.1f} TFLOP/s achieved")
            if "design" in c:      # the FFN: TFLOP/s and GB/s both
                rate += (f", {c['gb_per_s']:.1f} GB/s; design "
                         f"{c['design']}; cuBLAS addmm + act + mm (three "
                         f"calls, not one) {c['composite_ms']:.4f}")
            elif "gb_per_s" in c and "splits" not in c:
                rate += f" {c['gb_per_s']:.1f} GB/s achieved"
            if "splits" in c:
                rate += (f" {c['splits']} splits ({c['blocks']} blocks), "
                         f"{c['gb_per_s']:.1f} GB/s achieved")
            if "torch_rand_ms" in c:     # the dropout kernel's yardstick
                rate += (f"; kept {c['kept']:.5f}; torch.rand < keep "
                         f"(torch's Philox, not JAX's bits) "
                         f"{c['torch_rand_ms']:.4f} ms")
            if "write_ms" in c:      # the ragged kernels' two launches
                rate += (f" write alone {c['write_ms']:.4f}, attend alone "
                         f"{c['attend_ms']:.4f} ms; {c['max_splits']} "
                         f"splits a (row, query, head) at most")
            bound = f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}"
            if "cuda_core_bound_ms" in c:      # fp32: split TF32
                bound += (f", split TF32; CUDA cores "
                          f"{c['cuda_core_bound_ms']:.4f}")
            print(f"kernel {name} [{c['shape']} {c['dtype']}] "
                  f"max_abs_err={c['max_abs_err']:.3g} ({tol}; "
                  f"{c['err_over_limit']:.3g} of it) "
                  f"ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                  f"{bound}){rate}{lib}", flush=True)


def print_train(label, rec, launches, card, dtype="bfloat16"):
    p = rec["profile"]
    print(f"train {dtype} GPT-2 124M {label} {rec['batch']}: "
          f"{rec['tokens_per_s']:.1f} tokens/s, {rec['ms_per_step']:.3f} "
          f"ms per step over {rec['timed_steps']} steps ({card}); losses "
          f"{rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}; peak "
          f"memory {rec['peak_memory_gb']:.2f} GB; launches {launches}",
          flush=True)
    if p["device_ms"] > 0:
        print(f"train profile {dtype} {label}: one step {p['wall_ms']:.3f} "
              f"ms ({p['profiled_wall_ms']:.3f} under the profiler), device "
              f"{p['device_ms']:.3f} ms, busy {p['device_busy_share']:.3f}, "
              f"{p['device_ops']:.0f} device ops; by group (ms) "
              + ", ".join(f"{k} {v:.3f}" for k, v in p["ms_by_group"].items())
              + "; top: " + "; ".join(
                  f"{t['name'][:40]} {t['ms_per_step']:.3f} ms"
                  for t in p["top"][:8]), flush=True)
    else:
        print(f"train profile {dtype} {label}: the profiler recorded no "
              f"device time (not measured)", flush=True)


# ---------------------------------------------------------------------------
# phase 14: HTTP serving
# ---------------------------------------------------------------------------

HTTP_LENS = tuple(int(n) for n in np.linspace(7, 700, 16).round())
HTTP_SEEDED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 3}
HTTP_TURNS = ("api", "direct", "direct", "api")
# the telemetry gates for the decode step's cost, in turns
GATE_TURNS = (False, True, True, False)
GATE_SLO = "ttft_p95<1;tpot_p99<0.1;error_rate<0.01"


def http_requests(vocab):
    """Phase 14's requests: (path, body, SamplingParams fields, prompt ids)
    of 16 streamed completions of 7-700 tokens, a streamed and a JSON
    chat, and a seeded JSON completion; 32 new tokens each."""
    rng = np.random.RandomState(14)

    def ids(n):
        return rng.randint(0, vocab, (n,)).tolist()

    reqs = []
    for n in HTTP_LENS:
        p = ids(n)
        reqs.append(("/v1/completions", {"prompt": p, "max_tokens": NEW_TOKENS,
                                         "stream": True}, {}, p))
    for stream, (a, b) in ((True, (12, 90)), (False, (40, 300))):
        system, user = ids(a), ids(b)
        reqs.append(("/v1/chat/completions", {
            "messages": [{"role": "system", "content": system},
                         {"role": "user", "content": user}],
            "max_tokens": NEW_TOKENS, "stream": stream}, {}, system + user))
    p = ids(150)
    reqs.append(("/v1/completions",
                 dict({"prompt": p, "max_tokens": NEW_TOKENS}, **HTTP_SEEDED),
                 dict(HTTP_SEEDED, do_sample=True), p))
    return reqs


def engine14(model, **kw):
    """Phase 14's engine: bf16 on the card, fp pools, block 16, 8
    sequences, whole prompts a step, decode steps captured."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    return LLMEngine(model, EngineConfig(block_size=16, max_num_seqs=8,
                                         device="cuda",
                                         dtype=torch.bfloat16, **kw))


def http_client(url, path, body):
    """One request from a client thread: its token ids, finish reason and
    the host time of the send and of each chunk that carried tokens (one
    chunk an engine step; a JSON body's arrival)."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    out = {"tokens": [], "times": [], "finish": None,
           "sent": time.perf_counter()}
    with urllib.request.urlopen(req, timeout=300) as resp:
        if not body.get("stream"):
            choice = json.loads(resp.read())["choices"][0]
            out["times"].append(time.perf_counter())
            out["tokens"] = choice["token_ids"]
            out["finish"] = choice["finish_reason"]
            return out
        for line in resp:
            line = line.strip()
            if not line:
                continue
            if line == b"data: [DONE]":
                out["done"] = True
                break
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            if choice["token_ids"]:
                out["times"].append(time.perf_counter())
                out["tokens"].extend(choice["token_ids"])
            if choice["finish_reason"] is not None:
                out["finish"] = choice["finish_reason"]
    if not out.get("done"):
        raise RuntimeError(f"{path}: the stream ended without [DONE]")
    return out


def prom_value(text, name, labels=""):
    """One series' value from a Prometheus exposition (None if absent)."""
    m = re.search(rf"^{re.escape(name + labels)} (\S+)$", text, re.M)
    return None if m is None else float(m.group(1))


@contextlib.contextmanager
def capture_windows(windows):
    """Record the host-clock (start, end) of every `StepGraph` capture
    (its ``capture_ms`` back from its return)."""
    from paddle_tpu_torch.graphs import StepGraph
    orig = StepGraph._capture

    def timed(self):
        orig(self)
        t1 = time.perf_counter()
        windows.append((t1 - self.capture_ms / 1e3, t1))

    StepGraph._capture = timed
    try:
        yield
    finally:
        StepGraph._capture = orig


def http_api_turn(ops, model, reqs, what):
    """The requests sent at once from one client thread each to a fresh
    engine behind the port's `ApiServer`, while one more thread scrapes
    the engine's ``/metrics`` and ``/healthz`` in a loop from the end of
    the first decode step until the capture of the second has ended (a
    tighter loop than any scraper runs; outside it, its load would be in
    the turn's latencies): every response
    complete and finished by "stop", every scrape answered 200, at least
    one scrape in flight during the decode step's capture, and the
    endpoint's finished-request and decode-token counters equal to the
    client's counts.  Returns the turn's record, its tokens and the
    kernel launches of the turn."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import ApiServer
    monitor.reset()
    monitor.enable(True)
    eng = engine14(model, metrics_port=0)
    murl = eng.metrics_server.url
    srv = ApiServer(engine=eng, api_keys={})
    results, errors, scrapes, windows = [None] * len(reqs), [], [], []
    stop = threading.Event()

    def scraper():
        # from the end of the first decode step (the eager warm-up) until
        # the second (the capture) has ended: the engine's step counts
        # and the capture's window are host ints, read without a lock
        while eng.step_counts["decode"] < 1 and not stop.is_set():
            time.sleep(0.0005)
        while not (windows or stop.is_set()):
            for route in ("/metrics", "/healthz"):
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(murl + route,
                                                timeout=60) as r:
                        code, body = r.status, r.read()
                    if route == "/healthz":
                        json.loads(body)
                except Exception as e:     # reported as the turn's failure
                    errors.append(f"scrape {route}: {e!r}")
                    return
                scrapes.append((t0, time.perf_counter(), code))

    def client(i):
        path, body = reqs[i][:2]
        try:
            results[i] = http_client(srv.url, path, body)
        except Exception as e:             # reported as the turn's failure
            errors.append(f"request {i}: {e!r}")

    gc.collect()
    ops.reset_launch_counts()
    threads = [threading.Thread(target=scraper)] + [
        threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    with capture_windows(windows):
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join()
        wall = time.perf_counter() - t0
        stop.set()
        threads[0].join()
    launches = ops.launch_counts()
    with urllib.request.urlopen(murl + "/metrics", timeout=60) as r:
        text = r.read().decode()
    srv.stop()
    monitor.stop_server()
    if errors:
        fail(f"{what}: " + "; ".join(errors[:5]))
    if any(r["finish"] != "stop" or len(r["tokens"]) != NEW_TOKENS
           for r in results):
        fail(f"{what}: finishes {[r['finish'] for r in results]}, lengths "
             f"{[len(r['tokens']) for r in results]}")
    if eng.compiles != {"ragged": 1} or len(windows) != 1:
        fail(f"{what}: captures {eng.compiles} ({len(windows)} windows)")
    if any(code != 200 for *_, code in scrapes):
        fail(f"{what}: scrapes answered {sorted({c for *_, c in scrapes})}")
    (c0, c1), = windows
    during = sum(1 for a, b, _ in scrapes if a < c1 and b > c0)
    if not during:
        fail(f"{what}: no scrape in flight during the capture "
             f"({len(scrapes)} scrapes)")
    want = {"finished": len(reqs),
            "decode_tokens": sum(len(r["tokens"]) - 1 for r in results)}
    got = {"finished": prom_value(text, "serving_requests_finished"),
           "decode_tokens": prom_value(text, "serving_decode_tokens")}
    if got != want or prom_value(text, "serving_finish_reason",
                                 '{reason="stop"}') != len(reqs):
        fail(f"{what}: /metrics counts {got}, the client's {want}")
    expected = engine_launches(eng, torch.bfloat16)
    if launches != expected:
        fail(f"{what}: launches {launches}, expected {expected}")
    streamed = [r for r in results if len(r["times"]) > 1]
    ttft = [(r["times"][0] - r["sent"]) * 1e3 for r in streamed]
    tpot = [(r["times"][-1] - r["times"][0]) * 1e3 / (len(r["tokens"]) - 1)
            for r in streamed]
    rec = {"wall_s": wall, "ttft_ms": ttft, "tpot_ms": tpot,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p95_ms": float(np.percentile(ttft, 95)),
           "tpot_p50_ms": float(np.percentile(tpot, 50)),
           "tpot_p95_ms": float(np.percentile(tpot, 95)),
           "scrapes": len(scrapes), "scrapes_during_capture": during,
           "capture_ms": (c1 - c0) * 1e3, "step_counts": eng.step_counts,
           "metrics": got}
    return rec, [r["tokens"] for r in results], launches


def http_direct_turn(model, reqs):
    """The same requests through `LLMEngine.generate` on a fresh engine:
    (wall seconds, tokens)."""
    from paddle_tpu_torch.serving import SamplingParams
    eng = engine14(model)
    prompts = [np.asarray(r[3], np.int32) for r in reqs]
    params = [SamplingParams(max_new_tokens=NEW_TOKENS, **r[2]) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, [o[len(p):].tolist() for o, p in zip(outs, prompts)]


@contextlib.contextmanager
def telemetry_gates(on):
    """Every serving telemetry gate on (monitor, trace, reqlog, an SLO
    engine ticking each second) or off; as the environment says after."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import reqlog, slo, trace
    monitor.enable(on)
    trace.enable(on)
    reqlog.enable(on)
    slo.install(slo.SloEngine(GATE_SLO) if on else None)
    try:
        yield
    finally:
        slo.install(None)
        slo.refresh()
        for m in (monitor, trace, reqlog):
            m.refresh()
        trace.reset()
        reqlog.reset()


def decode_ms_gated(model, reqs, on):
    """Median wall ms of the engine's decode steps past the capture (each
    step synced alone), the first 8 requests served straight from the
    engine, the telemetry gates ``on`` or off."""
    from paddle_tpu_torch.serving import SamplingParams
    with telemetry_gates(on):
        eng = engine14(model)
        ids = [eng.add_request(np.asarray(r[3], np.int32),
                               SamplingParams(max_new_tokens=NEW_TOKENS))
               for r in reqs[:8]]
        times = []
        while eng.has_unfinished():
            decodes = eng.step_counts["decode"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.step_counts["decode"] > decodes >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        for i in ids:
            eng.release_request(i)
    return statistics.median(times)


def http_phase(ops, card):
    """Phase 14 (module docstring): GPT-2 124M served over HTTP.  Returns
    its record and the launches of its first API turn."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    cfg = gpt2_124m_config(stacked_blocks=True)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    reqs = http_requests(cfg.vocab_size)
    turns, tokens, launches = [], [], None
    for i, kind in enumerate(HTTP_TURNS):
        if kind == "api":
            rec, toks, ran = http_api_turn(ops, model, reqs,
                                           f"phase 14 API turn {i + 1}")
            launches = launches or ran
        else:
            wall, toks = http_direct_turn(model, reqs)
            rec = {"wall_s": wall}
        rec["turn"] = kind
        turns.append(rec)
        tokens.append(toks)
        torch.cuda.empty_cache()
    for i, toks in enumerate(tokens[1:], 2):
        for j, (a, b) in enumerate(zip(tokens[0], toks)):
            if a != b:
                first = next(k for k, (x, y) in enumerate(zip(a, b))
                             if x != y)
                fail(f"phase 14: request {j} ({reqs[j][0]}) in turn {i} "
                     f"({HTTP_TURNS[i - 1]}) differs from turn 1 (api) at "
                     f"token {first}")
    gated = [{"on": on, "decode_ms": decode_ms_gated(model, reqs, on)}
             for on in GATE_TURNS]
    api = [t for t in turns if t["turn"] == "api"]
    for t in turns:
        line = f"phase 14 {t['turn']} turn: wall {t['wall_s']:.3f} s"
        if t["turn"] == "api":
            line += (f", TTFT p50 {t['ttft_p50_ms']:.3f} / p95 "
                     f"{t['ttft_p95_ms']:.3f} ms, TPOT p50 "
                     f"{t['tpot_p50_ms']:.3f} / p95 {t['tpot_p95_ms']:.3f} ms"
                     f" ({len(t['ttft_ms'])} streamed), {t['scrapes']} "
                     f"scrapes ({t['scrapes_during_capture']} during the "
                     f"{t['capture_ms']:.1f} ms capture), /metrics "
                     f"{t['metrics']}")
        print(line + f" ({card})", flush=True)
    print(f"phase 14: {len(reqs)} requests (16 streamed of "
          f"{HTTP_LENS[0]}-{HTTP_LENS[-1]} tokens, 2 chats, 1 seeded; "
          f"{NEW_TOKENS} new), API tokens identical to the direct engine's "
          f"in every turn; engine wall ms a decode step, telemetry gates "
          + ", ".join(f"{'on' if g['on'] else 'off'} {g['decode_ms']:.3f}"
                      for g in gated)
          + f"; launches of the first API turn: flash forward "
          f"{launches[FWD]} ({launches[FWD_TC]} on the tensor cores), "
          f"ragged {launches[RAGGED]} ({card})", flush=True)
    return {"turns": turns, "gated_decode_ms": gated,
            "api_ttft_p50_ms": [t["ttft_p50_ms"] for t in api],
            "requests": len(reqs)}, launches



# ---------------------------------------------------------------------------
# phase 15: weight-only low-bit generate
# ---------------------------------------------------------------------------

# the models of phase 15's timed turns, in order
LOWBIT_TURNS = ("fp", "int8", "int4", "int4", "int8", "fp")
LOWBIT_DTYPES = ("int8", "int4")
# the FFN's launch counters, every design and type: none may run for a
# quantized MLP
FFN_ALL = (FFN, FFN_TC, FFN_TC32, FFN_DEC, FFN16, FFN_TC16, FFN_DEC16)


@contextlib.contextmanager
def monitor_on(on):
    """The port's monitor gate ``on`` or off; as the environment says
    after."""
    from paddle_tpu_torch import monitor
    monitor.enable(on)
    try:
        yield monitor
    finally:
        monitor.refresh()


def _tensor_bytes(model):
    """Bytes of a model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in model.param_arrays().values())


def _card_bytes():
    """(bytes the caching allocator was asked for, bytes of its blocks in
    use): a block can hold up to 1 MiB more than was asked of it."""
    stats = torch.cuda.memory_stats()
    return (stats.get("requested_bytes.all.current",
                      stats["allocated_bytes.all.current"]),
            torch.cuda.memory_allocated())


def _same_tokens(a, b, what):
    if not torch.equal(a, b):
        r, j = (int(i) for i in torch.nonzero(a != b)[0])
        fail(f"{what}: tokens differ at row {r} position {j} ({int(a[r, j])}"
             f" against {int(b[r, j])})")


def lowbit_fp32_card_vs_cpu(ops, batch=2, prompt=64, new=16):
    """A 2-layer GPT at GPT-2's widths in fp32 from one seed on the card
    and on the CPU, quantized at int8 and int4 on each: codes and scales
    bitwise equal, greedy tokens identical (the card's decode steps
    captured), the card's launches as expected."""
    from paddle_tpu_torch.lowbit import quantize_for_inference
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    cfg = gpt2_124m_config(num_hidden_layers=2)
    rng = np.random.RandomState(16)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    fp = {dev: GPTForCausalLM(cfg, device=dev,
                              generator=torch.Generator().manual_seed(0))
          for dev in ("cuda", "cpu")}
    ref = fp["cuda"].generate(ids.cuda(), max_new_tokens=new).cpu()
    rec = {}
    for dt in LOWBIT_DTYPES:
        q = {dev: quantize_for_inference(m, dt) for dev, m in fp.items()}
        card, cpu = (q[d].param_arrays() for d in ("cuda", "cpu"))
        for name, t in cpu.items():
            if name.endswith((".qweight", ".scale")) and not torch.equal(
                    card[name].cpu(), t):
                fail(f"float32 {dt} quantization: {name} differs between "
                     f"the card and the CPU")
        out = {}
        for dev, m in q.items():
            ops.reset_launch_counts()
            out[dev] = m.generate(ids.to(dev), max_new_tokens=new).cpu()
            launches = ops.launch_counts()
            if dev == "cuda":
                check_gen_launches(launches, "default", cfg, batch, new - 1,
                                   f"float32 {dt} generate", prompt=prompt)
            elif set(launches.values()) != {0}:
                fail(f"float32 {dt} generate on the CPU launched kernels: "
                     f"{launches}")
        _same_tokens(out["cuda"], out["cpu"],
                     f"float32 {dt} generate, card against CPU")
        rec[dt] = {"tokens_identical": True,
                   "agreement_with_fp": _agreement(out["cuda"], ref, prompt)}
    return rec


def lowbit_phase(ops, card, batch=8, prompt=896, new=128):
    """Phase 15 (module docstring): bf16 GPT-2 124M, per-layer, quantized
    at int8 and int4 from a model that has captured its decode step;
    returns its record and the launches of its runs by name."""
    from paddle_tpu_torch.lowbit import (WeightOnlyLinear,
                                         quantize_for_inference)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.nn import Linear
    cfg = gpt2_124m_config()
    rng = np.random.RandomState(15)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32)).cuda()
    torch.cuda.empty_cache()
    fp = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    fp.generate(ids, max_new_tokens=3)            # warm-up and capture
    if _captures(fp) != {"decode": 1}:
        fail(f"phase 15: fp model captures {_captures(fp)}")
    models, rec, launches_by = {"fp": fp}, {"bytes": {}}, {}
    linears = sum(m.weight.numel() for m in fp.modules()
                  if isinstance(m, Linear))
    for dt in LOWBIT_DTYPES:
        with monitor_on(True) as monitor:
            monitor.reset()
            gc.collect()
            torch.cuda.synchronize()
            before = _card_bytes()
            q = quantize_for_inference(fp, dt)
            gc.collect()
            torch.cuda.synchronize()
            requested, allocated = (a - b for a, b in
                                    zip(_card_bytes(), before))
            snap = monitor.snapshot()
            monitor.reset()
        wols = [m for m in q.modules() if isinstance(m, WeightOnlyLinear)]
        if len(wols) != 4 * cfg.num_hidden_layers or \
                snap.get("lowbit/weight_layers") != len(wols):
            fail(f"phase 15 {dt}: {len(wols)} layers swapped, "
                 f"lowbit/weight_layers {snap.get('lowbit/weight_layers')}")
        want = _tensor_bytes(q)
        if abs(requested - want) > 2 ** 20:
            fail(f"phase 15 {dt}: the copy asked the allocator for "
                 f"{requested} bytes ({allocated} in blocks), its tensors "
                 f"hold {want}")
        if q.compiles or q._decode_steps:
            fail(f"phase 15 {dt}: the copy carries captured steps")
        rec["bytes"][dt] = {
            "linear_elements": linears,
            "dense_bytes_fp32": sum(m.dense_bytes for m in wols),
            "dense_bytes_bf16": 2 * linears,
            "packed_bytes": sum(m.packed_bytes for m in wols),
            "bytes_saved": snap["lowbit/bytes_saved"]["wing=weights"],
            "model_bytes": want, "requested": requested,
            "allocated": allocated,
            "fp_model_bytes": _tensor_bytes(fp)}
        models[dt] = q
    # the timed turns: each decode step one captured graph
    turns, toks = [], {}
    for name in LOWBIT_TURNS:
        m = models[name]
        what = f"phase 15 {name} generate"
        if name not in toks and name != "fp":
            m.generate(ids, max_new_tokens=3)          # warm-up, capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.generate(ids, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = m.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        check_gen_launches(launches, "default", cfg, batch, new - 1, what,
                           dtype=torch.bfloat16, prompt=prompt)
        launches_by.setdefault(name, launches)
        if name in toks:
            _same_tokens(out, toks[name], f"{what}, second turn")
        toks.setdefault(name, out)
        turns.append({"model": name, "prefill_s": prefill_s,
                      "decode_ms_per_step": (total_s - prefill_s) * 1e3
                      / (new - 1)})
    for name, m in models.items():
        if _captures(m) != {"decode": 1}:
            fail(f"phase 15 {name}: captures {_captures(m)}, expected one")
    rec["turns"] = turns
    rec["agreement_with_fp"] = {dt: _agreement(toks[dt], toks["fp"], prompt)
                                for dt in LOWBIT_DTYPES}
    rec["profile"] = {name: profile_generate(m, ids)
                      for name, m in models.items()}
    # under both kernel flags: the LayerNorm kernel, and the FFN only for
    # the float model
    short = ids[:, :128]
    flags = {}
    with flag_env(TRAIN_MODES["flags"]):
        for name in ("fp", "int8"):
            ops.reset_launch_counts()
            models[name].generate(short, max_new_tokens=4)
            flags[name] = ops.launch_counts()
    layers = cfg.num_hidden_layers
    if any(flags["int8"][k] for k in FFN_ALL) or \
            flags["int8"][LN] != (2 * layers + 1) * 4:
        fail(f"phase 15: int8 generate under the flags launched "
             f"{flags['int8']}")
    if not sum(flags["fp"][k] for k in FFN_ALL):
        fail("phase 15: the float model launched no FFN under the flags")
    launches_by["int8 flags"] = flags["int8"]
    rec["flags_launches"] = {k: {n: c for n, c in v.items() if c}
                             for k, v in flags.items()}
    # the original still generates what it did before it was copied
    _same_tokens(fp.generate(ids, max_new_tokens=new), toks["fp"],
                 "phase 15 fp generate after the copies")
    del models
    torch.cuda.empty_cache()
    rec["fp32"] = lowbit_fp32_card_vs_cpu(ops)
    by = {n: [t["decode_ms_per_step"] for t in turns if t["model"] == n]
          for n in ("fp", "int8", "int4")}
    b8 = rec["bytes"]["int8"]
    print(f"phase 15 weight-only generate, bf16 per-layer GPT-2 124M, "
          f"B={batch} {prompt}+{new}, {4 * layers} linears swapped: linear "
          f"bytes bf16 {b8['dense_bytes_bf16']} (JAX's fp32 count "
          f"{b8['dense_bytes_fp32']}), int8 {b8['packed_bytes']}, int4 "
          f"{rec['bytes']['int4']['packed_bytes']}; copies asked the "
          f"allocator for {b8['requested']} / "
          f"{rec['bytes']['int4']['requested']} bytes (blocks "
          f"{b8['allocated']} / {rec['bytes']['int4']['allocated']}), "
          f"their tensors hold {b8['model_bytes']} / "
          f"{rec['bytes']['int4']['model_bytes']} (fp model "
          f"{b8['fp_model_bytes']}); ms a captured decode step "
          f"(turns fp, int8, int4, int4, int8, fp): "
          + ", ".join(f"{t['model']} {t['decode_ms_per_step']:.3f}"
                      for t in turns)
          + "; device ms a step (port kernels / matmul / other): "
          + "; ".join(f"{n} {p['device_ms_per_step']:.3f} ("
                      + " / ".join(f"{v:.3f}" for v in
                                   p["ms_per_step_by_group"].values())
                      + ")" for n, p in rec["profile"].items())
          + f"; greedy agreement with fp int8 "
          f"{rec['agreement_with_fp']['int8']:.3f}, int4 "
          f"{rec['agreement_with_fp']['int4']:.3f} (random weights); the "
          f"fp model captured before the copies, all three captured once; "
          f"under both flags int8 FFN 0, LN {flags['int8'][LN]}; fp32 "
          f"2-layer int8 / int4 codes and tokens equal to the CPU's "
          f"({card})", flush=True)
    rec["decode_ms_per_step"] = by
    return rec, launches_by


# ---------------------------------------------------------------------------
# phase 16: mixture-of-experts GPT
# ---------------------------------------------------------------------------

MOE = {"moe_every_n": 2, "moe_num_experts": 8}


def _moe_layers(model):
    from paddle_tpu_torch.models.gpt import GPTMoEMLP
    return [m for m in model.modules() if isinstance(m, GPTMoEMLP)]


def moe_fp32_card_vs_cpu(ops, steps=2, seq=1024, batch=2, prompt=64,
                         new=16):
    """A 2-layer MoE GPT at GPT-2's widths (block 1 holds 8 experts) in
    fp32 on the card and on the CPU: `steps` AdamW steps at B=1 (losses
    within 1e-5 relative, step-1 gradients within 1e-3 max|g|,
    `train_fp32_card_vs_cpu`), then greedy generate from one seed's
    weights, tokens identical."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    cfg = gpt2_124m_config(num_hidden_layers=2, **MOE)
    rec = train_fp32_card_vs_cpu(ops, cfg, {}, steps=steps, seq=seq)
    if max(rec["loss_rel_diff"]) > 1e-5:
        fail(f"float32 MoE training: card losses {rec['card_losses']} "
             f"against the CPU's {rec['cpu_losses']} (limit 1e-5 relative)")
    rng = np.random.RandomState(17)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        m = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
        out[dev] = m.generate(ids.to(dev), max_new_tokens=new).cpu()
    _same_tokens(out["cuda"], out["cpu"],
                 "float32 MoE generate, card against CPU")
    return rec


def moe_phase(ops, card, batch=8, seq=1024, warmup=2, timed=4,
              prompt=128, new=32):
    """Phase 16 (module docstring): the top-2 MoE GPT at GPT-2's widths;
    returns its record and the launches of its runs by name."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    cfg = gpt2_124m_config(**MOE)
    rec, launches_by = {}, {}
    rec["fp32"] = moe_fp32_card_vs_cpu(ops)
    launches_by["fp32 train"] = rec["fp32"]["launches"]
    torch.cuda.empty_cache()
    rng = np.random.RandomState(2)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(2)]
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    moes = _moe_layers(model)
    n_params = sum(p.numel() for p in model.parameters())
    step, _ = make_step(model)
    losses, aux, ms = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    steps = 0
    # routing telemetry on (the default: one read-back a MoE layer a
    # forward), then off
    for on in (True, False):
        with monitor_on(on):
            for i in range(warmup + timed):
                if i == warmup:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                losses.append(step(data))
                aux.append(torch.stack([m.aux_loss.detach().float()
                                        for m in moes]))
                steps += 1
            torch.cuda.synchronize()
            ms["telemetry on" if on else "telemetry off"] = (
                time.perf_counter() - t0) * 1e3 / timed
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_train_launches(launches, train_launches(
        cfg, steps, {}, dtype=torch.bfloat16, rows=batch * seq),
        "bfloat16 MoE training")
    launches_by["bf16 train"] = launches
    losses = [x.item() for x in losses]
    aux = torch.stack(aux).cpu()
    if not (all(np.isfinite(losses)) and bool(torch.isfinite(aux).all())):
        fail(f"bfloat16 MoE training: losses {losses}, aux {aux.tolist()}")
    if not losses[-1] < losses[0]:
        fail(f"bfloat16 MoE training: loss did not fall, {losses}")
    with monitor_on(False):
        prof = profile_step(step, data)
    rec["train"] = {"batch": f"B={batch} S={seq}", "parameters": n_params,
                    "moe_layers": len(moes), "losses": losses,
                    "aux_first_last": [aux[0].tolist(), aux[-1].tolist()],
                    "ms_per_step": ms, "tokens_per_s": {
                        k: batch * seq * 1e3 / v for k, v in ms.items()},
                    "peak_memory_gb": peak_gb, "profile": prof}
    # an eager forward's routing series
    with monitor_on(True) as monitor, torch.no_grad():
        monitor.reset()
        model(data[0])
        snap = {k: v for k, v in monitor.snapshot().items()
                if k.startswith("moe/")}
        monitor.reset()
        hist = snap.get("moe/tokens_per_expert", {})
        slots = len(moes) * batch * seq * cfg.moe_top_k
        kept = hist.get("sum", 0)
        if hist.get("count") != len(moes) * cfg.moe_num_experts or \
                kept + snap.get("moe/dropped_tokens", -1) != slots or \
                not snap.get("moe/imbalance", 0) >= 1:
            fail(f"phase 16: the eager forward's moe/* series {snap}")
        # generate records nothing: JAX's is one compiled program
        ids = data[0][:, :prompt].to(torch.int32)
        out = {}
        for on in (False, True):
            with graphs_env(on):
                model.generate(ids, max_new_tokens=3)   # warm-up, capture
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[on] = model.generate(ids, max_new_tokens=new)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                gl = ops.launch_counts()
                check_gen_launches(gl, "default", cfg, batch, new - 1,
                                   f"bfloat16 MoE generate "
                                   f"{'captured' if on else 'eager'}",
                                   dtype=torch.bfloat16, prompt=prompt)
                launches_by["generate captured" if on else
                            "generate eager"] = gl
                rec[f"generate_{'captured' if on else 'eager'}_s"] = secs
        after = {k: v for k, v in monitor.snapshot().items()
                 if k.startswith("moe/")}
    _same_tokens(out[True], out[False],
                 "bfloat16 MoE generate, captured against eager")
    if _captures(model) != {"decode": 1}:
        fail(f"phase 16: generate captures {_captures(model)}")
    if after.get("moe/tokens_per_expert", {}).get("count"):
        fail(f"phase 16: generate recorded routing {after}")
    rec["routing"] = {"tokens_per_expert_mean": hist["sum"] / hist["count"],
                      "dropped_tokens": snap["moe/dropped_tokens"],
                      "imbalance": snap["moe/imbalance"], "slots": slots}
    t = rec["train"]
    print(f"phase 16 MoE GPT (GPT-2 124M widths, {len(moes)} of "
          f"{cfg.num_hidden_layers} blocks with {cfg.moe_num_experts} "
          f"experts, top-{cfg.moe_top_k}, capacity factor "
          f"{cfg.moe_capacity_factor}; {n_params} parameters), bf16 AdamW "
          f"B={batch} S={seq}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"aux finite; ms a step telemetry on "
          f"{ms['telemetry on']:.3f} / off {ms['telemetry off']:.3f} "
          f"({t['tokens_per_s']['telemetry off']:.1f} tokens/s off); peak "
          f"{peak_gb:.2f} GB; profiled step device {prof['device_ms']:.3f} "
          f"ms (port kernels / matmul / other "
          + " / ".join(f"{v:.3f}" for v in prof["ms_by_group"].values())
          + f"), busy {prof['device_busy_share']:.3f}; launches a step "
          f"flash forward {launches[FWD] // steps}, dQ {launches[DQ] // steps}"
          f", dK/dV {launches[DKV] // steps}; eager forward: "
          f"{hist['count']} tokens_per_expert observations, "
          f"{snap['moe/dropped_tokens']:.0f} of {slots} slots dropped, "
          f"imbalance {snap['moe/imbalance']:.3f}; generate B={batch} "
          f"{prompt}+{new} captured tokens identical to eager, none "
          f"recorded; fp32 2 layers card vs CPU: losses "
          f"{rec['fp32']['card_losses']} (relative "
          f"{max(rec['fp32']['loss_rel_diff']):.3g}), gradients within "
          f"1e-3 max|g|, tokens identical ({card})", flush=True)
    del model, step
    torch.cuda.empty_cache()
    return rec, launches_by


# ---------------------------------------------------------------------------
# 17. BERT fine-tuning (the layer API and the masked, non-causal flash path)
# ---------------------------------------------------------------------------

# BERT-base's fine-tuning shape (`bench.py:276-313`) and BERT's longest
BERT_SHAPES = ((32, 128), (8, 512))
BERT_B, BERT_S, BERT_LR = 32, 128, 2e-5
# the turns of 17c: the bench's form (dropout 0, no mask), dropout 0.1 with
# the padding mask, and that again with the LayerNorm kernels
BERT_TURNS = {"bench": (False, {}), "dropout": (True, {}),
              "dropout_ln": (True, {"PTPU_PALLAS_LN": "1"})}


def bert_key_mask(b, s, seed):
    """BERT's padding mask, bool [B, 1, 1, S] on the card (True keeps):
    row i keeps its first len_i keys, lengths drawn in 16 .. S from
    ``seed``, the first row whole."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, s + 1, (b,), generator=g)
    lens[0] = s
    keep = torch.arange(s)[None, :] < lens[:, None]
    return keep[:, None, None, :].cuda()


def bert_kernel_cases(fa, tf, tol, timer, cases):
    """Phase 17a: the non-causal flash forward, dQ and dK/dV at BERT-base's
    shapes (H=12 D=64, B=32 S=128 and B=8 S=512), without a mask and with
    the padding mask (`bert_key_mask`, additive [B, 1, 1, S], read by the
    kernels as a stride-0 view over the queries), fp32 and bf16, each
    against its plain version (`check_flash_variant`: the limits of phase
    2), timed beside SDPA given the same mask; the dropout kernel at
    BERT-base's three dropout shapes (`check_threefry`)."""
    for b, s in BERT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("nc", "key"):
                for name, c in check_flash_variant(
                        fa, tol, timer, kind, b, s, 12, 64, dtype,
                        seed=s + b).items():
                    cases[name].append(c)
        torch.cuda.empty_cache()
    for shape in ((BERT_B, BERT_S, 768), (BERT_B, BERT_S, 12, 64),
                  (BERT_B, BERT_S, 3072)):
        cases[THREEFRY].append(check_threefry(tf, timer, shape, 0.9,
                                              seed=len(shape)))


def check_threefry(tf, timer, shape, keep, seed):
    """The dropout kernel against its plain version (`core.random.
    bernoulli` on the card, the same key): bitwise.  Timed with its bound:
    max(the mask's bytes written once over the memory rate, `THREEFRY_OPS`
    32-bit integer operations an element over `INT32_OPS`); no PyTorch call
    draws JAX's bits (library_ms None), so ``torch.rand(shape) < keep``
    (torch's own Philox stream) is timed beside it as a yardstick."""
    from paddle_tpu_torch.core import random as R
    key = R.split(R.PRNGKey(seed))[1]
    got = tf.bernoulli(key, keep, shape, "cuda")
    want = R.bernoulli(key.cuda(), keep, shape)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"threefry_bernoulli {list(shape)}: "
             f"{int((got != want).sum())} of {got.numel()} keep decisions "
             f"differ from the plain version's")
    n = got.numel()
    ms = timer(lambda: tf.bernoulli(key, keep, shape, "cuda"))
    plain_ms = timer(lambda: R.bernoulli(key.cuda(), keep, shape), reps=10)
    rand_ms = timer(lambda: torch.rand(shape, device="cuda") < keep)
    by_bytes, by_ops = n / HBM_BPS * 1e3, THREEFRY_OPS * n / INT32_OPS * 1e3
    return dict(shape=f"{list(shape)} keep {keep}", dtype="torch.bool",
                max_abs_err=0.0, err_over_limit=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None, tol="bitwise", gb_per_s=n / ms / 1e6,
                torch_rand_ms=rand_ms, kept=got.float().mean().item())


def bert_launches(layers, steps, masked, dtype, ln=False):
    """Expected launches of `steps` BERT training steps, its dropout and
    padding mask on (``masked``) or off: the non-causal flash forward, dQ
    and dK/dV once a layer, under ``:mask`` with the padding mask,
    ``:noncausal`` without; with dropout the keep-mask kernel once a site
    (the embeddings, four a layer, the pooled output); under
    PTPU_PALLAS_LN the LayerNorm forward and backward 2 a layer and the
    embeddings' one."""
    want = dict.fromkeys(KERNELS, 0)
    for name in ((FWD_MASK, DQ_MASK, DKV_MASK) if masked
                 else (FWD_NC, DQ_NC, DKV_NC)):
        want[name] = layers * steps
    if masked:
        want[THREEFRY] = (2 + 4 * layers) * steps
    if ln:
        want[LN] = want[LN_BWD] = (2 * layers + 1) * steps
    return with_tc(want, dtype)


def bert_batch(cfg, batch, seq, seed):
    """ids [B, S], labels [B] over 2 classes and the padding mask."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq)))
    labels = torch.from_numpy(rng.randint(0, 2, (batch,)))
    return ids.cuda(), labels.cuda(), bert_key_mask(batch, seq, seed)


def bert_step(model, opt, data, masked, grads=None):
    """One fine-tuning step (`bench.py:296-301`): cross entropy over the
    classifier's logits, backward, AdamW step, clear; returns the loss."""
    from paddle_tpu_torch.nn import functional as PF
    ids, labels, mask = data
    loss = PF.cross_entropy(model(ids, attention_mask=mask if masked
                                  else None), labels)
    loss.backward()
    if grads is not None:
        grads.update({n: p.grad.detach().float().cpu()
                      for n, p in model.named_parameters()})
    opt.step()
    opt.clear_grad()
    return loss.detach()


def bert_fp32_card_vs_cpu(ops, steps=3, batch=2, seq=BERT_S):
    """Phase 17b: a 2-layer fp32 BERT at BERT-base's widths (vocab 30522),
    B=2 S=128, dropout 0.1 and the padding mask, `steps` AdamW steps on the
    card and on the CPU from the same weights (drawn on the card from seed
    0, copied) and the same seed of the key stack, so the same dropout
    masks (threefry is bitwise on both): losses within 1e-5 relative,
    step-1 gradients within 1e-3 max|g| (a key bias's, rounding noise
    around 0 since softmax ignores it, 1e-3 max|g| of its key weight), the
    masked kernels 2 a step."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base_config)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base_config(num_hidden_layers=2)
    paddle_tpu_torch.seed(0)
    card = BertForSequenceClassification(cfg, device="cuda")
    cpu = BertForSequenceClassification(cfg, device="cpu")
    cpu.set_state_dict(card.state_dict())
    data = bert_batch(cfg, batch, seq, seed=5)
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
        model.train()
        paddle_tpu_torch.seed(17)
        grads = {}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [bert_step(model, opt, [t.to(dev) for t in data], True,
                            grads if i == 0 else None).item()
                  for i in range(steps)]
        runs[dev] = dict(losses=losses, grads=grads,
                         launches=ops.launch_counts(),
                         seconds=time.perf_counter() - t0)
    gpu, cpu_run = runs["cuda"], runs["cpu"]
    check_train_launches(gpu["launches"], bert_launches(
        2, steps, True, torch.float32), "float32 BERT training")
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu["losses"],
                                                cpu_run["losses"])]
    if not all(np.isfinite(gpu["losses"])) or max(rel) > 1e-5:
        fail(f"float32 BERT: card losses {gpu['losses']} against the CPU's "
             f"{cpu_run['losses']} (relative {rel}; limit 1e-5)")
    worst = 0.0
    for name, gc in cpu_run["grads"].items():
        err = (gpu["grads"][name] - gc).abs().max().item()
        scale = gc.abs().max().item()
        if name.endswith("k_proj.bias"):
            # softmax ignores the key bias: its gradient is rounding
            # noise around 0 on both devices, held at its layer's scale
            scale = cpu_run["grads"][name[:-4] + "weight"].abs().max().item()
        limit = 1e-3 * scale
        if not err <= limit:
            fail(f"float32 BERT: step-1 gradient of {name} differs by {err} "
                 f"(limit {limit})")
        worst = max(worst, err / limit if limit else 0.0)
    del card, cpu
    return {"batch": f"B={batch} S={seq}", "steps": steps,
            "card_losses": gpu["losses"], "cpu_losses": cpu_run["losses"],
            "loss_rel_diff": rel, "grad_err_over_limit_max": worst,
            "launches": gpu["launches"], "card_s": gpu["seconds"],
            "cpu_s": cpu_run["seconds"]}


def bert_train(ops, card, warmup=2, timed=10, batch=BERT_B, seq=BERT_S):
    """Phase 17c: BERT-base (12 layers, vocab 30522, random weights from
    seed 0) fine-tuned in bf16 with fp32 masters, `bench.py:276-313`'s
    recipe (AdamW lr 2e-5, cross entropy over 2 classes), B=32 S=128, in
    turns (`BERT_TURNS`): ms a step, tokens/s, peak GB, a profiled step
    (device ms by group, busy share) and the launches a step, checked."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base_config)
    from paddle_tpu_torch.optimizer import AdamW
    rec, launches_by = {}, {}
    for turn, (drop, env) in BERT_TURNS.items():
        p = 0.1 if drop else 0.0
        cfg = bert_base_config(hidden_dropout_prob=p,
                               attention_probs_dropout_prob=p)
        paddle_tpu_torch.seed(0)
        model = BertForSequenceClassification(cfg, device="cuda").bfloat16()
        model.train()
        n_params = sum(t.numel() for t in model.parameters())
        opt = AdamW(learning_rate=BERT_LR, parameters=model.parameters())
        data = bert_batch(cfg, batch, seq, seed=7)
        with flag_env(env):
            losses, ms, launches, peak, before = timed_steps(
                ops, lambda d: bert_step(model, opt, d, drop), data, warmup,
                timed)
            check_train_launches(launches, bert_launches(
                cfg.num_hidden_layers, warmup + timed, drop, torch.bfloat16,
                ln=bool(env)), f"bfloat16 BERT-base {turn}")
            prof = profile_step(lambda d: bert_step(model, opt, d, drop),
                                data)
        if not all(np.isfinite(losses)):
            fail(f"bfloat16 BERT-base {turn}: losses {losses}")
        steps = warmup + timed
        rec[turn] = {"batch": f"B={batch} S={seq}", "parameters": n_params,
                     "dropout": p, "mask": drop, "flags": env,
                     "losses": losses, "ms_per_step": ms,
                     "tokens_per_s": batch * seq * 1e3 / ms,
                     "peak_memory_gb": peak, "allocated_before_gb": before,
                     "profile": prof, "launches_per_step": {
                         k: n // steps for k, n in launches.items() if n}}
        launches_by[turn] = launches
        t = rec[turn]
        print(f"phase 17c BERT-base bf16 {turn} (dropout {p}, "
              f"{'padding mask' if drop else 'no mask'}"
              f"{', PTPU_PALLAS_LN=1' if env else ''}), {n_params} "
              f"parameters, B={batch} S={seq}, AdamW lr {BERT_LR} with fp32 "
              f"masters: losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"{ms:.3f} ms a step after {warmup} ({t['tokens_per_s']:.1f} "
              f"tokens/s); profiled step wall {prof['wall_ms']:.3f} ms, "
              f"device {prof['device_ms']:.3f} ms (port kernels / matmul / "
              f"other " + " / ".join(
                  f"{v:.3f}" for v in prof["ms_by_group"].values())
              + f"), busy {prof['device_busy_share']:.3f}, "
              f"{prof['device_ops']:.0f} device ops; peak {peak:.2f} GB; "
              f"launches a step {t['launches_per_step']} ({card})",
              flush=True)
        del model, opt
        torch.cuda.empty_cache()
    return rec, launches_by


def bert_phase(ops, card):
    """Phase 17b and 17c (module docstring); returns the record and the
    launches of its runs by name."""
    rec, launches_by = {}, {}
    t0 = time.perf_counter()
    rec["fp32"] = f32 = bert_fp32_card_vs_cpu(ops)
    launches_by["fp32"] = f32["launches"]
    print(f"phase 17b 2-layer fp32 BERT at BERT-base's widths, "
          f"{f32['batch']}, dropout 0.1, padding mask, {f32['steps']} AdamW "
          f"steps, card against CPU: losses {f32['card_losses']} (relative "
          f"{max(f32['loss_rel_diff']):.3g}, limit 1e-5), step-1 gradients "
          f"{f32['grad_err_over_limit_max']:.3g} of 1e-3 max|g|; masked "
          f"flash launches {f32['launches'][FWD_MASK]} / "
          f"{f32['launches'][DQ_MASK]} / {f32['launches'][DKV_MASK]}; card "
          f"{f32['card_s']:.1f} s, CPU {f32['cpu_s']:.1f} s ({card})",
          flush=True)
    torch.cuda.empty_cache()
    rec["train"], runs = bert_train(ops, card)
    launches_by.update(runs)
    rec["seconds"] = time.perf_counter() - t0
    return rec, launches_by


# ---------------------------------------------------------------------------
# 18. The conv path: ResNet on cuDNN (no kernel of the port's own) and LeNet
# ---------------------------------------------------------------------------

# `bench.py:316-365` (`bench_resnet50`): ResNet-50, bf16 weights and
# images, 224 x 224, B=64, Momentum(0.1, 0.9); bench.py:360-361 counts
# 3 x 4.1 G operations an image a training step (4.1 G: ResNet-50's
# forward multiply-adds at 224 x 224)
RESNET_B, RESNET_HW, RESNET_LR = 64, 224, 0.1
RESNET_OPS_PER_IMAGE = 3 * 4.1e9
RESNET_TURNS = ("NCHW", "NHWC", "NHWC", "NCHW")
# kernel names by group: cuDNN's (and cuBLAS's) products, cuDNN's layout
# transforms, torch's elementwise and reduction kernels (BatchNorm's
# composite, ReLU, the residual adds, casts)
CONV_NAMES = ("conv", "xmma", "implicit", "fprop", "dgrad", "wgrad",
              "cudnn", "cutlass", "nvjet", "gemm")
TRANSFORM_NAMES = ("nchwtonhwc", "nhwctonchw", "nchw2nhwc", "nhwc2nchw",
                   "transpose")
ELEMENTWISE_NAMES = ("elementwise", "reduce", "vectorized", "unrolled",
                     "norm", "welford")


def resnet_group(name):
    low = name.lower()
    if any(n in low for n in TRANSFORM_NAMES):
        return "layout_transform"
    if any(n in low for n in CONV_NAMES):
        return "conv"
    if any(n in low for n in ELEMENTWISE_NAMES):
        return "bn_elementwise"
    return "other"


def profile_resnet_step(step, data):
    """One more step timed alone, then one under torch.profiler: wall ms,
    device ms, busy share, device ops, the top kernels, device ms by
    `resnet_group` and the layout-transform kernels of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(data)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(data)
        torch.cuda.synchronize()
    kernels = sorted(((ev.self_device_time_total, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and ev.self_device_time_total > 0), reverse=True)
    groups = dict.fromkeys(("conv", "bn_elementwise", "layout_transform",
                            "other"), 0.0)
    transforms = 0
    for us, n, name in kernels:
        g = resnet_group(name)
        groups[g] += us / 1e3
        transforms += n if g == "layout_transform" else 0
    device_ms = sum(k[0] for k in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ops": sum(k[1] for k in kernels),
            "layout_transforms": transforms, "ms_by_group": groups,
            "top": [{"name": name[:100], "ms": us / 1e3, "launches": n}
                    for us, n, name in kernels[:12]]}


def resnet_step(model, opt, data, grads=None):
    """One training step of `bench_resnet50`: cross entropy over the
    logits, backward, Momentum step, clear; returns the loss."""
    from paddle_tpu_torch.nn import functional as PF
    x, labels = data
    loss = PF.cross_entropy(model(x), labels)
    loss.backward()
    if grads is not None:
        grads.update({n: p.grad.detach().float().cpu().clone()
                      for n, p in model.named_parameters()})
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _running_stats(model):
    """A copy of the BatchNorms' buffers (a CPU model's would alias its
    live ones)."""
    return {k: v.detach().float().cpu().clone() for k, v in
            model.state_dict().items() if k.endswith(("_mean", "_variance"))}


def conv_card_vs_cpu(what, build, data, steps):
    """``steps`` Momentum(0.01, 0.9) steps of the model ``build(device)``
    on the card and on the CPU from the same weights (the card's, copied)
    and inputs ``data`` (on the CPU): the step-1 loss within 1e-5
    relative, every step-1 gradient within 5e-3 of its norm (a ReLU input
    within rounding of 0 may take the other branch on one device: its
    element's gradient moves by O(1), every tensor before it by ~1e-3 of
    its norm), running statistics after step 1 within 1e-5 and after the
    last within 1e-3 of max(1, max|CPU|), later losses within 1e-3
    relative.  Returns the record."""
    from paddle_tpu_torch.optimizer import Momentum
    card = build("cuda")
    cpu = build("cpu")
    cpu.set_state_dict(card.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        opt = Momentum(learning_rate=0.01, momentum=0.9,
                       parameters=model.parameters())
        model.train()
        d = [t.to(dev) for t in data]
        grads, stats, losses = {}, [], []
        t0 = time.perf_counter()
        for i in range(steps):
            losses.append(resnet_step(model, opt, d,
                                      grads if i == 0 else None).item())
            stats.append(_running_stats(model))
        runs[dev] = dict(losses=losses, grads=grads, stats=stats,
                         seconds=time.perf_counter() - t0)
    gpu, ref = runs["cuda"], runs["cpu"]
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu["losses"], ref["losses"])]
    if not all(np.isfinite(gpu["losses"])) or rel[0] > 1e-5 or \
            max(rel) > 1e-3:
        fail(f"{what}: card losses {gpu['losses']} against the CPU's "
             f"{ref['losses']} (relative {rel}; limits 1e-5 at step 1, "
             f"1e-3 after)")
    worst_l2 = worst_max = 0.0
    for name, gc in ref["grads"].items():
        d = gpu["grads"][name] - gc
        l2 = d.norm().item() / max(gc.norm().item(), 1e-30)
        if not l2 <= 5e-3:
            fail(f"{what}: step-1 gradient of {name} off by {l2:.3g} of its "
                 f"norm (limit 5e-3)")
        worst_l2 = max(worst_l2, l2)
        worst_max = max(worst_max, d.abs().max().item()
                        / max(gc.abs().max().item(), 1e-30))
    worst_stats = []
    for i, limit in ((0, 1e-5), (steps - 1, 1e-3)):
        worst = 0.0
        for k, v in ref["stats"][i].items():
            err = (gpu["stats"][i][k] - v).abs().max().item()
            lim = limit * max(1.0, v.abs().max().item())
            if not err <= lim:
                fail(f"{what}: running statistic {k} after step {i + 1} off "
                     f"by {err} (limit {lim})")
            worst = max(worst, err / lim)
        worst_stats.append(worst)
    return {"steps": steps, "card_losses": gpu["losses"],
            "cpu_losses": ref["losses"], "loss_rel_diff": rel,
            "grad_l2_rel_max": worst_l2, "grad_max_over_max_g": worst_max,
            "stats_err_over_limit": worst_stats,
            "card_s": gpu["seconds"], "cpu_s": ref["seconds"]}


def resnet_fp32_card_vs_cpu(card, batch=4, hw=64):
    """Phase 18a, under torch's default cuDNN flags (TF32 allowed: the
    port's fp32 convolutions pin fp32 themselves): ResNet-18 (10 classes)
    at B=4, 64 x 64, and the ResNeXt bottleneck (``BottleneckBlock(256,
    64, stride=2, downsample, groups=32, base_width=4)``) on [4, 256, 16,
    16], each in NCHW and NHWC, two Momentum steps on the card and on the
    CPU (`conv_card_vs_cpu`)."""
    import paddle_tpu_torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models import BottleneckBlock, resnet18
    if not torch.backends.cudnn.allow_tf32:
        fail("phase 18a must run under torch's default cuDNN flags")
    rec = {}
    g = torch.Generator().manual_seed(18)
    images = torch.randn(batch, 3, hw, hw, generator=g)
    labels = torch.randint(0, 10, (batch,), generator=g)
    feats = torch.randn(batch, 256, 16, 16, generator=g)
    for df in ("NCHW", "NHWC"):
        x = images.permute(0, 2, 3, 1).contiguous() if df == "NHWC" \
            else images
        paddle_tpu_torch.seed(0)
        rec[f"resnet18_{df}"] = r = conv_card_vs_cpu(
            f"fp32 ResNet-18 {df}", lambda dev: resnet18(
                num_classes=10, data_format=df, device=dev), (x, labels), 2)
        print(f"phase 18a fp32 ResNet-18 {df} B={batch} {hw}x{hw}, default "
              f"cuDNN flags (allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32}), 2 Momentum steps, card "
              f"against CPU: losses {r['card_losses']} (relative "
              f"{max(r['loss_rel_diff']):.3g}), step-1 gradients "
              f"{r['grad_l2_rel_max']:.3g} of their norm (limit 5e-3; max "
              f"|err| {r['grad_max_over_max_g']:.3g} of max|g|), running "
              f"statistics {r['stats_err_over_limit'][0]:.3g} / "
              f"{r['stats_err_over_limit'][1]:.3g} of their limits; card "
              f"{r['card_s']:.1f} s, CPU {r['cpu_s']:.1f} s ({card})",
              flush=True)
        xf = feats.permute(0, 2, 3, 1).contiguous() if df == "NHWC" \
            else feats

        class _Head(nn.Layer):
            """The block, then a mean over its output as the loss's
            logits (10 classes from the first channels)."""

            def __init__(self, dev):
                super().__init__()
                self.block = BottleneckBlock(
                    256, 64, stride=2, downsample=nn.Sequential(
                        nn.Conv2D(256, 256, 1, stride=2, bias_attr=False,
                                  data_format=df, device=dev),
                        nn.BatchNorm2D(256, data_format=df, device=dev)),
                    groups=32, base_width=4, data_format=df, device=dev)

            def forward(self, x):
                y = self.block(x)
                y = y.mean((1, 2) if df == "NHWC" else (2, 3))
                return y[:, :10]

        paddle_tpu_torch.seed(1)
        rec[f"resnext_block_{df}"] = r = conv_card_vs_cpu(
            f"fp32 ResNeXt block {df}", _Head, (xf, labels), 2)
        print(f"phase 18a fp32 ResNeXt bottleneck (32 groups of 4) {df} "
              f"[{batch}, 256, 16, 16]: losses {r['card_losses']} (relative "
              f"{max(r['loss_rel_diff']):.3g}), step-1 gradients "
              f"{r['grad_l2_rel_max']:.3g} of their norm, running statistics "
              f"{r['stats_err_over_limit'][0]:.3g} / "
              f"{r['stats_err_over_limit'][1]:.3g} of their limits ({card})",
              flush=True)
    return rec


def resnet50_train(ops, card, warmup=2, timed=10, batch=RESNET_B,
                   hw=RESNET_HW):
    """Phase 18b: `bench_resnet50`'s step, ResNet-50 (1000 classes, random
    weights from seed 0), ``model.bfloat16()``, bf16 images, Momentum(0.1,
    0.9) with fp32 masters, in turns `RESNET_TURNS`: ms a step, images/s,
    model TFLOP/s (bench.py's count) against the bf16 peak, peak GB, a
    profiled step (device ms by group, busy share, device ops, layout
    transforms) and the port's kernel launches (none: the path runs
    cuDNN, cuBLAS and torch's kernels)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(batch, 3, hw, hw).astype(
        np.float32)).to("cuda", torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 1000, (batch,))).cuda()
    rec = {"cudnn_benchmark": torch.backends.cudnn.benchmark,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "turns": []}
    launches_by = {}
    for i, df in enumerate(RESNET_TURNS):
        paddle_tpu_torch.seed(0)
        model = resnet50(num_classes=1000, data_format=df,
                         device="cuda").bfloat16()
        model.train()
        opt = Momentum(learning_rate=RESNET_LR, momentum=0.9,
                       parameters=model.parameters())
        x = images.permute(0, 2, 3, 1).contiguous() if df == "NHWC" \
            else images
        step = lambda d: resnet_step(model, opt, d)      # noqa: E731
        losses, ms, launches, peak, before = timed_steps(
            ops, step, (x, labels), warmup, timed)
        check_train_launches(launches, dict.fromkeys(launches, 0),
                             f"bfloat16 ResNet-50 {df}")
        if not all(np.isfinite(losses)):
            fail(f"bfloat16 ResNet-50 {df}: losses {losses}")
        prof = profile_resnet_step(step, (x, labels))
        tflops = RESNET_OPS_PER_IMAGE * batch / (ms / 1e3) / 1e12
        t = {"layout": df, "batch": batch, "hw": hw, "losses": losses,
             "ms_per_step": ms, "images_per_s": batch * 1e3 / ms,
             "model_tflops": tflops,
             "share_of_bf16_peak": tflops * 1e12 / PEAK[torch.bfloat16],
             "peak_memory_gb": peak, "allocated_before_gb": before,
             "profile": prof}
        rec["turns"].append(t)
        launches_by[f"turn{i + 1}_{df}"] = launches
        print(f"phase 18b ResNet-50 bf16 {df} (turn {i + 1}), B={batch} "
              f"{hw}x{hw}, Momentum lr {RESNET_LR} with fp32 masters, "
              f"cudnn.benchmark {torch.backends.cudnn.benchmark}: losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.3f} ms a step "
              f"after {warmup} ({t['images_per_s']:.1f} images/s, "
              f"{tflops:.1f} model TFLOP/s by bench.py's count, "
              f"{t['share_of_bf16_peak']:.3f} of 989); profiled step wall "
              f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms "
              f"(conv / BN and elementwise / layout transforms / other "
              + " / ".join(f"{v:.3f}" for v in prof["ms_by_group"].values())
              + f"), busy {prof['device_busy_share']:.3f}, "
              f"{prof['device_ops']} device ops, "
              f"{prof['layout_transforms']} layout transforms; peak "
              f"{peak:.2f} GB; top: " + "; ".join(
                  f"{k['name'][:60]} {k['ms']:.3f} ms x{k['launches']}"
                  for k in prof["top"][:6]) + f" ({card})", flush=True)
        del model, opt, x
        torch.cuda.empty_cache()
    return rec, launches_by


def lenet_fit(card, steps_per_epoch=4, epochs=2, batch=64):
    """Phase 18c, rung 1 of the ladder: LeNet on the card through
    ``Model.fit`` on the synthetic ``MNIST(size=256)``, Momentum(0.01,
    0.9), cross entropy, 4 batches of 64 an epoch, two epochs: the loss of
    every step finite, the second epoch's below the first's."""
    import paddle_tpu_torch
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.ravel(logs["loss"])[0]))

    data = MNIST(mode="train", size=steps_per_epoch * batch)
    if not data.synthetic:
        fail("phase 18c expects the synthetic MNIST (no files here)")
    paddle_tpu_torch.seed(0)
    net = LeNet(device="cuda")
    model = Model(net)
    model.prepare(Momentum(learning_rate=0.01, momentum=0.9,
                           parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    rec_losses = Losses()
    t0 = time.perf_counter()
    model.fit(data, batch_size=batch, epochs=epochs, shuffle=False,
              verbose=0, callbacks=[rec_losses])
    seconds = time.perf_counter() - t0
    losses = rec_losses.losses
    first = np.mean(losses[:steps_per_epoch])
    second = np.mean(losses[steps_per_epoch:])
    if len(losses) != steps_per_epoch * epochs or \
            not all(np.isfinite(losses)) or not second < first:
        fail(f"LeNet fit: losses {losses}")
    print(f"phase 18c LeNet Model.fit on synthetic MNIST(size="
          f"{steps_per_epoch * batch}), B={batch}, {epochs} epochs: losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (epoch means {first:.4f}, "
          f"{second:.4f}); {seconds:.2f} s ({card})", flush=True)
    return {"losses": losses, "epoch_means": [first, second],
            "seconds": seconds}


def conv_phase(ops, card):
    """Phase 18 (module docstring); returns the record and the launches of
    its runs by name."""
    rec = {}
    t0 = time.perf_counter()
    rec["fp32"] = resnet_fp32_card_vs_cpu(card)
    torch.cuda.empty_cache()
    rec["resnet50"], launches_by = resnet50_train(ops, card)
    rec["lenet"] = lenet_fit(card)
    rec["seconds"] = time.perf_counter() - t0
    return rec, launches_by


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.ops import fused_decode as fdl
    from paddle_tpu_torch.ops import fused_mlp as fm
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import threefry as tf
    from paddle_tpu_torch.ops import tolerance as tol
    wrappers = {FWD: fa, FWD_MASK: fa.masked, FWD_SEGS: fa.segs,
                FWD_NC: fa.noncausal, FWD_TC: fa.tc, FWD_TC32: fa.tc32,
                FWD_TC16: fa.tc16,
                DQ: fa.flash_bwd_dq, DQ_TC: fa.flash_bwd_dq.tc,
                DQ_TC32: fa.flash_bwd_dq.tc32, DQ_TC16: fa.flash_bwd_dq.tc16,
                DKV: fa.flash_bwd_dkv, DKV_TC: fa.flash_bwd_dkv.tc,
                DKV_TC32: fa.flash_bwd_dkv.tc32,
                DKV_TC16: fa.flash_bwd_dkv.tc16,
                RAGGED: rpa, RAGGED8: rpa.int8, RAGGED16: rpa.fp16,
                RAGGED8_16: rpa.int8_fp16, DECODE16: fd.fp16,
                DECODE: fd, FUSED: fdl, LN: fm.ln_fwd, LN_BWD: fm.ln_bwd,
                FFN: fm.ffn_fwd, FFN_TC: fm.ffn_tc, FFN_TC32: fm.ffn_tc32,
                FFN_DEC: fm.ffn_decode, LN16: fm.ln_fwd16,
                LN_BWD16: fm.ln_bwd16, FFN16: fm.ffn_fwd16,
                FFN_TC16: fm.ffn_tc16, FFN_DEC16: fm.ffn_decode16,
                FWD_D256: fa.d256, FWD_SIMT: fa.simt, RAGGED_D256: rpa.d256,
                RAGGED8_D256: rpa.int8_d256, DECODE_D256: fd.d256,
                FUSED_D256: fdl.d256, DQ_D256: fa.flash_bwd_dq.d256,
                DQ_SIMT: fa.flash_bwd_dq.simt,
                DKV_D256: fa.flash_bwd_dkv.d256,
                DKV_SIMT: fa.flash_bwd_dkv.simt, THREEFRY: tf,
                FWD_WIDE: fa.wide, DQ_WIDE: fa.flash_bwd_dq.wide,
                DKV_WIDE: fa.flash_bwd_dkv.wide, FWD_WIDE_TC: fa.wide_tc,
                DKV_WIDE_TC: fa.flash_bwd_dkv.wide_tc}
    for bwd in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        wrappers.update({v.KERNEL: v for v in bwd.variants.values()})
    assert set(wrappers) == set(ops.launch_counts())

    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        """Record the seconds since the previous mark as phase `name`."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    # -- 1. card -----------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. kernels --------------------------------------------------------
    sources = sorted({w.SOURCE for w in wrappers.values()})
    t0 = time.perf_counter()
    paths = _build.build(sources)
    result["build_s"] = time.perf_counter() - t0
    result["ptxas"] = {}
    for name in sources:
        with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
            result["ptxas"][name] = f.read()
    print(f"built {', '.join(sources)} in {result['build_s']:.1f} s",
          flush=True)
    # registers and spills of the flash kernels' instantiations
    regs = {}
    for name in ("flash_fwd_causal", "flash_bwd_causal", "flash_wide_fwd",
                 "flash_wide_bwd", WIDE_TC):
        for fn, n_regs, st, ld in ptxas_table(result["ptxas"][name]):
            regs[short_name(fn)] = (n_regs, st, ld)
    result["flash_registers"] = regs
    print("ptxas registers (spill stores / loads, bytes) of the flash "
          "instantiations <type, D, MASKED, SEGS, CAUSAL>: " + "; ".join(
              f"{fn} {r}" + (f" ({st}/{ld})" if st or ld else "")
              for fn, (r, st, ld) in sorted(regs.items())), flush=True)
    # ... and of the FFN's designs and the LayerNorm forward (the
    # instantiations GPT-2's width takes: 3 chunks a lane in bf16, 6 fp32)
    regs = {}
    for name in (FFN_TC, FFN_TC32, FFN_DEC, FFN, LN):
        for fn, n_regs, st, ld in ptxas_table(result["ptxas"][name]):
            short = short_name(fn)
            chunks = short.split(",")[3] if short.count(",") == 4 else ""
            if name != LN or chunks in ("3", "6"):
                regs[short] = (n_regs, st, ld)
    result["ffn_ln_registers"] = regs
    print("ptxas registers (spill stores / loads, bytes) of the FFN "
          "designs <type, warpgroups, BN, epilogue> / <type, loads, "
          "epilogue, dependent> and the LayerNorm forward <x, w, y, chunks, "
          "early>: "
          + "; ".join(f"{fn} {r}" + (f" ({st}/{ld})" if st or ld else "")
                      for fn, (r, st, ld) in sorted(regs.items())),
          flush=True)
    # ... and of the split-K decode kernels (ragged, fused layer, decode)
    regs = {}
    for name in (RAGGED, FUSED, DECODE):
        for fn, n_regs, st, ld in ptxas_table(result["ptxas"][name]):
            regs[short_name(fn)] = (n_regs, st, ld)
    result["decode_registers"] = regs
    print("ptxas registers (spill stores / loads, bytes) of the ragged, "
          "fused-layer and decode kernels <q, pool, D> / <type, D>: "
          + "; ".join(f"{fn} {r}" + (f" ({st}/{ld})" if st or ld else "")
                      for fn, (r, st, ld) in sorted(regs.items())),
          flush=True)
    result["sass"] = check_sass(paths)
    print("SASS: " + "; ".join(
        f"{k} {n} instantiations, {h} with HGMMA, {f} with FFMA"
        for k, (n, h, f) in result["sass"].items()), flush=True)
    timer = Timer()
    cases = {name: [] for name in wrappers}
    # the packed training batch's own ids (B=8 S=1024, GPT-2's vocab)
    kernel_segs = packed_batch(50304, 8, 1024)[3]
    same = kernel_segs[:, :, None] == kernel_segs[:, None, :]
    allowed = int((same & torch.ones(1024, 1024, dtype=torch.bool).tril()
                   ).sum())
    result["packed_allowed_pairs"] = {
        "allowed": allowed, "causal": 8 * 1024 * 1025 // 2,
        "fraction_of_causal": allowed / (8 * 1024 * 1025 // 2)}
    print(f"packed batch B=8 S=1024: {allowed} allowed (query, key) pairs, "
          f"{result['packed_allowed_pairs']['fraction_of_causal']:.4f} of "
          f"the causal ones", flush=True)
    del same
    for dtype in (torch.float32, torch.bfloat16):
        for s in (7, 200, 384, 512, 700):
            cases[FWD].append(check_flash(fa, tol, timer, s, 12, 64, dtype,
                                          seed=s))
        cases[FWD].append(check_flash(fa, tol, timer, 512, 16, 128, dtype,
                                      seed=1))
        cases[FWD].append(check_flash(fa, tol, timer, 1024, 12, 64, dtype,
                                      seed=4, b=8))      # training shape
        for b, s, h, d in ((8, 1024, 12, 64), (1, 200, 12, 64),
                           (1, 512, 16, 128)):
            for name, c in check_flash_bwd(fa, tol, timer, b, s, h, d, dtype,
                                           seed=s + d).items():
                cases[name].append(c)
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:     # gpt3_1p3b's training shape (9c)
            cases[FWD].append(check_flash(fa, tol, timer, 2048, 16, 128,
                                          dtype, seed=21, b=2))
            for name, c in check_flash_bwd(fa, tol, timer, 2, 2048, 16, 128,
                                           dtype, seed=22).items():
                cases[name].append(c)
            torch.cuda.empty_cache()
        cases[RAGGED].append(check_ragged(rpa, tol, timer, DECODE_ROWS, 1,
                                          dtype, seed=2))
        cases[RAGGED].append(check_ragged(rpa, tol, timer, [(700, 188)], 188,
                                          dtype, seed=3))
        cases[RAGGED8].append(check_ragged_int8(rpa, tol, timer, DECODE_ROWS,
                                                1, dtype, seed=2))
        cases[RAGGED8].append(check_ragged_int8(rpa, tol, timer,
                                                [(700, 512)], 512, dtype,
                                                seed=3))
        # the split edges (127, 128, 129 keys; the table's full width),
        # gpt3_1p3b's heads (H=16 D=128), and speculative decoding's
        # verify step (8, k+1): rows of 0-4 drafts, a padding row
        for check, key in ((check_ragged, RAGGED),
                           (check_ragged_int8, RAGGED8)):
            cases[key].append(check(rpa, tol, timer, EDGE_ROWS, 1, dtype,
                                    seed=5))
            cases[key].append(check(rpa, tol, timer, DECODE_ROWS, 1, dtype,
                                    seed=6, h=16, d=128))
            cases[key].append(check(rpa, tol, timer, VERIFY_ROWS,
                                    SPEC_K + 1, dtype, seed=8))
        for kind in ("pad", "full", "shared", "lens"):
            cases[FWD_MASK].append(check_flash_masked(fa, tol, timer, kind,
                                                      dtype, seed=7))
            torch.cuda.empty_cache()
        variant_runs = [("segs", 8, 1024, True, True),   # packed training
                        ("nc", 1, 384, True, False),
                        ("nc", 8, 1024, True, False),
                        ("pad", 8, 896, False, True),    # padded shape
                        ("lens", 8, 896, False, True),
                        ("nc", 8, 896, True, True)]
        for kind, b, s, fwd, bwd in variant_runs:
            for name, c in check_flash_variant(
                    fa, tol, timer, kind, b, s, 12, 64, dtype, seed=s + b,
                    segs=kernel_segs if kind == "segs" else None, fwd=fwd,
                    bwd=bwd).items():
                cases[name].append(c)
            torch.cuda.empty_cache()
        # t = 1, 127-129, 511, 1023 (lengths t + 1), one split and the
        # split edges
        for length in (1, 2, 128, 129, 130, 255, 257, 512, 1024):
            cases[DECODE].append(check_decode(fd, tol, timer, 8, 1024, 12,
                                              64, length, dtype, length))
        cases[DECODE].append(check_decode(fd, tol, timer, 8, 1024, 16, 128,
                                          1024, dtype, 5))
        for t in (1, 127, 128, 129, 511, 1023):   # the split edges too
            for masked in (False, True):
                cases[FUSED].append(check_fused_layer(
                    fdl, tol, timer, 8, 12, 64, 1024, t, masked, dtype,
                    seed=t + masked))
        cases[FUSED].append(check_fused_layer(      # gpt3_1p3b's heads
            fdl, tol, timer, 8, 16, 128, 1024, 1023, False, dtype, seed=9))
        for n in (8, 8192):        # decode, training rows; 1002: a row
            for hidden in (768, 1002):   # not in 16-byte chunks
                cases[LN].append(check_ln(fm, tol, timer, n, hidden, dtype,
                                          n + hidden))
        # decode rows, -, -, fp32 training rows (B=1), training rows; then
        # the other activations at a decode and a tensor-core shape; then
        # an intermediate width off 128, which only the CUDA-core design
        # takes
        ffn_runs = [(n, "gelu_tanh", 3072) for n in (8, 256, 512, 1024, 8192)]
        ffn_runs += [(n, act, 3072) for act in ("gelu", "relu")
                     for n in (8, 512)]
        ffn_runs.append((1024, "gelu_tanh", FFN_ODD_INTER))
        for n, act, inter in ffn_runs:
            c = check_ffn(fm, ops, tol, timer, n, 768, inter, act, dtype, n)
            cases[FFN_COUNTER[c["design"]]].append(c)
        torch.cuda.empty_cache()
    for n, xdt, pdt in LN_BWD_CASES:
        cases[LN_BWD].append(check_ln_bwd(fm, tol, timer, n, 768, xdt, pdt,
                                          seed=n + (xdt == pdt)))
    print_cases(cases)
    result["kernel_cases"] = cases
    mark("1-2 card, build, kernels")

    # -- 3. engine ---------------------------------------------------------
    cfg = gpt2_124m_config(stacked_blocks=True)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    gpu32, eng32, launches, st32 = serve(model, prompts, "cuda",
                                         torch.float32, ops)
    expected = check_launches(eng32, launches, "float32 engine")
    cpu32, _, _, _ = serve(model, prompts, "cpu", torch.float32)
    for i, (g, c) in enumerate(zip(gpu32, cpu32)):
        if g.shape != (len(prompts[i]) + NEW_TOKENS,):
            fail(f"request {i}: output shape {g.shape}")
        if not np.array_equal(g, c):
            first = int(np.nonzero(g != c)[0][0])
            fail(f"request {i} (prompt {len(prompts[i])}): GPU float32 "
                 f"tokens differ from the CPU run at position {first} "
                 f"(GPU {g[first]}, CPU {c[first]})")
    print(f"engine float32: tokens identical to the CPU run for "
          f"{len(prompts)} requests, decode steps captured (1 graph, "
          f"{st32['capture_ms']:.1f} ms); launches {launches} == expected "
          f"(replays counted); steps {eng32.step_counts}", flush=True)
    serve(model, prompts[:2], "cuda", torch.bfloat16)          # warm-up
    (gpu16, eng16, launches16, st16), st16_eager = serve_turns(
        model, prompts, torch.bfloat16, ops, None, "bfloat16 engine")
    agree, first_diff = 0, []
    for p, a, b in zip(prompts, gpu32, gpu16):
        ga, gb = a[len(p):], b[len(p):]
        agree += int((ga == gb).sum())
        diff = np.nonzero(ga != gb)[0]
        first_diff.append(int(diff[0]) if diff.size else None)
    total = NEW_TOKENS * len(prompts)
    engine = {}
    for name, st in (("float32", st32), ("bfloat16", st16),
                     ("bfloat16_eager", st16_eager)):
        engine[name] = dict(
            st, prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
            decode_tok_s=st["decode_tokens"] / st["decode_s"])
    engine["bf16_vs_fp32_token_agreement"] = agree / total
    engine["bf16_first_diff_per_request"] = first_diff
    engine["launches_fp32"] = launches
    engine["launches_bf16"] = launches16
    engine["steps"] = eng32.step_counts
    result["engine"] = engine
    for name in ("float32", "bfloat16", "bfloat16_eager"):
        e = engine[name]
        print(f"engine {name}: prefill {e['prefill_tok_s']:.1f} tok/s "
              f"({e['prefill_tokens']} tokens), decode "
              f"{e['decode_tok_s']:.1f} tok/s ({e['decode_tokens']} tokens)"
              f", captures {e['captures']}", flush=True)
    print(f"engine bfloat16: captured tokens identical to the eager run; "
          f"vs float32: {agree}/{total} generated tokens agree; first "
          f"difference per request {first_diff}", flush=True)
    result["decode_profile_bf16"] = profile_turns(
        lambda: profile_decode(model, prompts, torch.bfloat16),
        "engine decode profile bfloat16, fp pools", card)

    mark("3 engine")

    # -- 3b. the int8 KV engine ----------------------------------------------
    gpu8, eng8, launches8, st8 = serve(model, prompts, "cuda", torch.float32,
                                       ops, "int8")
    check_launches(eng8, launches8, "int8 float32 engine")
    cpu8, _, _, _ = serve(model, prompts, "cpu", torch.float32, None, "int8")
    for i, (g, c) in enumerate(zip(gpu8, cpu8)):
        if g.shape != (len(prompts[i]) + NEW_TOKENS,) or not np.array_equal(
                g, c):
            first = int(np.nonzero(g != c)[0][0]) if g.shape == c.shape \
                else -1
            fail(f"int8 engine request {i}: GPU float32 tokens differ from "
                 f"the CPU run at position {first}")
    serve(model, prompts[:2], "cuda", torch.bfloat16, None, "int8")  # warm-up
    (gpu8b, eng8b, launches8b, st8b), st8b_eager = serve_turns(
        model, prompts, torch.bfloat16, ops, "int8", "int8 bfloat16 engine")
    gen = NEW_TOKENS * len(prompts)
    int8 = {
        "num_blocks": {"float32": eng8.cache.num_blocks,
                       "bfloat16": eng8b.cache.num_blocks,
                       "fp_pools": eng32.cache.num_blocks},
        "pool_bytes": {"float32": eng8.cache.pool_bytes,
                       "bfloat16": eng8b.cache.pool_bytes,
                       "fp32_pools": eng32.cache.pool_bytes,
                       "bf16_pools": eng16.cache.pool_bytes},
        "bf16_vs_bf16_fp_token_agreement": sum(
            int((a[len(p):] == b[len(p):]).sum())
            for p, a, b in zip(prompts, gpu8b, gpu16)) / gen,
        "fp32_vs_fp32_fp_token_agreement": sum(
            int((a[len(p):] == b[len(p):]).sum())
            for p, a, b in zip(prompts, gpu8, gpu32)) / gen,
        "launches_fp32": launches8, "steps": eng8.step_counts}
    for name, st in (("float32", st8), ("bfloat16", st8b),
                     ("bfloat16_eager", st8b_eager)):
        int8[name] = dict(
            st, prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
            decode_tok_s=st["decode_tokens"] / st["decode_s"])
    result["engine_int8"] = int8
    print(f"engine int8 float32: tokens identical to the CPU run for "
          f"{len(prompts)} requests; launches {launches8} == expected "
          f"(replays counted); num_blocks {int8['num_blocks']} at pool "
          f"bytes {int8['pool_bytes']}", flush=True)
    for name in ("float32", "bfloat16", "bfloat16_eager"):
        e = int8[name]
        print(f"engine int8 {name}: prefill {e['prefill_tok_s']:.1f} tok/s, "
              f"decode {e['decode_tok_s']:.1f} tok/s, captures "
              f"{e['captures']} ({card})", flush=True)
    print(f"engine int8 bfloat16: captured tokens identical to the eager "
          f"run; token agreement: bfloat16 vs the bfloat16 fp engine "
          f"{int8['bf16_vs_bf16_fp_token_agreement']:.4f}, float32 vs the "
          f"float32 fp engine {int8['fp32_vs_fp32_fp_token_agreement']:.4f}",
          flush=True)
    int8["decode_profile_bf16"] = profile_turns(
        lambda: profile_decode(model, prompts, torch.bfloat16,
                               kv_cache_dtype="int8"),
        "engine decode profile bfloat16, int8 pools", card)
    del model
    torch.cuda.empty_cache()
    mark("3b int8 engine")

    # -- 4. dense generate -------------------------------------------------
    cfg_pl = gpt2_124m_config()            # stacked_blocks=False
    gen32 = generate_fp32_card_vs_cpu(ops, cfg, cfg_pl)
    result["generate_fp32"] = gen32
    for path in GEN_PATHS:
        g = gen32[path]
        print(f"generate float32 GPT-2 124M {path} {gen32['batch']}: card "
              f"tokens (decode steps captured) identical to the CPU run; "
              f"launches {{{', '.join(f'{k}: {n}' for k, n in g['launches'].items() if n)}}} "
              f"== expected; card {g['card_s']:.2f} s, CPU {g['cpu_s']:.1f} "
              f"s", flush=True)
    print(f"generate float32: padded buffers left-aligned; fused vs default "
          f"agreement {gen32['fused_vs_default_token_agreement']:.3f}, "
          f"padded {gen32['padded_fused_vs_default_token_agreement']:.3f}",
          flush=True)
    torch.cuda.empty_cache()
    mark("4 generate fp32")
    gen16, launches_gen = generate_bf16(ops, cfg, cfg_pl, card)
    result["generate_bf16"] = gen16
    print(f"generate bfloat16: fused vs default token agreement "
          f"{gen16['fused_vs_default_token_agreement']:.3f}, padded "
          f"{gen16['padded_fused_vs_default_token_agreement']:.3f}; "
          f"per-layer flags vs default "
          f"{gen16['per_layer_flags_vs_default_token_agreement']:.3f}",
          flush=True)
    torch.cuda.empty_cache()

    mark("4 generate bf16")

    # -- 5. training, float32, card against CPU ----------------------------
    tr32 = train_fp32_card_vs_cpu(ops, cfg, {})
    result["train_fp32"] = tr32
    print(f"train float32 GPT-2 124M {tr32['batch']}: card losses "
          f"{tr32['card_losses']}, CPU {tr32['cpu_losses']} (relative "
          f"{tr32['loss_rel_diff'][0]:.3g} at step 1, "
          f"{tr32['loss_rel_diff'][-1]:.3g} at step {tr32['steps']}); "
          f"step-1 gradients within "
          f"{max(tr32['grad_err_over_limit'].values()):.3g} of 1e-3 "
          f"max|g|; launches {tr32['launches']}; card "
          f"{tr32['card_s']:.1f} s, CPU {tr32['cpu_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    mark("5 train fp32")

    # -- 6. training, bfloat16, full size ----------------------------------
    tr16, launches_train = train_bf16(ops, cfg, {})
    result["train_bf16"] = tr16
    print_train("stacked", tr16, launches_train, card)
    torch.cuda.empty_cache()

    mark("6 train bf16")

    # -- 6b. packed training -----------------------------------------------
    pk32 = train_fp32_card_vs_cpu(ops, cfg, {}, packed=True)
    result["train_packed_fp32"] = pk32
    print(f"train float32 GPT-2 124M {pk32['batch']}: card losses "
          f"{pk32['card_losses']}, CPU {pk32['cpu_losses']} (relative "
          f"{pk32['loss_rel_diff'][0]:.3g} at step 1, "
          f"{pk32['loss_rel_diff'][-1]:.3g} at step {pk32['steps']}); "
          f"step-1 gradients within "
          f"{max(pk32['grad_err_over_limit'].values()):.3g} of 1e-3 "
          f"max|g|; launches {pk32['launches']}; card "
          f"{pk32['card_s']:.1f} s, CPU {pk32['cpu_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    pk16, launches_packed = train_bf16(ops, cfg, {}, packed=True)
    result["train_packed_bf16"] = pk16
    print_train("stacked, packed", pk16, launches_packed, card)
    print(f"train bfloat16 packed vs unpacked, B=8 S=1024: "
          f"{pk16['ms_per_step']:.3f} vs {tr16['ms_per_step']:.3f} ms per "
          f"step; packed {pk16['tokens_per_s']:.1f} tokens/s over all "
          f"positions, {pk16['loss_tokens_per_s']:.1f} over the "
          f"{pk16['loss_tokens']:.0f} loss-mask positions of "
          f"{pk16['segments']} segments ({card})", flush=True)
    torch.cuda.empty_cache()
    mark("6b packed training")

    # -- 6c. entry-point autograd, float32, card against CPU ---------------
    entry, launches_entry = entry_autograd_card_vs_cpu(ops)
    result["entry_autograd_fp32"] = entry
    print(f"entry-point autograd float32 {entry['batch']}: gradients of "
          f"q, k, v within " + ", ".join(
              f"{kind} {max(entry[kind].values()):.3g}"
              for kind in ("nc", "pad", "lens"))
          + f" of 1e-4 max|ref| of the CPU run; launches "
          f"{ {k: n for k, n in launches_entry.items() if n} }", flush=True)
    ffn_entry, launches_ffn_entry = ffn_entry_card_vs_cpu(ops)
    result["entry_ffn_fp32"] = ffn_entry
    print(f"entry-point FFN autograd float32 {ffn_entry['shape']} (the "
          f"CUDA-core design): gradients within "
          f"{max(ffn_entry['grad_err_over_limit'].values()):.3g} of 1e-4 "
          f"max|ref| of the CPU run; launches "
          f"{ {k: n for k, n in launches_ffn_entry.items() if n} }",
          flush=True)
    torch.cuda.empty_cache()
    mark("6c entry-point autograd")

    # -- 7. training, per-layer layout, under the LN and FFN flags ---------
    st = train_stacked_ln_step(ops, cfg)
    result["train_stacked_pallas_ln"] = st
    print(f"train float32 stacked GPT-2 124M {st['batch']} under "
          f"PTPU_PALLAS_LN=1: loss {st['loss']:.4f}; launches "
          f"{st['launches']} == expected (ln_f: one LN forward, one LN "
          f"backward)", flush=True)
    torch.cuda.empty_cache()
    pl32 = train_fp32_card_vs_cpu(ops, cfg_pl, TRAIN_MODES["flags"])
    result["train_per_layer_fp32"] = pl32
    print(f"train float32 per-layer GPT-2 124M {pl32['batch']} under "
          f"PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1: card losses "
          f"{pl32['card_losses']}, CPU {pl32['cpu_losses']} (relative "
          f"{pl32['loss_rel_diff'][0]:.3g} at step 1, "
          f"{pl32['loss_rel_diff'][-1]:.3g} at step {pl32['steps']}); "
          f"step-1 gradients within "
          f"{max(pl32['grad_err_over_limit'].values()):.3g} of 1e-3 "
          f"max|g|; launches {pl32['launches']} == expected; card "
          f"{pl32['card_s']:.1f} s, CPU {pl32['cpu_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    launches_pl = {}
    for mode, env in TRAIN_MODES.items():
        rec, launches_pl[mode] = train_bf16(ops, cfg_pl, env)
        result[f"train_per_layer_bf16_{mode}"] = rec
        print_train(f"per-layer, {mode}", rec, launches_pl[mode], card)
        torch.cuda.empty_cache()

    mark("7 per-layer training")

    # -- 9. the training recipe --------------------------------------------
    recipe = {}
    for name, c in (("stacked", cfg), ("per-layer", cfg_pl)):
        env = {} if c.stacked_blocks else TRAIN_MODES["flags"]
        r = train_fp32_card_vs_cpu(ops, c, env, recipe=True)
        recipe[f"fp32_{name}"] = r
        print(f"recipe float32 {name} GPT-2 124M {r['batch']} (AdamW beta2 "
              f"0.95, wd 0.1 but biases and LNs, clip 1.0, warmup-cosine"
              f"{'; LN and FFN flags' if env else ''}): card losses "
              f"{r['card_losses']}, CPU {r['cpu_losses']} (relative "
              f"{r['loss_rel_diff'][0]:.3g} at step 1, "
              f"{r['loss_rel_diff'][-1]:.3g} at step {r['steps']}); step-1 "
              f"gradients within {max(r['grad_err_over_limit'].values()):.3g}"
              f" of 1e-3 max|g|; launches "
              f"{ {k: n for k, n in r['launches'].items() if n} }",
              flush=True)
        torch.cuda.empty_cache()
    rc = train_recompute_card(ops, cfg)
    recipe["fp32_recompute"] = rc
    print(f"recipe float32 stacked {rc['batch']}: recompute against none on "
          f"the card: bitwise {rc['bitwise']} (max loss difference "
          f"{rc['max_loss_diff']:.3g}, max step-1 gradient difference "
          f"{rc['max_grad_diff']:.3g}); launches with recompute "
          f"{ {k: n for k, n in rc['launches_recompute'].items() if n} }; "
          f"peak over what was allocated before {rc['peak_gb_recompute']:.2f}"
          f" GB against {rc['peak_gb']:.2f}", flush=True)
    mark("9a recipe fp32")
    cfg_a = gpt2_124m_config(**DROPOUT)        # per-layer, configuration A
    tr_a, launches_a = train_bf16(ops, cfg_a, TRAIN_MODES["flags"],
                                  dtype=torch.float32, recipe={"amp": "O1"},
                                  lr=RECIPE_LR)
    recipe["bf16_O1_A"] = tr_a
    print_train("per-layer, configuration A (fp32 weights, O1 bf16, "
                "GradScaler, dropout 0.1, recipe)", tr_a, launches_a, card)
    print(f"recipe A: loss scale {tr_a['scales'][0]:.0f} -> "
          f"{tr_a['scales'][-1]:.0f}, skipped steps {tr_a['skipped_steps']}",
          flush=True)
    torch.cuda.empty_cache()
    drop = dropout_sites(ops, cfg_a)
    recipe["dropout"] = drop
    print(f"recipe A dropout {drop['batch']}: {len(drop['sites'])} sites, "
          f"kept {min(x['kept'] for x in drop['sites']):.5f}-"
          f"{max(x['kept'] for x in drop['sites']):.5f} (at most "
          f"{drop['max_abs_sigmas']:.2f} sigma from 0.9); eval logits "
          f"bitwise those of p = 0: {drop['p0_bitwise_eval']}", flush=True)
    mark("9b recipe A")
    b13 = train_1p3b(ops)
    recipe["gpt3_1p3b"] = b13
    for key in ("no_recompute", "recompute"):
        r = b13[key]
        print(f"recipe B GPT-3 1.3B stacked bf16 {b13['batch']} {key}: "
              f"{r['ms_per_step']:.3f} ms per step, {r['tokens_per_s']:.1f} "
              f"tokens/s over {b13['timed_steps']} steps ({card}); losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; peak memory "
              f"{r['peak_memory_gb']:.2f} GB ({r['before_run_gb']:.2f} "
              f"before the run, weights {r['weights_gb']:.2f}); one more "
              f"step: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                    r["step_memory"].items())
              + f"; launches {dict((k, n) for k, n in r['launches'].items() if n)}",
              flush=True)
    print(f"recipe B: step-1 losses bitwise equal with and without "
          f"recompute: {b13['step1_bitwise']}", flush=True)
    result["recipe"] = recipe
    torch.cuda.empty_cache()
    mark("9c recipe B")

    # -- 10. the high-level Model API ---------------------------------------
    cfg_fit = gpt2_124m_config(vocab_size=50257)      # per-layer, GPT-2's
    fit, launches_fit = fit_phase(ops, cfg_fit, card)
    result["fit"] = fit
    f32 = fit["fp32"]
    print(f"fit float32 per-layer GPT-2 124M {f32['batch']} under "
          f"PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1, {f32['steps']} steps: card "
          f"losses {f32['card_losses']}, CPU {f32['cpu_losses']} (relative "
          f"{f32['loss_rel_diff'][0]:.3g} at step 1, "
          f"{f32['loss_rel_diff'][-1]:.3g} at step {f32['steps']}); "
          f"launches a step "
          f"{ {k: n for k, n in f32['launches_per_step'].items() if n} }; "
          f"card {f32['card_s']:.1f} s, CPU {f32['cpu_s']:.1f} s",
          flush=True)
    t = fit["ms_per_step"]
    print(f"fit bfloat16 per-layer GPT-2 124M {fit['batch']}, both flags, "
          f"{fit['steps']} batches + {fit['eval_batches']} eval batches, "
          f"ModelCheckpoint, PTPU_MONITOR=1: losses {fit['losses'][0]:.4f} "
          f"-> {fit['losses'][-1]:.4f}; ms per step after "
          f"{FIT_WARMUP} (turns bare, fit, fit, bare): bare "
          f"{t['bare'][0]:.3f}, fit {t['fit'][0]:.3f}, fit "
          f"{t['fit'][1]:.3f}, bare {t['bare'][1]:.3f}: Model's own "
          f"{fit['fit_minus_bare_ms']:.3f} ms a step ({card}); "
          f"train/goodput_examples_per_s {fit['goodput_examples_per_s']:.2f}"
          f", train/data_wait_frac {fit['data_wait_frac']:.5f}; whole fit "
          f"(eval, checkpoint) {fit['fit_s']:.1f} s; launches a step "
          f"{ {k: n for k, n in fit['launches_per_step'].items() if n} }, "
          f"eval {({k: n for k, n in fit['eval_launches'].items() if n})}; "
          f"save -> new Model -> load -> predict bitwise equal logits",
          flush=True)
    ts = fit["train_stats"]
    hu = fit["telemetry_host_us"]
    print(f"fit PTPU_TRAIN_STATS: a sampled bf16 step {ts['sampled_ms']:.3f}"
          f" ms against {ts['unsampled_ms']:.3f} unsampled (medians of "
          f"{ts['steps'] // 2} each, each step synced alone; {card}); one "
          f"step's telemetry hooks on the host {hu['off']:.3f} us with the "
          f"gates off, {hu['on']:.3f} us on", flush=True)
    torch.cuda.empty_cache()
    mark("10 Model.fit")

    # -- 11. serving completeness -------------------------------------------
    result["serving"], launches_serving = serving_phase(ops, card)
    mark("11 serving completeness")

    # -- 12. float16 ----------------------------------------------------------
    n_before = {name: len(c) for name, c in cases.items()}
    fp16_kernel_cases(fa, fd, rpa, fm, ops, tol, timer, cases, kernel_segs)
    print_cases({name: c[n_before[name]:] for name, c in cases.items()})
    mark("12a fp16 kernels")
    result["fp16"], launches_fp16 = fp16_phase(ops, card)
    mark("12b-g fp16 engine, generate, recipe A, per-layer flags, pure")

    # -- 13. head_dim 256 ---------------------------------------------------
    n_before = {name: len(c) for name, c in cases.items()}
    head256_kernel_cases(fa, fd, fdl, rpa, tol, timer, cases, kernel_segs)
    print_cases({name: c[n_before[name]:] for name, c in cases.items()})
    mark("13a head_dim 256 kernels")
    result["head256_fp32"], launches_h32 = head256_fp32_card_vs_cpu(ops,
                                                                    card)
    mark("13b head_dim 256 fp32 card vs CPU")
    result["head256_bf16"], launches_h16 = head256_bf16(ops, card)
    mark("13c head_dim 256 bf16 at GPT-3 1.3B widths")
    result["head256_train"], launches_h13d = head256_train(ops, card)
    mark("13d head_dim 256 recipe B training")

    # -- 14. HTTP serving ---------------------------------------------------
    result["http"], launches_http = http_phase(ops, card)
    mark("14 HTTP serving")

    # -- 15. weight-only low-bit generate -----------------------------------
    result["lowbit"], launches_lowbit = lowbit_phase(ops, card)
    mark("15 weight-only low-bit generate")

    # -- 16. mixture of experts ---------------------------------------------
    result["moe"], launches_moe = moe_phase(ops, card)
    mark("16 MoE training and generate")

    # -- 17. BERT fine-tuning -----------------------------------------------
    n_before = {name: len(c) for name, c in cases.items()}
    bert_kernel_cases(fa, tf, tol, timer, cases)
    print_cases({name: c[n_before[name]:] for name, c in cases.items()})
    mark("17a BERT kernels")
    result["bert"], launches_bert = bert_phase(ops, card)
    mark("17b-c BERT fp32 card vs CPU, BERT-base bf16 fine-tune")

    # -- 18. the conv path ----------------------------------------------------
    result["conv"], launches_conv = conv_phase(ops, card)
    mark("18 ResNet fp32 card vs CPU, ResNet-50 bf16, LeNet fit")

    # -- 19. head_dim 384, 512, ... -----------------------------------------
    n_before = {name: len(c) for name, c in cases.items()}
    head512_kernel_cases(fa, tol, timer, cases, kernel_segs)
    print_cases({name: c[n_before[name]:] for name, c in cases.items()})
    mark("19a head_dim 384 / 512 / 1024 kernels")
    result["head512_fp32"], launches_h512_32 = head512_fp32_card_vs_cpu(
        ops, card)
    mark("19b head_dim 512 fp32 card vs CPU")
    result["head512_bf16"], launches_h512_16 = head512_bf16(ops, card)
    mark("19c head_dim 512 bf16 serving and generate at GPT-3 1.3B widths")
    result["head512_train"], launches_h19d = head512_train(ops, card)
    mark("19d head_dim 512 recipe B training")

    # -- 8. summary --------------------------------------------------------
    # the serving kernels at fp32 S=384 / the decode step (the int8 one
    # too); the backward kernels at the training shape in bf16, the
    # training path's dtype; the generate kernels at the bf16 full-context
    # decode step, the masked forward at the bf16 padded prefill
    bf16, f32, f16 = (str(torch.bfloat16), str(torch.float32),
                      str(torch.float16))

    def pick(name, shape, dtype=bf16):
        return next(c for c in cases[name]
                    if c["shape"].startswith(shape) and c["dtype"] == dtype)

    main_case = {FWD: cases[FWD][2], RAGGED: cases[RAGGED][0],
                 FWD_TC: pick(FWD, "B=8 S=1024 H=12 D=64"),
                 DQ_TC: pick(DQ, "B=8 S=1024 H=12 D=64"),
                 DKV_TC: pick(DKV, "B=8 S=1024 H=12 D=64"),
                 FWD_TC32: pick(FWD, "B=8 S=1024 H=12 D=64", f32),
                 DQ_TC32: pick(DQ, "B=8 S=1024 H=12 D=64", f32),
                 DKV_TC32: pick(DKV, "B=8 S=1024 H=12 D=64", f32),
                 RAGGED8: cases[RAGGED8][0],
                 FWD_MASK: pick(FWD_MASK, "B=8 S=896 H=12 D=64 pad"),
                 DQ: cases[DQ][3], DKV: cases[DKV][3],
                 DECODE: pick(DECODE, "B=8 S_max=1024 length=1024 H=12 D=64"),
                 FUSED: pick(FUSED, "B=8 hd=768 H=12 S_max=1024 t=1023 "
                                    "mask=False"),
                 LN: pick(LN, "n=8 H=768"),
                 LN_BWD: pick(LN_BWD, "n=8192 H=768"),
                 FFN: pick(FFN, f"n=1024 H=768 I={FFN_ODD_INTER} gelu_tanh",
                           f32),
                 FFN_TC: pick(FFN_TC, "n=8192 H=768 I=3072 gelu_tanh"),
                 FFN_TC32: pick(FFN_TC32, "n=8192 H=768 I=3072 gelu_tanh",
                                f32),
                 FFN_DEC: pick(FFN_DEC, "n=8 H=768 I=3072 gelu_tanh"),
                 FWD_SEGS: pick(FWD_SEGS, "B=8 S=1024 H=12 D=64 segs"),
                 FWD_NC: pick(FWD_NC, "B=8 S=1024 H=12 D=64 nc"),
                 DQ_SEGS: pick(DQ_SEGS, "B=8 S=1024 H=12 D=64 segs"),
                 DKV_SEGS: pick(DKV_SEGS, "B=8 S=1024 H=12 D=64 segs"),
                 DQ_MASK: pick(DQ_MASK, "B=8 S=896 H=12 D=64 pad"),
                 DKV_MASK: pick(DKV_MASK, "B=8 S=896 H=12 D=64 pad"),
                 DQ_NC: pick(DQ_NC, "B=8 S=896 H=12 D=64 nc"),
                 DKV_NC: pick(DKV_NC, "B=8 S=896 H=12 D=64 nc"),
                 FWD_TC16: pick(FWD_TC16, "B=8 S=1024 H=12 D=64", f16),
                 DQ_TC16: pick(DQ_TC16, "B=8 S=1024 H=12 D=64", f16),
                 DKV_TC16: pick(DKV_TC16, "B=8 S=1024 H=12 D=64", f16),
                 RAGGED16: cases[RAGGED16][0],
                 RAGGED8_16: cases[RAGGED8_16][0],
                 DECODE16: pick(DECODE16,
                                "B=8 S_max=1024 length=1024 H=12 D=64", f16),
                 LN16: pick(LN16, "n=8192 H=768", f16),
                 LN_BWD16: pick(LN_BWD16, "n=8192 H=768", f16),
                 FFN16: pick(FFN16, f"n=1024 H=768 I={FFN_ODD_INTER} "
                                    f"gelu_tanh", f16),
                 FFN_TC16: pick(FFN_TC16, "n=8192 H=768 I=3072 gelu_tanh",
                                f16),
                 FFN_DEC16: pick(FFN_DEC16, "n=8 H=768 I=3072 gelu_tanh",
                                 f16),
                 FWD_D256: pick(FWD_D256, "B=1 S=2048 H=8 D=256"),
                 FWD_SIMT: pick(FWD_SIMT, "B=1 S=2048 H=8 D=256", f32),
                 RAGGED_D256: pick(RAGGED_D256, "B=8 C=1 "),
                 RAGGED8_D256: pick(RAGGED8_D256, "B=8 C=1 "),
                 DECODE_D256: pick(DECODE_D256,
                                   "B=8 S_max=2048 length=2048 H=8 D=256"),
                 FUSED_D256: pick(FUSED_D256, "B=8 hd=2048 H=8 S_max=2048 "
                                              "t=1023 mask=False"),
                 DQ_D256: pick(DQ_D256, "B=2 S=2048 H=8 D=256"),
                 DKV_D256: pick(DKV_D256, "B=2 S=2048 H=8 D=256"),
                 DQ_SIMT: pick(DQ_SIMT, "B=2 S=2048 H=8 D=256", f32),
                 DKV_SIMT: pick(DKV_SIMT, "B=2 S=2048 H=8 D=256", f32),
                 THREEFRY: pick(THREEFRY, "[32, 128, 3072]", "torch.bool"),
                 FWD_WIDE: pick(FWD_WIDE, "B=2 S=2048 H=4 D=512", f32),
                 DQ_WIDE: pick(DQ_WIDE, "B=2 S=2048 H=4 D=512"),
                 DKV_WIDE: pick(DKV_WIDE, "B=2 S=2048 H=4 D=512", f32),
                 FWD_WIDE_TC: pick(FWD_WIDE_TC, "B=2 S=2048 H=4 D=512"),
                 DKV_WIDE_TC: pick(DKV_WIDE_TC, "B=2 S=2048 H=4 D=512")}
    path_launches = {FWD: launches[FWD], RAGGED: launches[RAGGED],
                     RAGGED8: launches8[RAGGED8],
                     FWD_MASK: launches_gen["stacked default padded"][FWD_MASK],
                     DQ: launches_train[DQ], DKV: launches_train[DKV],
                     FWD_TC: launches_train[FWD_TC],
                     DQ_TC: launches_train[DQ_TC],
                     DKV_TC: launches_train[DKV_TC],
                     FWD_TC32: tr32["launches"][FWD_TC32],
                     DQ_TC32: tr32["launches"][DQ_TC32],
                     DKV_TC32: tr32["launches"][DKV_TC32],
                     DECODE: launches_gen["stacked default"][DECODE],
                     FUSED: launches_gen["stacked fused"][FUSED],
                     LN: launches_gen["stacked fused"][LN],
                     LN_BWD: launches_pl["flags"][LN_BWD],
                     FFN: launches_ffn_entry[FFN],
                     FFN_TC: launches_pl["flags"][FFN_TC],
                     FFN_TC32: pl32["launches"][FFN_TC32],
                     FFN_DEC: launches_gen["stacked fused"][FFN_DEC]}
    for name in (FWD_SEGS, DQ_SEGS, DKV_SEGS):
        path_launches[name] = launches_packed[name]
    for name in (FWD_NC, DQ_NC, DKV_NC, DQ_MASK, DKV_MASK):
        path_launches[name] = launches_entry[name]
    # the fp16 counters: the flash kernels in phase 12's O1 recipe run,
    # the ragged kernel in its engines, the decode kernel in its generate
    for name in (FWD_TC16, DQ_TC16, DKV_TC16):
        path_launches[name] = launches_fp16["O1"][name]
    path_launches[RAGGED16] = launches_fp16["engine"][RAGGED16]
    path_launches[RAGGED8_16] = launches_fp16["engine_int8"][RAGGED8_16]
    path_launches[DECODE16] = launches_fp16["generate"][DECODE16]
    # ... the LayerNorm's in the pure fp16 run (forward and backward at
    # 8192 rows), the FFN's tensor cores in recipe A's fp16 O1 run with the
    # flags, its decode design in the per-layer fp16 generate, its CUDA
    # cores in the fp16 entry-point call
    path_launches[LN16] = launches_fp16["pure"][LN16]
    path_launches[LN_BWD16] = launches_fp16["pure"][LN_BWD16]
    path_launches[FFN_TC16] = launches_fp16["O1_flags"][FFN_TC16]
    path_launches[FFN_DEC16] = launches_fp16["generate_flags"][FFN_DEC16]
    path_launches[FFN16] = launches_fp16["ffn_entry"][FFN16]
    # the D = 256 counters: phase 13c's bf16 runs at 8 heads of 256 (the
    # engine's prefill and decode on fp and int8 pools, generate's two
    # modes), the CUDA-core fp32 forward in 13b's fp32 engine
    path_launches[FWD_D256] = launches_h16["engine"][FWD_D256]
    path_launches[RAGGED_D256] = launches_h16["engine"][RAGGED_D256]
    path_launches[RAGGED8_D256] = launches_h16["engine_int8"][RAGGED8_D256]
    path_launches[DECODE_D256] = launches_h16["default"][DECODE_D256]
    path_launches[FUSED_D256] = launches_h16["fused"][FUSED_D256]
    path_launches[FWD_SIMT] = launches_h32["engine"][FWD_SIMT]
    # ... the backward's: phase 13d's first 8 x 256 turn of recipe B (bf16),
    # the CUDA-core fp32 dQ and dK/dV in 13b's stacked fp32 training
    for name in (DQ_D256, DKV_D256):
        path_launches[name] = launches_h13d["turn1"][name]
    for name in (DQ_SIMT, DKV_SIMT):
        path_launches[name] = launches_h32["train_stacked"][name]
    # dropout's keep masks: phase 17c's BERT-base turn with dropout
    path_launches[THREEFRY] = launches_bert["dropout"][THREEFRY]
    # head_dim 512: the tensor-core forward in 19c's bf16 fp engine (its
    # prefill), dQ and the tensor-core dK/dV in 19d's recipe B run; the
    # CUDA-core forward and dK/dV in 19b's fp32 engine and stacked training
    path_launches[FWD_WIDE_TC] = launches_h512_16["engine"][FWD_WIDE_TC]
    for name in (DQ_WIDE, DKV_WIDE_TC):
        path_launches[name] = launches_h19d[name]
    path_launches[FWD_WIDE] = launches_h512_32["engine"][FWD_WIDE]
    path_launches[DKV_WIDE] = launches_h512_32["train_stacked"][DKV_WIDE]
    kernels = []
    for name in KERNELS:
        c = main_case[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{wrappers[name].SOURCE}.cu",
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "case": f"{c['shape']} {c['dtype']}"})
    # launches of the per-layer bf16 training run under both flags, of
    # phase 10's bf16 fit (12 train and 2 eval batches) and of phase 11
    for k in kernels:
        k["launches_training"] = launches_pl["flags"][k["name"]]
        k["launches_fit"] = launches_fit[k["name"]]
        k["launches_serving"] = launches_serving[k["name"]]
        k["launches_fp16"] = sum(run[k["name"]]
                                 for run in launches_fp16.values())
        k["launches_head256"] = sum(
            run[k["name"]]
            for runs in (launches_h32, launches_h16, launches_h13d)
            for run in runs.values())
        k["launches_http"] = launches_http[k["name"]]
        k["launches_lowbit"] = sum(run[k["name"]]
                                   for run in launches_lowbit.values())
        k["launches_moe"] = sum(run[k["name"]]
                                for run in launches_moe.values())
        k["launches_bert"] = sum(run[k["name"]]
                                 for run in launches_bert.values())
        k["launches_resnet"] = sum(run[k["name"]]
                                   for run in launches_conv.values())
        k["launches_head512"] = launches_h19d[k["name"]] + sum(
            run[k["name"]] for runs in (launches_h512_32, launches_h512_16)
            for run in runs.values())
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    result["kernels"] = kernels
    result["expected_launches"] = expected
    result["phase_s"] = phase_s
    result["seconds"] = sum(phase_s.values())
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phase_s.items())
          + f"; the whole run {result['seconds']:.1f} s of its 1200 s limit",
          flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --probe [--quick] [--parent DIR]: the designs of the
# FFN and the LayerNorm forward at GPT-2 124M's MLP
# ---------------------------------------------------------------------------

PROBE_ROWS = (8, 16, 24, 32, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# edits of a source that build the alternatives the kernels measured
# against: the decode FFN's second product queued after the first (not as
# its programmatic dependent), the LayerNorm forward with 4 and 8 rows a
# block, the LayerNorm backward with a ring of 2 and 4 rows
PROBE_VARIANTS = {
    "ffn_decode_serial": ("fused_ffn_decode", [(
        "  cfg.numAttrs = DEPENDENT ? 1 : 0;\n", "  cfg.numAttrs = 0;\n")]),
    "ln_rows4": ("fused_layernorm", [(
        "constexpr int ROWS = 1; ", "constexpr int ROWS = 4; ")]),
    "ln_rows8": ("fused_layernorm", [(
        "constexpr int ROWS = 1; ", "constexpr int ROWS = 8; ")]),
    "ln_bwd_ring2": ("fused_layernorm_bwd", [(
        "constexpr int NBUF = 3; ", "constexpr int NBUF = 2; ")]),
    "ln_bwd_ring4": ("fused_layernorm_bwd", [(
        "constexpr int NBUF = 3; ", "constexpr int NBUF = 4; ")]),
}


def build_variants(sources):
    """{label: ctypes library} of ``sources`` {label: (path, [(old, new)])}:
    each source with every ``old`` replaced (it must occur once), built
    with the kernels' flags into ``csrc/build/probe/<label>.so``, all
    ``nvcc`` processes at once.  An edited source is written there too,
    its headers found in ``paddle_tpu_torch/csrc``; an unedited one is
    built in place, its headers found beside it."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, (path, edits) in sources.items():
        if edits:
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                if text.count(old) != 1:
                    fail(f"probe variant {label}: {old!r} is not in "
                         f"{path} once")
                text = text.replace(old, new)
            path = os.path.join(out_dir, label + ".cu")
            with open(path, "w") as f:
                f.write(text)
        lib = os.path.join(out_dir, label + ".so")
        procs[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", _build.SRC_DIR, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"probe variant {label}: nvcc exit {proc.returncode}\n{log}")
        libs[label] = ctypes.CDLL(lib)
    return libs


def _c_fn(lib, name, argtypes):
    import ctypes
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def probe_ffn_args(n, dtype, seed, h=768, i=3072):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    return (rnd(n, h), rnd(h, i, scale=h ** -0.5), rnd(i, scale=0.1),
            rnd(i, h, scale=i ** -0.5))


def probe_decode(lib, args, l1, l2, act="gelu_tanh"):
    """The decode FFN through `lib` with ``l1``, ``l2`` loads a thread."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    x, w1, b1, w2 = args
    (n, h), i, h2 = x.shape, w1.shape[1], w2.shape[1]
    dt = x.dtype
    cw = 128 // dt.itemsize
    hbuf = torch.empty((n, i), dtype=dt, device="cuda")
    y = torch.empty((n, h2), dtype=dt, device="cuda")
    p1 = torch.empty((h // (32 * l1), n, i), device="cuda")
    p2 = torch.empty((i // (32 * l2), n, h2), device="cuda")
    tk = _build.tickets(x.device, -(-n // 8) * (i + h2) // cw)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _c_fn(lib, "fused_ffn_decode", [vp] * 9 + [ci] * 8 + [vp])
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), hbuf.data_ptr(), y.data_ptr(),
                    p1.data_ptr(), p2.data_ptr(), tk.data_ptr(), n, h, i,
                    h2, l1, l2, ("gelu", "gelu_tanh", "relu").index(act),
                    _build.dtype_code(dt),
                    torch.cuda.current_stream().cuda_stream),
                 "fused_ffn_decode")
    return y


def probe_tc(lib, args, tiles, act="gelu_tanh"):
    """The tensor-core FFN through `lib` with ``tiles`` ((warpgroups, BN)
    of each product)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    x, w1, b1, w2 = args
    (n, h), i, h2 = x.shape, w1.shape[1], w2.shape[1]
    (g1, n1), (g2, n2) = tiles
    hbuf = torch.empty((n, i), dtype=x.dtype, device="cuda")
    y = torch.empty((n, h2), dtype=x.dtype, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _c_fn(lib, "fused_ffn_tc", [vp] * 6 + [ci] * 10 + [vp])
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), hbuf.data_ptr(), y.data_ptr(), n, h, i,
                    h2, ("gelu", "gelu_tanh", "relu").index(act), g1, n1,
                    g2, n2, _build.dtype_code(x.dtype),
                    torch.cuda.current_stream().cuda_stream),
                 "fused_ffn_tc")
    return y


def probe_tc32(lib, args, tiles, act="gelu_tanh"):
    """The split-TF32 FFN through `lib` with ``tiles`` ((warpgroups, BN) of
    each product)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    x, w1, b1, w2 = args
    (n, h), i, h2 = x.shape, w1.shape[1], w2.shape[1]
    (g1, n1), (g2, n2) = tiles
    hbuf = torch.empty((n, i), device="cuda")
    w1t = torch.empty((2, i, h), device="cuda")
    w2t = torch.empty((2, h2, i), device="cuda")
    y = torch.empty((n, h2), device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _c_fn(lib, "fused_ffn_tc32", [vp] * 8 + [ci] * 9 + [vp])
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), hbuf.data_ptr(), w1t.data_ptr(),
                    w2t.data_ptr(), y.data_ptr(), n, h, i, h2,
                    ("gelu", "gelu_tanh", "relu").index(act), g1, n1, g2, n2,
                    torch.cuda.current_stream().cuda_stream),
                 "fused_ffn_tc32")
    return y


def probe_kernel_ms(fn, calls=20):
    """{kernel name: device ms per call} of `fn` under torch.profiler
    (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[short_name(e.key)] = us / 1e3 / calls
    return out


def probe_cuda_core(lib, args, act):
    """The CUDA-core FFN through `lib` (its type a code: 0 fp32, as the
    bf16 flag of a tree from before reads it)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_mlp as fm
    x, w1, b1, w2 = args
    (n, h), i, h2 = x.shape, w1.shape[1], w2.shape[1]
    bi = fm.ffn_slice(n, i)
    tiles, slices = -(-n // 8), i // bi
    groups = -(-slices // 16)
    y = torch.empty((n, h2), dtype=x.dtype, device="cuda")
    part = torch.empty((slices + groups, n, h2), device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _c_fn(lib, "fused_ffn", [vp] * 7 + [ci] * 7 + [vp])
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), y.data_ptr(), part.data_ptr(),
                    _build.tickets(x.device, tiles * (groups + 1)).data_ptr(),
                    n, h, i, h2, bi, ("gelu", "gelu_tanh", "relu").index(act),
                    _build.dtype_code(x.dtype),
                    torch.cuda.current_stream().cuda_stream), "fused_ffn")
    return y


def probe_ln(lib, x, w, b):
    """The LayerNorm forward's y through `lib`."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    n, h = x.shape
    y = torch.empty((n, h), dtype=torch.promote_types(x.dtype, w.dtype),
                    device="cuda")
    mu = torch.empty((n, 1), device="cuda")
    rs = torch.empty((n, 1), device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _c_fn(lib, "fused_layernorm",
               [vp] * 6 + [ci] * 4 + [ctypes.c_float, vp])
    _build.check(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    mu.data_ptr(), rs.data_ptr(), n, h,
                    _build.dtype_code(x.dtype), _build.dtype_code(w.dtype),
                    1e-5, torch.cuda.current_stream().cuda_stream),
                 "fused_layernorm")
    return y


def probe_ln_bwd(lib, x, w, mu, rs, dy, plan):
    """(dx, dw, db) of the LayerNorm backward in ``lib`` under ``plan``
    (an `LnBwdPlan`), as `fused_layernorm_bwd` launches it."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    n, h = x.shape
    dx = torch.empty_like(x)
    dw, db = (torch.empty(h, dtype=w.dtype, device="cuda") for _ in range(2))
    part = _build.scratch("probe_ln_bwd", x.device, (plan.grid + plan.groups)
                          * (-(-2 * h // 4) * 4) * 4)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    err = _c_fn(lib, "fused_layernorm_bwd", [vp] * 10 + [ci] * 10 + [vp])(
        x.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part,
        _build.tickets(x.device, plan.groups + 1).data_ptr(), n, h,
        plan.grid, plan.warps, plan.s, plan.seg, plan.k, int(plan.wide),
        _build.dtype_code(x.dtype), _build.dtype_code(w.dtype),
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"layernorm backward probe: CUDA error {err}")
    return dx, dw, db


def probe_ln_bwd_plans(fm, n, h, dtype, sms):
    """The planner's plan for [n, h] and the row design's others: every
    chunk count a lane may hold (1 to `NC_MAX`: 2 in bf16, 3 in fp32)
    whose warps a row stay within 16, laid out as the planner lays out
    its own."""
    import math
    v = 16 // dtype.itemsize
    nvec = h // v
    base = fm.ln_bwd_plan(n, h, dtype, sms)
    plans = [base]
    for nc in range(1, 3 if v == 8 else 4):
        s = -(-nvec // (32 * nc))
        if s > 16 or s == base.s:
            continue
        g = 16 // s
        grid = max(1, min(-(-n // (2 * g)), sms))
        plans.append(base._replace(
            grid=grid, warps=s * g, s=s, seg=-(-nvec // s),
            k=grid if grid <= 16 else math.isqrt(grid - 1) + 1))
    return plans


def probe_check_ffn(fm, tol, design, n, dtype, act="gelu_tanh"):
    args = probe_ffn_args(n, dtype, n)
    launch = fm._FFN_LAUNCH[design]
    y, y2 = launch(*args, act), launch(*args, act)
    yr = fm.fused_ffn_reference(*args, act)
    torch.cuda.synchronize()
    limit = (FFN_REL_FP32 * yr.float().abs().max().item()
             if dtype == torch.float32 else tol.ffn_limit(*args, act))
    err, ratio, ok = tol.compare(y, yr, limit)
    same = torch.equal(y, y2)
    print(f"check ffn {design} n={n} {act} {dtype}: max_abs_err={err:.3g} "
          f"({ratio:.3g} of its limit) repeat bitwise={same}", flush=True)
    return ok and same


def probe_check_ln(fm, tol, hidden, xdt, pdt, off, n=37):
    g = torch.Generator().manual_seed(hidden + off)
    xs = torch.randn(n * hidden + off, generator=g) * 2 + 0.5
    x = xs.to("cuda", xdt)[off:].view(n, hidden)
    w = (1 + 0.1 * torch.randn(hidden + off, generator=g)).to(
        "cuda", pdt)[off:]
    b = (0.1 * torch.randn(hidden, generator=g)).to("cuda", pdt)
    y, mu, rs = fm.fused_layernorm_arrays(x, w, b, return_stats=True)
    yr, mur, rsr = fm.fused_layernorm_reference(x, w, b)
    torch.cuda.synchronize()
    lim = (TOL_FP32 if y.dtype == torch.float32 else tol.ln_limit(
        y, yr, x, w, b))
    err, ratio, good = tol.compare(y, yr, lim)
    stats = bool(((mu - mur).abs() <= 1e-5 * mur.abs() + 1e-6).all()
                 and ((rs - rsr).abs() <= 1e-5 * rsr.abs()).all())
    print(f"check layernorm H={hidden} x {xdt} w {pdt} offset {off}: "
          f"max_abs_err={err:.3g} ({ratio:.3g} of its limit) stats "
          f"ok={stats}", flush=True)
    return good and stats


def probe(argv):
    """Build the FFN's four sources and the LayerNorm forward and backward
    and print their registers and spills; hold every FFN design at the rows it may
    take and every activation, and the LayerNorm forward at H 768, 1000,
    1002 and 4096 (bf16, fp16, fp32, mixed; a base one element past 16
    bytes too), against their plain versions with phase 2's limits and a
    repeat bitwise.  Unless ``--quick``, then time at H=768 I=3072
    gelu_tanh (this script's timer): each design in bf16, fp16 and fp32
    at 8 to 8192 rows beside
    the cuBLAS composite and the bound (fp32: split TF32); the decode
    design against its second product queued after the first, and with
    every number of loads a thread of each product at 8 rows; the two
    tensor-core designs with every tile of each product at 256, 512, 1024
    and 8192 rows, and the split-TF32 design's device ms by kernel (its
    transposing pre-pass and its two products; torch.profiler); a copy of h's
    bytes at 8192 rows; the LayerNorm forward with 1, 4 and 8 rows a
    block at 8, 64 and 8192 rows beside ``F.layer_norm``; the LayerNorm
    backward at `LN_BWD_CASES` under the planner's plan with rings of 2,
    3 and 4 rows and under every other number of warps a row the row
    design takes (each checked within its limits).  With
    ``--parent DIR``, the fp32 CUDA-core FFN of DIR's
    ``paddle_tpu_torch/csrc/fused_ffn.cu`` is held bitwise against this
    tree's on 12 cases.  Exits non-zero on a failed check."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the probe needs a GPU")
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_mlp as fm
    from paddle_tpu_torch.ops import tolerance as tol
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    names = [FFN_TC, FFN_TC32, FFN_DEC, FFN, LN, LN_BWD]
    paths = _build.build(names)
    for name in names:
        with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
            for fn, regs, st, ld in ptxas_table(f.read()):
                print(f"ptxas {name} {fn}: {regs} registers, spill "
                      f"{st}/{ld} bytes", flush=True)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    ok = True
    for design, dtype, rows in (("tc", bf16, (64, 200, 256, 512, 8192)),
                                ("tc", f16, (24, 64, 200, 512, 8192)),
                                ("tc32", f32, (8, 64, 200, 256, 512, 1024,
                                               8192)),
                                ("decode", bf16, (8, 40, 64, 256)),
                                ("decode", f16, (8, 16, 40, 256)),
                                ("decode", f32, (8, 40, 64, 256)),
                                ("cuda_core", f32, (8, 512)),
                                ("cuda_core", f16, (8, 512))):
        for n in rows:
            ok &= probe_check_ffn(fm, tol, design, n, dtype)
    for act in ("gelu", "relu"):
        ok &= probe_check_ffn(fm, tol, "tc", 512, bf16, act)
        ok &= probe_check_ffn(fm, tol, "tc", 512, f16, act)
        ok &= probe_check_ffn(fm, tol, "tc32", 512, f32, act)
        ok &= probe_check_ffn(fm, tol, "decode", 8, bf16, act)
        ok &= probe_check_ffn(fm, tol, "decode", 8, f16, act)
        ok &= probe_check_ffn(fm, tol, "decode", 8, f32, act)
    for hidden in (768, 1000, 1002, 4096):
        for xdt, pdt in ((bf16, bf16), (f32, f32), (bf16, f32), (f16, f16),
                         (f16, f32)):
            for off in (0, 1):
                ok &= probe_check_ln(fm, tol, hidden, xdt, pdt, off)
    sources = {label: (os.path.join(_build.SRC_DIR, src + ".cu"), edits)
               for label, (src, edits) in PROBE_VARIANTS.items()}
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv \
        else None
    if parent:
        sources["parent_fused_ffn"] = (os.path.join(
            parent, "paddle_tpu_torch", "csrc", "fused_ffn.cu"), [])
    libs = build_variants(sources)
    if parent:
        import ctypes
        own = ctypes.CDLL(paths[FFN])
        same = 0
        for n, h, i in ((1024, 768, 3072), (8192, 768, 3072),
                        (8, 256, 400), (512, 256, 400)):
            args = probe_ffn_args(n, f32, n + i, h, i)
            for act in ("gelu", "gelu_tanh", "relu"):
                same += torch.equal(probe_cuda_core(own, args, act),
                                    probe_cuda_core(libs["parent_fused_ffn"],
                                                    args, act))
        print(f"fp32 CUDA-core FFN: {same} of 12 outputs bitwise the "
              f"parent's ({parent})", flush=True)
        ok &= same == 12
    if not ok:
        fail("a probe check failed")
    if "--quick" in argv:
        print("probe checks passed", flush=True)
        return
    own = {name: _build.load(name) for name in (FFN_TC, FFN_TC32, FFN_DEC)}
    timer = Timer()
    for dtype in (bf16, f16, f32):
        item = dtype.itemsize
        for n in PROBE_ROWS:
            args = probe_ffn_args(n, dtype, 1)
            x, w1, b1, w2 = args
            bnd = flash_bound((2 * 768 * 3072 + 3072 + 2 * n * 768) * item,
                              4 * n * 768 * 3072, dtype)
            bms, by = bnd["bound_ms"], bnd["bound_by"]
            cub = timer(lambda: torch.mm(torch.nn.functional.gelu(
                torch.addmm(b1, x, w1), approximate="tanh"), w2))
            line = (f"ffn n={n} {dtype}: bound {bms:.4f} ({by}), cuBLAS "
                    f"addmm+gelu+mm {cub:.4f}")
            for design in (("tc", "decode") if dtype != f32
                           else ("decode", "tc32", "cuda_core")):
                if design == "decode" and n > (4096 if dtype == f32
                                               else 1024):
                    continue      # 1024 row tiles: 0.6 GB of partials
                launch = fm._FFN_LAUNCH[design]
                ms = timer(lambda: launch(*args, "gelu_tanh"))
                line += f", {design} {ms:.4f}"
                if design == "decode":
                    l1 = fm.ffn_decode_loads(n, 768, 3072, dtype)
                    l2 = fm.ffn_decode_loads(n, 3072, 768, dtype)
                    ms = timer(lambda: probe_decode(
                        libs["ffn_decode_serial"], args, l1, l2))
                    line += f" (second product queued after {ms:.4f})"
            print(f"{line}; picked {fm.ffn_design(n, 768, 3072, dtype)}",
                  flush=True)
            del args, x, w1, b1, w2
    for dtype in (bf16, f16, f32):
        args = probe_ffn_args(8, dtype, 3)
        for l1 in (4, 8, 16):
            for l2 in (4, 8, 16):
                if 768 % (32 * l1) or 3072 % (32 * l2):
                    continue
                ms = timer(lambda: probe_decode(own[FFN_DEC], args, l1, l2))
                print(f"ffn decode loads n=8 {dtype}: {l1} / {l2}: "
                      f"{ms:.4f} ms", flush=True)
        print(f"ffn decode loads n=8 {dtype}: picker "
              f"{fm.ffn_decode_loads(8, 768, 3072, dtype)} / "
              f"{fm.ffn_decode_loads(8, 3072, 768, dtype)}", flush=True)
    for n in (256, 512, 1024, 8192):
        args = probe_ffn_args(n, bf16, 2)
        first, second = fm.ffn_tc_tiles(n, 3072, 768)
        for t1 in fm._TC_TILES:
            ms = timer(lambda: probe_tc(own[FFN_TC], args, (t1, second)))
            print(f"ffn tc tiles n={n}: first {t1} second {second}: "
                  f"{ms:.4f} ms", flush=True)
        for t2 in fm._TC_TILES:
            ms = timer(lambda: probe_tc(own[FFN_TC], args, (first, t2)))
            print(f"ffn tc tiles n={n}: first {first} second {t2}: "
                  f"{ms:.4f} ms", flush=True)
        print(f"ffn tc tiles n={n}: picker {(first, second)}", flush=True)
        args = probe_ffn_args(n, f32, 2)
        first, second = fm.ffn_tc_tiles(n, 3072, 768, tiles=fm._TC32_TILES)
        for t1 in fm._TC32_TILES:
            ms = timer(lambda: probe_tc32(own[FFN_TC32], args, (t1, second)))
            print(f"ffn tc32 tiles n={n}: first {t1} second {second}: "
                  f"{ms:.4f} ms", flush=True)
        for t2 in fm._TC32_TILES:
            ms = timer(lambda: probe_tc32(own[FFN_TC32], args, (first, t2)))
            print(f"ffn tc32 tiles n={n}: first {first} second {t2}: "
                  f"{ms:.4f} ms", flush=True)
        print(f"ffn tc32 tiles n={n}: picker {(first, second)}; device ms "
              f"by kernel (torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in probe_kernel_ms(
                      lambda: probe_tc32(own[FFN_TC32], args,
                                         (first, second))).items()),
              flush=True)
    hb = torch.empty(8192, 3072, dtype=bf16, device="cuda")
    hc = torch.empty_like(hb)
    print(f"ffn tc: one write and one read of h [8192, 3072] bf16 (a "
          f"copy): {timer(lambda: hc.copy_(hb)):.4f} ms", flush=True)
    del hb, hc
    ln_libs = {1: _build.load(LN), 4: libs["ln_rows4"], 8: libs["ln_rows8"]}
    for n in (8, 64, 8192):
        for dtype in (bf16, f16, f32):
            g = torch.Generator().manual_seed(n)
            x = (torch.randn(n, 768, generator=g) * 2 + 0.5).to("cuda", dtype)
            w = (1 + 0.1 * torch.randn(768, generator=g)).to("cuda", dtype)
            b = (0.1 * torch.randn(768, generator=g)).to("cuda", dtype)
            lib = timer(lambda: torch.nn.functional.layer_norm(
                x, (768,), w, b, 1e-5))
            line = f"layernorm n={n} {dtype}: F.layer_norm {lib:.4f}"
            want = probe_ln(ln_libs[1], x, w, b)
            for rows, ln_lib in ln_libs.items():
                ms = timer(lambda: probe_ln(ln_lib, x, w, b))
                same = torch.equal(probe_ln(ln_lib, x, w, b), want)
                line += f", {rows} rows a block {ms:.4f} (y bitwise {same})"
            print(line, flush=True)
    bwd_libs = {3: _build.load(LN_BWD), 2: libs["ln_bwd_ring2"],
                4: libs["ln_bwd_ring4"]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, xdt, pdt in LN_BWD_CASES:
        g = torch.Generator().manual_seed(n)
        x = (torch.randn(n, 768, generator=g) * 2 + 0.5).to("cuda", xdt)
        w = (1 + 0.1 * torch.randn(768, generator=g)).to("cuda", pdt)
        b = (0.1 * torch.randn(768, generator=g)).to("cuda", pdt)
        dy = torch.randn(n, 768, generator=g).to(
            "cuda", torch.promote_types(xdt, pdt))
        _, mu, rs = fm.fused_layernorm_reference(x, w, b)
        want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
        line = f"layernorm backward n={n} x {xdt}, w {pdt}:"
        for i, plan in enumerate(probe_ln_bwd_plans(fm, n, 768, xdt, sms)):
            for ring, lib in bwd_libs.items():
                if i and ring != 3:
                    continue
                got = probe_ln_bwd(lib, x, w, mu, rs, dy, plan)
                for gv, wv, lim in zip(got, want, tol.ln_bwd_limits(
                        got, want, x, w, mu, rs, dy)):
                    if not tol.compare(gv, wv, lim)[2]:
                        fail(f"layernorm backward probe n={n}: {plan}, "
                             f"ring {ring}, outside the limits")
                ms = timer(lambda: probe_ln_bwd(lib, x, w, mu, rs, dy, plan))
                line += (f" {plan.s} warps a row, grid {plan.grid}, ring "
                         f"{ring}{' (picked)' if i == 0 and ring == 3 else ''}"
                         f" {ms:.4f};")
        print(line, flush=True)


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --paths DIR: host and device time of the paths the
# FFN and LayerNorm designs run on, for the paddle_tpu_torch of DIR
# ---------------------------------------------------------------------------

def host_us(fn, calls=200, warmup=20):
    """Host microseconds of one call of `fn`, enqueued `calls` times back
    to back with no sync between (the card runs behind)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def decode_digest(fd, b, s_max, h, d, length, dtype, seed):
    """sha256 of the flash decode kernel's output on `check_decode`'s
    inputs: two trees whose digests agree give the same bits."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, 3, h, d, generator=g).to("cuda", dtype)[:, :, 0]
    kc, vc = (torch.randn(b, s_max, h * d, generator=g).to("cuda", dtype)
              for _ in range(2))
    out = fd.flash_decode_arrays(q, kc, vc, length)
    return hashlib.sha256(out.view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def time_decode_kernels(tree_ops, timer):
    """[case]: the ragged kernel (fp and int8 pools, the decode step, the
    split edges, H=16 D=128 and the C=188 / C=512 chunks), the fused
    layer (t = 1, 127-129, 511 and 1023, masked at 1023, H=16 D=128) and
    the flash decode kernel (lengths 1, 2, 128-130, 255, 257, 512 and
    1024, H=16 D=128; with the sha256 of its output), each in fp32 and
    bf16 against its plain version, with the modules of one tree
    (`check_*`), the lengths and t as ints."""
    rpa, fdl, fd, tol = (tree_ops[k] for k in ("rpa", "fdl", "fd", "tol"))
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        runs = [(check_ragged, RAGGED, DECODE_ROWS, 1, {}),
                (check_ragged, RAGGED, EDGE_ROWS, 1, {}),
                (check_ragged, RAGGED, DECODE_ROWS, 1, dict(h=16, d=128)),
                (check_ragged, RAGGED, [(700, 188)], 188, {}),
                (check_ragged_int8, RAGGED8, DECODE_ROWS, 1, {}),
                (check_ragged_int8, RAGGED8, EDGE_ROWS, 1, {}),
                (check_ragged_int8, RAGGED8, DECODE_ROWS, 1,
                 dict(h=16, d=128)),
                (check_ragged_int8, RAGGED8, [(700, 512)], 512, {})]
        for check, name, rows, c, kw in runs:
            out.append(dict(check(rpa, tol, timer, rows, c, dtype, seed=2,
                                  **kw), kernel=name))
        for h, d, t, masked in ([(12, 64, t, False)
                                 for t in (1, 127, 128, 129, 511, 1023)]
                                + [(12, 64, 1023, True), (16, 128, 1023,
                                                          False)]):
            out.append(dict(check_fused_layer(fdl, tol, timer, 8, h, d, 1024,
                                              t, masked, dtype, seed=t,
                                              device_len=False),
                            kernel=FUSED))
        for h, d, length in ([(12, 64, n) for n in (1, 2, 128, 129, 130, 255,
                                                   257, 512, 1024)]
                             + [(16, 128, 1024)]):
            c = check_decode(fd, tol, timer, 8, 1024, h, d, length, dtype,
                             length, device_len=False)
            c["sha256"] = decode_digest(fd, 8, 1024, h, d, length, dtype,
                                        length)
            out.append(dict(c, kernel=DECODE))
        torch.cuda.empty_cache()
    return out


def time_training(rec, cfg, reps):
    """The training paths of `time_paths` into ``rec``: the stacked bf16
    step, the stacked fp32 step and the per-layer fp32 step under the LN
    and FFN flags (B=8 S=1024), each timed `reps` times and profiled
    once."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    rng = np.random.RandomState(2)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 1024)))
            .cuda() for _ in range(2)]
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    step, _ = make_step(model)
    with flag_env({}):
        for _ in range(2):
            step(data)
        step_ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                step(data)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3 / 10)
        prof = profile_step(step, data)
    rec["stacked_step"] = {
        "ms_per_step": step_ms, "wall_ms": prof["wall_ms"],
        "device_ms": prof["device_ms"],
        "device_busy_share": prof["device_busy_share"],
        "device_ops": prof["device_ops"], "ms_by_group": prof["ms_by_group"]}
    del model, step
    torch.cuda.empty_cache()
    # the fp32 stacked step (fp32 weights and masters) and the fp32
    # per-layer step under the LN and FFN flags: their flash kernels and
    # (flags) FFN are the split-TF32 ones
    for key, cfg_fp32, env in (
            ("stacked_step_fp32", cfg, {}),
            ("per_layer_flags_step_fp32", gpt2_124m_config(),
             TRAIN_MODES["flags"])):
        model = GPTForCausalLM(cfg_fp32, device="cuda", dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
        step, _ = make_step(model)
        with flag_env(env):
            step(data)
            step_ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    step(data)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3 / 3)
            prof = profile_step(step, data)
        rec[key] = {
            "ms_per_step": step_ms, "wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ops": prof["device_ops"],
            "ms_by_group": prof["ms_by_group"], "top": prof["top"][:8]}
        del model, step
        torch.cuda.empty_cache()


def time_paths(tree, train=False, reps=3):
    """With ``paddle_tpu_torch`` imported from ``tree`` (so that two trees
    compare in one call, in turns): the decode kernels at the shapes of
    the kernel phase (`time_decode_kernels`) and the LayerNorm backward's
    cases (`LN_BWD_CASES`, with `F.layer_norm` autograd's time); bf16
    GPT-2 124M fused-mode ``generate`` (B=8, prompt 896 + 128 new; decode
    ms per step as phase 4 takes it, `reps` times) and 16 decode steps
    timed alone and under
    torch.profiler; 8 bf16 engine decode steps, fp and int8 pools, timed
    alone and under torch.profiler (phase 3's `profile_decode`); and the
    host microseconds of one FFN and one LayerNorm forward call at the
    decode step's 8 rows.  With ``train`` also the stacked bf16 training
    step (B=8 S=1024, 2 warm-up then 10 timed steps, `reps` times) and one
    profiled step; the stacked fp32 step and the per-layer fp32 step under
    PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1 (fp32 weights, B=8 S=1024, each 1
    warm-up then 3 timed steps, `reps` times, and one profiled step).
    Prints one JSON line."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: --paths needs a GPU")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import paddle_tpu_torch
    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(tree):
        fail(f"paddle_tpu_torch came from {paddle_tpu_torch.__file__}")
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.ops import fused_decode as fdl
    from paddle_tpu_torch.ops import fused_mlp as fm
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import tolerance as tol
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cfg = gpt2_124m_config(stacked_blocks=True)
    rec = {"tree": tree, "card": card}
    timer = Timer()
    rec["kernels"] = time_decode_kernels(
        dict(rpa=rpa, fdl=fdl, fd=fd, tol=tol), timer)
    # the LayerNorm backward's cases of the kernel phase
    rec["kernels"] += [
        dict(check_ln_bwd(fm, tol, timer, n, 768, xdt, pdt,
                          seed=n + (xdt == pdt)), kernel=LN_BWD)
        for n, xdt, pdt in LN_BWD_CASES]
    for c in rec["kernels"]:
        extra = "".join(f" {k} {c[k]:.4f}" for k in ("write_ms", "attend_ms")
                        if k in c)
        lib = ("" if c.get("library_ms") is None
               else f" library {c['library_ms']:.4f}")
        print(f"paths {tree} kernel {c['kernel']} [{c['shape']} "
              f"{c['dtype']}] ms {c['ms']:.4f}{extra} bound "
              f"{c['bound_ms']:.4f}{lib} ({c['err_over_limit']:.3g} of its "
              f"limit)" + (f" sha256 {c['sha256']}" if "sha256" in c
                           else ""), flush=True)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    for pools in (None, "int8"):
        prof = profile_decode(model, prompts, torch.bfloat16,
                              kv_cache_dtype=pools)
        rec[f"engine_decode_{pools or 'fp'}"] = {
            k: prof[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "device_busy_share", "device_ops_per_step",
                                 "ms_per_step_by_group", "top")}
        print(f"paths {tree} engine decode bf16, {pools or 'fp'} pools: "
              f"wall {prof['wall_ms_per_step']:.3f} device "
              f"{prof['device_ms_per_step']:.3f} ms a step ("
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          prof["ms_per_step_by_group"].items()) + ")",
              flush=True)
    del model
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 896))
                           .astype(np.int32)).cuda()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    with flag_env(GEN_MODES["fused"]):
        model.generate(ids[:, :64], max_new_tokens=4)          # warm-up
        steps = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(ids, max_new_tokens=1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.generate(ids, max_new_tokens=128)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            steps.append(((t2 - t1) - (t1 - t0)) * 1e3 / 127)
        prof = profile_generate(model, ids, steps=16)
    rec["fused_generate"] = {
        "decode_ms_per_step": steps,
        "wall_ms_per_step": prof["wall_ms_per_step"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "device_busy_share": prof["device_busy_share"],
        "device_ops_per_step": prof["device_ops_per_step"],
        "ms_per_step_by_group": prof["ms_per_step_by_group"]}
    del model
    if train:
        time_training(rec, cfg, reps)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(8, 768, generator=g).to("cuda", torch.bfloat16)
    w1 = (torch.randn(768, 3072, generator=g) / 28).to("cuda", torch.bfloat16)
    b1 = torch.zeros(3072, dtype=torch.bfloat16, device="cuda")
    w2 = (torch.randn(3072, 768, generator=g) / 56).to("cuda", torch.bfloat16)
    lw = torch.ones(768, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        rec["host_us_per_call_8_rows"] = {
            "ffn": host_us(lambda: fm.fused_ffn_arrays(x, w1, b1, w2,
                                                       "gelu_tanh")),
            "layernorm": host_us(lambda: fm.fused_layernorm_arrays(
                x, lw, b1[:768])),
            "three_empty": host_us(lambda: (
                torch.empty((8, 3072), dtype=torch.bfloat16, device="cuda"),
                torch.empty((3, 8, 3072), device="cuda"),
                torch.empty((12, 8, 768), device="cuda")))}
    g = rec["fused_generate"]
    gen_ms = ", ".join(f"{v:.3f}" for v in g["decode_ms_per_step"])
    train = []
    for key, label in (("stacked_step", "stacked step"),
                       ("stacked_step_fp32", "fp32 stacked step"),
                       ("per_layer_flags_step_fp32",
                        "fp32 per-layer step under the LN and FFN flags")):
        if key not in rec:
            continue
        st = rec[key]
        train.append(
            f"{label} " + ", ".join(f"{v:.3f}" for v in st["ms_per_step"])
            + f" ms, device {st['device_ms']:.3f} ms "
            f"({st['device_ops']:.0f} ops; by group " + ", ".join(
                f"{k} {v:.3f}" for k, v in st["ms_by_group"].items()) + ")")
    print(f"paths {tree} ({card}): fused generate decode {gen_ms} ms a "
          f"step, profiled window wall {g['wall_ms_per_step']:.3f} device "
          f"{g['device_ms_per_step']:.3f} ms ({g['device_ops_per_step']:.1f} "
          f"ops); " + "".join(t + "; " for t in train)
          + "host us per call at 8 rows: " + ", ".join(
              f"{k} {v:.2f}"
              for k, v in rec["host_us_per_call_8_rows"].items()),
          flush=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(sys.argv[2:])
    elif sys.argv[1:2] == ["--paths"] and len(sys.argv) in (3, 4) and \
            sys.argv[3:] in ([], ["--train"]):
        time_paths(sys.argv[2], train=sys.argv[3:] == ["--train"])
    elif len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]}; see the docstring")
    else:
        main()
