"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Card: name and power limit (nvidia-smi); TF32 off for matmuls and cuDNN.
2. Kernels: build every CUDA source (all at once), then hold each kernel
   against its plain PyTorch version on the card, in float32 and bfloat16,
   and time kernel, plain version and a PyTorch yardstick (SDPA, and for
   the backward `torch.autograd.grad` through SDPA).  Forward kernels run
   at the serving path's shapes and (flash) the training shape; the two
   backward kernels at the training shape (B=8 S=1024 H=12 D=64, q, k, v
   slices of one fused [B, S, 3, H, D] tensor), a ragged S=200 and S=512
   H=16 D=128.  Tolerances
   (`paddle_tpu_torch.ops.tolerance` derives the bf16 ones):
   - forward, float32: max absolute error 2e-5 — both sides accumulate in
     fp32 and differ only in summation order.  bfloat16, per element
     |out - ref| <= 2^-7 max(|out|, |ref|) + 2^-8 (P |V|): one bf16 step
     of the output (both sides round it once), plus the most that the
     plain version's rounding of the probabilities to bf16 (at most 2^-8
     of each, the bf16 unit roundoff) can move the value product, P |V|
     being that product over |V| in fp32.  So the limit follows each
     output's own magnitude: at rows of hundreds of keys it is ~3e-3, not
     the ~2e-2 a short row needs.  Pool writes must be bitwise equal.
   - backward, float32: max |err| <= 1e-4 max |ref| per gradient — both
     sides accumulate in fp32 over up to 1024 keys or queries, in
     different orders.  bfloat16, per element |out - ref| <= 2^-7
     max(|out|, |ref|) + 2^-7 mag: one bf16 step of the output, plus the
     rounding of p (for dV) and ds (for dK, dQ) to bf16, which both sides
     make at the same points but from fp32 values that differ in their
     last bits, so a value at a rounding boundary may round apart by up
     to 2^-8 of it on each side; mag is the gradient's sum over
     magnitudes in fp32 (P^T |dO|, scale W^T |Q|, scale W |K|), with
     W = P (|dO|.|V|^T + |dO|.|out|) bounding ds = P (dP - delta) also
     where the difference cancels to fp32 noise (a query's first key).
   - the generate kernels, at GPT-2 124M's decode shapes (B=8, H=12,
     D=64, S_max=1024): flash decode at lengths 1, 257 and 1024 (and
     H=16 D=128), yardstick SDPA over the prefix; the fused decode layer
     at t = 1, 511 and 1023 without and with a row mask (no yardstick),
     whose other ring rows must stay bitwise unchanged; LayerNorm at 8
     and 8192 rows of 768, yardstick `F.layer_norm`; FFN at 8, 512 and
     8192 rows, H=768 I=3072 gelu_tanh (no yardstick).  float32: 2e-5
     absolute (FFN 1e-5 max|ref|; LN statistics 1e-5 relative).
     bfloat16: one bf16 step of each output plus what each side rounds,
     weighted by what it multiplies (the `tolerance` module docstring).
   - the LayerNorm backward at the training shape, 8192 rows of 768, in
     fp32, bf16 and bf16 x with fp32 w and b, and in bf16 at 8 and 200
     rows; yardstick `torch.autograd.grad` through `F.layer_norm`.  dx,
     dw and db within 1e-5 of each output's sum over term magnitudes,
     plus one bf16 step for a bf16 output; two launches bitwise equal.
3. Engine: GPT-2 124M (full width, 12 layers, random weights from seed 0)
   served by `LLMEngine` with block_size 16, max_num_seqs 8,
   max_num_batched_tokens 512: five greedy prompts of 7, 64, 200, 384 and
   700 tokens, 32 new tokens each (the 700-token prompt runs as a (1, 512)
   then a (1, 188) ragged chunk).  The float32 run on the card must give
   exactly the tokens of the same engine on the CPU (plain versions), and
   each kernel's launch count over the run must equal its expected count.
   A bfloat16 run reports its agreement with float32 and its prefill and
   decode tokens per second; 8 bfloat16 decode steps, timed alone and
   then under torch.profiler, give the device's busy share of a step and
   the top kernels.
4. Generate: GPT-2 124M, weights from seed 0, greedy, in the default
   mode (flash decode per step) and the fused mode (PTPU_FUSED_DECODE=1
   PTPU_PALLAS_FFN=1: fused layer, LN and FFN per step).  float32, B=8,
   prompt 256, 32 new tokens: the card's tokens must equal the CPU run's
   in each mode, and each kernel's launches equal the expected count;
   the fused-vs-default agreement is reported, not checked (the
   arithmetic differs).  bfloat16, B=8, prompt 896, 128 new tokens
   (S_max = 1024): decode tokens/s and ms per step (the time of a
   prefill-only generate taken off), launches as expected (flash 12, and
   12 x 127 of the decode kernel or of each fused kernel), the agreement,
   and 8 decode steps timed alone and under torch.profiler per mode.
5. Training, float32, card against CPU: GPT-2 124M at full width and
   depth, weights from seed 0, one fixed random batch of B=1 S=1024,
   3 AdamW steps (lr 1e-4) through `model(ids)` ->
   `GPTPretrainingCriterion` -> `backward` -> `AdamW.step`, on the card
   (kernels) and on the CPU (plain versions).  Step-1 losses agree to
   1e-5 relative, each step-1 gradient to 1e-3 max |g|, step-3 losses to
   1e-4 relative; each flash kernel (forward, dQ, dK/dV) launches 12
   times per step on the card.
6. Training, bfloat16, full size: B=8 S=1024, bf16 params with fp32
   AdamW masters (lr 1e-4), 2 warm-up steps then 10 timed steps on one
   repeated batch.  Every loss finite, step 12's below step 1's, 12
   launches of each flash kernel per step; prints tokens/s and ms per
   step, then profiles one step with torch.profiler (device ms, busy
   share, top kernels).
   Phases 3-6 run the stacked-blocks layout (``stacked_blocks=True``).
7. Training of the per-layer layout (the JAX default) under
   PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1: first one fp32 step of the stacked
   model under PTPU_PALLAS_LN=1, whose ``ln_f`` launches the LayerNorm
   forward and backward once each; then GPT-2 124M per-layer, fp32 card
   against CPU as phase 5 (same limits), with 12 launches of each flash
   kernel, 25 of the LayerNorm forward and backward and 12 of the FFN per
   step and none on the CPU; then bf16 as phase 6 with the flags and
   without them.
8. Summary: one JSON line of the nine kernels, the card line, then the
   result line.

Every time is a median of CUDA-event timings (L2 flushed before each
launch, the host's enqueue hidden behind a spin on the stream); every
bound is max(bytes / 3.35 TB/s, FLOPs / peak for the type: 989 TFLOP/s
bf16, 67 TFLOP/s fp32), from this run's shapes and data.
Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BPS = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL_FP32 = 2e-5
BWD_REL_FP32 = 1e-4
FFN_REL_FP32 = 1e-5
FWD, DQ, DKV, RAGGED = ("flash_fwd_causal", "flash_bwd_dq_causal",
                        "flash_bwd_dkv_causal", "ragged_paged_attention")
DECODE, FUSED, LN, LN_BWD, FFN = ("flash_decode", "fused_decode_layer",
                                  "fused_layernorm", "fused_layernorm_bwd",
                                  "fused_ffn")
KERNELS = (FWD, RAGGED, DQ, DKV, DECODE, FUSED, LN, LN_BWD, FFN)
REPLACES = {
    FWD: "paddle_tpu/ops/pallas_ops.py:135",
    DQ: "paddle_tpu/ops/pallas_ops.py:210",
    DKV: "paddle_tpu/ops/pallas_ops.py:272",
    RAGGED: "paddle_tpu/ops/ragged_paged_attention.py:125",
    DECODE: "paddle_tpu/ops/pallas_ops.py:1008",
    FUSED: "paddle_tpu/ops/pallas_ops.py:1186",
    LN: "paddle_tpu/ops/pallas_ops.py:1391",
    LN_BWD: "paddle_tpu/ops/pallas_ops.py:1404",
    FFN: "paddle_tpu/ops/pallas_ops.py:1548",
}
# the __global__ functions of paddle_tpu_torch/csrc, as the profiler names
PORT_SYMBOLS = ("flash_fwd_causal_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel", "ragged_write_kernel",
                "ragged_attend_kernel", "flash_decode_kernel",
                "fused_decode_layer_kernel", "ln_fwd_kernel",
                "ln_bwd_kernel", "ln_bwd_sum_kernel", "fused_ffn_kernel")
TRAIN_LR = 1e-4
# the environment flags that select the decode kernels, by generate mode
GEN_MODES = {"default": {},
             "fused": {"PTPU_FUSED_DECODE": "1", "PTPU_PALLAS_FFN": "1"}}
# ... and the training kernels of the per-layer model, by training mode
TRAIN_MODES = {"flags": {"PTPU_PALLAS_LN": "1", "PTPU_PALLAS_FFN": "1"},
               "no_flags": {}}
FLAGS = ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN", "PTPU_PALLAS_LN")


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
    host's launch overhead (which would dominate calls of a few us)."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=25, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(fa, tol, timer, s, h, d, dtype, seed, b=1):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
               for _ in range(3))
    out = fa.flash_attention_arrays(q, k, v)
    want = fa.mha_reference(q, k, v, is_causal=True)
    limit = TOL_FP32 if dtype == torch.float32 else tol.bf16_limit(
        out, want, tol.flash_fwd_magnitude(q, k, v), tol.FWD_COEF)
    torch.cuda.synchronize()
    err, ratio = check_close(tol, out, want, limit,
                             f"flash S={s} H={h} D={d} {dtype}")
    ms = timer(lambda: fa.flash_attention_arrays(q, k, v))
    plain_ms = timer(lambda: fa.mha_reference(q, k, v, is_causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    item = q.element_size()
    nbytes = b * (4 * s * h * d * item + 4 * h * s)
    flops = 2 * b * d * h * s * (s + 1)   # 4*D per (query, visible key)
    bms, by = bound_ms(nbytes, flops, dtype)
    return dict(shape=f"B={b} S={s} H={h} D={d}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


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
    out, lse = fa.flash_attention_arrays(q, k, v, return_lse=True)
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    mags = (tol.flash_bwd_magnitudes(q, k, v, out, lse, do, scale)
            if dtype != torch.float32 else (None,) * 3)
    torch.cuda.synchronize()
    checks = {}
    for name, got, ref, mag in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                   mags):
        limit = (BWD_REL_FP32 * ref.abs().max().item() if mag is None
                 else tol.bf16_limit(got, ref, mag, tol.BWD_COEF))
        checks[name] = check_close(
            tol, got, ref, limit,
            f"flash backward {name} B={b} S={s} H={h} D={d} {dtype}")
    del mags
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
        bms, by = bound_ms((4 + n_out) * slab + stats, fl * d * pairs, dtype)
        cases[kernel] = dict(
            shape=shape, dtype=str(dtype),
            max_abs_err=max(checks[e][0] for e in errs),
            err_over_limit=max(checks[e][1] for e in errs), ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms)
    return cases


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


def check_ragged(rpa, tol, timer, rows, c, dtype, seed):
    nb, bs, h, d = 512, 16, 12, 64          # the GPT-2 engine's pool
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
        limits = [tol.bf16_limit(out[r, :n], want[r, :n], m[r, :n],
                                 tol.FWD_COEF)
                  for r, n in enumerate(qlens)]
    checks = [check_close(tol, out[r, :n], want[r, :n], limits[r],
                          f"ragged C={c} {dtype} row {r}")
              for r, n in enumerate(qlens) if n]
    err, ratio = max(e for e, _ in checks), max(w for _, w in checks)
    # both write the same values to the same slots: repeating is idempotent
    ms = timer(lambda: rpa.ragged_paged_attention_arrays(*args))
    plain_ms = timer(lambda: rpa.ragged_paged_attention_reference(
        q, kn, vn, kr, vr, tables, pos0, lens, slots))
    bms, by = bound_ms(nbytes, flops, dtype)
    lens_s = ",".join(str(r[0]) if r else "pad" for r in rows)
    return dict(shape=f"B={len(rows)} C={c} kv_lens=[{lens_s}] H={h} D={d} "
                f"block_size={bs}", dtype=str(dtype), max_abs_err=err,
                err_over_limit=ratio, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


def check_decode(fd, tol, timer, b, s_max, h, d, length, dtype, seed):
    """The flash-decode kernel against its plain version; q is the
    [B, 1, H, D] slice of a fused qkv projection, as in the GPT block."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, 3, h, d, generator=g).to("cuda", dtype)[:, :, 0]
    kc, vc = (torch.randn(b, s_max, h * d, generator=g).to("cuda", dtype)
              for _ in range(2))
    out = fd.flash_decode_arrays(q, kc, vc, length)
    want = fd.flash_decode_reference(q, kc, vc, length)
    limit = TOL_FP32 if dtype == torch.float32 else tol.decode_limit(
        out, want, q, kc, vc, length, d ** -0.5)
    torch.cuda.synchronize()
    err, ratio = check_close(tol, out, want, limit,
                             f"decode B={b} length={length} H={h} D={d} "
                             f"{dtype}")
    ms = timer(lambda: fd.flash_decode_arrays(q, kc, vc, length))
    plain_ms = timer(lambda: fd.flash_decode_reference(q, kc, vc, length))
    qt = q.transpose(1, 2)
    kt, vt = (c[:, :length].view(b, length, h, d).transpose(1, 2)
              for c in (kc, vc))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    item = q.element_size()
    nbytes = 2 * b * h * d * item * (length + 1)   # K, V prefix; q, out
    bms, by = bound_ms(nbytes, 4 * b * h * d * length, dtype)
    return dict(shape=f"B={b} S_max={s_max} length={length} H={h} D={d}",
                dtype=str(dtype), max_abs_err=err, err_over_limit=ratio,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, tol=_tol_text(dtype, TOL_FP32))


def _tol_text(dtype, fp32):
    return f"tol {fp32}" if dtype == torch.float32 \
        else "tol scaled to each output"


def check_fused_layer(fdl, tol, timer, b, h, d, s_max, t, masked, dtype,
                      seed):
    """The fused decode layer against its plain version: y and the
    written rows within their limits, every other ring row bitwise
    unchanged."""
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
    y, _, _ = fdl.fused_decode_layer_arrays(*args, kc, vc, t, h,
                                            cache_mask=mask)
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
        *args, kc, vc, t, h, cache_mask=mask))
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
                f"mask={masked}", dtype=str(dtype),
                max_abs_err=max(e for e, _ in checks),
                err_over_limit=max(r for _, r in checks), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, tol=_tol_text(dtype, TOL_FP32))


def check_ln(fm, tol, timer, n, hidden, dtype, seed):
    """The LayerNorm kernel against its plain version: y, and mu and rstd
    to 1e-5 relative."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, hidden, generator=g) * 2 + 0.5).to("cuda", dtype)
    w = (1 + 0.1 * torch.randn(hidden, generator=g)).to("cuda", dtype)
    b = (0.1 * torch.randn(hidden, generator=g)).to("cuda", dtype)
    y, mu, rs = fm.fused_layernorm_arrays(x, w, b, return_stats=True)
    yr, mur, rsr = fm.fused_layernorm_reference(x, w, b)
    torch.cuda.synchronize()
    what = f"layernorm n={n} H={hidden} {dtype}"
    for name, got, ref in (("mu", mu, mur), ("rstd", rs, rsr)):
        check_close(tol, got, ref, 1e-5 * ref.abs() + 1e-6, f"{what} {name}")
    limit = TOL_FP32 if dtype == torch.float32 else tol.bf16_limit(
        y, yr, tol.ln_magnitude(x, w, b), tol.LN_COEF)
    err, ratio = check_close(tol, y, yr, limit, what)
    ms = timer(lambda: fm.fused_layernorm_arrays(x, w, b))
    plain_ms = timer(lambda: fm.fused_layernorm_reference(x, w, b))
    lib_ms = timer(lambda: torch.nn.functional.layer_norm(
        x, (hidden,), w, b, 1e-5))
    item = x.element_size()
    nbytes = 2 * n * hidden * item + 2 * hidden * item + 8 * n
    bms, by = bound_ms(nbytes, 8 * n * hidden, dtype)
    return dict(shape=f"n={n} H={hidden}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, tol=_tol_text(dtype, TOL_FP32))


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
                    + ("" if xdt == torch.float32
                       else ", + 1 bf16 step of bf16 outputs"))


def check_ffn(fm, tol, timer, n, hidden, inter, act, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    args = (rnd(n, hidden), rnd(hidden, inter, scale=hidden ** -0.5),
            rnd(inter, scale=0.1), rnd(inter, hidden, scale=inter ** -0.5))
    y = fm.fused_ffn_arrays(*args, act=act)
    yr = fm.fused_ffn_reference(*args, act=act)
    limit = (FFN_REL_FP32 * yr.abs().max().item() if dtype == torch.float32
             else tol.ffn_limit(*args, act))
    torch.cuda.synchronize()
    err, ratio = check_close(tol, y, yr, limit,
                             f"ffn n={n} H={hidden} I={inter} {act} {dtype}")
    ms = timer(lambda: fm.fused_ffn_arrays(*args, act=act))
    plain_ms = timer(lambda: fm.fused_ffn_reference(*args, act=act))
    item = y.element_size()
    nbytes = (2 * hidden * inter + inter + 2 * n * hidden) * item
    bms, by = bound_ms(nbytes, 4 * n * hidden * inter, dtype)
    return dict(shape=f"n={n} H={hidden} I={inter} {act}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None,
                tol=_tol_text(dtype, f"{FFN_REL_FP32} max|ref|"))


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (7, 64, 200, 384, 700)
NEW_TOKENS = 32


def serve(model, prompts, device, dtype, ops=None):
    """Run the engine to completion; returns (outputs, engine, launches,
    per-kind seconds and tokens)."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine, \
        SamplingParams
    eng = LLMEngine(model, EngineConfig(
        block_size=16, max_num_seqs=8, max_num_batched_tokens=512,
        device=device, dtype=dtype))
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
    return outs, eng, launches, stats


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
        if any(n in name for n in PORT_SYMBOLS):
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


def profile_decode(model, prompts, dtype, steps=8):
    """Decode steps 1..`steps` (all prompts already prefilled), run twice on
    fresh engines: once timed on the host clock alone, once under
    torch.profiler.  Returns wall ms per step both ways, the device ms per
    step and device ops (kernels, copies) per step from the profile, the
    top ones by device time, and the device's busy share of the
    unprofiled step (the profiler's own host cost lengthens its steps)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine, \
        SamplingParams
    wall = {}
    for profiled in (False, True):
        eng = LLMEngine(model, EngineConfig(
            block_size=16, max_num_seqs=8, max_num_batched_tokens=512,
            device="cuda", dtype=dtype))
        ids = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
               for p in prompts]
        while eng.step_counts["decode"] == 0:
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
            "ms_per_step_by_group": groups}


def check_launches(eng, launches, what):
    layers = eng.cfg.num_hidden_layers
    want = {FWD: layers * eng.step_counts["prefill"],
            RAGGED: layers * (eng.step_counts["decode"]
                              + eng.step_counts["chunk"])}
    for name, n in want.items():
        if not (launches[name] > 0 and launches[name] == n):
            fail(f"{what}: {name} launched {launches[name]} times, "
                 f"expected {n} ({eng.step_counts})")
    if eng.step_counts["chunk"] != 2:
        fail(f"{what}: expected the 700-token prompt in 2 ragged chunks, "
             f"got {eng.step_counts}")
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


def check_gen_launches(launches, mode, layers, steps, what):
    """One flash prefill per layer; per decode step and layer the decode
    kernel (default) or the fused layer, LN and FFN (fused); nothing
    else."""
    want = dict.fromkeys(KERNELS, 0)
    want[FWD] = layers
    for name in ((DECODE,) if mode == "default" else (FUSED, LN, FFN)):
        want[name] = layers * steps
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    return want


def _agreement(a, b, prompt):
    return float((a[:, prompt:] == b[:, prompt:]).float().mean())


def generate_fp32_card_vs_cpu(ops, cfg, batch=8, prompt=256, new=32):
    """Greedy fp32 generate in both modes on the card (kernels) and on the
    CPU (plain versions): the tokens must be identical in each mode."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32))
    models = {dev: GPTForCausalLM(cfg, device=dev,
                                  generator=torch.Generator().manual_seed(0))
              for dev in ("cuda", "cpu")}
    rec, toks = {}, {}
    for mode in GEN_MODES:
        out, secs, launches = {}, {}, {}
        with flag_env(GEN_MODES[mode]):
            for dev, model in models.items():
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out[dev] = model.generate(ids.to(dev),
                                          max_new_tokens=new).cpu()
                secs[dev] = time.perf_counter() - t0
                launches[dev] = ops.launch_counts()
        what = f"float32 generate ({mode})"
        want = check_gen_launches(launches["cuda"], mode,
                                  cfg.num_hidden_layers, new - 1, what)
        if set(launches["cpu"].values()) != {0}:
            fail(f"{what} on the CPU launched kernels: {launches['cpu']}")
        g, c = out["cuda"], out["cpu"]
        if g.shape != (batch, prompt + new) or g.dtype != torch.int32:
            fail(f"{what}: output {tuple(g.shape)} {g.dtype}")
        if not torch.equal(g, c):
            r, j = (int(i) for i in torch.nonzero(g != c)[0])
            fail(f"{what}: card tokens differ from the CPU run at row {r} "
                 f"position {j} (card {int(g[r, j])}, CPU {int(c[r, j])})")
        toks[mode] = g
        rec[mode] = {"card_s": secs["cuda"], "cpu_s": secs["cpu"],
                     "launches": launches["cuda"], "expected": want}
    rec["fused_vs_default_token_agreement"] = _agreement(
        toks["fused"], toks["default"], prompt)
    rec["batch"] = f"B={batch} prompt={prompt} new={new}"
    return rec


def profile_generate(model, ids, steps=8):
    """Decode steps 1..`steps` after a prefill, through the port's cached
    forward and greedy argmax (what `generate` runs per token), twice:
    timed alone on the host clock, then under torch.profiler.  Returns
    wall ms per step both ways and the device table of the profiled
    window; the busy share is of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile
    b, p = ids.shape
    wall = {}
    for profiled in (False, True):
        caches = model.init_caches(b, p + steps + 1)
        with torch.no_grad():
            tok = torch.argmax(model._forward_cached(ids, caches, 0, True), -1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) if profiled \
                    else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                for i in range(steps):
                    logits = model._forward_cached(tok[:, None], caches,
                                                   p + i, False)
                    tok = torch.argmax(logits, -1)
                torch.cuda.synchronize()
                wall[profiled] = (time.perf_counter() - t0) * 1e3 / steps
    device_ms, n_ops, top, groups = device_table(prof, steps)
    return {"steps": steps, "wall_ms_per_step": wall[False],
            "profiled_wall_ms_per_step": wall[True],
            "device_busy_share": device_ms / wall[False],
            "device_ms_per_step": device_ms,
            "device_ops_per_step": n_ops, "top": top,
            "ms_per_step_by_group": groups}


def generate_bf16(ops, cfg, batch=8, prompt=896, new=128):
    """bf16 generate at GPT-2's full context in both modes: decode
    tokens/s (the prefill-only generate's time taken off), launch counts,
    the fused-vs-default agreement and a profiled window per mode.
    Returns the record and the launches of each mode's timed run."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, prompt))
                           .astype(np.int32)).cuda()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    rec, toks, path = {}, {}, {}
    for mode in GEN_MODES:
        with flag_env(GEN_MODES[mode]):
            model.generate(ids[:, :64], max_new_tokens=4)       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(ids, max_new_tokens=1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            toks[mode] = model.generate(ids, max_new_tokens=new)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            path[mode] = ops.launch_counts()
            check_gen_launches(path[mode], mode, cfg.num_hidden_layers,
                               new - 1, f"bfloat16 generate ({mode})")
            decode_s = total_s - prefill_s
            rec[mode] = {"total_s": total_s, "prefill_s": prefill_s,
                         "decode_ms_per_step": decode_s * 1e3 / (new - 1),
                         "decode_tok_s": batch * (new - 1) / decode_s,
                         "launches": path[mode],
                         "profile": profile_generate(model, ids)}
        if toks[mode].shape != (batch, prompt + new):
            fail(f"bfloat16 generate ({mode}): output "
                 f"{tuple(toks[mode].shape)}")
    rec["fused_vs_default_token_agreement"] = _agreement(
        toks["fused"], toks["default"], prompt)
    rec["batch"] = f"B={batch} prompt={prompt} new={new} (S_max=1024)"
    return rec, path


# ---------------------------------------------------------------------------
# phases 5 and 6: training
# ---------------------------------------------------------------------------

def make_step(model, lr=TRAIN_LR):
    """The JAX package's pretraining step on `model` with a fresh AdamW:
    crit(model(ids), labels) -> backward -> step -> clear_grad.  Returns
    the step function, which returns the loss (a tensor, not synced) and
    fills `grads` (when given) with the gradients on the host in fp32, and
    the optimizer."""
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    crit = GPTPretrainingCriterion(model.cfg)
    opt = AdamW(learning_rate=lr, parameters=model.parameters())

    def step(ids, labels, grads=None):
        loss = crit(model(ids), labels)
        loss.backward()
        if grads is not None:
            grads.update({n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return step, opt


def train_launches(cfg, steps, env):
    """Expected launches of `steps` training steps under the flags `env`:
    each flash kernel once per layer; under PTPU_PALLAS_LN the LayerNorm
    forward and backward once per LayerNorm layer (2L+1 per-layer, ``ln_f``
    alone stacked); under PTPU_PALLAS_FFN the FFN once per per-layer
    block (the stacked blocks keep their own MLP); nothing else."""
    layers = cfg.num_hidden_layers
    want = dict.fromkeys(KERNELS, 0)
    for name in (FWD, DQ, DKV):
        want[name] = layers * steps
    if env.get("PTPU_PALLAS_LN") == "1":
        per_step = 1 if cfg.stacked_blocks else 2 * layers + 1
        want[LN] = want[LN_BWD] = per_step * steps
    if env.get("PTPU_PALLAS_FFN") == "1" and not cfg.stacked_blocks:
        want[FFN] = layers * steps
    return want


def check_train_launches(launches, want, what):
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")


def train_fp32_card_vs_cpu(ops, cfg, env, steps=3, seq=1024):
    """`steps` fp32 AdamW steps on the card and on the CPU under the flags
    `env`: losses, step-1 gradients and launches checked."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq)))
    runs = {}
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=device,
                               generator=torch.Generator().manual_seed(0))
        step, _ = make_step(model)
        grads = {}
        with flag_env(env):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [step(ids.to(device), labels.to(device),
                           grads if i == 0 else None).item()
                      for i in range(steps)]
            runs[device] = dict(losses=losses, grads=grads,
                                launches=ops.launch_counts(),
                                seconds=time.perf_counter() - t0)
        del model
    gpu, cpu = runs["cuda"], runs["cpu"]
    check_train_launches(gpu["launches"], train_launches(cfg, steps, env),
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
    return {"steps": steps, "batch": f"B=1 S={seq}",
            "card_losses": gpu["losses"], "cpu_losses": cpu["losses"],
            "loss_rel_diff": rel, "grad_err_over_limit": grad_ratio,
            "launches": gpu["launches"], "card_s": gpu["seconds"],
            "cpu_s": cpu["seconds"]}


def train_bf16(ops, cfg, env, batch=8, seq=1024, warmup=2, timed=10):
    """The full-size bf16 run under the flags `env`; returns its record and
    the launches of all its steps."""
    from paddle_tpu_torch.models import GPTForCausalLM
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (batch, seq))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq))).cuda()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    step, opt = make_step(model)           # multi_precision: fp32 masters
    with flag_env(env):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(ids, labels) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, labels) for _ in range(timed)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / timed
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile_rec = profile_step(step, ids, labels)
    losses = [x.item() for x in losses]
    check_train_launches(launches, train_launches(cfg, warmup + timed, env),
                         "bfloat16 training")
    if not all(np.isfinite(losses)):
        fail(f"bfloat16 training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"bfloat16 training: loss did not fall, {losses}")
    if not all(p.dtype == torch.bfloat16 for p in model.parameters()) or \
            len(opt._master_weights) != len(list(model.parameters())):
        fail("bfloat16 training: params are not bf16 with fp32 masters")
    tokens = batch * seq
    return {"batch": f"B={batch} S={seq}", "warmup": warmup,
            "timed_steps": timed, "losses": losses, "ms_per_step": step_ms,
            "tokens_per_s": tokens * 1e3 / step_ms,
            "peak_memory_gb": peak_gb, "profile": profile_rec}, launches


def profile_step(step, ids, labels):
    """One more step timed alone, then one under torch.profiler: wall ms
    both ways, device ms, busy share, device ops, top kernels and ms by
    group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(ids, labels)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
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
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (1, seq))).cuda()
                   for _ in range(2))
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    step, _ = make_step(model)
    env = {"PTPU_PALLAS_LN": "1"}
    with flag_env(env):
        ops.reset_launch_counts()
        loss = step(ids, labels).item()
        launches = ops.launch_counts()
    check_train_launches(launches, train_launches(cfg, 1, env),
                         "stacked float32 training under PTPU_PALLAS_LN=1")
    if not np.isfinite(loss):
        fail(f"stacked training under PTPU_PALLAS_LN=1: loss {loss}")
    return {"loss": loss, "launches": launches, "batch": f"B=1 S={seq}"}


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
            elif name in (FWD, RAGGED):
                tol = f"tol {TOL_FP32}"
            else:
                tol = f"tol {BWD_REL_FP32} max|ref|"
            print(f"kernel {name} [{c['shape']} {c['dtype']}] "
                  f"max_abs_err={c['max_abs_err']:.3g} ({tol}; "
                  f"{c['err_over_limit']:.3g} of it) "
                  f"ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                  f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}){lib}",
                  flush=True)


def print_train(label, rec, launches, card):
    p = rec["profile"]
    print(f"train bfloat16 GPT-2 124M {label} {rec['batch']}: "
          f"{rec['tokens_per_s']:.1f} tokens/s, {rec['ms_per_step']:.3f} "
          f"ms per step over {rec['timed_steps']} steps ({card}); losses "
          f"{rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}; peak "
          f"memory {rec['peak_memory_gb']:.2f} GB; launches {launches}",
          flush=True)
    if p["device_ms"] > 0:
        print(f"train profile bfloat16 {label}: one step {p['wall_ms']:.3f} "
              f"ms ({p['profiled_wall_ms']:.3f} under the profiler), device "
              f"{p['device_ms']:.3f} ms, busy {p['device_busy_share']:.3f}, "
              f"{p['device_ops']:.0f} device ops; by group (ms) "
              + ", ".join(f"{k} {v:.3f}" for k, v in p["ms_by_group"].items())
              + "; top: " + "; ".join(
                  f"{t['name'][:40]} {t['ms_per_step']:.3f} ms"
                  for t in p["top"][:8]), flush=True)
    else:
        print(f"train profile bfloat16 {label}: the profiler recorded no "
              f"device time (not measured)", flush=True)


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
    from paddle_tpu_torch.ops import tolerance as tol
    wrappers = {FWD: fa, DQ: fa.flash_bwd_dq, DKV: fa.flash_bwd_dkv,
                RAGGED: rpa, DECODE: fd, FUSED: fdl, LN: fm.ln_fwd,
                LN_BWD: fm.ln_bwd, FFN: fm.ffn_fwd}
    assert set(wrappers) == set(ops.launch_counts())

    # -- 1. card -----------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. kernels --------------------------------------------------------
    sources = sorted({w.SOURCE for w in wrappers.values()})
    t0 = time.perf_counter()
    _build.build(sources)
    result["build_s"] = time.perf_counter() - t0
    result["ptxas"] = {}
    for name in sources:
        with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
            result["ptxas"][name] = f.read()
    print(f"built {', '.join(sources)} in {result['build_s']:.1f} s",
          flush=True)
    timer = Timer()
    cases = {name: [] for name in wrappers}
    decode_rows = [(1024, 1), (700, 1), (513, 1), (384, 1), (200, 1),
                   (64, 1), (7, 1), None]
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
        cases[RAGGED].append(check_ragged(rpa, tol, timer, decode_rows, 1,
                                          dtype, seed=2))
        cases[RAGGED].append(check_ragged(rpa, tol, timer, [(700, 188)], 188,
                                          dtype, seed=3))
        for length in (1, 257, 1024):
            cases[DECODE].append(check_decode(fd, tol, timer, 8, 1024, 12,
                                              64, length, dtype, length))
        cases[DECODE].append(check_decode(fd, tol, timer, 8, 1024, 16, 128,
                                          1024, dtype, 5))
        for t in (1, 511, 1023):
            for masked in (False, True):
                cases[FUSED].append(check_fused_layer(
                    fdl, tol, timer, 8, 12, 64, 1024, t, masked, dtype,
                    seed=t + masked))
        for n in (8, 8192):
            cases[LN].append(check_ln(fm, tol, timer, n, 768, dtype, n))
        for n in (8, 512, 8192):              # decode, -, training rows
            cases[FFN].append(check_ffn(fm, tol, timer, n, 768, 3072,
                                        "gelu_tanh", dtype, n))
        torch.cuda.empty_cache()
    bf16, f32 = torch.bfloat16, torch.float32
    for n, xdt, pdt in ((8192, f32, f32), (8192, bf16, bf16),
                        (8192, bf16, f32), (8, bf16, bf16),
                        (200, bf16, bf16)):
        cases[LN_BWD].append(check_ln_bwd(fm, tol, timer, n, 768, xdt, pdt,
                                          seed=n + (xdt == pdt)))
    print_cases(cases)
    result["kernel_cases"] = cases

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
          f"{len(prompts)} requests; launches {launches} == expected; "
          f"steps {eng32.step_counts}", flush=True)
    serve(model, prompts[:2], "cuda", torch.bfloat16)          # warm-up
    gpu16, eng16, launches16, st16 = serve(model, prompts, "cuda",
                                           torch.bfloat16, ops)
    check_launches(eng16, launches16, "bfloat16 engine")
    agree, first_diff = 0, []
    for p, a, b in zip(prompts, gpu32, gpu16):
        ga, gb = a[len(p):], b[len(p):]
        agree += int((ga == gb).sum())
        diff = np.nonzero(ga != gb)[0]
        first_diff.append(int(diff[0]) if diff.size else None)
    total = NEW_TOKENS * len(prompts)
    engine = {}
    for name, st in (("float32", st32), ("bfloat16", st16)):
        engine[name] = dict(
            st, prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
            decode_tok_s=st["decode_tokens"] / st["decode_s"])
    engine["bf16_vs_fp32_token_agreement"] = agree / total
    engine["bf16_first_diff_per_request"] = first_diff
    engine["launches_fp32"] = launches
    engine["steps"] = eng32.step_counts
    result["engine"] = engine
    for name in ("float32", "bfloat16"):
        e = engine[name]
        print(f"engine {name}: prefill {e['prefill_tok_s']:.1f} tok/s "
              f"({e['prefill_tokens']} tokens), decode "
              f"{e['decode_tok_s']:.1f} tok/s ({e['decode_tokens']} tokens)",
              flush=True)
    print(f"engine bfloat16 vs float32: {agree}/{total} generated tokens "
          f"agree; first difference per request {first_diff}", flush=True)

    prof = profile_decode(model, prompts, torch.bfloat16)
    result["decode_profile_bf16"] = prof
    if prof["device_ms_per_step"] > 0:
        print(f"decode profile bfloat16: {prof['wall_ms_per_step']:.3f} ms "
              f"per step ({prof['profiled_wall_ms_per_step']:.3f} under the "
              f"profiler), device {prof['device_ms_per_step']:.3f} ms, "
              f"busy {prof['device_busy_share']:.3f} of the unprofiled "
              f"step, "
              f"{prof['device_ops_per_step']:.1f} device ops (kernels, "
              f"copies) per step; top: " + "; ".join(
                  f"{t['name'][:40]} {t['ms_per_step']:.4f} ms"
                  for t in prof["top"][:6]), flush=True)
    else:
        print("decode profile bfloat16: the profiler recorded no device "
              "time (not measured)", flush=True)
    del model
    torch.cuda.empty_cache()

    # -- 4. dense generate -------------------------------------------------
    gen32 = generate_fp32_card_vs_cpu(ops, cfg)
    result["generate_fp32"] = gen32
    print(f"generate float32 GPT-2 124M {gen32['batch']}: card tokens "
          f"identical to the CPU run in both modes; launches default "
          f"{gen32['default']['launches']}, fused "
          f"{gen32['fused']['launches']} == expected; fused vs default "
          f"agreement {gen32['fused_vs_default_token_agreement']:.3f}; "
          f"card {gen32['default']['card_s']:.2f} / "
          f"{gen32['fused']['card_s']:.2f} s, CPU "
          f"{gen32['default']['cpu_s']:.1f} / {gen32['fused']['cpu_s']:.1f} "
          f"s", flush=True)
    torch.cuda.empty_cache()
    gen16, launches_gen = generate_bf16(ops, cfg)
    result["generate_bf16"] = gen16
    for mode in GEN_MODES:
        g = gen16[mode]
        pr = g["profile"]
        print(f"generate bfloat16 {mode} {gen16['batch']}: decode "
              f"{g['decode_tok_s']:.1f} tok/s, {g['decode_ms_per_step']:.3f} "
              f"ms per step ({card}); prefill {g['prefill_s'] * 1e3:.1f} ms; "
              f"launches {g['launches']}", flush=True)
        if pr["device_ms_per_step"] > 0:
            print(f"generate profile bfloat16 {mode}: "
                  f"{pr['wall_ms_per_step']:.3f} ms per step "
                  f"({pr['profiled_wall_ms_per_step']:.3f} under the "
                  f"profiler), device {pr['device_ms_per_step']:.3f} ms, "
                  f"busy {pr['device_busy_share']:.3f}, "
                  f"{pr['device_ops_per_step']:.1f} device ops per step; by "
                  f"group (ms) " + ", ".join(
                      f"{k} {v:.3f}"
                      for k, v in pr["ms_per_step_by_group"].items())
                  + "; top: " + "; ".join(
                      f"{t['name'][:40]} {t['ms_per_step']:.4f} ms"
                      for t in pr["top"][:6]), flush=True)
        else:
            print(f"generate profile bfloat16 {mode}: the profiler recorded "
                  f"no device time (not measured)", flush=True)
    print(f"generate bfloat16: fused vs default token agreement "
          f"{gen16['fused_vs_default_token_agreement']:.3f}", flush=True)
    torch.cuda.empty_cache()

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

    # -- 6. training, bfloat16, full size ----------------------------------
    tr16, launches_train = train_bf16(ops, cfg, {})
    result["train_bf16"] = tr16
    print_train("stacked", tr16, launches_train, card)
    torch.cuda.empty_cache()

    # -- 7. training, per-layer layout, under the LN and FFN flags ---------
    cfg_pl = gpt2_124m_config()            # stacked_blocks=False
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

    # -- 8. summary --------------------------------------------------------
    # the serving kernels at fp32 S=384 / the decode step; the backward
    # kernels at the training shape in bf16, the training path's dtype;
    # the generate kernels at the bf16 full-context decode step
    bf16 = str(torch.bfloat16)

    def pick(name, shape):
        return next(c for c in cases[name]
                    if c["shape"] == shape and c["dtype"] == bf16)

    main_case = {FWD: cases[FWD][2], RAGGED: cases[RAGGED][0],
                 DQ: cases[DQ][3], DKV: cases[DKV][3],
                 DECODE: pick(DECODE, "B=8 S_max=1024 length=1024 H=12 D=64"),
                 FUSED: pick(FUSED, "B=8 hd=768 H=12 S_max=1024 t=1023 "
                                    "mask=False"),
                 LN: pick(LN, "n=8 H=768"),
                 LN_BWD: pick(LN_BWD, "n=8192 H=768"),
                 FFN: pick(FFN, "n=8 H=768 I=3072 gelu_tanh")}
    path_launches = {FWD: launches[FWD], RAGGED: launches[RAGGED],
                     DQ: launches_train[DQ], DKV: launches_train[DKV],
                     DECODE: launches_gen["default"][DECODE],
                     FUSED: launches_gen["fused"][FUSED],
                     LN: launches_gen["fused"][LN],
                     LN_BWD: launches_pl["flags"][LN_BWD],
                     FFN: launches_gen["fused"][FFN]}
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
    # launches of the per-layer bf16 training run under both flags
    for k in kernels:
        k["launches_training"] = launches_pl["flags"][k["name"]]
    result["kernels"] = kernels
    result["expected_launches"] = expected
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
