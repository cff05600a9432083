"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Card: name and power limit (nvidia-smi); TF32 off for matmuls and cuDNN.
2. Kernels: build every CUDA source of the serving path with nvcc (all at
   once), then hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes, in float32 and bfloat16, and time
   kernel, plain version and (flash) the PyTorch SDPA call as a yardstick.
   Tolerances: float32, max absolute error 2e-5 — both sides accumulate
   in fp32 and differ only in summation order.  bfloat16, per element
   |out - ref| <= 2^-7 max(|out|, |ref|) + 2^-8 (P |V|): one bf16 step of
   the output (both sides round it once), plus twice the most that the
   plain version's rounding of the probabilities to bf16 (2^-9 relative
   each) can move the value product, P |V| being that product over |V|
   in fp32.  So the limit follows each output's own magnitude: at rows of
   hundreds of keys it is ~3e-3, not the ~2e-2 a short row needs.  Pool
   writes must be bitwise equal.
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
4. Summary: one JSON line of kernels, the card line, then the result line.

Every time is a median of CUDA-event timings (L2 flushed before each
launch); every bound is max(bytes / 3.35 TB/s, FLOPs / peak for the type:
989 TFLOP/s bf16, 67 TFLOP/s fp32), from this run's shapes and data.
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
REPLACES = {
    "flash_fwd_causal": "paddle_tpu/ops/pallas_ops.py:135",
    "ragged_paged_attention": "paddle_tpu/ops/ragged_paged_attention.py:125",
}


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
    """Median CUDA-event time of one call, L2 flushed before each."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=25, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def check_close(out, want, mag, what):
    """Hold `out` against `want` at the tolerance of their dtype (module
    docstring): float32 when `mag` is None, else bfloat16 with `mag` the
    fp32 value product over |V|.  Returns the max absolute error and the
    largest ratio of error to limit."""
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    err = diff.max().item()
    if mag is None:
        tol = TOL_FP32
    else:
        tol = 2.0 ** -7 * torch.maximum(out.abs(), want.abs()) \
            + 2.0 ** -8 * mag
    worst = (diff / tol).max().item()
    if not bool((diff <= tol).all()):          # NaN fails too
        fail(f"{what}: max error {err}, {worst:.3g}x its limit")
    return err, worst


def bound_ms(nbytes, flops, dtype):
    return max(nbytes / HBM_BPS, flops / PEAK[dtype]) * 1e3, \
        "bytes" if nbytes / HBM_BPS >= flops / PEAK[dtype] else "operations"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(fa, timer, s, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(1, s, h, d, generator=g).to("cuda", dtype)
               for _ in range(3))
    out = fa.flash_attention_arrays(q, k, v)
    want = fa.mha_reference(q, k, v, is_causal=True)
    mag = None if dtype == torch.float32 else fa.mha_reference(
        q.float(), k.float(), v.float().abs(), is_causal=True)
    torch.cuda.synchronize()
    err, ratio = check_close(out, want, mag,
                             f"flash S={s} H={h} D={d} {dtype}")
    ms = timer(lambda: fa.flash_attention_arrays(q, k, v))
    plain_ms = timer(lambda: fa.mha_reference(q, k, v, is_causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    item = q.element_size()
    nbytes = 4 * s * h * d * item + 4 * h * s
    flops = 2 * d * h * s * (s + 1)       # 4*D*H per (query, visible key)
    bms, by = bound_ms(nbytes, flops, dtype)
    return dict(shape=f"B=1 S={s} H={h} D={d}", dtype=str(dtype),
                max_abs_err=err, err_over_limit=ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


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


def check_ragged(rpa, timer, rows, c, dtype, seed):
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
    mag = [None] * len(qlens)
    if dtype != torch.float32:
        m, _, _ = rpa.ragged_paged_attention_reference(
            q.float(), kn.float(), vn.float().abs(), kr.float(),
            vr.float().abs(), tables, pos0, lens, slots)
        mag = [m[r, :n] for r, n in enumerate(qlens)]
    checks = [check_close(out[r, :n], want[r, :n], mag[r],
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
                err_over_limit=ratio, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


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


def profile_decode(model, prompts, dtype, steps=8):
    """Decode steps 1..`steps` (all prompts already prefilled), run twice on
    fresh engines: once timed on the host clock alone, once under
    torch.profiler.  Returns wall ms per step both ways, the device ms per
    step and device ops (kernels, copies) per step from the profile, the
    top ones by device time, and the device's busy share of the
    unprofiled step (the profiler's own host cost lengthens its steps)."""
    from torch.autograd import DeviceType
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
    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    kernels = [(ev.self_device_time_total, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall[False],
            "profiled_wall_ms_per_step": wall[True],
            "device_busy_share": device_ms / wall[False],
            "device_ms_per_step": device_ms,
            "device_ops_per_step": sum(k[1] for k in kernels) / steps,
            "top": [{"name": k[2][:90], "ms_per_step": k[0] / 1e3 / steps,
                     "launches_per_step": k[1] / steps}
                    for k in kernels[:10]]}


def check_launches(eng, launches, what):
    layers = eng.cfg.num_hidden_layers
    want = {"flash_fwd_causal": layers * eng.step_counts["prefill"],
            "ragged_paged_attention": layers * (eng.step_counts["decode"]
                                                + eng.step_counts["chunk"])}
    for name, n in want.items():
        if not (launches[name] > 0 and launches[name] == n):
            fail(f"{what}: {name} launched {launches[name]} times, "
                 f"expected {n} ({eng.step_counts})")
    if eng.step_counts["chunk"] != 2:
        fail(f"{what}: expected the 700-token prompt in 2 ragged chunks, "
             f"got {eng.step_counts}")
    return want


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_124m_config
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    # -- 1. card -----------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. kernels --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build([fa.KERNEL, rpa.KERNEL])
    result["build_s"] = time.perf_counter() - t0
    result["ptxas"] = {}
    for name in (fa.KERNEL, rpa.KERNEL):
        with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
            result["ptxas"][name] = f.read()
    print(f"built {fa.KERNEL}, {rpa.KERNEL} in {result['build_s']:.1f} s",
          flush=True)
    timer = Timer()
    cases = {fa.KERNEL: [], rpa.KERNEL: []}
    decode_rows = [(1024, 1), (700, 1), (513, 1), (384, 1), (200, 1),
                   (64, 1), (7, 1), None]
    for dtype in (torch.float32, torch.bfloat16):
        for s in (7, 200, 384, 512, 700):
            cases[fa.KERNEL].append(check_flash(fa, timer, s, 12, 64, dtype,
                                                seed=s))
        cases[fa.KERNEL].append(check_flash(fa, timer, 512, 16, 128, dtype,
                                            seed=1))
        cases[rpa.KERNEL].append(check_ragged(rpa, timer, decode_rows, 1,
                                              dtype, seed=2))
        cases[rpa.KERNEL].append(check_ragged(rpa, timer, [(700, 188)], 188,
                                              dtype, seed=3))
    for name, rows in cases.items():
        for c in rows:
            lib = ("" if c["library_ms"] is None
                   else f" library_ms={c['library_ms']:.4f}")
            tol = (f"tol {TOL_FP32}" if c["dtype"] == str(torch.float32)
                   else "tol scaled to each output")
            print(f"kernel {name} [{c['shape']} {c['dtype']}] "
                  f"max_abs_err={c['max_abs_err']:.3g} ({tol}; "
                  f"{c['err_over_limit']:.3g} of it) "
                  f"ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                  f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}){lib}",
                  flush=True)
    result["kernel_cases"] = cases

    # -- 3. engine ---------------------------------------------------------
    cfg = gpt2_124m_config()
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

    # -- 4. summary --------------------------------------------------------
    main_case = {fa.KERNEL: cases[fa.KERNEL][2],          # fp32 S=384
                 rpa.KERNEL: cases[rpa.KERNEL][0]}         # fp32 decode
    kernels = []
    for name, c in main_case.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
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
