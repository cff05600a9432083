"""Where the time goes inside the split-K decode kernels, on one GPU.

    PYTHONPATH=. python3 scripts/decode_kernel_probe.py

Copies ``paddle_tpu_torch`` into ``paddle_tpu_torch/csrc/build/stamps/``
(ignored by git), adds ``%globaltimer`` stamps to the copy of
``csrc/fused_decode_layer.cu`` (each block at its phase boundaries; each
warp at its first attention task's start, after its keys, after its
ticket, and at its last task's end) and of
``csrc/ragged_paged_attention.cu`` (each attend block at its start, after
its keys, after its warps' merge, and at its end), builds the copy, and
runs the fused layer at GPT-2 124M's decode shapes (B=8, S_max=1024: bf16
t=1 and t=1023, fp32 t=1023; bf16 H=16 D=128 t=1023) and the ragged
kernel at `chip_smoke.py`'s decode step (bf16 and fp32), each once after
an L2 flush as `chip_smoke.Timer` times it.  Prints, in microseconds from
the first block's start, the min-max over blocks (or min/median/max over
warps and blocks) of each stamp, beside the call's CUDA-event time.  The
stamps change what they measure by a few instructions a block; compare
their spans, not their sums, with the kernel's times.
"""
import ctypes
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "build", "stamps")

CLOCK = """
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""


def _sub(src, old, new):
    if old not in src:
        raise SystemExit(f"probe: the source no longer holds {old[:60]!r}")
    return src.replace(old, new, 1)


def stamp_fused(src):
    src = _sub(src, "namespace cg = cooperative_groups;", f"""\
namespace cg = cooperative_groups;
{CLOCK}
__device__ unsigned long long g_stamps[2048][8];
__device__ unsigned long long w_stamps[16384][5];
__device__ __forceinline__ void stamp(int i) {{
  if (threadIdx.x == 0) g_stamps[blockIdx.x][i] = gtime();
}}
extern "C" int fused_stamps(void* blocks, void* warps, int clear) {{
  static unsigned long long zb[2048][8], zw[16384][5];
  cudaError_t e =
      clear ? cudaMemcpyToSymbol(g_stamps, zb, sizeof(zb))
            : cudaMemcpyFromSymbol(blocks, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  return (int)(clear ? cudaMemcpyToSymbol(w_stamps, zw, sizeof(zw))
                     : cudaMemcpyFromSymbol(warps, w_stamps,
                                            sizeof(w_stamps)));
}}""")
    marks = [
        "  // -- phase 1: LN1 of every row, then the qkv units",
        "  __syncthreads();\n  for (int u = blockIdx.x; u < units1;",
        "  grid.sync();\n\n  // -- phase 2",
        "  // -- phase 2: attention per (split, head, row), one warp each",
        "  // -- phase 3: out-proj, bias, residual",
        "  grid.sync();\n  for (int u = blockIdx.x; u < units3;"]
    for i, text in enumerate(marks):
        src = _sub(src, text, f"  stamp({i});\n" + text)
    src = _sub(src, "  grid.sync();\n\n  stamp(3);", "  grid.sync();\n  stamp(3);")
    src = _sub(src, "  stamp(5);\n  grid.sync();\n",
               "  stamp(5);\n  grid.sync();\n  stamp(6);\n")
    src = _sub(src, "    __syncthreads();   // is_last and xs are reused by "
               "the next unit\n  }\n}", "    __syncthreads();   // is_last "
               "and xs are reused by the next unit\n  }\n  stamp(7);\n}")
    loop = ("  for (int task = blockIdx.x * WARPS + warp; task < bhs * splits;"
            "\n       task += gridDim.x * WARPS) {\n")
    src = _sub(src, loop, "  int ntask = 0;\n  const int wid = blockIdx.x * "
               "WARPS + warp;\n" + loop + "    if (ntask == 0 && lane == 0) "
               "w_stamps[wid][0] = gtime();\n")
    src = _sub(src, "    // this split's partial;", "    if (ntask == 0 && lane"
               " == 0) w_stamps[wid][1] = gtime();\n    // this split's "
               "partial;")
    src = _sub(src, "    if (!warp_last_of(a.tickets + bh, splits)) continue;",
               "    const bool lastw = warp_last_of(a.tickets + bh, splits);\n"
               "    if (ntask == 0 && lane == 0) w_stamps[wid][2] = gtime();\n"
               "    ++ntask;\n    if (lane == 0) {\n      w_stamps[wid][3] = "
               "gtime();\n      w_stamps[wid][4] = ntask;\n    }\n"
               "    if (!lastw) continue;")
    return _sub(src, "      a.vc[w] = from_f<T>(vd[i]);\n    }\n  }\n",
                "      a.vc[w] = from_f<T>(vd[i]);\n    }\n    if (lane == 0) "
                "w_stamps[wid][3] = gtime();\n  }\n")


def stamp_ragged(src):
    src = _sub(src, "namespace {\n\nusing namespace decode;", f"""\
{CLOCK}
__device__ unsigned long long r_stamps[8192][4];
__device__ __forceinline__ void rstamp(int i) {{
  if (threadIdx.x == 0)
    r_stamps[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)]
            [i] = gtime();
}}
extern "C" int ragged_stamps(void* out, int clear) {{
  static unsigned long long zero[8192][4];
  if (clear)
    return (int)cudaMemcpyToSymbol(r_stamps, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(out, r_stamps, sizeof(r_stamps));
}}
namespace {{

using namespace decode;""")
    src = _sub(src, "  __shared__ int tbl[TBL];\n",
               "  __shared__ int tbl[TBL];\n  rstamp(0);\n")
    src = _sub(src, "  float bm, bl, ba;\n  block_state<P, D, A_WARPS>",
               "  rstamp(1);\n  float bm, bl, ba;\n  block_state<P, D, A_WARPS>")
    src = _sub(src, "  if (splits == 1) {\n    if (tid < D) op[tid]",
               "  rstamp(2);\n  if (splits == 1) {\n    if (tid < D) op[tid]")
    return _sub(src, "    op[tid] = from_f<T>(ga / fmaxf(gl, 1e-30f));\n"
                "  if (first) wait_prior_grid();\n}",
                "    op[tid] = from_f<T>(ga / fmaxf(gl, 1e-30f));\n"
                "  rstamp(3);\n  if (first) wait_prior_grid();\n}")


def make_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    dst = os.path.join(COPY, "paddle_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for name, fn in (("fused_decode_layer", stamp_fused),
                     ("ragged_paged_attention", stamp_ragged)):
        path = os.path.join(dst, "csrc", name + ".cu")
        with open(path) as f:
            src = fn(f.read())
        with open(path, "w") as f:
            f.write(src)


def spread(v):
    return f"{v.min():.2f}/{np.median(v):.2f}/{v.max():.2f}"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a GPU")
    make_copy()
    sys.path.insert(0, COPY)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_decode as fdl
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    if not fdl.__file__.startswith(COPY):
        raise SystemExit(f"probe: imported {fdl.__file__}")
    print(f"card: {cs.card_line()}", flush=True)
    timer = cs.Timer()

    def once(fn):
        """fn once after an L2 flush, as the timer runs it."""
        torch.cuda.synchronize()
        timer.flush.zero_()
        torch.cuda._sleep(2_000_000)
        fn()
        torch.cuda.synchronize()

    flib = _build.load("fused_decode_layer")
    names = ("start", "LN1 done", "phase 1 done", "sync 1 out",
             "phase 2 done", "wo loaded", "sync 2 out", "end")
    for dtype, t, h, d in ((torch.bfloat16, 1, 12, 64),
                           (torch.bfloat16, 1023, 12, 64),
                           (torch.float32, 1023, 12, 64),
                           (torch.bfloat16, 1023, 16, 128)):
        hd = h * d
        g = torch.Generator().manual_seed(0)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

        args = (rnd(8, hd), 1 + rnd(hd, scale=0.1), rnd(hd, scale=0.1),
                rnd(hd, 3 * hd, scale=hd ** -0.5), rnd(3 * hd, scale=0.1),
                rnd(hd, hd, scale=hd ** -0.5), rnd(hd, scale=0.1))
        kc, vc = rnd(8, 1024, hd), rnd(8, 1024, hd)

        def call():
            fdl.fused_decode_layer_arrays(*args, kc, vc, t, h)

        ms = timer(call)
        torch.cuda.synchronize()
        flib.fused_stamps(None, None, 1)        # warps idle here stay 0
        once(call)
        blocks = np.zeros((2048, 8), np.uint64)
        warps = np.zeros((16384, 5), np.uint64)
        err = flib.fused_stamps(ctypes.c_void_p(blocks.ctypes.data),
                                ctypes.c_void_p(warps.ctypes.data), 0)
        if err:
            raise SystemExit(f"probe: CUDA error {err}")
        plan = fdl.fused_plan(8, h, d, t, dtype, fdl._blocks(
            kc.device, 1, h, d, int(dtype == torch.bfloat16)))
        st = blocks[:plan.grid].astype(np.int64)
        t0 = st[:, 0].min()
        rel = (st - t0) / 1e3
        w = warps[:plan.grid * 8].astype(np.int64)
        busy = w[:, 4] > 0
        wr = (w[busy, :4] - t0) / 1e3
        print(f"fused {str(dtype)[6:]} t={t} H={h} D={d} grid={plan.grid} "
              f"splits={plan.splits}x{plan.chunk} keys: event {ms:.4f} ms; "
              + "; ".join(f"{n} {rel[:, i].min():.2f}-{rel[:, i].max():.2f}"
                          for i, n in enumerate(names)), flush=True)
        print(f"  attention warps: {busy.sum()} busy, tasks "
              f"{w[busy, 4].min()}-{w[busy, 4].max()}; first task start "
              f"{spread(wr[:, 0])}, keys done {spread(wr[:, 1])}, ticket "
              f"{spread(wr[:, 2])}, last task end {spread(wr[:, 3])}",
              flush=True)

    rlib = _build.load("ragged_paged_attention")
    rnames = ("start", "keys done", "warps merged", "merged and written")
    for dtype in (torch.bfloat16, torch.float32):
        args, _, _, _ = cs.ragged_case(cs.DECODE_ROWS, 1, 512, 16, 12, 64,
                                       dtype, 2)
        ms = timer(lambda: rpa.ragged_paged_attention_arrays(*args))
        torch.cuda.synchronize()
        rlib.ragged_stamps(None, 1)
        once(lambda: rpa.ragged_paged_attention_arrays(*args))
        st = np.zeros((8192, 4), np.uint64)
        err = rlib.ragged_stamps(ctypes.c_void_p(st.ctypes.data), 0)
        if err:
            raise SystemExit(f"probe: CUDA error {err}")
        st = st.astype(np.int64)
        t0 = st[:, 0][st[:, 0] > 0].min()
        parts = []
        for i, n in enumerate(rnames):
            v = (st[:, i][st[:, i] > 0] - t0) / 1e3
            parts.append(f"{n} ({len(v)} blocks) {spread(v)}")
        print(f"ragged {str(dtype)[6:]} decode step: event {ms:.4f} ms; "
              + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
