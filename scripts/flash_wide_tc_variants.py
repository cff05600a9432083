"""What bounds the tensor-core wide flash kernels, on one GPU.

    PYTHONPATH=. python3 scripts/flash_wide_tc_variants.py

Writes variants of ``csrc/flash_wide_tc.cu`` to
``paddle_tpu_torch/csrc/build/variants/`` (ignored by git), builds them
all at once with the port's ``nvcc`` flags, and times the forward and
dK/dV of each in turns (source, the variants, the variants reversed,
source) as `chip_smoke.Timer` times a launch (CUDA events, L2 flushed,
median of 25), causal bf16 at recipe B's shape B=2 S=2048 H=4 D=512 (a
cluster of 4 blocks) and at D = 1024 with B=2 H=2 (the same products, a
cluster of 8):

- ``source``: the kernels as they stand;
- ``bq64``: dK/dV with 64-query tiles (161 KB of shared memory, one
  block an SM, against two);
- ``local``: each block sums its own part G times in place of the other
  blocks' (the barriers kept; wrong scores): the exchange without its
  reads of distributed shared memory;
- ``none``: no exchange and no cluster barrier a tile (each block's own
  part; wrong scores): the kernels' time without the exchange.

``source`` and ``bq64`` are held against the plain versions at the
limits of `ops/tolerance.py` first; the variants with wrong scores are
timed only.  Prints each turn's ms and TFLOP/s (the causal half of 4 D
FLOPs a pair forward, 8 D dK/dV), then the card's name and power limit.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import tolerance as tol  # noqa: E402

OUT = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "build", "variants")
SRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "flash_wide_tc.cu")

FWD_EXCHANGE = """\
    // S: the cluster's parts, summed in rank order
    const uint32_t xb = xch + FWD_XCH * (it & 1);   // this tile's buffer
    put_part(xb, 0, s, tid);
    cluster_arrive();
    cluster_wait();               // every block's part has landed
    reduce_own<BK / 8>(xb, G, rank, tid);
    cluster_arrive();
    cluster_wait();               // every block's sums have landed
    gather<BK / 2, BK / 8>(s, xb, 0, G, rank, tid);
"""
DKV_EXCHANGE = """\
    // the cluster's parts, summed in rank order
    const uint32_t xb = xch + DKV_XCH * (it & 1);   // this tile's buffer
    put_part(xb, 0, s, tid);
    put_part(xb, BQT / 8, dp, tid);
    cluster_arrive();
    cluster_wait();               // every block's part has landed
    reduce_own<BQT / 4>(xb, G, rank, tid);
    cluster_arrive();
    cluster_wait();               // every block's sums have landed
    gather<BQT / 2, BQT / 4>(s, xb, 0, G, rank, tid);
    gather<BQT / 2, BQT / 4>(dp, xb, BQT / 8, G, rank, tid);
"""
REMOTE_SUM = """\
      const float4 x = g == rank ? lds128(xch + off)
                                 : ld_cluster(cluster_map(xch, g) + off);
"""
REMOTE_GATHER = """\
    const float4 x = owner == rank ? lds128(xch + off)
                                   : ld_cluster(cluster_map(xch, owner) + off);
"""


def _sub(src, old, new):
    if old not in src:
        raise SystemExit(f"variants: the source no longer holds {old[:60]!r}")
    return src.replace(old, new, 1)


def variants(src):
    """{name: source text}."""
    local = _sub(src, REMOTE_SUM, "      const float4 x = lds128(xch + off);\n")
    local = _sub(local, REMOTE_GATHER,
                 "    (void)owner;\n    const float4 x = lds128(xch + off);\n")
    none = _sub(_sub(src, FWD_EXCHANGE, ""), DKV_EXCHANGE, "")
    return {"source": src,
            "bq64": _sub(src, "constexpr int BQT = 32;",
                         "constexpr int BQT = 64;"),
            "local": local, "none": none}


def build(texts):
    """{name: ctypes.CDLL}, every variant compiled at once."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, f"flash_wide_tc_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.FLAGS, "-I", _build.SRC_DIR, "-o",
               path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variants: nvcc failed for {name}:\n{log}")
        regs = sorted({r for fn, r, _, _ in cs.ptxas_table(log)})
        print(f"{name}: registers {regs[0]}-{regs[-1]} a thread", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"flash_wide_tc_{name}.so"))
    return libs


def inputs(b, s, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to("cuda", torch.bfloat16)
            for _ in range(4)]


def check(b, s, h, d):
    """Hold the loaded variant's forward and dK/dV against the plain
    versions at the card tests' limits."""
    q, k, v, do = inputs(b, s, h, d, d + s)
    scale = d ** -0.5
    out, lse, _ = fa._launch(q, k, v, scale, True)
    want = fa.mha_reference(q, k, v, None, True, scale).to(q.dtype)
    cs.check_close(tol, out, want, tol.flash_fwd_limit(out, want, q, k, v),
                   f"forward D={d}")
    delta = fa.attention_delta(out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    lim = tol.flash_bwd_limits((ref[0], dk, dv), ref, q, k, v, out, lse, do,
                               scale)
    cs.check_close(tol, dk, ref[1], lim[1], f"dK D={d}")
    cs.check_close(tol, dv, ref[2], lim[2], f"dV D={d}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("variants: this script needs a GPU")
    libs = build(variants(open(SRC).read()))
    timer = cs.Timer()
    for name in ("source", "bq64"):
        _build._LIBS[fa.WIDE_TC_SOURCE] = libs[name]
        for d, s in ((512, 330), (640, 200), (1024, 200)):
            check(2, s, 2, d)
        print(f"{name}: forward and dK/dV within the card limits", flush=True)
    shapes = ((2, 2048, 4, 512), (2, 2048, 2, 1024))
    args = {}
    for b, s, h, d in shapes:
        q, k, v, do = inputs(b, s, h, d, 0)
        scale = d ** -0.5
        out, lse, _ = fa._launch(q, k, v, scale, True)
        args[d] = (q, k, v, do, lse, fa.attention_delta(out, do), scale)
    names = list(libs)
    turns = names + names[::-1]
    for name in turns:
        _build._LIBS[fa.WIDE_TC_SOURCE] = libs[name]
        line = []
        for b, s, h, d in shapes:
            q, k, v, do, lse, delta, scale = args[d]
            pairs = b * h * s * (s + 1) / 2
            f_ms = timer(lambda: fa._launch(q, k, v, scale, True))
            d_ms = timer(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale))
            line.append(
                f"D={d} H={h} forward {f_ms:.4f} ms "
                f"({4 * d * pairs / f_ms / 1e9:.1f} TFLOP/s), dK/dV "
                f"{d_ms:.4f} ms ({8 * d * pairs / d_ms / 1e9:.1f} TFLOP/s)")
        print(f"{name}: " + "; ".join(line), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
