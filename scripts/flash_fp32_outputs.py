"""Hold the flash kernels of two trees of paddle_tpu_torch bitwise against
each other on one NVIDIA GPU, in float32 (the default) or in the type
named last (bfloat16, float16).

    PYTHONPATH=<tree A> python3 scripts/flash_fp32_outputs.py save a.pt [TYPE]
    PYTHONPATH=<tree B> python3 scripts/flash_fp32_outputs.py save b.pt [TYPE]
    python3 scripts/flash_fp32_outputs.py compare a.pt b.pt

``save`` runs the forward (out, lse and, with a mask or kv_lens, the
(row max, log l) pair), dQ and dK/dV kernels in that type on fixed inputs
made from seeds -- causal, non-causal (Sk = Sq + 70), a pad mask with
rows it closes entirely, kv_lens, segment ids (documents across the
64-row tiles, permuted in row 1) and all of mask, kv_lens and segments
together, each at D 64 and 128, B=2 S=200 H=2, q, k, v slices of one
fused projection -- and saves every output.  ``compare`` exits 1 unless
the two saves hold the same outputs bit for bit.
"""
import sys

import torch

KINDS = ("causal", "nc", "pad", "lens", "segs", "all")


def _inputs(kind, d, b=2, s=200, h=2, dtype=torch.float32):
    g = torch.Generator().manual_seed(d + len(kind))
    sk = s + 70 if kind == "nc" else s
    qkv = torch.randn(b, sk, 3, h, d, generator=g).to("cuda", dtype)
    q, k, v = qkv[:, :s, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    mask = lens = segs = None
    if kind in ("pad", "all"):
        m = torch.zeros(b, 1, s, s)
        m[1, :, :, :37] = -1e30
        m[1, :, :37, :] = -1e30
        if kind == "all":
            m = m + torch.randn(b, 1, s, s, generator=g)
        mask = m.cuda()
    if kind in ("lens", "all"):
        lens = torch.tensor([s, s - 70], dtype=torch.int32).cuda()
    if kind in ("segs", "all"):
        row = torch.cat([torch.full((n,), i)
                         for i, n in enumerate((50, 90, 60))])
        segs = torch.stack([row, row[torch.randperm(s, generator=g)]])
        segs = segs.int().cuda()
    return q, k, v, do, kind != "nc", mask, lens, segs


def save(path, dtype="float32"):
    from paddle_tpu_torch.ops import flash_attention as fa
    out = {}
    for d in (64, 128):
        for kind in KINDS:
            q, k, v, do, causal, mask, lens, segs = _inputs(
                kind, d, dtype=getattr(torch, dtype))
            b, s, h, _ = q.shape
            scale = d ** -0.5
            m4 = None if mask is None else fa.normalize_mask(
                mask, b, h, s, k.shape[1])
            o, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
            row_max, stat = (None, lse) if pair is None else pair
            delta = fa.attention_delta(o, do)
            kw = dict(causal=causal, mask=m4, lens=lens, segs=segs,
                      row_max=row_max)
            dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, **kw)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale, **kw)
            got = dict(out=o, lse=lse, dq=dq, dk=dk, dv=dv)
            if pair is not None:
                got.update(m=pair[0], logl=pair[1])
            out.update({f"{kind}-{d}-{n}": t.cpu() for n, t in got.items()})
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"saved {len(out)} {dtype} outputs to {path}")


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    bad = sorted(set(a) ^ set(b)) + [
        n for n in sorted(set(a) & set(b)) if not torch.equal(a[n], b[n])]
    print(f"outputs compared: {len(a)}, bitwise different or missing: "
          f"{bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "save":
        save(*sys.argv[2:4])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
