"""Hold the forward attention kernels of two trees of paddle_tpu_torch
bitwise against each other at head dims 64 and 128, on one NVIDIA GPU.

    PYTHONPATH=<tree A> python3 scripts/decode_outputs.py save a.pt
    PYTHONPATH=<tree B> python3 scripts/decode_outputs.py save b.pt
    python3 scripts/decode_outputs.py compare a.pt b.pt

``save`` runs, on fixed inputs made from seeds, at D 64 and 128: the
ragged kernel on fp32, bf16 and fp16 pools and on int8 pools with q of
each type (a decode step over rows of 1-1024 keys, split-K with several
splits, and C = 5 rows), flash decode in the three types at lengths 1,
129 and 1024 (the length in device memory), the fused decode layer in
fp32 and bf16 at t = 1, 129 and 1023 (with a row mask at 129), and the
flash forward (causal, B=2 S=200 H=2) in the three types; it saves every
output, the written pools, codes, scales and ring rows.  ``compare``
exits 1 unless the two saves hold the same tensors bit for bit.
"""
import sys

import torch

TYPES = (torch.float32, torch.bfloat16, torch.float16)
ROWS = {1: [(1024, 1), (700, 1), (129, 1), (7, 1)],
        5: [(1024, 5), (513, 3), (64, 5), (7, 2)]}


def _ragged(rows, c, h, d, dtype, seed, nb=256, bs=16):
    g = torch.Generator().manual_seed(seed)
    b, maxb = len(rows), 1024 // bs
    tables = torch.full((b, maxb), nb, dtype=torch.int32)
    pos0 = torch.zeros(b, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    slots = torch.full((b, c), nb * bs, dtype=torch.int32)
    free = torch.randperm(nb, generator=g).tolist()
    for r, (kv, nq) in enumerate(rows):
        nblk = -(-kv // bs)
        tables[r, :nblk] = torch.tensor([free.pop() for _ in range(nblk)])
        pos0[r], lens[r] = kv - nq, kv
        for j in range(nq):
            p = kv - nq + j
            slots[r, j] = tables[r, p // bs] * bs + p % bs
    q, kn, vn = (torch.randn(b, c, h, d, generator=g).to("cuda", dtype)
                 for _ in range(3))
    kb, vb = (torch.randn(nb, bs, h, d, generator=g).to("cuda", dtype)
              for _ in range(2))
    codes = [torch.randint(-127, 128, (nb, bs, h, d), generator=g,
                           dtype=torch.int8).cuda() for _ in range(2)]
    scales = [(torch.rand(nb, h, generator=g) * 0.005).cuda()
              for _ in range(2)]
    idx = [t.cuda() for t in (tables, pos0, lens, slots)]
    return q, kn, vn, kb, vb, codes, scales, idx


def save(path):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.ops import fused_decode as fdl
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    out = {}
    for d in (64, 128):
        h = 768 // d
        for dtype in TYPES:
            name = str(dtype).replace("torch.", "")
            for c in (1, 5):
                q, kn, vn, kb, vb, codes, scales, idx = _ragged(
                    ROWS[c], c, h, d, dtype, d + c)
                o, kb, vb = rpa.ragged_paged_attention_arrays(q, kn, vn, kb,
                                                              vb, *idx)
                out.update({f"ragged-{d}-{name}-{c}-{n}": t for n, t in
                            (("out", o), ("k", kb), ("v", vb))})
                o, *pools = rpa.ragged_paged_attention_arrays(
                    q, kn, vn, *codes, *idx, *scales)
                out[f"ragged8-{d}-{name}-{c}-out"] = o
                for n, t in zip(("k", "v", "ks", "vs"), pools):
                    out[f"ragged8-{d}-{name}-{c}-{n}"] = t
            g = torch.Generator().manual_seed(d)
            q = torch.randn(8, 1, 3, h, d, generator=g).to(
                "cuda", dtype)[:, :, 0]
            kc, vc = (torch.randn(8, 1024, h * d, generator=g).to(
                "cuda", dtype) for _ in range(2))
            for length in (1, 129, 1024):
                n = torch.tensor([length], dtype=torch.int32, device="cuda")
                out[f"decode-{d}-{name}-{length}"] = fd.flash_decode_arrays(
                    q, kc, vc, n)
            q, k, v = torch.randn(2, 200, 3, 2, d, generator=g).to(
                "cuda", dtype).unbind(2)
            o, lse, _ = fa._launch(q, k, v, d ** -0.5)
            out[f"flash-{d}-{name}-out"], out[f"flash-{d}-{name}-lse"] = \
                o, lse
            if dtype == torch.float16:
                continue
            hd = h * d
            for t, masked in ((1, False), (129, True), (1023, False)):
                g = torch.Generator().manual_seed(t)

                def rnd(*shape, scale=1.0):
                    return (torch.randn(*shape, generator=g) * scale).to(
                        "cuda", dtype)

                args = (rnd(8, hd), 1 + rnd(hd, scale=0.1),
                        rnd(hd, scale=0.1), rnd(hd, 3 * hd, scale=hd ** -0.5),
                        rnd(3 * hd, scale=0.1), rnd(hd, hd, scale=hd ** -0.5),
                        rnd(hd, scale=0.1))
                kc, vc = rnd(8, 1024, hd), rnd(8, 1024, hd)
                mask = None
                if masked:
                    mask = torch.where(torch.rand(8, 1024, generator=g) < 0.3,
                                       -1e30, 0.0).cuda()
                y, kc, vc = fdl.fused_decode_layer_arrays(
                    *args, kc, vc,
                    torch.tensor([t], dtype=torch.int32, device="cuda"), h,
                    cache_mask=mask)
                out.update({f"fused-{d}-{name}-{t}-{n}": x for n, x in
                            (("y", y), ("k", kc[:, t]), ("v", vc[:, t]))})
    torch.cuda.synchronize()
    out = {n: t.cpu() for n, t in out.items()}
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    bad = sorted(set(a) ^ set(b)) + [
        n for n in sorted(set(a) & set(b)) if not torch.equal(a[n], b[n])]
    print(f"outputs compared: {len(a)}, bitwise different or missing: "
          f"{bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"] and len(sys.argv) == 3:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
