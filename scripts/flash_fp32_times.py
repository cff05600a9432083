"""Time the float32 flash backward kernels and forward of paddle_tpu_torch
on one NVIDIA GPU, each against its plain version and SDPA.

    PYTHONPATH=. python3 scripts/flash_fp32_times.py [DIR]

Runs `chip_smoke.check_flash_bwd` (dQ and dK/dV) at the training shape
B=8 S=1024 H=12 D=64, at B=1 S=200 H=12 D=64 and at B=1 S=512 H=16
D=128, `chip_smoke.check_flash_variant`'s backward on the packed
training batch's segment ids (B=8 S=1024) and on the padded shape's pad
mask, kv_lens and non-causal cases (B=8 S=896), and
`chip_smoke.check_flash` (the causal forward) at the training shape, all
in float32 -- every fp32 backward case `chip_smoke.py` times -- and
prints each case's median time, SDPA's (for the backward, its whole
backward), the split-TF32 bound and the error over its limit.  With
``DIR``, the ``paddle_tpu_torch`` of DIR is timed (this tree's
`chip_smoke` helpers), so that two trees compare in one call, in turns.
A quick check of a kernel design between full `chip_smoke.py` runs.
"""
import os
import sys

import torch

import chip_smoke as cs


def main(argv):
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    tree = os.path.abspath(argv[0]) if argv else None
    if tree:
        sys.path.insert(0, tree)
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import tolerance as tol
    if tree and not os.path.abspath(paddle_tpu_torch.__file__).startswith(
            tree):
        cs.fail(f"paddle_tpu_torch came from {paddle_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{cs.card_line()}; tree {tree or 'this one'}", flush=True)
    timer = cs.Timer()
    f32 = torch.float32
    cases = []
    for b, s, h, d in ((8, 1024, 12, 64), (1, 200, 12, 64),
                       (1, 512, 16, 128)):
        cases += cs.check_flash_bwd(fa, tol, timer, b, s, h, d, f32,
                                    seed=1).items()
    segs = cs.packed_batch(50304, 8, 1024)[3]
    for kind, b, s in (("segs", 8, 1024), ("pad", 8, 896), ("lens", 8, 896),
                       ("nc", 8, 896)):
        cases += cs.check_flash_variant(
            fa, tol, timer, kind, b, s, 12, 64, f32, seed=s + b,
            segs=segs if kind == "segs" else None, fwd=False).items()
        torch.cuda.empty_cache()
    cases.append((fa.KERNEL, cs.check_flash(fa, tol, timer, 1024, 12, 64,
                                            f32, seed=4, b=8)))
    for name, c in cases:
        print(f"{name} [{c['shape']}] ms {c['ms']:.4f} SDPA "
              f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"err/limit {c['err_over_limit']:.3f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
