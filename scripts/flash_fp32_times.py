"""Time the float32 flash backward kernels and forward of paddle_tpu_torch
on one NVIDIA GPU, each against its plain version and SDPA.

    PYTHONPATH=. python3 scripts/flash_fp32_times.py

Runs `chip_smoke.check_flash_bwd` (dQ and dK/dV) at the training shape
B=8 S=1024 H=12 D=64 and at B=1 S=512 H=16 D=128, and
`chip_smoke.check_flash` (the causal forward) at the training shape, in
float32, and prints each case's median time, SDPA's (for the backward,
its whole backward), the split-TF32 bound and the error over its limit.
A quick check of a kernel design between full `chip_smoke.py` runs.
"""
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tolerance as tol


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    timer = cs.Timer()
    f32 = torch.float32
    cases = []
    for b, s, h, d in ((8, 1024, 12, 64), (1, 512, 16, 128)):
        cases += cs.check_flash_bwd(fa, tol, timer, b, s, h, d, f32,
                                    seed=1).items()
    cases.append((fa.KERNEL, cs.check_flash(fa, tol, timer, 1024, 12, 64,
                                            f32, seed=4, b=8)))
    for name, c in cases:
        print(f"{name} [{c['shape']}] ms {c['ms']:.4f} SDPA "
              f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"err/limit {c['err_over_limit']:.3f}", flush=True)


if __name__ == "__main__":
    main()
