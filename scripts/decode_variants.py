"""Time variants of the split-K flash-decode kernel on one NVIDIA GPU.

    python3 scripts/decode_variants.py

Builds copies of ``paddle_tpu_torch/csrc/flash_decode.cu`` with other
constants -- keys per split (CHUNK), 16-byte loads of K and of V in
flight per lane (U), and the least number of blocks per SM asked of
``__launch_bounds__`` (which caps the registers) -- all ``nvcc``
processes at once, into ``paddle_tpu_torch/csrc/build/variants/``.
Each variant is held against the plain version (the limits of
``chip_smoke.py``) and timed (the median of CUDA-event timings, L2
flushed, as ``chip_smoke.py`` times) through ``flash_decode_arrays`` at
the decode step of GPT-2 124M's ``generate``: B=8, H=12, D=64,
S_max=1024, lengths 1, 257 and 1024, bfloat16 and float32, beside SDPA
over the prefix.  Prints one line per variant and case.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (keys per split, loads in flight, min blocks per SM or None)
VARIANTS = {"chunk128_u4": (128, 4, None),
            "chunk128_u2": (128, 2, None),
            "chunk128_u8": (128, 8, None),
            "chunk256_u4": (256, 4, None),
            "chunk256_u8": (256, 8, None)}
CASES = [(length, dtype) for dtype in (torch.bfloat16, torch.float32)
         for length in (1, 257, 1024)]


def variant_source(src, chunk, u, min_blocks):
    src = re.sub(r"constexpr int CHUNK = \d+;", f"constexpr int CHUNK = "
                 f"{chunk};", src)
    src = re.sub(r"constexpr int U = \d+;", f"constexpr int U = {u};", src)
    if min_blocks:
        src = src.replace("__launch_bounds__(THREADS)",
                          f"__launch_bounds__(THREADS, {min_blocks})")
    return src


def build(out_dir):
    from paddle_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.SRC_DIR, "flash_decode.cu")) as f:
        src = f.read()
    procs = {}
    for name, consts in VARIANTS.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, *consts))
        so = os.path.join(out_dir, name + ".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", _build.SRC_DIR, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"variant {name}: registers {regs}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.ops import tolerance as tol
    print(chip_smoke.card_line(), flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "variants"))
    timer = chip_smoke.Timer()
    b, h, d, s_max = 8, 12, 64, 1024
    for length, dtype in CASES:
        g = torch.Generator().manual_seed(length)
        q = torch.randn(b, 1, 3, h, d, generator=g).to("cuda", dtype)[:, :,
                                                                       0]
        kc, vc = (torch.randn(b, s_max, h * d, generator=g).to("cuda", dtype)
                  for _ in range(2))
        want = fd.flash_decode_reference(q, kc, vc, length)
        limit = (chip_smoke.TOL_FP32 if dtype == torch.float32 else
                 tol.decode_limit(want, want, q, kc, vc, length, d ** -0.5))
        qt = q.transpose(1, 2)
        kt, vt = (c[:, :length].view(b, length, h, d).transpose(1, 2)
                  for c in (kc, vc))
        lib_ms = timer(lambda: torch.nn.functional
                       .scaled_dot_product_attention(qt, kt, vt))
        nbytes = 2 * b * h * d * q.element_size() * (length + 1)
        for name, lib in libs.items():
            _build._LIBS[fd.SOURCE] = lib     # the wrapper launches it
            out = fd.flash_decode_arrays(q, kc, vc, length)
            torch.cuda.synchronize()
            err, ratio, ok = tol.compare(out, want, limit)
            if not ok:
                sys.exit(f"{name} length={length} {dtype}: error {err}, "
                         f"{ratio:.3g}x the limit")
            ms = timer(lambda: fd.flash_decode_arrays(q, kc, vc, length))
            print(f"decode {name} B={b} H={h} D={d} length={length} {dtype}: "
                  f"{ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                  f"splits {lib.flash_decode_splits(length)}, err/limit "
                  f"{ratio:.3g}; SDPA {lib_ms:.4f} ms", flush=True)
    _build._LIBS.pop(fd.SOURCE, None)


if __name__ == "__main__":
    main()
