"""Build ``paddle_tpu_torch/csrc/*.cu`` at first use and load them by ctypes.

Each source becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o csrc/build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel or header is rebuilt
and an unchanged one is loaded from the build directory (listed in
``.gitignore``).  Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.

`tickets` holds the int32 counters through which the last block of a
cross-block sum (``fused_ffn.cu``, ``flash_decode.cu``,
``fused_decode_layer.cu``, ``ragged_paged_attention.cu``) finds itself;
`scratch` the kept per-device buffers of the kernels' partial sums; `sms`
the SM count the wrappers' planners fill; `device_int` the argument pair of
a length or position that may live in device memory; `dtype_code` the
element type the attention kernels' C entries take (0 float32, 1
bfloat16, 2 float16): each entry returns ``cudaErrorInvalidValue`` for a
code it does not instantiate, which `check` raises on.

A CUDA graph keeps the addresses its launches were captured with, so the
kept buffers are safe to capture: a buffer that grows is replaced but
never freed (a graph captured before may still use it), and one that
would have to grow during a capture raises instead (the captured step
runs once eagerly first, which sizes every buffer it uses).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SRC_DIR", "BUILD_DIR", "build", "load", "check", "tickets",
           "scratch", "sms", "device_int", "dtype_code", "Counter",
           "HEAD_DIMS"]

SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(SRC_DIR, "build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()
_TICKETS: dict = {}
_SCRATCH: dict = {}
_RETIRED: list = []   # replaced buffers, kept for the graphs that hold them
_SMS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> dict:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once.  Returns {name: library path}; raises
    with the compiler's output when one fails.  ``-Xptxas -v`` (registers,
    shared memory, spills) goes to ``build/<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(SRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, n + ".log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
        return lib


class Counter:
    """The launch counter of one variant of a kernel (a branch or a type
    that a wrapper counts apart), named ``KERNEL``, built from
    ``csrc/<SOURCE>.cu``."""

    def __init__(self, kernel, source):
        self.KERNEL = kernel
        self.SOURCE = source
        self.launches = 0


_DTYPE_CODES = ("float32", "bfloat16", "float16")
# the head dims the decode kernels take, and those of flash_fwd_causal.cu
# and flash_bwd_causal.cu (the flash gate takes every larger multiple of
# 128 too, in flash_wide_*.cu: `flash_attention.head_dim_ok`)
HEAD_DIMS = (64, 128, 256)


def dtype_code(dtype) -> int:
    """The element-type code of the attention kernels' C entries: 0
    float32, 1 bfloat16, 2 float16.  Raises for any other type, so that no
    tensor reaches an instantiation of another type."""
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPE_CODES:
        raise ValueError(f"the kernels take float32, bfloat16 or float16, "
                         f"got {dtype}")
    return _DTYPE_CODES.index(name)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point (a
    refused launch never runs, and a later synchronize would not say so)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _capturing(device) -> bool:
    import torch
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _kept(store, key, device, n, make):
    """``store[key]`` if it holds ``n`` elements, else a new one from
    ``make(n)``; the one it replaces is retired, not freed.  Raises during
    a CUDA-graph capture where it would have to grow."""
    buf = store.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    if _capturing(device):
        raise RuntimeError(
            f"kernel buffer {key} would grow to {n} elements during a "
            f"CUDA-graph capture; run the step once before capturing it")
    if buf is not None:
        _RETIRED.append(buf)
    buf = store[key] = make(n)
    return buf


def tickets(device, n: int):
    """A per-device int32 buffer of at least ``n`` tickets, zero between
    launches: the block that takes the last ticket of a group resets it.
    The kernels that use it share it, one launch after another on the
    stream."""
    import torch
    return _kept(_TICKETS, device, device, n, lambda n: torch.zeros(
        max(n, 64), dtype=torch.int32, device=device))


def scratch(owner: str, device, nbytes: int) -> int:
    """The address of ``owner``'s per-device byte buffer of at least
    ``nbytes``, grown as needed and kept, so that a call allocates
    nothing.  As with the tickets, the launches that use one buffer follow
    one another on the stream."""
    import torch
    return _kept(_SCRATCH, (owner, device), device, nbytes,
                 lambda n: torch.empty(max(n, 256), dtype=torch.uint8,
                                       device=device)).data_ptr()


def device_int(value, device, what):
    """The (pointer, int) pair by which a kernel takes a length or position:
    ``(0, value)`` for a Python int, ``(value.data_ptr(), 0)`` for an int32
    tensor of one element on ``device``, which the kernel reads in device
    memory (and adds the int to)."""
    import torch
    if not isinstance(value, torch.Tensor):
        return 0, int(value)
    if (value.dtype != torch.int32 or value.numel() != 1
            or value.device != torch.device(device)):
        raise ValueError(f"{what} must be an int or an int32 tensor of one "
                         f"element on {device}, got {value.dtype} "
                         f"{tuple(value.shape)} on {value.device}")
    return value.data_ptr(), 0


def sms(device) -> int:
    """The streaming multiprocessors of ``device``, which the planners
    fill."""
    n = _SMS.get(device)
    if n is None:
        import torch
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
