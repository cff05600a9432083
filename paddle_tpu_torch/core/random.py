"""JAX's threefry2x32 PRNG in torch, and the global key stack of
`paddle_tpu/core/random.py` — the port's counterpart of the keys that the
JAX package threads through sampling.

A key is what ``jax.random.PRNGKey`` returns, two uint32 words, held here
in an int64 tensor ``[..., 2]`` (torch has no full uint32 arithmetic: the
rounds run on int64 masked to 32 bits, with explicit rotations).  Every
function is the form the JAX package runs, ``jax_threefry_partitionable``
on (`jax/_src/prng.py`):

- `PRNGKey(seed)` — `threefry_seed` with 64-bit types off: the seed's
  low 32 bits, the high word 0 (``-1`` gives ``[0, 2^32 - 1]``,
  ``2^32 + 5`` gives ``[0, 5]``);
- `split(key, num)` — `_threefry_split_foldlike`: the hash of the
  counters ``(0, i)``, i < num;
- `random_bits(key, shape)` — `_threefry_random_bits_partitionable`: the
  counters are the flat index of each element split into its high and low
  32-bit words, the bits the xor of the two hashed words;
- `uniform` — `_uniform` (`jax/_src/random.py`): the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval)
  by one fused multiply-add (as XLA contracts it), then ``max`` with
  minval;
- `bernoulli` — `_bernoulli`, mode "low": ``uniform(key, shape) < p``
  (the uniform in [0, 1) needs no multiply-add: it is the mantissa's
  float minus 1);
- `gumbel` — `_gumbel`, mode "low": ``-log(-log(uniform(tiny, 1)))``;
- `categorical` — the argmax of gumbel noise plus the logits, the first
  maximal index.

Keys, bits and uniforms are bitwise JAX's; the two logs of `gumbel` are
torch's, which may differ from XLA's in the last ulp.

Each function takes one key ``[2]`` or a batch of keys ``[R, 2]``: a
batch gives row r the draw of key r alone (as `jax.vmap` would), in one
call over all rows.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "bernoulli",
           "gumbel",
           "categorical", "threefry2x32", "seed", "next_key", "get_state",
           "set_state", "key_scope"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the most ways one CPU key is split on Python ints (`split`)
_HOST_SPLIT = 16
# float32's smallest normal, gumbel's lower bound (`finfo(float32).tiny`)
_TINY = 1.1754943508222875e-38


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter words (x1, x2) under the key
    words (k1, k2): int64 tensors of uint32 values, broadcast together
    (`jax/_src/prng.py` `_threefry2x32_lowering`, its 20 rounds unrolled).
    Returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2^32]`` as int64 [2].  Seeds outside the int64 range raise, as JAX's
    conversion does."""
    s = int(seed)
    if not -2 ** 63 <= s < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, s & _MASK], dtype=torch.int64, device=device)


def _as_key(key):
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,) or key.dim() > 2:
        raise ValueError(f"a key is [2] or a batch [R, 2], got "
                         f"{tuple(key.shape)}")
    return key.to(torch.int64)


def _words(key, ndim):
    """The key's two words, shaped to broadcast over ``ndim`` trailing
    dimensions (and the batch dimension of a batch of keys)."""
    k1, k2 = key[..., 0], key[..., 1]
    view = k1.shape + (1,) * ndim
    return k1.reshape(view), k2.reshape(view)


def split(key, num=2):
    """``jax.random.split``: [2] -> [num, 2]; a batch [R, 2] -> [R, num,
    2], row r split from key r.  One key on the CPU split a few ways is
    hashed on Python ints (`threefry2x32` takes them as it takes tensors):
    the same bits without a hundred small tensor ops."""
    key = _as_key(key)
    if key.dim() == 1 and key.device.type == "cpu" and num <= _HOST_SPLIT:
        k1, k2 = key.tolist()
        return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64)
    k1, k2 = _words(key, 1)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def _counters(shape, device):
    """`iota_2x32_shape`: each element's flat index as (high, low) words."""
    n = 1
    for d in shape:
        n *= int(d)
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & _MASK


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (uint32) as int64; a batch of keys
    [R, 2] gives [R, *shape]."""
    key = _as_key(key)
    shape = tuple(int(d) for d in shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def _unit(bits):
    """Floats in [0, 1) from 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1."""
    one = 0x3F800000                        # 1.0f's bits
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    f = _unit(random_bits(key, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    # XLA contracts the scale and shift into one fused multiply-add: the
    # product of two floats is exact in float64, so one float64 add and
    # the final rounding give its result
    fma = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (float32, as JAX takes it): bool, True with probability ``p``."""
    f = _unit(random_bits(key, shape))
    return f < torch.tensor(p, dtype=torch.float32, device=f.device)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape, float32)``, mode "low"."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits, axis=-1)``: argmax over the
    last axis of gumbel noise of the logits' shape plus the logits.  A
    batch of keys [R, 2] draws row r of ``logits`` [R, ...] from key r
    (noise of shape ``logits.shape[1:]`` each).  Returns int64."""
    key = _as_key(key)
    shape = logits.shape if key.dim() == 1 else logits.shape[1:]
    noise = gumbel(key.to(logits.device), shape)
    return torch.argmax(noise + logits, dim=-1)


# -- the global key stack (`paddle_tpu/core/random.py`) ----------------------

class _RngState(threading.local):
    def __init__(self):
        self.stack = None


_state = _RngState()


def _stack():
    if _state.stack is None:
        _state.stack = [PRNGKey(0)]
    return _state.stack


def seed(s: int):
    """``paddle.seed``: reset the root key to ``PRNGKey(s)``."""
    _stack()[-1] = PRNGKey(int(s))
    return s


def next_key():
    """Split the current key: keep the first half, return the second."""
    st = _stack()
    new, sub = split(st[-1])
    st[-1] = new
    return sub


def get_state():
    return _stack()[-1]


def set_state(key):
    _stack()[-1] = _as_key(key)


class key_scope:
    """Push a base key for the duration of a ``with`` block."""

    def __init__(self, key):
        self._key = _as_key(key)

    def __enter__(self):
        _stack().append(self._key)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False
