"""The bf16 flash forward's limit (`tolerance.FLASH_FWD_COEF`) against the
JAX package, on the CPU.

The tensor-core forward rounds p to bf16 for its PV product at the running
max of each key tile, as the TPU kernel `_flash_fwd_kernel` does
(`pallas_ops.py:180-181`); the port's plain version (`mha_reference`)
rounds the normalised probabilities, at each row's final max.  The limit
the card tests hold the kernel to, 2^-7 max(|out|, |ref|) + 2^-7 P|V| per
element (`tolerance` docstring), has to cover that difference.  Here JAX's
own `_flash_fwd`, run in bf16 in interpret mode with 128-row blocks (so two
key tiles and their running max per row), is held against the port's
`mha_reference` under that limit, for every branch the kernel takes:
causal, a left-pad mask, kv_lens, segment ids (sorted documents across the
tiles in row 0, permuted in row 1) and non-causal, at S=256 and D 64 and
128.  Its lse is held to 1e-4 (both fp32, from the same bf16 products).

Rows the pad mask closes entirely (queries before the pad's end, whose
every allowed key is masked) are left out: there JAX's kernel spreads the
row over whole key tiles and the port over the allowed keys, a difference
by design (ROADMAP Queue 3); no real token reads such a row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ops as jpo

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tolerance as tol

B, H, S = 2, 2, 256
PADS = (0, 37)
BRANCHES = ["causal", "pad_mask", "kv_lens", "segments", "noncausal"]


def _inputs(branch, d, seed):
    """q, k, v float32 [B, S, H, D] (bf16-exact), causal, the additive
    [B, 1, S, S] mask, kv_lens [B] and segment ids [B, S] of a branch, and
    the first row each batch row is compared from."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, d).astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (q, k, v))
    mask = lens = segs = None
    first = [0] * B
    if branch == "pad_mask":
        mask = np.zeros((B, 1, S, S), np.float32)
        for r, n in enumerate(PADS):
            mask[r, :, :, :n] = -1e30
        first = list(PADS)
    if branch == "kv_lens":
        lens = np.array([S - 45, S], np.int32)
    if branch == "segments":
        row = np.concatenate([np.full(n, i) for i, n in
                              enumerate((100, 70, 50, 36))]).astype(np.int32)
        segs = np.stack([row, rng.permutation(row)])
    return q, k, v, branch != "noncausal", mask, lens, segs, first


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", BRANCHES)
def test_jax_bf16_flash_fwd_within_flash_limit(branch, d, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    q, k, v, causal, mask, lens, segs, first = _inputs(branch, d, 7 + d)
    scale = d ** -0.5
    of, lse = jpo._flash_fwd(
        *(jpo._fold_heads(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v)),
        causal, scale, block_q=128, block_k=128, n_heads=H,
        mask=None if mask is None else jnp.asarray(mask),
        kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
        segments=None if segs is None else jnp.asarray(segs))
    assert of.dtype == jnp.bfloat16
    got = torch.from_numpy(np.asarray(
        jpo._unfold_heads(of, b=B, h=H).astype(jnp.float32)))
    got_lse = torch.from_numpy(np.asarray(lse)).reshape(B, H, S)

    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mt, lt, st = (None if a is None else torch.from_numpy(a)
                  for a in (mask, lens, segs))
    want, want_lse = fa.mha_reference(qt, kt, vt, mt, causal, scale, lt, st,
                                      return_lse=True)
    mag = tol.flash_fwd_magnitude(qt, kt, vt, causal, mt, lt, st)
    limit = tol.bf16_limit(got, want, mag, tol.FLASH_FWD_COEF)
    for r in range(B):
        rows = slice(first[r], S)
        err, ratio, ok = tol.compare(got[r, rows], want[r, rows],
                                     limit[r, rows])
        assert ok, (branch, d, r, err, ratio)
        lse_err = (got_lse[r, :, rows] - want_lse[r, :, rows]).abs().max()
        assert lse_err.item() <= 1e-4, (branch, d, r, lse_err.item())
