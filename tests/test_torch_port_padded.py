"""paddle_tpu_torch's padded-prompt generate and masked flash forward
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

- the plain masked / kv_lens flash forward against the JAX Pallas
  `_flash_fwd_kernel` (`flash_attention_arrays` under
  ``PTPU_PALLAS_INTERPRET=1``; it takes the kernel for S % 128 == 0 and
  D in {64, 128}), causal, with a [1, 1, S, S], [B, 1, S, S] or
  [B, H, S, S] additive mask, a bool mask, kv_lens, and kv_lens with a
  mask: float32 within 1e-5 (the two sum in different orders).  Every
  row keeps a key the mask leaves open (column 0 and the diagonal); a
  row the mask closes entirely is pinned on its own, as the uniform
  softmax over the keys causal allows.
- greedy ``generate(pad_token_id=...)`` of the test GPT of
  tests/test_generate.py against the JAX ``generate``: right-padded,
  left-padded and mixed rows, and with ``eos_token_id``, in the default
  mode and in the fused mode (``PTPU_FUSED_DECODE=1 PTPU_PALLAS_FFN=1``;
  ``PTPU_PALLAS_INTERPRET=1`` for JAX).  Tokens and the returned
  left-aligned buffer must be identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.serving import LLMEngine as JaxEngine

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops import flash_attention as fa
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
B, H, D = 2, 2, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _additive(shape, rng):
    """Random additive mask: N(0, 2) scores, -1e30 at ~30 % of the keys,
    column 0 and the diagonal open."""
    m = (rng.randn(*shape) * 2).astype(np.float32)
    m[rng.rand(*shape) < 0.3] = -1e30
    m[..., 0] = 0.0
    idx = np.arange(shape[-1])
    m[..., idx, idx] = 0.0
    return m


def _mask_case(case, s, rng):
    """(attn_mask or None, kv_lens or None) of a named case."""
    if case == "mask_1_1":
        return _additive((1, 1, s, s), rng), None
    if case == "mask_b_1":
        return _additive((B, 1, s, s), rng), None
    if case == "mask_b_h":
        return _additive((B, H, s, s), rng), None
    if case == "bool_b":
        return _additive((B, s, s), rng) == 0.0, None
    lens = np.array([s - 28, s], np.int32)
    if case == "kv_lens":
        return None, lens
    return _additive((B, 1, s, s), rng), lens


CASES = ["mask_1_1", "mask_b_1", "mask_b_h", "bool_b", "kv_lens",
         "kv_lens_mask"]


@pytest.mark.parametrize("s,case", [(128, c) for c in CASES]
                         + [(256, "kv_lens_mask")])
def test_masked_plain_matches_jax_kernel(s, case, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    rng = np.random.RandomState(s + CASES.index(case))
    q, k, v = (rng.randn(B, s, H, D).astype(np.float32) for _ in range(3))
    mask, lens = _mask_case(case, s, rng)
    jpo.reset_attention_path_counts()
    want = np.asarray(jpo.flash_attention_arrays(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), is_causal=True,
        kv_lens=None if lens is None else jnp.asarray(lens)))
    assert any(p.startswith("attn_kernel")
               for p in jpo.attention_path_counts())
    ops.reset_launch_counts()
    got = fa.flash_attention_arrays(
        _t(q), _t(k), _t(v), None if mask is None else _t(mask),
        is_causal=True, kv_lens=None if lens is None else _t(lens))
    assert set(ops.launch_counts().values()) == {0}
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_fully_masked_row_is_uniform_over_allowed_keys():
    """A left-pad query (every key masked) averages the values of the keys
    causal and kv_lens allow, as the kernel computes it."""
    rng = np.random.RandomState(0)
    s = 8
    q, k, v = (_t(rng.randn(1, s, 1, D).astype(np.float32))
               for _ in range(3))
    mask = torch.zeros(1, 1, 1, s)
    mask[..., :3] = -1e30                      # three left pads
    m = mask.expand(1, 1, s, s)
    out = fa.flash_attention_arrays(q, k, v, m, is_causal=True,
                                    kv_lens=torch.tensor([6]))
    for i in range(3):                         # pad rows
        torch.testing.assert_close(out[0, i, 0], v[0, :i + 1, 0].mean(0))
    keys = torch.arange(s)
    for i in range(3, s):
        allowed = (keys >= 3) & (keys <= i) & (keys < 6)
        p = torch.softmax((q[0, i, 0] @ k[0, :, 0].T)[allowed] * D ** -0.5,
                          0)
        torch.testing.assert_close(out[0, i, 0], p @ v[0, allowed, 0])


def test_masked_grad_on_cpu_matches_jax_vjp():
    """On the CPU a mask under grad is differentiated through the plain
    forward, as the JAX fallback's VJP (`pallas_ops.py:718-729`)."""
    rng = np.random.RandomState(1)
    s = 16
    q, k, v, g = (rng.randn(B, s, H, D).astype(np.float32)
                  for _ in range(4))
    mask = _additive((B, 1, s, s), rng)

    def jf(q, k, v):
        return jpo.mha_reference(q, k, v, jnp.asarray(mask), True)
    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    fa.flash_attention_arrays(qt, kt, vt, _t(mask),
                              is_causal=True).backward(_t(g))
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


def test_mask_and_kv_lens_shapes_are_checked():
    q = torch.zeros(2, 4, 3, 64)
    for bad in (torch.zeros(4, 5), torch.zeros(3, 4, 4),
                torch.zeros(2, 2, 4, 4), torch.zeros(1, 1, 1, 4, 4)):
        with pytest.raises(ValueError, match="attn_mask"):
            fa.flash_attention_arrays(q, q, q, bad)
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention_arrays(q, q, q, kv_lens=torch.tensor([1, 2, 3]))
    m = fa.normalize_mask(torch.ones(2, 4, 4, dtype=torch.bool), 2, 3, 4, 4)
    assert m.shape == (2, 3, 4, 4) and m.stride(1) == 0
    assert m.dtype == torch.float32 and not m.any()


# ---------------------------------------------------------------------------
# the slice as a whole: padded-prompt generate
# ---------------------------------------------------------------------------

CFG = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=256,
           num_attention_heads=2, max_position_embeddings=64)
PAD, P, NEW = 0, 7, 6


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(21)
    m = JaxGPT(jax_test_config(stacked_blocks=True, sequence_parallel=False,
                               **CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jax_model)._param_arrays().items()}
    m = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                       device="cpu")
    return m.load_params(params_from_numpy(arrays, device="cpu"))


def _batch(kind, seed=3):
    """8 rows of up to P tokens in 1..89: every row right-padded, every
    row left-padded, or a mix (right, left, unpadded, one token)."""
    rs = np.random.RandomState(seed)
    lens = [7, 4, 2, 6, 1, 5, 3, 7]
    ids = np.full((8, P), PAD, np.int32)
    for r, n in enumerate(lens):
        toks = rs.randint(1, 90, n)
        left = kind == "left" or (kind == "mixed" and r % 2)
        if left:
            ids[r, P - n:] = toks
        else:
            ids[r, :n] = toks
    return ids


def _jax_generate(jax_model, ids, **kw):
    jax_model._gen_step = None        # its jit cache ignores the env flags
    return np.asarray(jax_model.generate(paddle.to_tensor(ids),
                                         max_new_tokens=NEW,
                                         pad_token_id=PAD, **kw).numpy())


MODES = {"default": {}, "fused": {"PTPU_FUSED_DECODE": "1",
                                  "PTPU_PALLAS_FFN": "1",
                                  "PTPU_PALLAS_INTERPRET": "1"}}


@pytest.mark.parametrize("mode,kind", [("default", "right"),
                                       ("default", "left"),
                                       ("default", "mixed"),
                                       ("default", "eos"),
                                       ("fused", "mixed"),
                                       ("fused", "eos")])
def test_padded_generate_matches_jax(jax_model, port_model, mode, kind,
                                     monkeypatch):
    for name in ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN",
                 "PTPU_PALLAS_INTERPRET"):
        monkeypatch.delenv(name, raising=False)
    for name, val in MODES[mode].items():
        monkeypatch.setenv(name, val)
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    jpo.reset_attention_path_counts()
    ids = _batch("mixed" if kind == "eos" else kind)
    kw = {}
    if kind == "eos":
        free = _jax_generate(jax_model, ids)
        kw["eos_token_id"] = int(free[0, P + 1])   # row 0 ends after two
    want = _jax_generate(jax_model, ids, **kw)
    paths = jpo.attention_path_counts()
    assert (paths.get("fused_decode_kernel", 0) > 0) == (mode == "fused")
    calls = {"masks": [], "fused": 0}
    flash, fused = port_gpt.flash_attention_arrays, \
        port_gpt.fused_decode_layer_arrays

    def flash_spy(q, k, v, attn_mask=None, **a):
        calls["masks"].append(attn_mask)
        return flash(q, k, v, attn_mask, **a)

    def fused_spy(*a, **k):
        calls["fused"] += 1
        assert k["cache_mask"] is not None
        return fused(*a, **k)

    monkeypatch.setattr(port_gpt, "flash_attention_arrays", flash_spy)
    monkeypatch.setattr(port_gpt, "fused_decode_layer_arrays", fused_spy)
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                              pad_token_id=PAD, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefill's mask: the key-validity row as a stride-0 [B, 1, P, P]
    layers = port_model.cfg.num_hidden_layers
    assert len(calls["masks"]) == layers
    assert all(m.shape == (8, 1, P, P) and m.stride(2) == 0
               for m in calls["masks"])
    steps = got.shape[1] - P - 1
    assert calls["fused"] == (layers * steps if mode == "fused" else 0)
    if kind != "eos":
        assert steps == NEW - 1
    # left-aligned: [pads | prompt | generated]
    for r, row in enumerate(ids):
        real = row[row != PAD]
        np.testing.assert_array_equal(got[r, P - len(real):P].numpy(), real)
        assert (got[r, :P - len(real)] == PAD).all()


def test_padded_rows_generate_what_they_generate_alone(port_model):
    """Each padded row continues as it would unpadded (the JAX test's
    bar), right- and left-padded alike."""
    ids = _batch("mixed", seed=5)
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                              pad_token_id=PAD)
    for r in (0, 1, 4):
        real = ids[r][ids[r] != PAD]
        alone = port_model.generate(torch.from_numpy(real[None]),
                                    max_new_tokens=NEW)
        np.testing.assert_array_equal(got[r, P:].numpy(),
                                      alone[0, len(real):].numpy())
