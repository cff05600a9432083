"""head_dim 256 through paddle_tpu_torch's forward attention paths, against
the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages at
D = 256 (Gemma 2B's and GPT-J's head size):

(a) the plain flash forward (out and lse) against the JAX Pallas
    `_flash_fwd` in interpret mode (``PTPU_PALLAS_INTERPRET=1``, one
    128-row block: B=1, H=2, S=128), every branch, in float32, bfloat16
    and float16;
(b) the plain decode (`flash_decode_reference`) against the JAX
    `_decode_kernel` (`flash_decode_arrays`, interpret mode, forced with
    ``PTPU_FLASH_DECODE=1``), three types;
(c) the plain fused decode layer against `_fused_decode_layer_kernel`
    (interpret mode; hidden 512, two heads), float32 and bfloat16;
(d) the ragged plain version on fp pools (three types) and on int8 pools
    (q of each type) against the JAX XLA fallback (jitted, as the JAX
    engine's step programs run it), the oracle of ROADMAP's "Caveat
    about the reference";
(e) the slice as a whole: a stacked 2-layer GPT of hidden 512 with two
    heads of 256, the JAX model's weights carried across by
    `convert.params_from_numpy`: the engine's greedy tokens on fp and
    int8 pools, and greedy `generate` in the default and the fused mode
    (``PTPU_FUSED_DECODE=1 PTPU_PALLAS_FFN=1``), identical to the JAX
    package's;
(f) what the card side rests on, checked here: each wrapper's gate
    takes 256 and still refuses other sizes (the flash gate takes the
    larger multiples of 128 too), the flash backward's gate
    takes 256 and 384 (each reaches its kernel's load) and refuses 96
    with its own ValueError before any launch, the split-K loop's
    lane layout (`decode_common.cuh` `RowLanes`, mirrored) covers a row
    once with neighbouring lanes on neighbouring 16 bytes and is the
    layout of before at D <= 128, and `fused_plan` sizes the fused
    layer's scratch for D = 256.

Limits (`paddle_tpu_torch.ops.tolerance`): float32 ``FP32_FWD`` (2e-5,
derived for D = 256 in the module docstring); bfloat16 and float16 the
per-element limits of each kernel kind -- one step of the output plus
what each side rounds (p at 2^-7 / 2^-10 P|V| in the flash forward),
plus, against the TPU decode kernels in bf16, 2^-8 scale sum_d |q_d k_d|
a score (they round each product to bf16, `qk_rounding`).  Pools, int8
codes and scales bitwise; greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

B, H, D = 1, 2, 256
LSE_TOL = 1e-5
QK_ROUNDING = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# (name, causal, mask, kv_lens, segments)
BRANCHES = [("causal", True, False, False, False),
            ("segs_causal", True, False, False, True),
            ("segs_noncausal", False, False, False, True),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("noncausal", False, False, False, False),
            ("mask_kv_lens_noncausal", False, True, True, False)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _j(a, jdt):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def _assert_within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _limit(kind, got, want, mag, sub=None):
    """float32: FP32_FWD; bf16 / fp16: the half limit of ``kind``."""
    if got.dtype == torch.float32:
        return tol.FP32_FWD
    return tol.half_limit(got, want, mag, kind, sub)


# ---------------------------------------------------------------------------
# (a) flash forward against the JAX kernel
# ---------------------------------------------------------------------------

S = 128


def _branch_inputs(name, seed):
    _, causal, has_mask, has_lens, has_segs = next(
        c for c in BRANCHES if c[0] == name)
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = None
    if has_mask:
        mask = (rng.randn(B, 1, S, S) * 2).astype(np.float32)
        mask[rng.rand(B, 1, S, S) < 0.3] = -1e30
        mask[..., 0] = 0.0
        idx = np.arange(S)
        mask[..., idx, idx] = 0.0
    lens = np.array([S - 37], np.int32) if has_lens else None
    segs = None
    if has_segs:
        row = np.concatenate([np.full(n, i)
                              for i, n in enumerate((50, 40, 38))])
        segs = rng.permutation(row)[None].astype(np.int32)
    return causal, q, k, v, mask, lens, segs


@pytest.fixture(scope="module")
def jax_flash():
    """{(branch, dtype): (out, lse)} of the JAX Pallas forward in interpret
    mode, one 128-row block."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PTPU_PALLAS_INTERPRET", "1")
    runs = {}
    try:
        for name, *_ in BRANCHES:
            causal, q, k, v, mask, lens, segs = _branch_inputs(name, 11)
            for dtype, (jdt, _) in DTYPES.items():
                qf, kf, vf = (jpo._fold_heads(_j(a, jdt)) for a in (q, k, v))
                of, lse = jpo._flash_fwd(
                    qf, kf, vf, causal, D ** -0.5, block_q=128, block_k=128,
                    n_heads=H,
                    mask=None if mask is None else jnp.asarray(mask),
                    kv_lens=(None if lens is None
                             else jnp.asarray(lens)[:, None]),
                    segments=None if segs is None else jnp.asarray(segs))
                assert of.dtype == jdt
                runs[name, dtype] = (jpo._unfold_heads(of, B, H), lse)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
def test_plain_forward_matches_jax_kernel_d256(name, dtype, jax_flash):
    causal, q, k, v, mask, lens, segs = _branch_inputs(name, 11)
    tdt = DTYPES[dtype][1]
    want, want_lse = jax_flash[name, dtype]
    qt, kt, vt = (_t(a, tdt) for a in (q, k, v))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    got, lse = fa.mha_reference(qt, kt, vt, br[0], causal, D ** -0.5,
                                *br[1:], return_lse=True)
    got = got.to(tdt)
    want = _t(_np(want), tdt)
    limit = tol.FP32_FWD if tdt == torch.float32 else tol.flash_fwd_limit(
        got, want, qt, kt, vt, causal, *br)
    _assert_within(got, want, limit, f"forward {name} {dtype}")
    np.testing.assert_allclose(lse.numpy(), _np(want_lse).reshape(B, H, S),
                               atol=LSE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# (b) decode against the JAX decode kernel
# ---------------------------------------------------------------------------

S_MAX = 256


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("length", [1, 200])
def test_decode_reference_matches_jax_kernel_d256(length, dtype,
                                                  monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PTPU_FLASH_DECODE", "1")
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(length)
    q = rng.randn(2, 1, H, D).astype(np.float32)
    kc, vc = (rng.randn(2, S_MAX, H * D).astype(np.float32)
              for _ in range(2))
    assert jpo._decode_ok(_j(q, jdt), _j(kc, jdt), _j(vc, jdt))
    want = jpo.flash_decode_arrays(_j(q, jdt), _j(kc, jdt), _j(vc, jdt),
                                   length)
    qt, kt, vt = (_t(a, tdt) for a in (q, kc, vc))
    got = fd.flash_decode_reference(qt, kt, vt, length)
    assert got.dtype == tdt and got.shape == (2, 1, H, D)
    want = _t(_np(want), tdt)
    limit = tol.FP32_FWD if tdt == torch.float32 else tol.decode_limit(
        got, want, qt, kt, vt, length, D ** -0.5,
        QK_ROUNDING if tdt == torch.bfloat16 else 0.0)
    _assert_within(got, want, limit, f"decode length {length} {dtype}")


# ---------------------------------------------------------------------------
# (c) the fused decode layer against the JAX kernel
# ---------------------------------------------------------------------------

HD = H * D


def _layer_inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, HD).astype(np.float32)
    ln_w = (1 + 0.1 * rng.randn(HD)).astype(np.float32)
    ln_b = (0.1 * rng.randn(HD)).astype(np.float32)
    wqkv = (rng.randn(HD, 3 * HD) * HD ** -0.5).astype(np.float32)
    bqkv = (0.1 * rng.randn(3 * HD)).astype(np.float32)
    wo = (rng.randn(HD, HD) * HD ** -0.5).astype(np.float32)
    bo = (0.1 * rng.randn(HD)).astype(np.float32)
    kc, vc = (rng.randn(b, S_MAX, HD).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(b, S_MAX) < 0.3, -1e30, 0.0).astype(np.float32)
    return (x, ln_w, ln_b, wqkv, bqkv, wo, bo, kc, vc), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,masked", [(1, False), (200, True)])
def test_fused_decode_reference_matches_jax_kernel_d256(t, masked, dtype,
                                                        monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    arrays, mask = _layer_inputs(t)
    m = mask if masked else None
    wy, wk, wv = jpo.fused_decode_layer_arrays(
        *(_j(a, jdt) for a in arrays), t, H,
        cache_mask=None if m is None else jnp.asarray(m))
    args = [_t(a, tdt) for a in arrays]
    before = [c.clone() for c in args[7:]]
    mt = None if m is None else torch.from_numpy(m)
    plain = fdl.fused_decode_plain(*args, t, H, cache_mask=mt)
    y, gk, gv = fdl.fused_decode_layer_reference(*args, t, H, cache_mask=mt)
    for c, c0 in zip((gk, gv), before):       # only row t is written
        assert torch.equal(c[:, :t], c0[:, :t])
        assert torch.equal(c[:, t + 1:], c0[:, t + 1:])
    wy, wk, wv = (_t(_np(a), tdt) for a in (wy, wk, wv))
    if dtype == "float32":
        limits = dict(y=tol.FP32_FWD, k=tol.FP32_FWD, v=tol.FP32_FWD)
    else:
        limits = tol.fused_decode_limits(plain, args[:7], *before, t, H,
                                         D ** -0.5, qk_rounding=QK_ROUNDING)
    _assert_within(y, wy, limits["y"], f"fused y t={t}")
    _assert_within(gk[:, t], wk[:, t], limits["k"], f"fused k row t={t}")
    _assert_within(gv[:, t], wv[:, t], limits["v"], f"fused v row t={t}")


# ---------------------------------------------------------------------------
# (d) ragged on fp and int8 pools against the JAX fallback
# ---------------------------------------------------------------------------

NB, BS = 24, 16
# the fallback jitted, as the JAX engine runs it in its step programs
_jit_ragged = jax.jit(jrpa.ragged_paged_attention_arrays)


def _ragged_inputs(seed, c=1):
    """Rows of 40, 17 and 64 keys after the write (the last a chunk of C
    queries), block 16, tables from a permutation of the pool."""
    rng = np.random.RandomState(seed)
    lens = np.array([40, 17, 64], np.int32)
    b = len(lens)
    pos0 = (lens - c).astype(np.int32)
    maxb = 4
    perm = rng.permutation(NB)
    tables = perm[:b * maxb].reshape(b, maxb).astype(np.int32)
    slots = np.stack([tables[r, (pos0[r] + np.arange(c)) // BS] * BS
                      + (pos0[r] + np.arange(c)) % BS
                      for r in range(b)]).astype(np.int32)
    q, kn, vn = (rng.randn(b, c, H, D).astype(np.float32) for _ in range(3))
    kb, vb = (rng.randn(NB, BS, H, D).astype(np.float32) for _ in range(2))
    return q, kn, vn, kb, vb, tables, pos0, lens, slots


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [1, 5])
def test_ragged_fp_pools_match_jax_fallback_d256(c, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kn, vn, kb, vb, tables, pos0, lens, slots = _ragged_inputs(c, c)
    idx = [jnp.asarray(a) for a in (tables, pos0, lens, slots)]
    assert not jrpa._ragged_kernel_ok(_j(q, jdt), _j(kb, jdt), c, False)
    want, wk, wv = _jit_ragged(
        *(_j(a, jdt) for a in (q, kn, vn, kb, vb)), *idx)
    qt, knt, vnt, kbt, vbt = (_t(a, tdt) for a in (q, kn, vn, kb, vb))
    ti = [torch.from_numpy(a) for a in (tables, pos0, lens, slots)]
    ops.reset_launch_counts()
    got, gk, gv = rpa.ragged_paged_attention_arrays(qt, knt, vnt, kbt, vbt,
                                                    *ti)
    assert set(ops.launch_counts().values()) == {0}
    assert torch.equal(gk, _t(_np(wk), tdt))
    assert torch.equal(gv, _t(_np(wv), tdt))
    want = _t(_np(want), tdt)
    mag = rpa.ragged_paged_attention_reference(
        q=qt.float(), k_new=knt.float(), v_new=vnt.float().abs(),
        k_blocks=gk.float(), v_blocks=gv.float().abs(), block_table=ti[0],
        pos0=ti[1], kv_lens=ti[2], slots=ti[3])[0]
    _assert_within(got, want, _limit("decode", got, want, mag),
                   f"ragged {dtype} pools C={c}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [1, 5])
def test_ragged_int8_pools_match_jax_fallback_d256(c, dtype):
    """Codes and scales bitwise, the scales grown by the new rows."""
    jdt, tdt = DTYPES[dtype]
    q, kn, vn, _, _, tables, pos0, lens, slots = _ragged_inputs(10 + c, c)
    rng = np.random.RandomState(c)
    codes = [rng.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.rand(NB, H) * 0.005).astype(np.float32)
              for _ in range(2)]
    idx = [jnp.asarray(a) for a in (tables, pos0, lens, slots)]
    want, *wpools = _jit_ragged(
        *(_j(a, jdt) for a in (q, kn, vn)), jnp.asarray(codes[0]),
        jnp.asarray(codes[1]), *idx, jnp.asarray(scales[0]),
        jnp.asarray(scales[1]))
    qt, knt, vnt = (_t(a, tdt) for a in (q, kn, vn))
    ti = [torch.from_numpy(a) for a in (tables, pos0, lens, slots)]
    pools = [torch.from_numpy(a.copy()) for a in codes + scales]
    got, *gpools = rpa.ragged_paged_attention_arrays(
        qt, knt, vnt, pools[0], pools[1], *ti, pools[2], pools[3])
    for g, w in zip(gpools, wpools):
        assert torch.equal(g, torch.from_numpy(np.asarray(w)))
    assert not np.array_equal(gpools[2].numpy(), scales[0])   # they grew
    want = _t(_np(want), tdt)
    mag = rpa.folded_quant_attention(qt.float(), gpools[0], gpools[1].abs(),
                                     gpools[2], gpools[3], ti[0], ti[1],
                                     D ** -0.5)
    _assert_within(got, want, _limit("decode", got, want, mag),
                   f"ragged int8 pools {dtype} q C={c}")


# ---------------------------------------------------------------------------
# (e) the slice: a GPT with two heads of 256, engine and generate
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=512, num_attention_heads=2, intermediate_size=1024,
           num_hidden_layers=2, max_position_embeddings=64, vocab_size=128)
P, NEW = 6, 6
ENGINE_NEW = 4
LENS = [5, 12, 5]


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
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
    assert m.cfg.hidden_size // m.cfg.num_attention_heads == 256
    return m.load_params(params_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_d256_matches_jax(jax_model, port_model, kv, monkeypatch):
    """Greedy tokens of a mixed batch with a chunked prefill (the 12-token
    prompt in chunks of 8), fp and int8 pools, equal to the JAX engine's
    (its XLA fallback)."""
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32) for n in LENS]
    cfg = dict(block_size=4, max_num_seqs=4, max_num_batched_tokens=8,
               kv_cache_dtype=kv)
    want = JaxEngine(jax_model, JaxEngineConfig(**cfg)).generate(
        prompts, JaxSamplingParams(max_new_tokens=ENGINE_NEW))
    eng = LLMEngine(port_model, EngineConfig(device="cpu", **cfg))
    ops.reset_launch_counts()
    got = eng.generate(prompts, SamplingParams(max_new_tokens=ENGINE_NEW))
    assert set(ops.launch_counts().values()) == {0}
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.head_dim == 256 and eng.step_counts["chunk"] > 0


def _jax_generate(jax_model, ids):
    jax_model._gen_step = None        # its jit cache ignores the env flags
    return np.asarray(jax_model.generate(paddle.to_tensor(ids),
                                         max_new_tokens=NEW).numpy())


@pytest.mark.parametrize("mode", ["default", "fused"])
def test_generate_d256_matches_jax(jax_model, port_model, mode,
                                   monkeypatch):
    """B=8 (a row block of 8, so the fused mode's MLP runs the fused LN +
    FFN in both packages)."""
    if mode == "fused":
        for name in ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN",
                     "PTPU_PALLAS_INTERPRET", "PTPU_ATTN_DEBUG"):
            monkeypatch.setenv(name, "1")
        jpo.reset_attention_path_counts()
    ids = np.random.RandomState(2).randint(0, 128, (8, P)).astype(np.int32)
    want = _jax_generate(jax_model, ids)
    if mode == "fused":
        paths = jpo.attention_path_counts()
        assert paths.get("fused_decode_kernel", 0) > 0
        assert paths.get("ffn_kernel", 0) > 0
    ops.reset_launch_counts()
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert set(ops.launch_counts().values()) == {0}
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (f) gates, the backward's refusal, the lane layout, the fused plan
# ---------------------------------------------------------------------------

def _zeros(*shape):
    return torch.zeros(*shape)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_gates_take_d256(d):
    q, k, v = (_zeros(1, 8, 2, d) for _ in range(3))
    fa._check_qkv(q, k, v)
    fd._check(q[:, :1], _zeros(1, 16, 2 * d), _zeros(1, 16, 2 * d), 4)
    x = _zeros(8, 2 * d)
    fdl._check(x, _zeros(2 * d), _zeros(2 * d), _zeros(2 * d, 6 * d),
               _zeros(6 * d), _zeros(2 * d, 2 * d), _zeros(2 * d),
               _zeros(8, 128, 2 * d), _zeros(8, 128, 2 * d), 5, 2, None)
    idx = (torch.zeros(1, 4, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32),
           torch.ones(1, dtype=torch.int32),
           torch.zeros(1, 1, dtype=torch.int32))
    qr = _zeros(1, 1, 2, d)
    rpa._check(qr, qr, qr, _zeros(4, 16, 2, d), _zeros(4, 16, 2, d), *idx,
               None, None)


@pytest.mark.parametrize("d", [32, 96, 192, 384, 512])
def test_gates_refuse_other_head_dims(d):
    """The decode kernels take 64, 128 and 256 only; the flash gate also
    takes every larger multiple of 128 (384, 512), as JAX's does."""
    q, k, v = (_zeros(1, 8, 2, d) for _ in range(3))
    if d % 128 == 0:
        fa._check_qkv(q, k, v)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_qkv(q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fd._check(q[:, :1], _zeros(1, 16, 2 * d), _zeros(1, 16, 2 * d), 4)
    idx = (torch.zeros(1, 4, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32),
           torch.ones(1, dtype=torch.int32),
           torch.zeros(1, 1, dtype=torch.int32))
    qr = _zeros(1, 1, 2, d)
    with pytest.raises(ValueError, match="head_dim"):
        rpa._check(qr, qr, qr, _zeros(4, 16, 2, d), _zeros(4, 16, 2, d),
                   *idx, None, None)
    x = _zeros(8, 2 * d)
    with pytest.raises(ValueError, match="head_dim"):
        fdl._check(x, _zeros(2 * d), _zeros(2 * d), _zeros(2 * d, 6 * d),
                   _zeros(6 * d), _zeros(2 * d, 2 * d), _zeros(2 * d),
                   _zeros(8, 128, 2 * d), _zeros(8, 128, 2 * d), 5, 2, None)


@pytest.mark.parametrize("kernel", [fa.flash_bwd_dq, fa.flash_bwd_dkv])
def test_backward_refuses_d256_before_any_launch(kernel, monkeypatch):
    """The backward's gate: D = 256 passes it and reaches the kernel's
    load, D = 384 the load of the kernels at larger multiples of 128
    (each refused here by a stub, as it fails on a machine without nvcc);
    D = 96 is refused with the gate's own ValueError before anything is
    loaded or launched."""
    loads = []

    def refuse_load(name):
        loads.append(name)
        raise LookupError(f"load {name}")

    monkeypatch.setattr(_build, "load", refuse_load)
    stats = _zeros(1, 2, 8)
    ops.reset_launch_counts()
    q, k, v, do = (_zeros(1, 8, 2, D) for _ in range(4))
    with pytest.raises(LookupError, match="flash_bwd_causal"):
        kernel._launch(q, k, v, do, stats, stats, 0.0625, True, None, None,
                       None, None)
    assert loads == ["flash_bwd_causal"]
    with pytest.raises(LookupError, match="flash_wide_bwd"):
        kernel._launch(*(_zeros(1, 8, 2, 384) for _ in range(4)), stats,
                       stats, 384 ** -0.5, True, None, None, None, None)
    assert loads == ["flash_bwd_causal", "flash_wide_bwd"]
    with pytest.raises(ValueError,
                       match="head_dim 64, 128, 256 or a larger multiple "
                             "of 128, got 96"):
        kernel._launch(*(_zeros(1, 8, 2, 96) for _ in range(4)), stats,
                       stats, 96 ** -0.5, True, None, None, None, None)
    assert loads == ["flash_bwd_causal", "flash_wide_bwd"]
    assert set(ops.launch_counts().values()) == {0}


def test_plain_backward_still_runs_at_d256_on_the_cpu():
    """The CPU path of autograd (the plain forward and backward) takes any
    head size, as JAX's fallback does; only the card's kernels refuse."""
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(1, 16, 2, D)).requires_grad_()
               for _ in range(3))
    out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()


# the element types of the split-K loop's pools, by 16-byte load: 4 fp32,
# 8 bf16 / fp16, 16 int8 values
VE = {"fp32": 4, "bf16": 8, "fp16": 8, "int8": 16}


def _row_lanes(ve, d):
    """`RowLanes<P, D>` of decode_common.cuh: (LPK, NV, KPW, STEP)."""
    lpk = min(d // ve, 32)
    nv = d // (ve * lpk)
    return lpk, nv, 32 // lpk, lpk * ve


@pytest.mark.parametrize("pool", list(VE))
@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_k_lane_layout_covers_each_row_once(pool, d):
    """Lane l of a key group holds dims (l % LPK) VE + j STEP + i: every
    dim of the row once, each of the NV loads of the LPK lanes contiguous
    16 bytes beside its neighbour's; up to D = 128 one load a lane (the
    loop of before, bitwise), at 256 two for fp32 and the whole warp for
    a 2-byte row."""
    ve = VE[pool]
    lpk, nv, kpw, step = _row_lanes(ve, d)
    dims = sorted((lane * ve + j * step + i) for lane in range(lpk)
                  for j in range(nv) for i in range(ve))
    assert dims == list(range(d))
    for j in range(nv):       # load j of lanes 0 .. LPK - 1: one run
        starts = [lane * ve + j * step for lane in range(lpk)]
        assert starts == list(range(j * step, j * step + lpk * ve, ve))
    assert kpw * lpk == 32
    if d <= 128:
        assert (lpk, nv) == (d // ve, 1)
    else:
        assert (lpk, nv) == ((32, 2) if pool == "fp32" else
                             (32, 1) if ve == 8 else (16, 1))
    # the fused layer's loads in flight: the old formula up to D = 128
    u_new = min(32 // kpw, 8 // nv)
    if d <= 128:
        assert u_new == min(32 // (32 // (d // ve)), 8)
    # each of the 128 threads of a block merges dims tid, tid + 128, ...
    block_dims = -(-d // 128)
    assert sorted(t + 128 * x for t in range(128) for x in range(block_dims)
                  if t + 128 * x < d) == list(range(d))


def test_fused_plan_sizes_the_d256_layer():
    """GPT-3 1.3B's widths with 8 heads of 256 at B=8 over S_max 2048 on
    132 blocks: part2 holds (m, l) and acc[256] for every split any
    t < S_max takes; the loads and the grid as at 16 heads of 128."""
    p256 = fdl.fused_plan(8, 8, 256, 2048, torch.bfloat16, 132)
    p128 = fdl.fused_plan(8, 16, 128, 2048, torch.bfloat16, 132)
    assert (p256.l1, p256.l3) == (p128.l1, p128.l3)
    assert p256.splits == min(-(-2047 // fdl.RUN), p256.cap)
    part2 = p256.offsets[3] - p256.offsets[2]
    assert part2 >= 8 * 8 * p256.splits * (256 + 2) * 4
    assert p256.tickets == 8 * 8 + 2048 // 64
    chunk, splits = fdl.fused_split(1023, 64, 8 * 132)
    assert splits * chunk >= 1023 and chunk % fdl.RUN == 0
