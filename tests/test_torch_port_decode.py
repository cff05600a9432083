"""paddle_tpu_torch's dense KV-cache decode against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through both packages:

- the plain decode attention against the JAX Pallas `_decode_kernel`
  (`flash_decode_arrays`, interpret mode) and against the XLA branch of
  `cached_attention_arrays`;
- the plain fused decode layer against `_fused_decode_layer_kernel`
  (interpret), without and with a row mask;
- the plain LayerNorm and FFN against `_ln_fwd_kernel` and
  `_ffn_fwd_kernel` (interpret);
- greedy `generate` of the test GPT in the default mode and in the fused
  mode (``PTPU_FUSED_DECODE=1 PTPU_PALLAS_FFN=1``).

Tolerances: float32 1e-5 absolute (the frameworks sum in different
orders; LayerNorm statistics 1e-5 relative).  bfloat16, per element
(`paddle_tpu_torch.ops.tolerance`): one bf16 step of the output plus the
rounding of the intermediates each side rounds — p (2^-7 P|V|), and for
the fused layer xn and the attention output through the weights they
multiply, for LayerNorm the fp32 noise of its terms where y cancels.  The
TPU decode kernels also round each q_d k_d product to bf16
before the per-head sum (a matmul against a head indicator, an artefact
of the (8, 128) tiling) and the port does not, so against them each score
may move by a further 2^-8 scale sum_d |q_d k_d|, which moves the output
by up to twice that times P|V| (`qk_rounding=2^-8`).  Against the XLA
branch, which rounds the normalised probabilities, the same limit holds
without that term.  Greedy tokens must be identical.
"""
import numpy as np
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
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import tolerance as tol
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


TOL_FP32 = 1e-5
QK_ROUNDING = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _j(a, jdt):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def _assert_close(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

B, H, D, S_MAX = 2, 2, 64, 256


def _decode_inputs(seed):
    rng = np.random.RandomState(seed)
    q, kn, vn = (rng.randn(B, 1, H, D).astype(np.float32) for _ in range(3))
    kc, vc = (rng.randn(B, S_MAX, H * D).astype(np.float32)
              for _ in range(2))
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 100, 256])
def test_decode_reference_matches_jax_kernel(length, dtype, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    q, _, _, kc, vc = _decode_inputs(length)
    want = jpo.flash_decode_arrays(_j(q, jdt), _j(kc, jdt), _j(vc, jdt),
                                   length)
    qt, kt, vt = (_t(a, tdt) for a in (q, kc, vc))
    got = fd.flash_decode_reference(qt, kt, vt, length)
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    want = _t(_np(want), tdt)
    limit = TOL_FP32 if dtype == "float32" else tol.decode_limit(
        got, want, qt, kt, vt, length, D ** -0.5, QK_ROUNDING)
    _assert_close(got, want, limit, f"decode length {length}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 100, 256])
def test_cached_attention_matches_jax_xla_branch(length, dtype):
    """Off the TPU the JAX `cached_attention_arrays` takes its masked XLA
    branch; the port's S_q = 1 step takes the decode (plain on the CPU).
    Both write the new row at t = length - 1."""
    jdt, tdt = DTYPES[dtype]
    q, kn, vn, kc, vc = _decode_inputs(length + 7)
    t = length - 1
    want, wk, wv = jpo.cached_attention_arrays(
        _j(q, jdt), _j(kn, jdt), _j(vn, jdt), _j(kc, jdt), _j(vc, jdt), t)
    qt, knt, vnt, kct, vct = (_t(a, tdt) for a in (q, kn, vn, kc, vc))
    ops.reset_launch_counts()
    got, gk, gv = ops.cached_attention_arrays(qt, knt, vnt, kct, vct, t)
    assert gk is kct and gv is vct          # written in place
    assert torch.equal(gk, _t(_np(wk), tdt))
    assert torch.equal(gv, _t(_np(wv), tdt))
    want = _t(_np(want), tdt)
    limit = TOL_FP32 if dtype == "float32" else tol.decode_limit(
        got, want, qt, gk, gv, length, D ** -0.5)
    _assert_close(got, want, limit, f"cached attention t={t}")
    assert set(ops.launch_counts().values()) == {0}


def test_cached_attention_masked_branch_matches_jax():
    """A prefill chunk with an extra bool mask takes the masked branch in
    both packages."""
    rng = np.random.RandomState(4)
    s, t = 5, 3
    q, k, v = (rng.randn(B, s, H, D).astype(np.float32) for _ in range(3))
    kc, vc = (rng.randn(B, 16, H * D).astype(np.float32) for _ in range(2))
    mask = rng.rand(B, 1, 1, 16) > 0.3
    mask[..., 0] = True
    want, _, _ = jpo.cached_attention_arrays(
        *(jnp.asarray(a) for a in (q, k, v, kc, vc)), t,
        mask=jnp.asarray(mask))
    got, _, _ = ops.cached_attention_arrays(
        *(_t(a) for a in (q, k, v, kc, vc)), t, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL_FP32,
                               rtol=0)


# ---------------------------------------------------------------------------
# fused decode layer
# ---------------------------------------------------------------------------

HD = H * D


def _layer_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, HD).astype(np.float32)
    ln_w = (1 + 0.1 * rng.randn(HD)).astype(np.float32)
    ln_b = (0.1 * rng.randn(HD)).astype(np.float32)
    wqkv = (rng.randn(HD, 3 * HD) * HD ** -0.5).astype(np.float32)
    bqkv = (0.1 * rng.randn(3 * HD)).astype(np.float32)
    wo = (rng.randn(HD, HD) * HD ** -0.5).astype(np.float32)
    bo = (0.1 * rng.randn(HD)).astype(np.float32)
    kc, vc = (rng.randn(B, S_MAX, HD).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(B, S_MAX) < 0.3, -1e30, 0.0).astype(np.float32)
    return (x, ln_w, ln_b, wqkv, bqkv, wo, bo, kc, vc), mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 37, 255])
def test_fused_decode_reference_matches_jax_kernel(t, dtype, masked,
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
    assert y.dtype == tdt and gk is args[7] and gv is args[8]
    for c, c0 in zip((gk, gv), before):       # only row t is written
        assert torch.equal(c[:, :t], c0[:, :t])
        assert torch.equal(c[:, t + 1:], c0[:, t + 1:])
    wy, wk, wv = (_t(_np(a), tdt) for a in (wy, wk, wv))
    if dtype == "float32":
        limits = {"y": TOL_FP32, "k": TOL_FP32, "v": TOL_FP32}
    else:
        limits = tol.fused_decode_limits(plain, args[:7], *before, t, H,
                                         D ** -0.5, qk_rounding=QK_ROUNDING)
    _assert_close(y, wy, limits["y"], f"fused y t={t}")
    _assert_close(gk[:, t], wk[:, t], limits["k"], f"fused k row t={t}")
    _assert_close(gv[:, t], wv[:, t], limits["v"], f"fused v row t={t}")


def test_fused_decode_cpu_wrapper_is_the_reference():
    arrays, mask = _layer_inputs(3)
    a1 = [_t(a) for a in arrays]
    a2 = [x.clone() for x in a1]
    ops.reset_launch_counts()
    y1, _, _ = ops.fused_decode_layer_arrays(
        *a1, 9, H, cache_mask=torch.from_numpy(mask)[:, None, None])
    y2, _, _ = fdl.fused_decode_layer_reference(
        *a2, 9, H, cache_mask=torch.from_numpy(mask))
    assert torch.equal(y1, y2) and torch.equal(a1[7], a2[7])
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# fused LayerNorm and FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,pdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_layernorm_reference_matches_jax_kernel(xdt, pdt, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(5)
    x = (rng.randn(16, 256) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    b = (0.1 * rng.randn(256)).astype(np.float32)
    (jx, tx), (jp, tp) = DTYPES[xdt], DTYPES[pdt]
    wy, wmu, wrs = jpo._ln_fwd(_j(x, jx), _j(w, jp), _j(b, jp), 1e-5)
    y, mu, rs = fm.fused_layernorm_arrays(_t(x, tx), _t(w, tp), _t(b, tp),
                                          1e-5, return_stats=True)
    want_dt = torch.float32 if "float32" in (xdt, pdt) else torch.bfloat16
    assert y.dtype == want_dt and str(wy.dtype) == str(want_dt)[6:]
    assert mu.shape == rs.shape == (16, 1) and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), _np(wmu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), _np(wrs), rtol=1e-5, atol=0)
    wy = _t(_np(wy), want_dt)
    limit = TOL_FP32 if want_dt == torch.float32 else tol.bf16_limit(
        y, wy, tol.ln_magnitude(_t(x, tx), _t(w, tp), _t(b, tp)),
        tol.LN_COEF)
    _assert_close(y, wy, limit, "layernorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
def test_ffn_reference_matches_jax_kernel(act, dtype, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(6)
    x = rng.randn(16, 128).astype(np.float32)
    w1 = (rng.randn(128, 256) / 12).astype(np.float32)
    b1 = (0.1 * rng.randn(256)).astype(np.float32)
    w2 = (rng.randn(256, 128) / 16).astype(np.float32)
    want = jpo.fused_ffn_arrays(*(_j(a, jdt) for a in (x, w1, b1, w2)),
                                act=act)
    args = [_t(a, tdt) for a in (x, w1, b1, w2)]
    got = fm.fused_ffn_arrays(*args, act=act)
    assert got.dtype == tdt and got.shape == (16, 128)
    want = _t(_np(want), tdt)
    limit = TOL_FP32 if dtype == "float32" else tol.ffn_limit(*args, act)
    _assert_close(got, want, limit, f"ffn {act}")


def test_fused_mlp_refuses_grad():
    """Neither refuses grad any more: with an input that requires it each
    records its autograd Function and back-propagates; under
    torch.no_grad() (the decode step) each records nothing."""
    x = torch.randn(8, 128, requires_grad=True)
    w, b = torch.ones(128), torch.zeros(128)
    ffn = (torch.ones(128, 128), torch.zeros(128), torch.ones(128, 128))
    for y in (fm.fused_layernorm_arrays(x, w, b),
              fm.fused_ffn_arrays(x, *ffn)):
        assert y.grad_fn is not None
        x.grad = None
        y.square().sum().backward()
        assert x.grad.shape == (8, 128) and torch.isfinite(x.grad).all()
    with torch.no_grad():
        assert fm.fused_layernorm_arrays(x, w, b).grad_fn is None
        assert fm.fused_ffn_arrays(x, *ffn).grad_fn is None


# ---------------------------------------------------------------------------
# the slice as a whole: generate
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
P, NEW = 6, 6


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
    return m.load_params(params_from_numpy(arrays, device="cpu"))


def _ids(b, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, P)).astype(
        np.int32)


def _jax_generate(jax_model, ids, **kw):
    jax_model._gen_step = None        # its jit cache ignores the env flags
    return np.asarray(jax_model.generate(paddle.to_tensor(ids),
                                         max_new_tokens=NEW, **kw).numpy())


class _Spy:
    """Counts the calls of some functions of the port's gpt module."""

    def __init__(self, monkeypatch, names):
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(port_gpt, name)

            def spy(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(port_gpt, name, spy)


SPIED = ("cached_attention_arrays", "fused_decode_layer_arrays",
         "fused_ffn_arrays", "flash_attention_arrays")


@pytest.mark.parametrize("b", [8, 3])
def test_generate_default_mode_matches_jax(jax_model, port_model, b,
                                           monkeypatch):
    ids = _ids(b)
    want = _jax_generate(jax_model, ids)
    spy = _Spy(monkeypatch, SPIED)
    ops.reset_launch_counts()
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (b, P + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    layers = port_model.cfg.num_hidden_layers
    assert spy.calls == {"cached_attention_arrays": layers * (NEW - 1),
                         "fused_decode_layer_arrays": 0,
                         "fused_ffn_arrays": 0,
                         "flash_attention_arrays": layers}
    assert set(ops.launch_counts().values()) == {0}


def test_generate_eos_matches_jax(jax_model, port_model):
    ids = _ids(8, seed=1)
    free = _jax_generate(jax_model, ids)
    eos = int(free[0, P + 1])      # row 0 finishes after two tokens
    want = _jax_generate(jax_model, ids, eos_token_id=eos)
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                              eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = got.numpy()[:, P:]
    for row in gen:                # an emitted eos repeats to the end
        hit = np.nonzero(row == eos)[0]
        if hit.size:
            assert (row[hit[0]:] == eos).all()


@pytest.mark.parametrize("b,mlp_fused", [(8, True), (3, False)])
def test_generate_fused_mode_matches_jax(jax_model, port_model, b,
                                         mlp_fused, monkeypatch):
    """Both flags: at B=8 the MLP runs the fused LN + FFN in both
    packages; at B=3 (no row block of 8) it falls back to `_stacked_mlp`
    in both, while the attention half stays fused."""
    for name in ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN",
                 "PTPU_PALLAS_INTERPRET", "PTPU_ATTN_DEBUG"):
        monkeypatch.setenv(name, "1")
    jpo.reset_attention_path_counts()
    ids = _ids(b, seed=2)
    want = _jax_generate(jax_model, ids)
    paths = jpo.attention_path_counts()
    assert paths.get("fused_decode_kernel", 0) > 0
    assert (paths.get("ffn_kernel", 0) > 0) == mlp_fused
    spy = _Spy(monkeypatch, SPIED)
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    layers = port_model.cfg.num_hidden_layers
    steps = layers * (NEW - 1)
    assert spy.calls == {"cached_attention_arrays": 0,
                         "fused_decode_layer_arrays": steps,
                         "fused_ffn_arrays": steps if mlp_fused else 0,
                         "flash_attention_arrays": layers}


def test_generate_fused_flag_alone_keeps_the_unfused_mlp(port_model,
                                                         monkeypatch):
    monkeypatch.setenv("PTPU_FUSED_DECODE", "1")
    spy = _Spy(monkeypatch, SPIED)
    port_model.generate(torch.from_numpy(_ids(8)), max_new_tokens=3)
    assert spy.calls["fused_decode_layer_arrays"] == 2 * 2
    assert spy.calls["fused_ffn_arrays"] == 0


def test_init_caches_and_argument_checks(port_model):
    caches = port_model.init_caches(3, 40)
    assert len(caches) == port_model.cfg.num_hidden_layers
    for k, v in caches:
        assert k.shape == v.shape == (3, 128, 128)
        assert k.dtype == torch.float32 and k.device.type == "cpu"
        assert not k.any()
    assert port_model.init_caches(1, 129, torch.bfloat16)[0][0].shape == (
        1, 256, 128)
    assert port_model.init_caches(1, 129, torch.bfloat16)[0][0].dtype == \
        torch.bfloat16
    ids = torch.from_numpy(_ids(2))
    out = port_model.generate(ids, max_new_tokens=0)
    assert torch.equal(out, ids) and out.dtype == torch.int32
    assert port_model.generate(ids[0], max_new_tokens=2).shape == (1, P + 2)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port_model.generate(ids, max_new_tokens=64 - P + 1)
    # a padded generate of the per-layer layout raises JAX's own refusal
    # (`gpt.py:766-769`): the cache mask is wired on the stacked path only
    per_layer = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="cache_mask is wired on the stacked-blocks"):
        per_layer.generate(ids, max_new_tokens=2, pad_token_id=0)


def test_seeded_sampling_is_reproducible(port_model):
    ids = torch.from_numpy(_ids(4))
    kw = dict(max_new_tokens=5, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9)
    a = port_model.generate(ids, seed=7, **kw)
    assert torch.equal(a, port_model.generate(ids, seed=7, **kw))
    assert ((a[:, P:] >= 0) & (a[:, P:] < 128)).all()
