"""paddle_tpu_torch's packed-document pretraining and the remaining flash
branches against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

(a) the plain flash forward (out and lse) and backward against the JAX
    Pallas kernels `_flash_fwd` / `_flash_bwd` run in interpret mode, at
    S=256 with 128-row blocks (so the kernels' loop bounds and segment
    envelopes run): segment ids causal and non-causal, an additive mask,
    kv_lens, non-causal, and mask with kv_lens non-causal.  Row 0 of the
    ids holds sorted documents that straddle the 128-row tiles, row 1 the
    same ids permuted.  Every row keeps a key the mask leaves open (column
    0 and the diagonal), so every row is held against JAX.  The masked
    backward reads the port's own (row max, log l) pair; JAX's reads lse.
(b) `flash_attention_arrays` gradients against `jax.grad` of JAX's
    `flash_attention_arrays` (off the TPU: its reference and that one's
    VJP) for each branch, with no kernel launched; and, on left-pad rows
    (every key masked), the port's backward against the autograd of its
    own forward (`mha_reference`): JAX's kernels rebuild p = 1 there, not
    1/n, so such rows are not held against JAX.
(c) the JAX ValueError on segment ids that are not [B, S] or with
    Sq != Sk, and NotImplementedError on segment ids in the per-layer model.
(d) three AdamW steps of the stacked test GPT of
    `examples/packed_pretraining.py` on its `pack_documents` triple and
    loss mask (`pack_documents` copied: the example sets XLA_FLAGS and
    PTPU_FORCE_PLATFORM when imported) against the JAX
    ``pretrain_loss(x, y, mk, segment_ids=s, position_ids=p)``.
(e) the ROADMAP Queue 3 repairs: a `flash_attention_arrays` call that
    leaves out ``is_causal``, ``pretrain_loss`` with five positional
    arguments, and positional `SamplingParams` / `EngineConfig` calls mean
    what they mean in JAX or raise TypeError.

Tolerances: 1e-5 absolute for attention outputs, lse and gradients (fp32,
the two sum in different orders), and for the losses and weights of the
three steps, but for the weights whose JAX gradient falls below
``GRAD_FLOOR`` = 1e-5 at some step, held to ``2 * lr * steps`` as in
tests/test_torch_port_ln_train.py: the two packages' gradients differ by
fp32 noise, and Adam's normalised step ``m / sqrt(v)`` turns a relative
difference of a small gradient into the same relative difference of a step
of up to ``lr``.  Among them is the key slice of ``qkv_b``, whose gradient
is rounding noise in both packages (softmax is blind to the key bias).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import EngineConfig, SamplingParams
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _doc_ids(s, lens):
    """[s] int32: documents of the given lengths, then one pad segment."""
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    return np.concatenate([ids, np.full(s - len(ids), len(lens))]).astype(
        np.int32)


def _segments(s, rng, lens=(100, 70, 50, 20)):
    """[2, s]: sorted documents (by default straddling the 128-row tiles
    of S=256), and the same ids permuted."""
    row = _doc_ids(s, lens)
    return np.stack([row, rng.permutation(row)])


def _additive(shape, rng):
    """N(0, 2) scores, -1e30 at ~30 % of the keys, column 0 and the
    diagonal open (every row keeps a key)."""
    m = (rng.randn(*shape) * 2).astype(np.float32)
    m[rng.rand(*shape) < 0.3] = -1e30
    m[..., 0] = 0.0
    idx = np.arange(shape[-1])
    m[..., idx, idx] = 0.0
    return m


B, H, D = 2, 2, 64
# (name, causal, mask, kv_lens, segments)
BRANCHES = [("segs_causal", True, False, False, True),
            ("segs_noncausal", False, False, False, True),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("noncausal", False, False, False, False),
            ("mask_kv_lens_noncausal", False, True, True, False)]


def _branch_inputs(name, s, seed, doc_lens=(100, 70, 50, 20)):
    _, causal, has_mask, has_lens, has_segs = next(
        c for c in BRANCHES if c[0] == name)
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, s, H, D).astype(np.float32)
                   for _ in range(4))
    mask = _additive((B, 1, s, s), rng) if has_mask else None
    lens = np.array([s - 37, s], np.int32) if has_lens else None
    segs = _segments(s, rng, doc_lens) if has_segs else None
    return causal, q, k, v, do, mask, lens, segs


# ---------------------------------------------------------------------------
# (a) plain forward and backward against the JAX Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
def test_plain_matches_jax_kernels(name, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    s = 256
    causal, q, k, v, do, mask, lens, segs = _branch_inputs(name, s, 11)
    scale = D ** -0.5
    qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a))
                       for a in (q, k, v, do))
    kw = dict(n_heads=H, mask=None if mask is None else jnp.asarray(mask),
              kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
              segments=None if segs is None else jnp.asarray(segs))
    of, lse = jpo._flash_fwd(qf, kf, vf, causal, scale, block_q=128,
                             block_k=128, **kw)
    want_bwd = jpo._flash_bwd(qf, kf, vf, of, lse, dof, causal, scale,
                              block_q=128, block_k=128, **kw)
    out = _np(jpo._unfold_heads(of, b=B, h=H))
    branches = [None if a is None else _t(a) for a in (mask, lens, segs)]
    got, got_lse = fa.mha_reference(_t(q), _t(k), _t(v), branches[0], causal,
                                    scale, *branches[1:], return_lse=True)
    np.testing.assert_allclose(got.numpy(), out, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), _np(lse).reshape(B, H, s),
                               atol=TOL, rtol=0)
    stat, row_max = _t(_np(lse).reshape(B, H, s)), None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(_t(q), _t(k), scale, causal,
                                         *branches)
    got_bwd = fa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(out), stat, _t(do), scale, is_causal=causal,
        mask=branches[0], kv_lens=branches[1], segment_ids=branches[2],
        row_max=row_max)
    for what, g, w in zip(("dq", "dk", "dv"), got_bwd, want_bwd):
        np.testing.assert_allclose(g.numpy(),
                                   _np(jpo._unfold_heads(w, B, H)),
                                   atol=TOL, rtol=0, err_msg=what)


def test_segment_rows_straddle_tiles_and_permute():
    """The id rows of (a) hold documents across the 128-row tile edge and
    an unsorted row, so the envelope and the in-tile test both bind."""
    segs = _segments(256, np.random.RandomState(11))
    assert segs[0, 127] == segs[0, 128]
    assert (np.diff(segs[1]) < 0).any()
    assert sorted(segs[0]) == sorted(segs[1])


# ---------------------------------------------------------------------------
# (b) flash_attention_arrays gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
def test_flash_grads_match_jax_grad(name):
    s = 40
    causal, q, k, v, g, mask, lens, segs = _branch_inputs(name, s, 5,
                                                          (13, 9, 11))
    branches = dict(attn_mask=mask, kv_lens=lens, segment_ids=segs)

    def loss(q, k, v):
        out = jpo.flash_attention_arrays(
            q, k, v, is_causal=causal,
            **{n: None if a is None else jnp.asarray(a)
               for n, a in branches.items()})
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ops.reset_launch_counts()
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_arrays(
        qt, kt, vt, is_causal=causal,
        **{n: None if a is None else _t(a) for n, a in branches.items()})
    assert "FlashAttention" in out.grad_fn.name()
    out.backward(_t(g))
    for what, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=TOL, rtol=0,
                                   err_msg=what)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_backward_is_the_forward_derivative(causal):
    """Left-pad queries (the mask closes every key of their rows): the
    backward through `FlashAttention` equals autograd through the port's
    own forward, pad rows included, where p is 1/n over the allowed keys."""
    rng = np.random.RandomState(2)
    s = 24
    q, k, v, g = (rng.randn(B, s, H, D).astype(np.float32)
                  for _ in range(4))
    m = np.zeros((B, 1, s, s), np.float32)
    for r, pads in enumerate((5, 9)):             # pad keys and pad rows
        m[r, :, :, :pads] = -1e30
        m[r, :, :pads, :] = -1e30
    mask = _t(m)
    lens = torch.tensor([s, s - 4], dtype=torch.int32)
    grads = []
    for through_fn in (True, False):
        qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
        if through_fn:
            out = fa.flash_attention_arrays(qt, kt, vt, mask, causal,
                                            kv_lens=lens)
            assert "FlashAttention" in out.grad_fn.name()
        else:
            out = fa.mha_reference(qt, kt, vt, mask, causal, kv_lens=lens)
        out.backward(_t(g))
        grads.append([t.grad for t in (qt, kt, vt)])
    for what, a, w in zip(("dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL, rtol=0,
                                   err_msg=what)
    # a pad row's output is the mean of the values it may attend
    out = fa.flash_attention_arrays(_t(q), _t(k), _t(v), mask, causal,
                                    kv_lens=lens)
    torch.testing.assert_close(out[0, 4], _t(v)[0, :5 if causal else s]
                               .mean(0))


def test_mask_that_requires_grad_takes_the_reference_vjp_on_cpu():
    rng = np.random.RandomState(3)
    s = 16
    q, k, v = (_t(rng.randn(1, s, H, D).astype(np.float32))
               for _ in range(3))
    mask = _t(_additive((1, 1, s, s), rng)).clamp(min=-50)
    mask.requires_grad_()
    out = fa.flash_attention_arrays(q.requires_grad_(), k, v, mask,
                                    is_causal=True)
    assert "FlashAttention" not in out.grad_fn.name()
    out.sum().backward()
    assert mask.grad is not None and mask.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# (c) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,seg_shape", [(8, 8, (2, 7)), (8, 8, (8,)),
                                             (8, 12, (2, 8))])
def test_bad_segment_ids_raise_jax_value_error(sq, sk, seg_shape):
    q = np.zeros((2, sq, 2, 64), np.float32)
    k = np.zeros((2, sk, 2, 64), np.float32)
    segs = np.zeros(seg_shape, np.int32)
    with pytest.raises(ValueError) as want:
        jpo.flash_attention_arrays(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(k), segment_ids=segs)
    with pytest.raises(ValueError) as got:
        fa.flash_attention_arrays(_t(q), _t(k), _t(k), segment_ids=_t(segs))
    assert str(got.value) == str(want.value)


def test_per_layer_model_refuses_segment_ids():
    ids = np.zeros((1, 8), np.int32)
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False))
    with pytest.raises(NotImplementedError) as want:
        jmodel(paddle.to_tensor(ids), segment_ids=paddle.to_tensor(ids))
    model = GPTForCausalLM(gpt_test_config(), device="cpu")
    with pytest.raises(NotImplementedError) as got:
        model(_t(ids), segment_ids=_t(ids))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        model.pretrain_loss(_t(ids), _t(ids), None, _t(ids))


# ---------------------------------------------------------------------------
# (d) the slice as a whole: three packed training steps of the test GPT
# ---------------------------------------------------------------------------

def pack_documents(docs, row_len):
    """Greedy-pack variable-length docs into fixed rows; returns
    (ids, segment_ids, position_ids) — a copy of the function of
    examples/packed_pretraining.py."""
    rows, segs, poss = [], [], []
    row, seg, pos, seg_id = [], [], [], 0
    for doc in docs:
        if len(doc) > row_len:
            raise ValueError(
                f"document of length {len(doc)} exceeds row_len {row_len}; "
                "chunk long documents before packing")
        if len(row) + len(doc) > row_len:
            pad = row_len - len(row)
            row += [0] * pad
            seg += [seg_id + 1] * pad          # padding = its own segment
            pos += list(range(pad))
            rows.append(row), segs.append(seg), poss.append(pos)
            row, seg, pos, seg_id = [], [], [], 0
        row += list(doc)
        seg += [seg_id] * len(doc)
        pos += list(range(len(doc)))
        seg_id += 1
    if row:
        pad = row_len - len(row)
        rows.append(row + [0] * pad)
        segs.append(seg + [seg_id + 1] * pad)
        poss.append(pos + list(range(pad)))
    return (np.asarray(rows, np.int32), np.asarray(segs, np.int32),
            np.asarray(poss, np.int32))


CFG = dict(stacked_blocks=True, num_hidden_layers=2, hidden_size=128,
           intermediate_size=256, num_attention_heads=2,
           max_position_embeddings=128)
STEPS, LR, GRAD_FLOOR = 3, 1e-3, 1e-5


def _packed_batch():
    """The example's batch: 12 documents of 8-39 tokens in 3..99, packed
    into 64-token rows; labels the next token; the loss mask trains a
    position only when its next token is real and in the same document."""
    rng = np.random.RandomState(0)
    docs = [rng.randint(3, 100, rng.randint(8, 40)) for _ in range(12)]
    ids, segs, poss = pack_documents(docs, row_len=64)
    labels = np.roll(ids, -1, axis=1)
    mask = ((segs == np.roll(segs, -1, axis=1)) & (ids != 0)).astype(
        np.float32)
    return ids, labels, mask, segs, poss


def _jax_arrays(model):
    return {n: _np(a) for n, a in JaxEngine(model)._param_arrays().items()}


def _array_key(name):
    """The `_param_arrays` key of a stacked JAX parameter name."""
    return {"gpt.embeddings.word_embeddings.weight": "wte",
            "gpt.embeddings.position_embeddings.weight": "wpe",
            "gpt.ln_f.weight": "lnf_w", "gpt.ln_f.bias": "lnf_b"}.get(
                name, name.replace("gpt.blocks.", ""))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's initial weights, its five-positional-argument
    pretrain_loss there, and the losses and weights of three packed AdamW
    steps, with the weights whose gradient fell below ``GRAD_FLOOR`` (one
    JAX eager run shared by the tests)."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jmodel.train()
    init = _jax_arrays(jmodel)
    batch = [paddle.to_tensor(a) for a in _packed_batch()]
    positional = float(jmodel.pretrain_loss(*batch).numpy())
    x, y, mk, s, p = batch
    jopt = JaxAdamW(learning_rate=LR, parameters=jmodel.parameters())
    losses, small = [], {}
    for _ in range(STEPS):
        loss = jmodel.pretrain_loss(x, y, mk, segment_ids=s, position_ids=p)
        loss.backward()
        for name, prm in jmodel.named_parameters():
            below = np.abs(_np(prm.grad.numpy())) < GRAD_FLOOR
            key = _array_key(name)
            small[key] = small.get(key, False) | below
        jopt.step()
        jopt.clear_grad()
        losses.append(float(loss.numpy()))
    return dict(init=init, positional=positional, losses=losses,
                final=_jax_arrays(jmodel), small=small)


def _port_model(arrays):
    return GPTForCausalLM(gpt_test_config(**CFG), device="cpu").load_params(
        params_from_numpy(arrays, device="cpu"))


def test_packed_batch_is_the_examples_triple():
    ids, labels, mask, segs, poss = _packed_batch()
    assert ids.shape == segs.shape == poss.shape and ids.shape[1] == 64
    assert ids.shape[0] > 1
    for r in range(ids.shape[0]):
        for sid in np.unique(segs[r]):
            at = np.nonzero(segs[r] == sid)[0]
            assert (np.diff(at) == 1).all()        # contiguous documents
            np.testing.assert_array_equal(poss[r, at], np.arange(len(at)))
    assert 0 < mask.sum() < mask.size


def test_three_packed_training_steps_match_jax(jax_run, monkeypatch):
    model = _port_model(jax_run["init"])
    x, y, mk, s, p = (_t(a) for a in _packed_batch())
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    seen = []
    flash = port_gpt.flash_attention_arrays

    def spy(q, k, v, *a, **kw):
        seen.append(kw.get("segment_ids"))
        return flash(q, k, v, *a, **kw)

    monkeypatch.setattr(port_gpt, "flash_attention_arrays", spy)
    ops.reset_launch_counts()
    for step in range(STEPS):
        loss = model.pretrain_loss(x, y, mk, segment_ids=s, position_ids=p)
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), jax_run["losses"][step],
                                   atol=TOL, rtol=0, err_msg=f"step {step}")
    assert set(ops.launch_counts().values()) == {0}
    assert len(seen) == STEPS * CFG["num_hidden_layers"]
    assert all(torch.equal(t, s.int()) for t in seen)
    want, got = jax_run["final"], params_to_numpy(model)
    assert set(got) == set(want)
    hidden = CFG["hidden_size"]
    small = jax_run["small"]
    assert small["qkv_b"][:, hidden:2 * hidden].all()
    for name in sorted(want):
        g, w, sm = got[name], want[name], small[name]
        assert g.shape == w.shape == sm.shape, name
        np.testing.assert_allclose(g[sm], w[sm], atol=2 * LR * STEPS,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(g[~sm], w[~sm], atol=TOL, rtol=0,
                                   err_msg=name)


def test_packing_changes_the_loss(jax_run):
    """The ids and positions matter: the same tokens unpacked (one causal
    row, positions 0..S-1) give another loss."""
    model = _port_model(jax_run["init"])
    x, y, mk, s, p = (_t(a) for a in _packed_batch())
    with torch.no_grad():
        packed = model.pretrain_loss(x, y, mk, s, p).item()
        plain = model.pretrain_loss(x, y, mk).item()
    assert abs(packed - jax_run["losses"][0]) <= TOL
    assert abs(packed - plain) > 1e-3


# ---------------------------------------------------------------------------
# (e) the Queue 3 repairs: the same call means the same in both packages
# ---------------------------------------------------------------------------

def test_flash_default_is_non_causal_as_in_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 8, 2, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jpo.flash_attention_arrays(
        *(jnp.asarray(a) for a in (q, k, v))))
    got = fa.flash_attention_arrays(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    causal = fa.flash_attention_arrays(_t(q), _t(k), _t(v), is_causal=True)
    assert (causal[0, :7] - got[0, :7]).abs().max() > 0.1


def test_pretrain_loss_positional_arguments_match_jax(jax_run):
    model = _port_model(jax_run["init"])
    with torch.no_grad():
        got = model.pretrain_loss(*(_t(a) for a in _packed_batch())).item()
    np.testing.assert_allclose(got, jax_run["positional"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got, jax_run["losses"][0], atol=TOL, rtol=0)


def _positional(cls):
    return [f.name for f in dataclasses.fields(cls) if not f.kw_only]


@pytest.mark.parametrize("port,jax_cls", [(SamplingParams, JaxSamplingParams),
                                          (EngineConfig, JaxEngineConfig)])
def test_positional_dataclass_fields_are_jaxs(port, jax_cls):
    # every JAX field, in JAX's order (deadline_s and the engine's
    # metrics_port .. spec_lookup_window restored); the port's own fields
    # (the engine's device and dtype) keyword-only after them
    mine = _positional(port)
    assert mine == _positional(jax_cls)
    extra = [f.name for f in dataclasses.fields(port) if f.kw_only]
    assert not set(extra) & {f.name for f in dataclasses.fields(jax_cls)}
    assert extra == (["device", "dtype"] if port is EngineConfig else [])


def test_positional_calls_mean_what_they_mean_in_jax():
    ten = (4, False, 1.0, 0, 1.0, None, None, 5.0, "acme", "batch")
    want = JaxSamplingParams(*ten)
    assert want.deadline_s == 5.0
    assert dataclasses.asdict(SamplingParams(*ten)) == dataclasses.asdict(
        want)
    assert SamplingParams(*ten[:8]).deadline_s == 5.0
    with pytest.raises(TypeError):
        SamplingParams(*ten, "cpu")
    six = (16, None, 8, None, None, "int8")
    assert JaxEngineConfig(*six).kv_cache_dtype == "int8"
    assert EngineConfig(*six).kv_cache_dtype == "int8"
    thirteen = six + (None, "bucketed", True, 3, 4, 2, 64)
    want = dataclasses.asdict(JaxEngineConfig(*thirteen))
    got = dataclasses.asdict(EngineConfig(*thirteen))
    assert {k: got[k] for k in want} == want
    # the live metrics endpoint's port, in JAX's position
    assert JaxEngineConfig(*six, 9090).metrics_port == 9090
    assert EngineConfig(*six, 9090).metrics_port == 9090
    with pytest.raises(TypeError):
        EngineConfig(*thirteen, "cpu")
    cfg = EngineConfig(*six, device="cpu", dtype=torch.bfloat16)
    assert (cfg.device, cfg.dtype) == ("cpu", torch.bfloat16)
