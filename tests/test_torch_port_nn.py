"""The port's layer API (`paddle_tpu_torch.nn`) against the JAX package's
(`paddle_tpu.nn`), on the CPU.

The same numpy inputs, made from a seed, go through both packages; a
layer's weights go from the JAX layer's ``state_dict()`` (as numpy) to the
port's by `Layer.set_state_dict`, under the same structured names.

- `Layer`: ``state_dict`` keys, ``named_parameters`` order, persistable
  buffers, the round trip both ways, ``ParamAttr`` (trainable,
  initializer, learning rate, False), hooks, dtypes, traversal;
- the initializers after ``seed`` on both sides: uniforms bit for bit,
  normals within a few float32 ulps (torch's ``erfinv`` is not XLA's),
  one key a call (the key stacks equal afterwards), the global
  initializer;
- `Linear`, `Embedding` (``padding_idx``), `LayerNorm`, `RMSNorm`, the
  containers, the activations and `CrossEntropyLoss`;
- dropout on JAX's keys: the masks of `dropout` (with ``axis``),
  `dropout2d` / `dropout3d`, `alpha_dropout`, `nn.Dropout` and the flash
  output's dropout equal JAX's bit for bit for one seed;
- `scaled_dot_product_attention` with a [B, 1, 1, S] key mask (bool and
  additive; forward and gradients) against JAX's `mha_reference`, the
  key mask as a stride-0 view, and head_dim 16 on the reference route,
  counted as JAX counts it;
- `MultiHeadAttention` without a cache, with `Cache` and with
  `StaticCache`; `TransformerEncoderLayer` pre- and post-norm (and in
  training with dropout); the encoder's deep copies; the decoder layer,
  `TransformerDecoder` with caches and `Transformer`.

Limits: fp32 outputs within 1e-5 max-abs (summation order only); masks and
dropped positions bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import random as jrandom
from paddle_tpu.ops import pallas_ops as jpo

import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.ops import flash_attention as pfa
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _carry(jlayer, player):
    """The JAX layer's weights into the port's, by name; every name
    found on both sides."""
    sd = {k: _np(v) for k, v in jlayer.state_dict().items()}
    missing, unexpected = player.set_state_dict(sd)
    assert missing == [] and unexpected == []
    return sd


def _both(seed=0):
    paddle.seed(seed)
    paddle_tpu_torch.seed(seed)


def _keys_equal():
    np.testing.assert_array_equal(np.asarray(jrandom.get_state()),
                                  prandom.get_state().numpy())


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(jlayer, player, *xs):
    want = jlayer(*(None if x is None else paddle.to_tensor(x) for x in xs))
    got = player(*(None if x is None else torch.from_numpy(x) for x in xs))
    return got, want


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

def _net(ns, **kw):
    class Net(ns.Layer):
        def __init__(self):
            super().__init__()
            self.fc = ns.Linear(8, 6, **kw)
            self.blocks = ns.LayerList([ns.Linear(6, 6, **kw),
                                        ns.LayerNorm(6, **kw)])
            self.register_buffer("steps", _buf(ns, np.arange(3.0)))
            self.register_buffer("scratch", _buf(ns, np.ones(2)),
                                 persistable=False)

        def forward(self, x):
            x = self.fc(x)
            for b in self.blocks:
                x = b(x)
            return x
    return Net()


def _buf(ns, a):
    a = a.astype(np.float32)
    return paddle.to_tensor(a) if ns is jnn else torch.from_numpy(a)


def test_layer_state_dict_names_and_round_trip():
    jnet, pnet = _net(jnn), _net(pnn, device="cpu")
    want = list(jnet.state_dict())
    got = list(pnet.state_dict())
    assert sorted(got) == sorted(want)
    assert "scratch" not in got and "steps" in got
    assert [n for n, _ in pnet.named_parameters()] == \
        [n for n, _ in jnet.named_parameters()]
    assert [n for n, _ in pnet.named_sublayers()] == \
        [n for n, _ in jnet.named_sublayers()]
    assert len(pnet.parameters()) == len(jnet.parameters()) == 6
    assert isinstance(pnet.parameters(), list)
    assert len(pnet.parameters(include_sublayers=False)) == 0
    assert len(pnet.sublayers(include_self=True)) == \
        len(jnet.sublayers(include_self=True))
    _carry(jnet, pnet)
    x = _x(3, 8)
    _close(*_run(jnet, pnet, x))
    # back again: the port's state into a fresh JAX net
    jnet2 = _net(jnn)
    missing, unexpected = jnet2.set_state_dict(
        {k: v.numpy() for k, v in pnet.state_dict().items()})
    assert missing == [] and unexpected == []
    _close(*_run(jnet2, pnet, x))
    # names it lacks and names it does not know, as JAX reports them
    sd = {k: v.numpy() for k, v in pnet.state_dict().items()}
    sd["extra.w"] = np.zeros(1, np.float32)
    del sd["fc.bias"]
    assert pnet.set_state_dict(sd) == jnet.set_state_dict(sd)
    with pytest.raises(ValueError, match="shape mismatch"):
        pnet.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})
    own = pnet.state_dict(include_sublayers=False)
    assert list(own) == ["steps"]


def test_param_attr_hooks_dtypes():
    attr = dict(weight_attr=jnn.ParamAttr(trainable=False,
                                          learning_rate=0.1),
                bias_attr=jnn.ParamAttr(initializer=jnn.initializer.Constant(
                    0.5)))
    pattr = dict(weight_attr=pnn.ParamAttr(trainable=False,
                                           learning_rate=0.1),
                 bias_attr=pnn.ParamAttr(initializer=pnn.initializer.Constant(
                     0.5)))
    jl, pl = jnn.Linear(4, 3, **attr), pnn.Linear(4, 3, **pattr, device="cpu")
    assert jl.weight.stop_gradient and not pl.weight.requires_grad
    assert not pl.weight.trainable
    assert pl.weight.optimize_attr == jl.weight.optimize_attr == {
        "learning_rate": 0.1}
    np.testing.assert_array_equal(_np(pl.bias), _np(jl.bias))
    assert pl.bias.requires_grad
    no_bias = pnn.Linear(4, 3, bias_attr=False, device="cpu")
    assert no_bias.bias is None
    assert list(no_bias.state_dict()) == \
        list(jnn.Linear(4, 3, bias_attr=False).state_dict()) == ["weight"]
    assert pl.full_name().startswith("linear_")
    # hooks: the pre hook's result replaces the inputs, the post hook's
    # the outputs
    _carry(jl, pl)
    for lay in (jl, pl):
        lay.register_forward_pre_hook(lambda l, inp: (inp[0] * 2,))
        h = lay.register_forward_post_hook(lambda l, inp, out: out + 1)
    x = _x(2, 4)
    _close(*_run(jl, pl, x))
    h.remove()                  # the port's post hook only
    got, want = _run(jl, pl, x)
    _close(got, _np(want) - 1)
    # dtypes by Paddle name; new parameters take the layer's dtype
    pl.to("bfloat16")
    assert pl.weight.dtype == pl.bias.dtype == torch.bfloat16
    assert pl.create_parameter([2], device="cpu").dtype == torch.bfloat16
    assert pl.astype("float32").weight.dtype == torch.float32
    assert pl.half().weight.dtype == torch.float16
    assert pl.float().weight.dtype == torch.float32
    pl.bias.grad = torch.ones(3)
    pl.clear_gradients()
    assert pl.bias.grad is None


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

INITS = [("Uniform", (-0.3, 0.5), True), ("XavierUniform", (), True),
         ("KaimingUniform", (), True), ("Normal", (0.1, 2.0), False),
         ("XavierNormal", (), False), ("KaimingNormal", (), False),
         ("TruncatedNormal", (0.0, 0.02), False)]


@pytest.mark.parametrize("name,args,bitwise", INITS)
def test_initializers_on_jax_keys(name, args, bitwise):
    shape = (64, 48)
    _both(7)
    want = np.asarray(getattr(jnn.initializer, name)(*args)(shape,
                                                            "float32"))
    got = getattr(pnn.initializer, name)(*args)(shape, "float32",
                                                device="cpu").numpy()
    _keys_equal()                 # one key a call on both stacks
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        # torch's erfinv against XLA's: a few float32 ulps
        assert np.all(np.abs(got - want) <= 8e-6 * np.maximum(
            np.abs(want), 1.0))
    if name == "TruncatedNormal":
        assert np.abs(got).max() < 2 * 0.02


def test_constant_assign_gain_and_global_initializer():
    for ns, kw in ((jnn, {}), (pnn, {"device": "cpu"})):
        c = ns.initializer.Constant(0.25)((2, 3), "float32", **kw)
        np.testing.assert_array_equal(_np_any(c), np.full((2, 3), 0.25))
        a = ns.initializer.Assign(np.arange(6.0))((2, 3), "float32", **kw)
        np.testing.assert_array_equal(_np_any(a),
                                      np.arange(6.0).reshape(2, 3))
    for nl in ("relu", "tanh", "sigmoid", "leaky_relu", "selu"):
        assert pnn.initializer.calculate_gain(nl) == \
            jnn.initializer.calculate_gain(nl)
    try:
        for ns in (jnn, pnn):
            ns.initializer.set_global_initializer(
                ns.initializer.Constant(0.5), ns.initializer.Constant(-1.0))
        jl, pl = jnn.LayerNorm(4), pnn.LayerNorm(4, device="cpu")
        np.testing.assert_array_equal(_np(pl.weight), _np(jl.weight))
        np.testing.assert_array_equal(_np(pl.bias), _np(jl.bias))
        assert pl.weight[0].item() == 0.5 and pl.bias[0].item() == -1.0
    finally:
        for ns in (jnn, pnn):
            ns.initializer.set_global_initializer(None, None)


def _np_any(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# common, norm, containers, activations, loss
# ---------------------------------------------------------------------------

def test_linear_embedding_norms():
    x = _x(2, 5, 8)
    pairs = [(jnn.Linear(8, 6), pnn.Linear(8, 6, device="cpu")),
             (jnn.LayerNorm(8, epsilon=1e-12),
              pnn.LayerNorm(8, epsilon=1e-12, device="cpu")),
             (jnn.RMSNorm(8), pnn.RMSNorm(8, device="cpu"))]
    for jl, pl in pairs:
        _carry(jl, pl)
        with torch.no_grad():
            pl.weight.mul_(1.5)
        jl.set_state_dict({k: v.detach().numpy()
                           for k, v in pl.state_dict().items()})
        _close(*_run(jl, pl, x))
    ids = np.array([[0, 3, 1, 3], [2, 2, 0, 1]], np.int32)
    je, pe = jnn.Embedding(4, 5, padding_idx=3), \
        pnn.Embedding(4, 5, padding_idx=3, device="cpu")
    assert not pe.weight[3].any()
    _carry(je, pe)
    _close(*_run(je, pe, ids))
    assert not pe(torch.from_numpy(ids))[0, 1].any()
    f = pnn.Flatten()
    assert f(torch.zeros(2, 3, 4)).shape == (2, 12)
    assert pnn.Identity(3, k=1)(torch.ones(2)).tolist() == [1.0, 1.0]


def _containers(ns, **kw):
    lin = lambda i, o: ns.Linear(i, o, **kw)          # noqa: E731
    seq = ns.Sequential(("a", lin(8, 6)), ("act", ns.ReLU()),
                        ("b", lin(6, 4)))
    ll = ns.LayerList([lin(4, 4)])
    ll.append(lin(4, 3))
    ll.insert(1, lin(4, 4))
    ld = ns.LayerDict({"x": lin(3, 3)})
    ld.update({"y": lin(3, 2)})
    pl = ns.ParameterList([ld["y"].weight])
    pl.append(ld["y"].bias)
    root = ns.LayerList([seq, ll, ld, pl])
    return root


def test_containers():
    jr, pr = _containers(jnn), _containers(pnn, device="cpu")
    assert list(pr.state_dict()) == list(jr.state_dict())
    _carry(jr, pr)

    def run(root, x):
        seq, ll, ld, _ = root
        x = seq(x)
        for i in range(len(ll)):
            x = ll[i](x)
        assert ll[-1] is ll[2]
        x = ld["x"](x)
        return ld["y"](x)
    x = _x(2, 8)
    _close(run(pr, torch.from_numpy(x)), run(jr, paddle.to_tensor(x)))
    _close(pr[0][:1](torch.from_numpy(x)), jr[0][:1](paddle.to_tensor(x)))
    assert len(pr[0]) == len(jr[0]) == 3 and len(pr[3]) == 2
    assert list(pr[2].keys()) == list(jr[2].keys()) == ["x", "y"]
    assert "x" in pr[2]
    del pr[2]["x"]
    assert len(pr[2]) == 1


ACTS = [("ReLU", ()), ("ReLU6", ()), ("GELU", ()), ("GELU", (True,)),
        ("Sigmoid", ()), ("Tanh", ()), ("Softmax", ()), ("Softmax", (1,)),
        ("LogSoftmax", ()), ("Silu", ())]


@pytest.mark.parametrize("name,args", ACTS)
def test_activations(name, args):
    x = _x(3, 4, 5) * 4
    _close(*_run(getattr(jnn, name)(*args), getattr(pnn, name)(*args), x))


@pytest.mark.parametrize("kw", [{}, {"reduction": "sum", "ignore_index": 1},
                                {"label_smoothing": 0.1},
                                {"weight": np.array([0.5, 1.0, 2.0],
                                                    np.float32)}])
def test_cross_entropy_loss(kw):
    logits = _x(6, 3)
    label = np.array([0, 1, 2, 1, 0, 2], np.int64)
    jkw = dict(kw, **({"weight": paddle.to_tensor(kw["weight"])}
                      if "weight" in kw else {}))
    pkw = dict(kw, **({"weight": torch.from_numpy(kw["weight"])}
                      if "weight" in kw else {}))
    want = jnn.CrossEntropyLoss(**jkw)(paddle.to_tensor(logits),
                                       paddle.to_tensor(label))
    got = pnn.CrossEntropyLoss(**pkw)(torch.from_numpy(logits),
                                      torch.from_numpy(label))
    _close(got, want)


# ---------------------------------------------------------------------------
# dropout on JAX's keys
# ---------------------------------------------------------------------------

def _sdpa_drop(F, t, x):
    q = t(x)
    return F.scaled_dot_product_attention(q, q, q, dropout_p=0.25,
                                          training=True)


DROPS = {
    "p": (lambda F, t, x: F.dropout(t(x), 0.3), (4, 6, 5)),
    "axis": (lambda F, t, x: F.dropout(t(x), 0.4, axis=[0, 2]), (4, 6, 5)),
    "int_axis": (lambda F, t, x: F.dropout(t(x), 0.5, axis=1), (4, 6, 5)),
    "downscale": (lambda F, t, x: F.dropout(t(x), 0.2,
                                            mode="downscale_in_infer"),
                  (4, 6, 5)),
    "2d": (lambda F, t, x: F.dropout2d(t(x), 0.5), (3, 4, 2, 2)),
    "3d": (lambda F, t, x: F.dropout3d(t(x), 0.5), (3, 4, 2, 2, 2)),
    "alpha": (lambda F, t, x: F.alpha_dropout(t(x), 0.3), (4, 6, 5)),
    "flash": (_sdpa_drop, (2, 8, 2, 64)),
}


@pytest.mark.parametrize("case", list(DROPS))
def test_dropout_masks_are_jax_bitwise(case):
    fn, shape = DROPS[case]
    x = np.abs(_x(*shape, seed=3)) + 0.5
    _both(11)
    want = _np(fn(JF, paddle.to_tensor, x))
    got = _np(fn(PF, torch.from_numpy, x))
    _keys_equal()
    if case in ("flash", "alpha"):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    else:
        np.testing.assert_array_equal(got, want)
    dropped = (want == 0) if case != "alpha" else np.isclose(
        want, want.min())
    np.testing.assert_array_equal(
        (got == 0) if case != "alpha" else np.isclose(got, got.min()),
        dropped)
    assert 0 < dropped.mean() < 1


def test_dropout_layer_and_generator_override():
    x = np.abs(_x(8, 16, seed=2)) + 0.5
    jd, pd = jnn.Dropout(0.3, axis=1), pnn.Dropout(0.3, axis=1)
    _both(4)
    np.testing.assert_array_equal(*(_np(v) for v in _run(jd, pd, x)))
    pd.eval()
    np.testing.assert_array_equal(pd(torch.from_numpy(x)).numpy(), x)
    # an explicit generator draws from it, not from the key stack
    state = prandom.get_state()
    g = torch.Generator().manual_seed(5)
    a = PF.dropout(torch.from_numpy(x), 0.5, generator=g)
    g.manual_seed(5)
    assert torch.equal(PF.dropout(torch.from_numpy(x), 0.5, generator=g), a)
    assert torch.equal(prandom.get_state(), state)


# ---------------------------------------------------------------------------
# scaled_dot_product_attention: key masks and the head-dim gate
# ---------------------------------------------------------------------------

def _qkv(b, s, h, d, seed=5):
    return [_x(b, s, h, d, seed=seed + i) for i in range(3)]


def _key_mask(b, s, lens, kind):
    m = np.arange(s)[None, None, None, :] < np.array(lens)[:, None, None,
                                                             None]
    return m if kind == "bool" else np.where(m, 0.0, -1e4).astype(np.float32)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_key_mask_matches_jax_reference(kind):
    b, s, h, d = 2, 32, 2, 64
    q, k, v = _qkv(b, s, h, d)
    mask = _key_mask(b, s, (32, 20), kind)
    ref = jax.jit(jpo.mha_reference)
    want = ref(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    jwant = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), paddle.to_tensor(mask))
    np.testing.assert_allclose(np.asarray(want), _np(jwant), atol=1e-6)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = PF.scaled_dot_product_attention(tq, tk, tv, torch.from_numpy(mask))
    _close(got, want)
    # gradients: the port's plain flash backward against jax.grad
    do = _x(b, s, h, d, seed=9)
    gq, gk, gv = torch.autograd.grad(got, [tq, tk, tv], torch.from_numpy(do))
    jg = jax.jit(jax.grad(lambda a, bb, c: jnp.sum(jpo.mha_reference(
        a, bb, c, jnp.asarray(mask)) * do), argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip((gq, gk, gv), jg):
        _close(g, w)


def test_key_mask_is_a_stride0_view():
    b, h, s = 2, 3, 16
    m = torch.ones(b, 1, 1, s, dtype=torch.bool)
    v = pfa.normalize_mask(m, b, h, s, s)
    assert v.shape == (b, h, s, s) and v.stride()[1:3] == (0, 0)
    # 2- and 3-D key masks broadcast as JAX's reference broadcasts them
    q, k, vv = _qkv(1, s, h, 64)
    for shape in ((1, s), (h, 1, s), (1, 1, s)):
        mask = np.random.RandomState(1).rand(*shape) > 0.3
        mask[..., 0] = True
        want = jax.jit(jpo.mha_reference)(
            *(jnp.asarray(a) for a in (q, k, vv)), jnp.asarray(mask))
        got = pfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, vv)),
                                torch.from_numpy(mask))
        _close(got, want)
    with pytest.raises(ValueError, match="attn_mask must be"):
        pfa.normalize_mask(torch.ones(2, 1, s, dtype=torch.bool), 2, 3, s, s)


def test_head_dim_16_takes_the_reference_route_counted(monkeypatch):
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    jpo.reset_attention_path_counts()
    pfa.reset_attention_path_counts()
    q, k, v = _qkv(2, 32, 2, 16)
    mask = _key_mask(2, 32, (32, 20), "bool")
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), paddle.to_tensor(mask))
    got = PF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    _close(got, want)
    assert pfa.attention_path_counts() == jpo.attention_path_counts() == {
        "attn_fallback:head_dim": 1}


# ---------------------------------------------------------------------------
# transformer layers
# ---------------------------------------------------------------------------

E, NH, S = 32, 2, 6        # one width and length: JAX compiles each op
                            # once a shape


def test_multi_head_attention_with_and_without_caches():
    jm = jnn.MultiHeadAttention(E, NH, kdim=24, vdim=20)
    pm = pnn.MultiHeadAttention(E, NH, kdim=24, vdim=20, device="cpu")
    _carry(jm, pm)
    jm.eval(), pm.eval()
    q, k, v = _x(2, S, E), _x(2, S, 24, seed=1), _x(2, S, 20, seed=2)
    mask = _key_mask(2, S, (S, 4), "bool")
    _close(*_run(jm, pm, q, k, v, mask))
    # StaticCache: the keys and values of a memory, computed once
    jc = jm.gen_cache(paddle.to_tensor(k), paddle.to_tensor(v),
                      type=jnn.MultiHeadAttention.StaticCache)
    pc = pm.gen_cache(torch.from_numpy(k), torch.from_numpy(v),
                      type=pnn.MultiHeadAttention.StaticCache)
    _close(pc.k, jc.k), _close(pc.v, jc.v)
    _close(pm(torch.from_numpy(q), cache=pc), jm(paddle.to_tensor(q),
                                                 cache=jc))
    # Cache: self-attention one token at a time, the cache growing
    js = jnn.MultiHeadAttention(E, NH)
    ps = pnn.MultiHeadAttention(E, NH, device="cpu")
    _carry(js, ps)
    js.eval(), ps.eval()
    jc, pc = js.gen_cache(paddle.to_tensor(q)), ps.gen_cache(
        torch.from_numpy(q))
    assert pc.k.shape == tuple(jc.k.shape) == (2, 0, NH, E // NH)
    for t in range(2):
        x = q[:, t:t + 1]
        want, jc = js(paddle.to_tensor(x), cache=jc)
        got, pc = ps(torch.from_numpy(x), cache=pc)
        _close(got, want)
        assert pc.k.shape == tuple(jc.k.shape) == (2, t + 1, NH, E // NH)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_pre_and_post_norm(normalize_before):
    args = (E, NH, 48, 0.1, "gelu", None, None, normalize_before)
    jl = jnn.TransformerEncoderLayer(*args)
    pl = pnn.TransformerEncoderLayer(*args, device="cpu")
    _carry(jl, pl)
    x = _x(2, S, E)
    mask = _key_mask(2, S, (S, 3), "additive")
    jl.eval(), pl.eval()
    _close(*_run(jl, pl, x, mask))
    if not normalize_before:
        # training (BERT's form): four dropout sites, drawn in JAX's order
        # on JAX's keys
        jl.train(), pl.train()
        _both(3)
        _close(*_run(jl, pl, x, mask))
        _keys_equal()


def test_encoder_deep_copies_and_caches():
    args = (E, NH, 48, 0.0, "relu", None, None, True)
    je = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(*args), 2,
                                jnn.LayerNorm(E))
    pe = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(
        *args, device="cpu"), 2, pnn.LayerNorm(E, device="cpu"))
    sd = pe.state_dict()
    for name, t in sd.items():      # every layer starts as layer 0
        if name.startswith("layers."):
            assert torch.equal(t, sd["layers.0." + name.split(".", 2)[2]])
    assert list(sd) == list(je.state_dict())
    _carry(je, pe)
    x = _x(2, S, E)
    _close(*_run(je, pe, x))
    jc, pc = je.gen_cache(paddle.to_tensor(x)), pe.gen_cache(
        torch.from_numpy(x))
    for t in range(2):
        want, jc = je(paddle.to_tensor(x[:, t:t + 1]), None, jc)
        got, pc = pe(torch.from_numpy(x[:, t:t + 1]), None, pc)
        _close(got, want)


def test_decoder_and_transformer():
    args = (E, NH, 48, 0.0, "relu", None, None, False)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(*args), 2)
    pd = pnn.TransformerDecoder(pnn.TransformerDecoderLayer(
        *args, device="cpu"), 2)
    _carry(jd, pd)
    tgt, mem = _x(2, S, E), _x(2, S, E, seed=1)
    causal = np.array(jnn.Transformer.generate_square_subsequent_mask(
        S).numpy())
    np.testing.assert_array_equal(
        pnn.Transformer.generate_square_subsequent_mask(
            S, device="cpu").numpy(), causal)
    _close(*_run(jd, pd, tgt, mem, causal))
    # incremental decoding: the self-attention cache grows, the
    # cross-attention one is static
    jc = jd.gen_cache(paddle.to_tensor(mem))
    pc = pd.gen_cache(torch.from_numpy(mem))
    for t in range(2):
        want, jc = jd(paddle.to_tensor(tgt[:, t:t + 1]),
                      paddle.to_tensor(mem), None, None, jc)
        got, pc = pd(torch.from_numpy(tgt[:, t:t + 1]),
                     torch.from_numpy(mem), None, None, pc)
        _close(got, want)
    kw = dict(d_model=E, nhead=NH, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=48, dropout=0.0,
              normalize_before=True)
    jt, pt = jnn.Transformer(**kw), pnn.Transformer(**kw, device="cpu")
    _carry(jt, pt)
    src = _x(2, S, E, seed=4)
    _close(*_run(jt, pt, src, tgt, None, causal))
