"""The tensor-core flash forward and dK/dV at head_dim 384, 512, ...
(``csrc/flash_wide_tc.cu``), on the CPU: which kernel each wrapper takes,
and the design's arithmetic emulated against the plain versions.

Routing: `flash_attention.kernel_route` decides by shape and type alone.
The wrappers' launch paths (`flash_attention._launch`,
``flash_bwd_dq._launch``, ``flash_bwd_dkv._launch``) run here on CPU
tensors with a stand-in for the built library, which records the entry
each launch calls: at D = 256 the kernels of ``flash_fwd_causal.cu`` /
``flash_bwd_causal.cu`` (``:d256``, and ``:simt`` for float32); at 384,
512, 640 and 1024 in bfloat16 and float16 the forward and dK/dV take
``flash_wide_tc_fwd`` / ``flash_wide_tc_dkv`` and count under ``:wide``
and ``:wide_tc``; float32 there, 16-bit past ``WIDE_TC_MAX_D`` (1024;
1152 here), and dQ in every type take the CUDA-core entries and count
under ``:wide`` alone.

Arithmetic: the kernels spread D over a cluster of D / 128 blocks.  Each
block sums its part of the scores over its 128 columns (an fp32
accumulator over bf16 / fp16 products, exact in fp32), and every block
sums the parts in rank order.  The forward then runs the online softmax
over key tiles of 64, p rounded to the input type at the running max of
its tile for the P V product, l the sum of the unrounded p; dK/dV rebuilds
p from the forward's statistics over query tiles of 32, rounds p to dO's
type before dV and ds = p (dP - delta) to q's type before dK, and sums
both over the tiles in order.  That arithmetic, written out in torch at
D = 512 in bfloat16 and float16 for causal attention and a left-pad mask
(batch row 1's first 37 keys closed, so its first 37 queries have no open
key and take the uniform softmax of their allowed keys), is held against
the port's plain versions (`mha_reference`, `flash_attention_bwd_reference`)
under the limits the card tests hold the kernels to
(`tolerance.flash_fwd_limit`, `tolerance.flash_bwd_limits`), every
element.  S = 200 leaves a ragged last tile of both widths.
"""
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tolerance as tol
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
CODE = {F32: 0, BF16: 1, F16: 2}
DC, BK, BQT = 128, 64, 32        # columns a block, key / query tile rows
B, H, S, D = 2, 2, 200, 512
PAD = 37


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class _Entry:
    """A C entry of the stand-in library: records its calls, returns 0."""

    def __init__(self, calls, lib, name):
        self.argtypes = self.restype = None
        self._calls, self._key = calls, (lib, name)

    def __call__(self, *args):
        self._calls.append((*self._key, args))
        return 0


class _Lib:
    def __init__(self, calls, name):
        self._calls, self._name = calls, name

    def __getattr__(self, entry):
        fn = _Entry(self._calls, self._name, entry)
        setattr(self, entry, fn)
        return fn


@pytest.fixture
def calls(monkeypatch):
    """The (library, entry, arguments) of every launch while the test
    runs, through the stand-in library."""
    made, libs = [], {}
    monkeypatch.setattr(fa._build, "load", lambda name: libs.setdefault(
        name, _Lib(made, name)))
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    return made


def _want(d, dtype):
    """{direction: (library, entry, counters other than the branch's)}."""
    if d == 256:
        design = {F32: "simt", BF16: "tc", F16: "tc16"}[dtype]
        return {kind: (src, f"flash_{name}", {"d256", design})
                for kind, src, name in (
                    ("fwd", "flash_fwd_causal", "fwd"),
                    ("dq", "flash_bwd_causal", "bwd_dq"),
                    ("dkv", "flash_bwd_causal", "bwd_dkv"))}
    tc = dtype != F32 and d <= 1024
    want = {"dq": ("flash_wide_bwd", "flash_wide_dq", {"wide"})}
    for kind, src in (("fwd", "flash_wide_fwd"), ("dkv", "flash_wide_bwd")):
        want[kind] = (("flash_wide_tc", f"flash_wide_tc_{kind}",
                       {"wide", "wide_tc"}) if tc
                      else (src, f"flash_wide_{kind}", {"wide"}))
    return want


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", [256, 384, 512, 640, 1024, 1152])
def test_wrappers_route_by_head_dim_and_type(d, dtype, calls):
    q, k, v, do = (torch.zeros(1, 8, 1, d, dtype=dtype) for _ in range(4))
    stats = torch.zeros(1, 1, 8)
    want = _want(d, dtype)
    kernels = {"fwd": fa, "dq": fa.flash_bwd_dq, "dkv": fa.flash_bwd_dkv}
    for kind, kern in kernels.items():
        ops.reset_launch_counts()
        calls.clear()
        if kind == "fwd":
            fa._launch(q, k, v, 0.1)
        else:
            kern._launch(q, k, v, do, stats, stats, 0.1, True, None, None,
                         None, None)
        lib, entry, designs = want[kind]
        assert [c[:2] for c in calls] == [(lib, entry)]
        args = calls[0][2]
        # after the pointers (10 of the forward, 12 of dK/dV, 11 of dQ):
        # B, H, Sq, Sk, D, the type's code, causal
        n_ptr = {"fwd": 10, "dq": 11, "dkv": 12}[kind]
        assert args[n_ptr:n_ptr + 7] == (1, 1, 8, 8, d, CODE[dtype], 1)
        assert fa.kernel_route(kind, d, dtype) == (lib, entry,
                                                   tuple(sorted(designs)))
        counts = {n for n, c in ops.launch_counts().items() if c}
        assert counts == {kern.KERNEL} | {f"{kern.KERNEL}:{s}"
                                          for s in designs}


# ---------------------------------------------------------------------------
# the design's arithmetic, emulated
# ---------------------------------------------------------------------------

def _inputs(dtype, branch, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g).to(dtype)
                   for _ in range(4))
    mask = None
    if branch == "pad_mask":
        mask = torch.zeros(B, 1, S, S)
        mask[1, :, :, :PAD] = -1e30
        mask = fa.normalize_mask(mask, B, H, S, S)
    return q, k, v, do, mask


def _scores(x, y):
    """fp32 [B, H, rows of x, rows of y]: sum_d x y as the cluster sums
    it, each block's 128 columns an fp32 product, the parts added in rank
    order."""
    s = torch.zeros(B, H, x.shape[1], y.shape[1])
    for g in range(D // DC):
        cols = slice(g * DC, (g + 1) * DC)
        s = s + torch.einsum("bqhd,bkhd->bhqk", x[..., cols].float(),
                             y[..., cols].float())
    return s


def _allowed(mask):
    """(bool [1, 1, S, S], the pairs causal leaves; the additive mask, or
    0 without one)."""
    allowed = torch.ones(S, S, dtype=torch.bool).tril()[None, None]
    return allowed, (0.0 if mask is None else mask)


def _emulated_forward(q, k, v, scale, mask):
    """out [B, S, H, D] in q's type and the statistics (lse, m, log l):
    the kernel's online softmax over key tiles of 64."""
    allowed, add = _allowed(mask)
    x = _scores(q, k) * scale + add
    x = x.masked_fill(~allowed, float("-inf") if mask is not None else -1e30)
    m = torch.full((B, H, S), float("-inf") if mask is not None else -1e30)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, BK):
        t = x[..., k0:k0 + BK]
        mx = torch.maximum(m, t.amax(-1))
        empty = mx == float("-inf")
        alpha = torch.where(empty, 1.0, torch.exp(m - mx))
        base = torch.where(empty, 0.0, mx)
        p = torch.exp(t - base[..., None])
        l = l * alpha + p.sum(-1)
        m = mx
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(),
            v[:, k0:k0 + BK].float())
    ls = l.clamp_min(1e-30)
    out = (o / ls[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return out, m + ls.log(), m, ls.log()


def _emulated_dkv(q, k, v, do, stat, delta, scale, mask, row_max):
    """(dk, dv) in the inputs' type: p and ds per query tile of 32, p
    rounded to dO's type before dV and ds to q's before dK, both summed
    over the tiles in order."""
    allowed, add = _allowed(mask)
    x = _scores(q, k) * scale + add
    if row_max is None:
        p = torch.exp(x - stat[..., None])
    else:
        p = torch.exp((x - row_max[..., None]) - stat[..., None])
    p = torch.where(allowed, p, 0.0)
    dp = _scores(do, v)
    ds = p * (dp - delta[..., None])
    dk = torch.zeros(B, S, H, D)
    dv = torch.zeros(B, S, H, D)
    for q0 in range(0, S, BQT):
        rows = slice(q0, q0 + BQT)
        dv = dv + torch.einsum("bhqk,bqhd->bkhd",
                               p[:, :, rows].to(do.dtype).float(),
                               do[:, rows].float())
        dk = dk + torch.einsum("bhqk,bqhd->bkhd",
                               ds[:, :, rows].to(q.dtype).float(),
                               q[:, rows].float())
    return (dk * scale).to(q.dtype), dv.to(q.dtype)


def _within(got, want, limit, what, apart=False):
    """Every element within its limit; with ``apart``, not every element
    equal (the emulation rounds where the plain version does not)."""
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"
    assert ratio > 0 or not apart, f"{what}: bitwise the plain version's"


@pytest.mark.parametrize("branch", ["causal", "pad_mask"])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_emulated_design_within_the_card_limits(dtype, branch):
    torch.manual_seed(0)
    with torch.no_grad():
        q, k, v, do, mask = _inputs(dtype, branch, 512 + len(branch))
        scale = D ** -0.5
        out, lse, m, logl = _emulated_forward(q, k, v, scale, mask)
        want, want_lse = fa.mha_reference(q, k, v, mask, True, scale,
                                          return_lse=True)
        want = want.to(dtype)
        _within(out, want, tol.flash_fwd_limit(out, want, q, k, v, True,
                                               mask),
                f"forward {dtype} {branch}", apart=True)
        if mask is None:
            _within(lse, want_lse, 1e-5, "lse")
            row_max, stat = None, lse
        else:
            rm, ls = fa.softmax_stats(q, k, scale, True, mask)
            _within(m, rm, 1e-5, "row max")
            _within(logl, ls, 1e-5, "log l")
            row_max, stat = m, logl
        delta = fa.attention_delta(out, do)
        dk, dv = _emulated_dkv(q, k, v, do, stat, delta, scale, mask,
                               row_max)
        want = fa.flash_attention_bwd_reference(
            q, k, v, out, stat, do, scale, is_causal=True, mask=mask,
            row_max=row_max)
        limits = tol.flash_bwd_limits((want[0], dk, dv), want, q, k, v, out,
                                      stat, do, scale, causal=True,
                                      mask=mask, row_max=row_max)
        for which, got, w, lim in (("dk", dk, want[1], limits[1]),
                                   ("dv", dv, want[2], limits[2])):
            assert got.dtype == dtype
            _within(got, w, lim, f"{which} {dtype} {branch}", apart=True)
