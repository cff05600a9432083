"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_kernels.py

Tolerances (max absolute error against the plain version on the same
inputs): float32 2e-5, since both accumulate in fp32 and differ only in
summation order; bfloat16 3e-2, since outputs round to bf16 and the plain
version also rounds the probabilities to bf16.  Pool writes are bitwise.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

from _torch_port_util import MIXES, mix


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain)")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("s,d", [(7, 64), (200, 64), (130, 128)])
def test_flash_kernel_matches_plain(s, d, dtype, atol):
    g = torch.Generator().manual_seed(s + d)
    # slices of one fused [B, S, 3, H, D] projection, as the engine passes
    q, k, v = torch.randn(2, s, 3, 3, d, generator=g).to(
        "cuda", dtype).unbind(2)
    out, lse = fa.flash_attention_arrays(q, k, v, return_lse=True)
    want, want_lse = fa.mha_reference(q, k, v, is_causal=True,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() <= atol
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("mix_name", MIXES)
def test_ragged_kernel_matches_plain(mix_name, dtype, atol):
    q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = mix(mix_name)
    nb, bs, H, _ = geo
    d = 64
    rng = np.random.RandomState(2)
    b, c, _, _ = q.shape
    q, kn, vn = _t(rng.randn(b, c, 3, H, d).astype(np.float32)).unbind(2)
    kb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    vb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    dev = [x.to("cuda", dtype) for x in (q, kn, vn, kb, vb)]
    idx = [_t(a).cuda() for a in (tables, pos0, lens, slots)]
    ref = [x.clone() for x in dev[3:]]
    out, k2, v2 = rpa.ragged_paged_attention_arrays(*dev, *idx)
    want, k2r, v2r = rpa.ragged_paged_attention_reference(
        *dev[:3], *ref, *idx)
    torch.cuda.synchronize()
    assert torch.equal(k2, k2r) and torch.equal(v2, v2r)
    for b in valid:
        err = (out[b, :qlens[b]].float()
               - want[b, :qlens[b]].float()).abs().max().item()
        assert err <= atol, (mix_name, b, err)
