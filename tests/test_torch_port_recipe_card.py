"""The training recipe on the card (skipped without one; no JAX, so it runs
on the GPU machine with ``python -m pytest --noconftest -p no:cacheprovider
-q tests/test_torch_port_recipe_card.py``).

- The stacked test GPT (head_dim 64) with ``recompute`` against without:
  three recipe steps bitwise equal in losses, step-1 gradients and
  weights; the flash forward launched twice a layer under recompute, the
  backward kernels once.
- The per-layer test GPT under O1 with the LN and FFN flags: the flash
  kernels and the FFN run their bf16 tensor-core designs, the LayerNorm
  kernels fp32; the unscaled gradients are fp32 and finite, and the
  loss is fp32.
"""
import dataclasses

import pytest
import torch

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import amp, ops
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as L

CFG = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=128, vocab_size=503)


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the recipe's kernels on the card)")


def _batch(b, s, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, CFG["vocab_size"], (b, s), generator=g).cuda()
            for _ in range(2)]


def _opt(model):
    sched = L.LinearWarmup(L.CosineAnnealingDecay(1e-3, 5), 1, 1e-4, 1e-3)
    return AdamW(learning_rate=sched, beta2=0.95, weight_decay=0.1,
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 parameters=model.named_parameters())


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_recompute_is_bitwise_on_the_card():
    cfg = gpt_test_config(stacked_blocks=True, **CFG)
    batch = _batch(2, 128, 0)
    runs = {}
    for rc in (False, True):
        model = GPTForCausalLM(dataclasses.replace(cfg, recompute=rc),
                               device="cuda",
                               generator=torch.Generator().manual_seed(0))
        opt = _opt(model)
        ops.reset_launch_counts()
        losses, grads = [], None
        for step in range(3):
            loss = model.pretrain_loss(*batch)
            loss.backward()
            if step == 0:
                grads = [p.grad.clone() for p in model.parameters()]
            opt.step()
            opt.clear_grad()
            opt._lr_scheduler.step()
            losses.append(loss.item())
        torch.cuda.synchronize()
        runs[rc] = (losses, grads, [p.detach().clone()
                                    for p in model.parameters()],
                    ops.launch_counts())
    (la, ga, pa, na), (lb, gb, pb, nb) = runs[False], runs[True]
    layers = cfg.num_hidden_layers
    assert na["flash_fwd_causal"] == 3 * layers
    assert nb["flash_fwd_causal"] == 6 * layers
    for n in (na, nb):
        assert n["flash_bwd_dq_causal"] == n["flash_bwd_dkv_causal"] \
            == 3 * layers
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_o1_launches_the_bf16_designs(monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_LN", "1")
    monkeypatch.setenv("PTPU_PALLAS_FFN", "1")
    ln_dtypes = []
    ln = PF.fused_layernorm_arrays

    def spy(x, w, b, *a, **k):
        ln_dtypes.append((x.dtype, w.dtype, b.dtype))
        return ln(x, w, b, *a, **k)
    monkeypatch.setattr(PF, "fused_layernorm_arrays", spy)
    cfg = gpt_test_config(**CFG)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    opt = _opt(model)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    batch = _batch(2, 64, 1)                 # 128 rows: the FFN's tc design
    ops.reset_launch_counts()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = model.pretrain_loss(*batch)
    assert loss.dtype == torch.float32
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    grads = [opt._grad(p) for p in model.parameters()]
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    scaler.step(opt)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    layers = cfg.num_hidden_layers
    for k in ("flash_fwd_causal", "flash_bwd_dq_causal",
              "flash_bwd_dkv_causal"):
        assert counts[k] == counts[k + ":tc"] == layers, k
        assert counts[k + ":tc32"] == 0, k
    assert counts["fused_ffn_tc"] == layers
    assert counts["fused_ffn_tc32"] == counts["fused_ffn_decode"] == 0
    assert counts["fused_layernorm"] == counts["fused_layernorm_bwd"] \
        == 2 * layers + 1
    assert set(ln_dtypes) == {(torch.float32,) * 3}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert opt._step_count == 1 and not opt._master_weights
