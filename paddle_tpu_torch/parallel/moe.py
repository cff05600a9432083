"""Mixture-of-experts FFN with capacity-factor top-k routing — the port of
the single-device branch of `paddle_tpu/parallel/moe.py` (GShard's
layout).  This module has no kernel of its own: the JAX package computes
the routing and the experts as XLA einsums, and so does the port, as
torch einsums.

- top-k gating with a static capacity ``C = ceil(cf * k * tokens / E)``
  from the call's own token count (a decode step's is ``ceil(cf * k * B /
  E)``); tokens past an expert's capacity are dropped (combine weight 0);
- dispatch and combine are one-hot [N, E, C] tensors, applied by einsums.

Ties: ``jax.lax.top_k`` returns the lower index first among equal values,
and so does the port (a stable descending sort); a zero gate gives every
expert 1/E and both packages route to experts 0 .. k-1.

Telemetry (`_maybe_record_routing`): ``moe/tokens_per_expert``,
``moe/dropped_tokens`` and ``moe/imbalance``, read back from the dispatch
on eager forwards only, as in the JAX package (whose compiled programs
carry tracers): never inside ``generate`` or a CUDA-graph capture
(`graphs.tracing`).

Expert parallelism (the ``ep`` mesh axis, one all-to-all each way) needs
the distributed runtime and is not ported: every expert runs locally.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import monitor
from ..graphs import tracing

__all__ = ["moe_mlp_arrays", "moe_capacity"]


def _maybe_record_routing(dispatch, n_tokens, top_k):
    """Expert-routing telemetry from the dispatch tensor [N, E, C]: one
    host read-back, on eager forwards only."""
    if not monitor.enabled() or tracing():
        return
    tokens_per_expert = dispatch.sum(dim=(0, 2)).cpu().numpy()      # [E]
    hist = monitor.histogram("moe/tokens_per_expert")
    for c in tokens_per_expert:
        hist.observe(float(c))
    kept = float(tokens_per_expert.sum())
    monitor.counter("moe/dropped_tokens").add(
        max(0.0, n_tokens * top_k - kept))
    mean = float(tokens_per_expert.mean())
    if mean > 0:
        monitor.gauge("moe/imbalance").set(
            float(tokens_per_expert.max()) / mean)


def moe_capacity(num_tokens, num_experts, top_k, capacity_factor):
    """Static per-expert queue length (tokens beyond it overflow)."""
    return max(1, math.ceil(capacity_factor * top_k * num_tokens
                            / num_experts))


def _one_hot(idx, n):
    """fp32 one-hot of ``idx`` over ``n`` classes, all zeros for an index
    outside [0, n) (``jax.nn.one_hot``'s rule; no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _routing(logits, num_experts, top_k, capacity):
    """[N, E] gate logits -> (dispatch [N, E, C] 0/1, combine [N, E, C]
    fp32, aux_loss scalar).  Top-k routing with queue positions assigned
    choice-major (all first choices before any second choice, GShard's
    priority) and capacity overflow dropped."""
    n = logits.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)                     # [N, E]
    # jax.lax.top_k's order: largest first, the lower index among equals
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(dim=-1, keepdim=True)

    onehot = _one_hot(topi, num_experts).to(torch.int32)              # [N,k,E]
    # queue position of each (token, choice): earlier slots routed to the
    # same expert, choice-major so primary routes win capacity
    by_choice = onehot.transpose(0, 1)                                # [k,N,E]
    flat = by_choice.reshape(top_k * n, num_experts)
    # the running count down the k*N slots, scanned along the last axis
    # of the transpose ([E, k*N]): torch's scan down the outer axis took
    # 2.9 ms a call at [16384, 8] on an H100
    pos_flat = torch.cumsum(flat.t(), dim=1).t() - flat
    pos = (pos_flat.reshape(top_k, n, num_experts) * by_choice).sum(
        -1).transpose(0, 1)                                           # [N, k]

    keep = pos < capacity
    oh_e = onehot.float() * keep[..., None].float()
    oh_c = _one_hot(pos, capacity)                                    # [N,k,C]
    dispatch = torch.einsum("nke,nkc->nec", oh_e, oh_c)
    combine = torch.einsum("nke,nkc,nk->nec", oh_e, oh_c, topv)

    # GShard aux load-balance loss: E * sum_e(mean prob_e * top-1 share_e)
    me = probs.mean(dim=0)
    ce = onehot[:, 0].float().mean(dim=0)
    aux = num_experts * (me * ce).sum()
    return dispatch, combine, aux


def _expert_ffn(expert_in, w_in, w_out):
    """[E, C, H] x [E, H, M] -> tanh-gelu -> [E, C, H]."""
    hidden = torch.einsum("ech,ehm->ecm", expert_in, w_in)
    hidden = F.gelu(hidden, approximate="tanh")
    return torch.einsum("ecm,emh->ech", hidden, w_out)


def _moe_single(x, logits, w_in, w_out, *, top_k, capacity_factor):
    """Route and run every expert locally."""
    b, s, h = x.shape
    e = w_in.shape[0]
    xf = x.reshape(b * s, h)
    cap = moe_capacity(b * s, e, top_k, capacity_factor)
    dispatch, combine, aux = _routing(logits.reshape(b * s, e), e, top_k,
                                      cap)
    _maybe_record_routing(dispatch, b * s, top_k)
    expert_in = torch.einsum("nec,nh->ech", dispatch.to(x.dtype), xf)
    out = _expert_ffn(expert_in, w_in, w_out)
    y = torch.einsum("nec,ech->nh", combine.to(out.dtype), out)
    return y.reshape(b, s, h).to(x.dtype), aux


def moe_mlp_arrays(x, gate_logits, w_in, w_out, top_k=2,
                   capacity_factor=1.25, axis="ep"):
    """Array-level MoE FFN.  x: [B, S, H]; gate_logits: [B, S, E]; w_in:
    [E, H, M]; w_out: [E, M, H].  Returns (y [B, S, H], aux_loss).
    ``axis`` names the JAX package's expert-parallel mesh axis; the port
    runs on one device, so every expert runs here."""
    return _moe_single(x, gate_logits, w_in, w_out, top_k=top_k,
                       capacity_factor=capacity_factor)
