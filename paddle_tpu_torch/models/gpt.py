"""GPT decoder — the port of the parts of `paddle_tpu/models/gpt.py` that
serving, pretraining and dense generation run, in the JAX package's two
layouts, chosen by ``GPTConfig.stacked_blocks``:

- per-layer (the default, as in the JAX package): `GPTModel` of
  `GPTEmbeddings`, `GPTBlock`s (`GPTAttention`, `GPTMLP`, two
  `LayerNorm`s) registered as ``h_{i}`` and ``ln_f``, with the JAX
  ``state_dict()`` names.  Its LayerNorms take the fused kernels under
  ``PTPU_PALLAS_LN=1`` and its MLP the fused FFN under
  ``PTPU_PALLAS_FFN=1``, both differentiable.  It trains (``forward``,
  ``pretrain_loss``) and generates: its cached forward is the JAX one
  (`gpt.py:199-234`, `:713-723`, `:753-774`), the flash prefill then
  `ops.cached_attention_arrays` per step.
- stacked: every block's weights stacked as ``[L, ...]`` parameters under
  the names and shapes of `GPTStackedBlocks`, plus ``wte``, ``wpe``,
  ``lnf_w`` and ``lnf_b``; `param_arrays` returns them keyed like the JAX
  engine's ``_param_arrays``.  The block arithmetic is
  `_stacked_block_body` (pre-LN, tanh-GELU MLP, learned positions); the
  final LayerNorm is the gated `nn.functional.layer_norm`.

``forward`` returns logits and ``pretrain_loss`` the causal-LM loss, both
differentiable: attention goes through the flash kernels' autograd
Function on the card.  The stacked layout also trains on packed rows
(`examples/packed_pretraining.py`): ``segment_ids`` [B, S] mark the
documents, attention never crosses them (the segment branch of the flash
kernels), and ``position_ids`` [B, S] restart at each document; the
per-layer layout raises on ``segment_ids``, as the JAX one does.

``generate`` (both layouts) is the dense KV-cache decode of the JAX
``generate``: per-layer flat ``[B, S_max, H*D]`` rings (`init_caches`), a
causal flash prefill, then one cached forward per token, driven from the
host.  The decode step reads its token, its ring row t and (padded) its
pad counts and mask from static buffers that outlive it, and writes its
fp32 logits; on the card it is captured as one CUDA graph and replayed
per token (`graphs.StepGraph`; ``PTPU_CUDA_GRAPHS=0`` runs it eagerly),
the counterpart of JAX's one compiled decode loop.  With ``pad_token_id``
(stacked layout, as in JAX) the prompts may be padded (left or right):
they are canonicalised to left padding, the pads masked by an additive
cache mask (the masked flash forward at the prefill, the masked branch or
the fused layer's row mask at each step) and positions counted per row.
A decode step runs each layer as the JAX unrolled cached forward
does (`_forward_cached_unrolled`, `gpt.py:627-695`): by default the block
body with `ops.cached_attention_arrays` (the flash-decode kernel); under
``PTPU_FUSED_DECODE=1`` the attention half as one fused-layer kernel, and
under ``PTPU_PALLAS_FFN=1`` as well the MLP half as the fused LayerNorm
and FFN kernels.

Mixture of experts (per-layer only, as in JAX; `gpt.py:283-325`,
`:698-711`): with ``moe_every_n`` > 0 and ``moe_num_experts`` > 1, block
``i`` holds a `GPTMoEMLP` where ``(i + 1) % moe_every_n == 0`` (GShard's
every other block at 2): a ``gate`` `Linear` and the experts' ``w_in``
[E, H, M] and ``w_out`` [E, M, H], routed top-k with capacity factor
(`parallel.moe`), its GShard aux loss of the last forward in
``aux_loss`` (which `GPTPretrainingCriterion` does not add, as in JAX).
The stacked layout refuses MoE with JAX's error.

Weight-only low-bit inference (`lowbit.quantize_for_inference`) swaps
the per-layer model's `Linear` layers for `WeightOnlyLinear` ones:
``out_proj`` and ``fc_out`` are then called as layers (bias after the
product, as JAX's), and the MLP takes the fused FFN only while both its
projections hold a float ``weight`` (`gpt.py:266-279`).

Training takes the JAX recipe's two switches.  Dropout
(``hidden_dropout_prob``: after the embeddings and on each block's
attention and MLP outputs; ``attention_dropout_prob``: on the flash
output, after the kernel), per-layer only, drawn from the default
generator of the weights' device, in training mode (``self.training``);
the stacked layout raises on it, as the JAX one does (`gpt.py:445-446`).
``recompute`` (stacked only; the JAX per-layer layout ignores it, and so
does the port's): each block's body runs under `recompute`, so the
backward runs its forward again (the flash forward twice a block) in place
of keeping its activations.  Under `amp.auto_cast` the ops cast their
inputs by the names JAX dispatches them under (`amp`): the layers' ops,
``lm_head`` (`gpt.py:887`), and the stacked blocks as the one op
``gpt_stacked_blocks`` (`gpt.py:553`, `:563`).

Left out for later slices: expert parallelism, pipeline execution (and
the 1F1B fused loss), and the stacked-cache layer-scan decode.
"""
from __future__ import annotations

import copy
import dataclasses
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import cast_inputs
from ..core import random as _random
from ..device import resolve_device
from ..distributed.fleet.utils.recompute import recompute
from ..graphs import StepGraph, traced
from ..nn.functional import (cross_entropy, embedding, flash_attention,
                             fused_ln_applies, layer_norm, layer_norm_arrays,
                             linear)
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from ..ops.flash_attention import flash_attention_arrays
from ..ops.flash_decode import cached_attention_arrays
from ..ops.fused_decode import fused_decode_layer_arrays, fused_decode_ok
from ..ops.fused_mlp import (ffn_geometry_ok, fused_ffn_arrays,
                             fused_layernorm_arrays, maybe_fused_ffn)
from ..parallel.moe import moe_mlp_arrays

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "GPTEmbeddings", "GPTAttention", "GPTMLP", "GPTMoEMLP", "GPTBlock",
           "GPTModel", "gpt_test_config",
           "gpt2_124m_config", "gpt3_1p3b_config", "gpt3_6p7b_config"]

_NEG_INF = -1e30


@dataclasses.dataclass
class GPTConfig:
    """The fields of the JAX `GPTConfig` that the port reads, in JAX's
    relative order.  The others (sequence, context and pipeline
    parallelism) select behaviour the port does not have yet, so they
    cannot be set: the port runs on one device.  The fields up to
    ``layer_norm_epsilon`` take the positions they have in JAX; the rest
    are keyword-only, since JAX's eleventh positional field is one the
    port lacks.  ``stacked_blocks`` picks the layout, per-layer by
    default as in the JAX package; the dropout probabilities, the MoE
    fields and ``recompute`` act as the module docstring says."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    _: dataclasses.KW_ONLY
    # MoE: a mixture of experts in place of the dense FFN every n blocks
    moe_every_n: int = 0
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    stacked_blocks: bool = False
    recompute: bool = False


def gpt_test_config(**kw):
    """Tiny config for tests."""
    d = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_124m_config(**kw):
    d = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
             num_attention_heads=12, intermediate_size=3072,
             max_position_embeddings=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_1p3b_config(**kw):
    d = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
             num_attention_heads=16, intermediate_size=8192,
             max_position_embeddings=2048)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_6p7b_config(**kw):
    d = dict(vocab_size=50304, hidden_size=4096, num_hidden_layers=32,
             num_attention_heads=32, intermediate_size=16384,
             max_position_embeddings=2048)
    d.update(kw)
    return GPTConfig(**d)


def _stacked_ln(h, w, b, eps):
    """fp32-accumulated LayerNorm on stacked-block activations."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
    return ((h32 - mu) * torch.rsqrt(var + eps)).to(h.dtype) * w + b


def _stacked_mlp(p, h, eps):
    """ln2 -> tanh-gelu(fc_in) -> fc_out -> residual."""
    hn = _stacked_ln(h, p["ln2_w"], p["ln2_b"], eps)
    m = F.gelu(hn @ p["fc_in_w"] + p["fc_in_b"], approximate="tanh")
    return h + m @ p["fc_out_w"] + p["fc_out_b"]


def _stacked_mlp_fused_decode(p, h, eps):
    """The decode step's MLP half through the fused LayerNorm and FFN
    kernels — `gpt.py:381-410`: the same arithmetic as `_stacked_mlp`
    (gelu_tanh).  Returns None, and the caller runs `_stacked_mlp`, unless
    ``PTPU_PALLAS_FFN == "1"``, the activations and both FFN weights share
    one dtype and `ffn_geometry_ok` holds."""
    if os.environ.get("PTPU_PALLAS_FFN") != "1":
        return None
    mb, s, H = h.shape
    if not (h.dtype == p["fc_in_w"].dtype == p["fc_out_w"].dtype
            and ffn_geometry_ok(mb * s, H, p["fc_in_w"].shape[-1], H)):
        return None
    hn = fused_layernorm_arrays(h, p["ln2_w"], p["ln2_b"], eps)
    m = fused_ffn_arrays(hn, p["fc_in_w"], p["fc_in_b"], p["fc_out_w"],
                         act="gelu_tanh")
    return h + m + p["fc_out_b"]


def _cached_attn_arrays(q, k, v, kc, vc, t, prefill, cache_mask=None):
    """Prefill / decode cached attention (`gpt.py:329-361`).  At the
    static prefill (position 0) the rings beyond the chunk are empty, so
    causal flash attention over the chunk plus the ring write at rows
    ``[0, S)`` is exact; a decode step goes to `cached_attention_arrays`.
    The rings are written in place.  ``cache_mask``: optional additive
    [B, 1, 1, S_max] over cache positions (padded prompts); at the prefill
    its first S columns, broadcast over the queries as a stride-0
    [B, 1, S, S] view, are the flash mask."""
    if prefill:
        b, s = k.shape[0], k.shape[1]
        kc[:, :s] = k.reshape(b, s, -1).to(kc.dtype)
        vc[:, :s] = v.reshape(b, s, -1).to(vc.dtype)
        m = None
        if cache_mask is not None:
            m = cache_mask[:, :, :, :s].expand(b, 1, s, s)
        return flash_attention_arrays(q, k, v, m, is_causal=True)
    out, _, _ = cached_attention_arrays(q, k, v, kc, vc, t, mask=cache_mask)
    return out


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature, then top-k, then top-p (nucleus) filtering of [R, V]
    fp32 logits with -1e30, a row at a time as the JAX engine's sampler
    computes it (`engine.py:1792-1805`): ``temperature``, ``top_p`` fp32
    [R] and ``top_k`` int [R] tensors on the logits' device (a row's
    top_k 0 and top_p >= 1 filter nothing).  The division is by a device
    tensor, so a true division (a CPU scalar divisor would make it a
    product with the reciprocal on the card)."""
    ll = logits / torch.clamp(temperature, min=1e-6)[:, None]
    v = ll.shape[-1]
    asc = torch.sort(ll, dim=-1).values
    kth = asc.gather(1, torch.clamp(v - top_k.long(), 0, v - 1)[:, None])
    cut = (top_k > 0)[:, None]
    ll = torch.where(cut & (ll < kth), _NEG_INF, ll)
    # the filtered row sorted: the same sort with the cut values at -1e30
    # (still ascending), reversed
    desc = torch.where(cut & (asc < kth), _NEG_INF, asc).flip(-1)
    probs = torch.softmax(desc, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs <= top_p[:, None]
    thresh = torch.where(keep, desc, float("inf")).amin(-1, keepdim=True)
    return torch.where((top_p < 1.0)[:, None] & (ll < thresh), _NEG_INF, ll)


def _sample_next(logits, key, do_sample, temperature, top_k, top_p):
    """Next token of each row of [B, V] fp32 logits, in JAX's argument
    order (`gpt.py:824-844`): greedy argmax (the first maximal index), or
    `_filter_logits` then ``categorical(key, logits)`` — one key for the
    whole batch, gumbel noise of shape [B, V] (`core.random`).  Returns
    int64 [B]."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    b, dev = logits.shape[0], logits.device
    ll = _filter_logits(
        logits,
        torch.full((b,), float(temperature), device=dev),
        torch.full((b,), int(top_k or 0), device=dev),
        torch.full((b,), 1.0 if top_p is None else float(top_p),
                   device=dev))
    return _random.categorical(key, ll)


def _stacked_block_body(p, h, attn_fn, nh, hd, eps):
    """One pre-LN transformer block over a stacked-weight slice ``p``.
    attn_fn: (q, k, v) [B, S, nh, hd] -> (o, extra)."""
    mb, s, hidden = h.shape
    hn = _stacked_ln(h, p["ln1_w"], p["ln1_b"], eps)
    qkv = (hn @ p["qkv_w"] + p["qkv_b"]).reshape(mb, s, 3, nh, hd)
    o, extra = attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    h = h + o.reshape(mb, s, hidden) @ p["out_w"] + p["out_b"]
    return _stacked_mlp(p, h, eps), extra


BLOCK_PARAMS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
                "ln2_w", "ln2_b", "fc_in_w", "fc_in_b", "fc_out_w",
                "fc_out_b")


def _causal_attn(q, k, v):
    return flash_attention_arrays(q, k, v, is_causal=True), None


def _stacked_layer(p, attn, nh, hd, eps):
    """``h -> h`` through one stacked block, its weights ``p`` bound now
    (`recompute` calls it again in the backward)."""
    def block(h):
        return _stacked_block_body(p, h, attn, nh, hd, eps)[0]
    return block


def _row_linear(layer, x):
    """A `Linear` as the JAX ``RowParallelLinear`` computes it
    (`parallel/mp_layers.py:89-97`): the op ``linear`` without the bias,
    then the bias added, so under `amp.auto_cast` the sum takes the
    wider of the two dtypes.  A layer without a float ``weight`` (a
    `WeightOnlyLinear`) is called as a layer, which adds its bias after
    the product, as JAX's does."""
    if getattr(layer, "weight", None) is None:
        return layer(x)
    return linear(x, layer.weight) + layer.bias


def _copy_without(obj, memo, fresh):
    """A deep copy of ``obj`` whose attributes named in ``fresh`` are new
    values (``fresh[name]()``) instead of copies."""
    new = obj.__class__.__new__(obj.__class__)
    memo[id(obj)] = new
    for k, v in obj.__dict__.items():
        new.__dict__[k] = fresh[k]() if k in fresh else copy.deepcopy(v, memo)
    return new


def _lm_head(h, wte):
    """The tied head ``h @ wte.T``, the op ``lm_head`` (`gpt.py:887`)."""
    h, wte = cast_inputs("lm_head", h, wte)
    return h @ wte.t()


def _packed_attn(segment_ids):
    """The attention closure of packed rows (`gpt.py:509-515`)."""
    def attn(q, k, v):
        return flash_attention_arrays(q, k, v, is_causal=True,
                                      segment_ids=segment_ids), None
    return attn


class GPTPretrainingCriterion(nn.Module):
    """Causal-LM loss over logits [B, S, V] and labels [B, S] — the
    counterpart of `paddle_tpu.models.gpt.GPTPretrainingCriterion`:
    per-position `cross_entropy` (fp32, ignore_index -100), then with
    ``loss_mask`` ``sum(loss * mask) / max(sum(mask), 1)``, otherwise the
    mean over ALL positions, ignored ones counted as 0."""

    def __init__(self, cfg: GPTConfig = None):
        super().__init__()         # cfg is unused, as in the JAX class

    def forward(self, logits, labels, loss_mask=None):
        loss = cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            mask = torch.as_tensor(loss_mask, device=loss.device).float()
            return (loss * mask).sum() / mask.sum().clamp(min=1.0)
        return loss.mean()


# ---------------------------------------------------------------------------
# per-layer layout (`gpt.py:143-280`, `:698-811`)
# ---------------------------------------------------------------------------

class GPTEmbeddings(nn.Module):
    """``word_embeddings[ids] + position_embeddings[pos]``, both drawn
    normal with std ``initializer_range``, then dropout
    (``hidden_dropout_prob``; `gpt.py:143-169`)."""

    def __init__(self, cfg: GPTConfig, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  std=cfg.initializer_range)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTAttention(nn.Module):
    """Causal self-attention (`gpt.py:172-251`): the fused ``qkv_proj``,
    ``[b, s, 3, heads, head_dim]``, causal flash attention
    (differentiable; `nn.functional.flash_attention`, with the attention
    dropout in training), ``out_proj`` (its bias added after the product,
    `_row_linear`).  With ``cache`` (a ``(k, v)`` pair of
    flat [B, S_max, H*D] rings, written in place) it is the cached branch
    (`gpt.py:199-234`): ``time_step`` None is the static prefill at
    position 0 (causal flash over the chunk and the ring write), else the
    chunk goes to `cached_attention_arrays` at position ``time_step`` (an
    int or an int32 [1] device tensor); it then returns ``(out,
    cache)``."""

    def __init__(self, cfg: GPTConfig, device, dtype, generator):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.attn_drop = cfg.attention_dropout_prob
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, cache=None, time_step=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            kc, vc = cache
            if time_step is None:
                o = _cached_attn_arrays(q, k, v, kc, vc, 0, True)
            else:
                o, _, _ = cached_attention_arrays(q, k, v, kc, vc, time_step)
            return _row_linear(self.out_proj, o.reshape(b, s, h)), cache
        o = flash_attention(q, k, v, is_causal=True,
                            dropout_p=self.attn_drop, training=self.training)
        return _row_linear(self.out_proj, o.reshape(b, s, h))


class GPTMLP(nn.Module):
    """``fc_out(gelu_tanh(fc_in(x)))`` (``fc_out`` as `_row_linear`), or
    under ``PTPU_PALLAS_FFN=1`` the fused FFN plus ``fc_out.bias`` where
    `maybe_fused_ffn` takes it (`gpt.py:254-280`): only while both
    projections hold a float ``weight`` (quantized ones do not)."""

    def __init__(self, cfg: GPTConfig, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        w1 = getattr(self.fc_in, "weight", None)
        w2 = getattr(self.fc_out, "weight", None)
        b2 = self.fc_out.bias
        if w1 is not None and w2 is not None and b2 is not None:
            y = maybe_fused_ffn(x, w1, self.fc_in.bias, w2, "gelu_tanh")
            if y is not None:
                return y + b2
        return _row_linear(self.fc_out,
                           F.gelu(self.fc_in(x), approximate="tanh"))


class GPTMoEMLP(nn.Module):
    """Mixture-of-experts FFN (`gpt.py:283-325`): the ``gate`` `Linear` (H
    -> E), then `parallel.moe.moe_mlp_arrays` over the experts' ``w_in``
    [E, H, M] and ``w_out`` [E, M, H] (drawn normal with std
    ``initializer_range``), dispatched as the op ``moe_mlp``
    (`amp.cast_inputs`).  ``aux_loss`` holds the GShard load-balance loss
    of the last forward (a deep copy starts without one)."""

    def __init__(self, cfg: GPTConfig, device, dtype, generator):
        super().__init__()
        self.num_experts = cfg.moe_num_experts
        self.top_k = cfg.moe_top_k
        self.capacity_factor = cfg.moe_capacity_factor
        e, h, m = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate = Linear(h, e, **kw)
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for name, shape in (("w_in", (e, h, m)), ("w_out", (e, m, h))):
            t = torch.empty(shape).normal_(0.0, cfg.initializer_range,
                                           generator=g)
            self.register_parameter(name, nn.Parameter(
                t.to(device=dev, dtype=dtype)))
        self.aux_loss = None

    def __deepcopy__(self, memo):
        # the last forward's loss may hold an autograd graph, which a
        # deep copy refuses
        return _copy_without(self, memo, {"aux_loss": lambda: None})

    def forward(self, x):
        logits = self.gate(x)                        # [b, s, E]
        x, logits, w_in, w_out = cast_inputs("moe_mlp", x, logits,
                                             self.w_in, self.w_out)
        out, aux = moe_mlp_arrays(x, logits, w_in, w_out, top_k=self.top_k,
                                  capacity_factor=self.capacity_factor)
        self.aux_loss = aux
        return out


class GPTBlock(nn.Module):
    """Pre-LN block (`gpt.py:698-723`), dropout (``hidden_dropout_prob``)
    on the attention and MLP outputs; with ``cache`` it returns ``(x,
    cache)`` (`GPTAttention`).  Its FFN is a `GPTMoEMLP` where
    ``moe_every_n`` > 0, ``moe_num_experts`` > 1 and ``(layer_idx + 1) %
    moe_every_n == 0``, else a `GPTMLP`."""

    def __init__(self, cfg: GPTConfig, layer_idx=0, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(cfg.hidden_size, eps, device, dtype)
        self.attn = GPTAttention(cfg, device, dtype, generator)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps, device, dtype)
        use_moe = (cfg.moe_every_n > 0 and cfg.moe_num_experts > 1
                   and (layer_idx + 1) % cfg.moe_every_n == 0)
        self.mlp = (GPTMoEMLP if use_moe else GPTMLP)(cfg, device, dtype,
                                                      generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, cache=None, time_step=None):
        if cache is not None:
            a, cache = self.attn(self.ln_1(x), cache=cache,
                                 time_step=time_step)
            x = x + self.dropout(a)
            return x + self.dropout(self.mlp(self.ln_2(x))), cache
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    """Embeddings, blocks ``h_0 .. h_{L-1}`` and ``ln_f``
    (`gpt.py:726-811`, the per-layer branches).  With ``caches`` (one
    ``(k, v)`` ring pair a layer) it returns ``(ln_f(x), caches)``, the
    positions ``time_step + [0, S)`` unless given (`gpt.py:753-774`)."""

    def __init__(self, cfg: GPTConfig, device, dtype, generator):
        super().__init__()
        self.embeddings = GPTEmbeddings(cfg, device, dtype, generator)
        self.h = [GPTBlock(cfg, i, device, dtype, generator)
                  for i in range(cfg.num_hidden_layers)]
        for i, blk in enumerate(self.h):
            self.add_module(f"h_{i}", blk)
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device, dtype)

    def forward(self, input_ids, position_ids=None, caches=None,
                time_step=None, segment_ids=None, cache_mask=None):
        if segment_ids is not None:
            raise NotImplementedError(
                "segment_ids are supported on the stacked-blocks training "
                "path (no KV-cache decode); packed decoding is not a "
                "standard inference shape")
        if caches is not None and position_ids is None:
            # decode positions are absolute: time_step + [0, s)
            t = 0 if time_step is None else time_step
            position_ids = t + torch.arange(input_ids.shape[-1],
                                            device=input_ids.device)
        x = self.embeddings(input_ids, position_ids)
        if caches is not None:
            if cache_mask is not None:
                raise NotImplementedError(
                    "padded-prompt cache_mask is wired on the "
                    "stacked-blocks path; use stacked_blocks=True")
            new_caches = []
            for blk, cache in zip(self.h, caches):
                x, c = blk(x, cache=cache, time_step=time_step)
                new_caches.append(c)
            return self.ln_f(x), new_caches
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with a tied LM head, in the layout ``cfg.stacked_blocks``
    picks (module docstring).

    Weights are drawn on the CPU from ``generator`` (a seeded
    `torch.Generator`; default: a fresh one seeded 0) — normal with std
    ``initializer_range`` for the embeddings (and, stacked, the matrices;
    per-layer, the `Linear` weights are XavierNormal as in the JAX
    layers), ones for the LayerNorm scales, zeros for biases — then moved
    to ``device``, so one seed gives the same model on every device."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        # generate's decode steps by shape key, and the CUDA graphs
        # captured of them by kind ({"decode": n})
        self._decode_steps: dict = {}
        self.compiles: dict = {}
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if not cfg.stacked_blocks:
            self.gpt = GPTModel(cfg, dev, dtype, g)
            return
        if cfg.hidden_dropout_prob or cfg.attention_dropout_prob:
            raise ValueError(
                "stacked_blocks path does not support dropout yet")
        if cfg.moe_every_n > 0:
            raise ValueError(
                "stacked_blocks path does not support MoE; use "
                "stacked_blocks=False")
        L, H, I = (cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.intermediate_size)
        shapes = {
            "ln1_w": (L, H), "ln1_b": (L, H),
            "qkv_w": (L, H, 3 * H), "qkv_b": (L, 3 * H),
            "out_w": (L, H, H), "out_b": (L, H),
            "ln2_w": (L, H), "ln2_b": (L, H),
            "fc_in_w": (L, H, I), "fc_in_b": (L, I),
            "fc_out_w": (L, I, H), "fc_out_b": (L, H),
            "wte": (cfg.vocab_size, H),
            "wpe": (cfg.max_position_embeddings, H),
            "lnf_w": (H,), "lnf_b": (H,),
        }
        for name, shape in shapes.items():
            if name in ("ln1_w", "ln2_w", "lnf_w"):
                t = torch.ones(shape)
            elif name.endswith("_b"):
                t = torch.zeros(shape)
            else:
                t = torch.empty(shape).normal_(
                    0.0, cfg.initializer_range, generator=g)
            self.register_parameter(name, nn.Parameter(
                t.to(device=dev, dtype=dtype)))

    def __deepcopy__(self, memo):
        # generate's decode steps hold CUDA graphs over this model's
        # buffers: a copy captures its own (`gpt.py:859-871`)
        return _copy_without(self, memo, {"_decode_steps": dict,
                                          "compiles": dict})

    @property
    def word_embeddings(self):
        """The tied embedding and head matrix [vocab, H]."""
        return (self.wte if self.cfg.stacked_blocks
                else self.gpt.embeddings.word_embeddings.weight)

    def forward(self, input_ids, position_ids=None, *, segment_ids=None):
        """[B, S] token ids -> [B, S, vocab] logits in the weights' dtype:
        the embeddings ``wte[ids] + wpe[pos]``, the blocks with causal
        flash attention, the final LayerNorm (the gated `layer_norm`), then
        the tied head ``h @ wte.T`` — the non-pipeline, non-cache branch
        of the JAX ``GPTModel.forward`` and ``GPTForCausalLM.forward``
        (stacked under ``recompute``, each block `recompute`).
        ``position_ids`` ([S] or [B, S]) defaults to ``0 .. S-1``;
        ``segment_ids`` [B, S] (stacked layout only; keyword-only, since
        JAX's third positional is the caches) keeps attention inside each
        packed document."""
        cfg = self.cfg
        wte = self.word_embeddings
        dev = wte.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        pos = (None if position_ids is None
               else torch.as_tensor(position_ids, device=dev).long())
        if not cfg.stacked_blocks:
            return _lm_head(self.gpt(ids, pos, segment_ids=segment_ids), wte)
        if pos is None:
            pos = torch.arange(ids.shape[-1], device=dev)
        h = embedding(ids, self.wte) + embedding(pos, self.wpe)
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        eps = cfg.layer_norm_epsilon
        attn = _causal_attn
        if segment_ids is not None:
            attn = _packed_attn(torch.as_tensor(segment_ids, device=dev,
                                                dtype=torch.int32))
        h, *stacked = cast_inputs("gpt_stacked_blocks", h,
                                  *(getattr(self, n) for n in BLOCK_PARAMS))
        for layer in range(cfg.num_hidden_layers):
            block = _stacked_layer(
                {n: w[layer] for n, w in zip(BLOCK_PARAMS, stacked)}, attn,
                nh, hd, eps)
            h = recompute(block, h) if cfg.recompute else block(h)
        h = layer_norm(h, cfg.hidden_size, self.lnf_w, self.lnf_b, eps)
        return _lm_head(h, self.wte)

    def pretrain_loss(self, input_ids, labels, loss_mask=None,
                      segment_ids=None, position_ids=None):
        """``GPTPretrainingCriterion()(self(input_ids, position_ids,
        segment_ids=segment_ids), labels, loss_mask)`` in the JAX argument
        order — the non-1F1B branch of the JAX ``pretrain_loss``."""
        return GPTPretrainingCriterion(self.cfg)(
            self(input_ids, position_ids, segment_ids=segment_ids), labels,
            loss_mask)

    def param_arrays(self) -> dict:
        """{name: tensor}: stacked, keyed like the JAX engine's
        ``_param_arrays``; per-layer, like the JAX model's
        ``state_dict()`` (``gpt.h_0.attn.qkv_proj.weight``, ...; a
        quantized model's ``...qweight`` and ``...scale`` buffers too)."""
        return {**dict(self.named_parameters()),
                **dict(self.named_buffers())}

    @torch.no_grad()
    def load_params(self, params: dict) -> "GPTForCausalLM":
        """Copy tensors keyed like `param_arrays` into this model, each
        cast to the device and dtype of the tensor it replaces (a
        quantized model's int8 / uint8 codes and fp32 scales keep theirs);
        every name must be present, shapes must match."""
        mine = self.param_arrays()
        if set(params) != set(mine):
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(set(mine) - set(params))}, extra "
                             f"{sorted(set(params) - set(mine))}")
        for name, t in params.items():
            if tuple(t.shape) != tuple(mine[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(mine[name].shape)}")
            mine[name].copy_(t)
        return self

    # -- autoregressive decoding -------------------------------------------
    def init_caches(self, batch_size, max_length, dtype=None):
        """Per-layer ``(k, v)`` flat rings ``[B, S_max, H*D]`` of zeros on
        the model's device, ``S_max`` = ``max_length`` rounded up to 128
        (`gpt.py:973-1000`; only the valid prefix is ever read).  ``dtype``
        defaults to the weights'.  The JAX package switches to stacked
        ``[L, ...]`` caches above 32 layers (stacked layout), a trade of
        its layer scan; the port always takes the per-layer form."""
        cfg = self.cfg
        s_max = -(-max_length // 128) * 128
        shape = (batch_size, s_max, cfg.hidden_size)
        wte = self.word_embeddings
        dt = dtype or wte.dtype
        return [tuple(torch.zeros(shape, dtype=dt, device=wte.device)
                      for _ in range(2))
                for _ in range(cfg.num_hidden_layers)]

    def _forward_cached(self, input_ids, caches, t, prefill,
                        position_ids=None, cache_mask=None):
        """[B, S] ids written at ring rows ``t .. t+S-1`` (``t`` an int or
        an int32 [1] device tensor) through every layer with the rings
        (written in place) -> the last position's fp32 logits [B, V] — the
        cached branch of the JAX ``GPTModel.forward``, then ``ln_f`` and
        the tied head on the last position only (its rows are
        independent; the fused LayerNorm's gate is decided on all B*S
        rows, as the JAX package normalises them all).  Stacked: the
        blocks as `_forward_cached_unrolled`; per-layer: `GPTModel`'s
        cached branch.  ``position_ids`` ([B, S], default the ring rows)
        and ``cache_mask`` (additive [B, 1, 1, S_max]) serve padded
        prompts."""
        cfg = self.cfg
        if not cfg.stacked_blocks:
            h, _ = self.gpt(input_ids.long(), position_ids, caches,
                            None if prefill else t, cache_mask=cache_mask)
            return (h[:, -1] @ self.word_embeddings.t()).float()
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        eps = cfg.layer_norm_epsilon
        ids = input_ids.long()
        pos = (t + torch.arange(ids.shape[1], device=ids.device)
               if position_ids is None else position_ids.long())
        h = self.wte[ids] + self.wpe[pos]
        mb, s, H = h.shape
        fused = (not prefill and s == 1 and fused_decode_ok(
            h, self.qkv_w, caches[0][0], caches[0][1]))
        for layer, (kc, vc) in enumerate(caches):
            p = {n: getattr(self, n)[layer] for n in BLOCK_PARAMS}
            if fused:
                y, _, _ = fused_decode_layer_arrays(
                    h.reshape(mb, H), p["ln1_w"], p["ln1_b"], p["qkv_w"],
                    p["qkv_b"], p["out_w"], p["out_b"], kc, vc, t, nh, eps,
                    cache_mask=cache_mask)
                y3 = y.reshape(mb, 1, H)
                h = _stacked_mlp_fused_decode(p, y3, eps)
                if h is None:
                    h = _stacked_mlp(p, y3, eps)
                continue

            def attn_fn(q, k, v, kc=kc, vc=vc):
                return _cached_attn_arrays(q, k, v, kc, vc, t, prefill,
                                           cache_mask), None

            h, _ = _stacked_block_body(p, h, attn_fn, nh, hd, eps)
        ln = (fused_layernorm_arrays
              if fused_ln_applies(mb * s, H, self.lnf_w, self.lnf_b)
              else layer_norm_arrays)
        hn = ln(h[:, -1], self.lnf_w, self.lnf_b, eps)
        return (hn @ self.wte.t()).float()

    def _decode_step(self, batch, max_length, padded):
        """The `_DecodeStep` of ``generate`` for this shape key — JAX's
        ``gen_key`` less the sampling parameters, which stay outside the
        step: (B, S_max, dtype, layout, the kernel flags that pick the
        step's path, padded).  It is made anew when the weights or buffers
        (a quantized model's codes and scales) have moved: the graph holds
        their addresses."""
        wte = self.word_embeddings
        s_max = -(-max_length // 128) * 128
        key = (batch, s_max, wte.dtype, self.cfg.stacked_blocks,
               tuple(os.environ.get(k) for k in _DECODE_FLAGS), padded)
        weights = tuple(p.data_ptr() for p in self.param_arrays().values())
        step = self._decode_steps.get(key)
        if step is None or step.weights != weights:
            step = self._decode_steps[key] = _DecodeStep(
                self, batch, s_max, padded, weights)
        return step

    @torch.no_grad()
    @traced()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None, pad_token_id=None):
        """KV-cache autoregressive decoding with the semantics of the JAX
        ``GPTForCausalLM.generate`` (`gpt.py:1002-1210`), in both layouts:
        a prefill at position 0, then one cached forward per token and
        none after the last; greedy by default, temperature / top-k /
        top-p with ``do_sample``, drawn from JAX's threefry stream
        (`core.random`): the key ``PRNGKey(seed)``, or ``next_key()``
        when ``seed`` is None, split once a step, one categorical draw
        over the batch, so a seed gives the JAX package's tokens; rows
        that emitted ``eos_token_id`` keep emitting it and the loop stops
        when every row has.  Returns ``[B, P + n]`` int32 on the model's
        device.

        ``pad_token_id`` (stacked layout; the per-layer one raises, as in
        JAX): rows padded with it (left or right, no interior pads) are
        rolled to left padding; the pads are masked out of every attention
        (an additive -1e30 mask over the cache rows they fill) and each
        row's positions count from its first real token.  The returned
        buffer is left-aligned, ``[pads | prompt | generated]`` per row
        (`gpt.py:1081-1113`, `:1143-1150`).

        The loop is driven from the host and syncs with it only to test
        the finished flags when ``eos_token_id`` is set.  For telemetry it
        is one traced program (`graphs.traced`: no MoE routing read-back,
        no ``lowbit/dequant_calls``), as JAX's is one compiled program.
        Each decode step is the key's `_DecodeStep` (`_decode_step`): on
        the card one CUDA graph replay, then the sampler."""
        cfg = self.cfg
        dev = self.word_embeddings.device
        ids = torch.as_tensor(input_ids).to(dev, torch.int32)
        if ids.dim() == 1:
            ids = ids[None]
        if max_new_tokens <= 0:
            return ids
        b, prompt = ids.shape
        total = prompt + max_new_tokens
        if total > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({prompt}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position_embeddings "
                f"({cfg.max_position_embeddings})")
        # the key as JAX threads it (`gpt.py:1126-1131`): split once a
        # step when sampling
        key = ((_random.PRNGKey(seed) if seed is not None
                else _random.next_key()) if do_sample
               else _random.PRNGKey(0)).to(dev)
        step = self._decode_step(b, total, pad_token_id is not None)
        pos = cache_mask = None
        if pad_token_id is not None:
            ids, shift, pos, cache_mask = _left_pad(
                ids, pad_token_id, step.caches[0][0].shape[1])
            step.shift.copy_(shift)
            step.mask.copy_(cache_mask)
        logits = self._forward_cached(ids, step.caches, 0, prefill=True,
                                      position_ids=pos,
                                      cache_mask=cache_mask)
        step.t.fill_(prompt)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        toks = []
        for i in range(max_new_tokens):
            sub = None
            if do_sample:
                key, sub = _random.split(key)
            tok = _sample_next(logits, sub, do_sample, temperature, top_k,
                               top_p)
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished |= tok == eos_token_id
            toks.append(tok)
            if i + 1 == max_new_tokens or (
                    eos_token_id is not None and bool(finished.all())):
                break
            step.tok.copy_(tok[:, None])
            logits = step.run()
        return torch.cat([ids, torch.stack(toks, 1).to(torch.int32)], 1)


# the kernel flags whose values pick the path of a decode step
_DECODE_FLAGS = ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN", "PTPU_PALLAS_LN")


class _DecodeStep:
    """One decode step of ``generate`` over buffers that outlive it: the
    token ``tok`` [B, 1], the ring row ``t`` (int32 [1] on the device;
    the step writes row t, then adds one to it), the rings ``caches``
    and, for padded prompts, the pad counts ``shift`` [B] and the
    additive ``mask`` [B, 1, 1, S_max], from which the step takes each
    row's position ``t - shift``.  ``run()`` returns the fp32 logits
    [B, V]; it is a `StepGraph` of kind "decode" counted in the model's
    ``compiles``, so on the card one CUDA graph replay."""

    def __init__(self, model, batch, s_max, padded, weights):
        dev = model.word_embeddings.device
        self.weights = weights
        self.caches = model.init_caches(batch, s_max)
        self.tok = torch.zeros(batch, 1, dtype=torch.long, device=dev)
        self.t = torch.zeros(1, dtype=torch.int32, device=dev)
        self.shift = self.mask = None
        if padded:
            self.shift = torch.zeros(batch, dtype=torch.int32, device=dev)
            self.mask = torch.zeros(batch, 1, 1, s_max, device=dev)

        def step():
            pos = (None if self.shift is None
                   else (self.t - self.shift)[:, None])
            with traced():
                logits = model._forward_cached(self.tok, self.caches,
                                               self.t, False, pos, self.mask)
            self.t += 1
            return logits

        self.run = StepGraph(step, dev, "decode", model.compiles)


def _left_pad(ids, pad_token_id, s_max):
    """Canonicalise padded prompts [B, P] to left padding, as the JAX
    ``generate`` does (`gpt.py:1081-1113`).  Two quantities: the roll
    comes from each row's LAST real index (0 for a left-padded row), the
    mask and positions from its pad COUNT.  Returns the rolled ids, the
    pad counts [B], the prefill positions ``max(col - shift, 0)`` and the
    additive fp32 cache mask [B, 1, 1, S_max] (-1e30 at each row's pad
    rows)."""
    b, p = ids.shape
    dev = ids.device
    valid = ids != pad_token_id
    cols = torch.arange(p, dtype=torch.int32, device=dev)[None, :]
    last1 = torch.where(valid, cols + 1, 0).amax(1)
    roll = p - last1
    shift = (p - valid.sum(1)).to(torch.int32)
    idx = torch.remainder(cols - roll[:, None], p).long()
    ids = torch.gather(ids, 1, idx)
    ids = torch.where(cols >= shift[:, None], ids, pad_token_id).to(
        torch.int32)
    pos = torch.clamp(cols - shift[:, None], min=0)
    j = torch.arange(s_max, device=dev)[None, :]
    invalid = (j < shift[:, None]) & (j < p)
    mask = torch.where(invalid, _NEG_INF, 0.0).to(torch.float32)
    return ids, shift, pos, mask[:, None, None, :]
