"""GPT decoder, stacked-blocks form — the port of the parts of
`paddle_tpu/models/gpt.py` that serving and pretraining run.

`GPTForCausalLM` holds every block's weights stacked as ``[L, ...]``
parameters under the names and shapes of `GPTStackedBlocks`, plus ``wte``,
``wpe``, ``lnf_w`` and ``lnf_b``; `param_arrays` returns them keyed like
the JAX engine's ``_param_arrays``.  The block arithmetic is
`_stacked_block_body` (pre-LN, tanh-GELU MLP, learned positions).
``forward`` returns logits and ``pretrain_loss`` the causal-LM loss, both
differentiable: attention goes through the flash kernels' autograd
Function on the card.

Left out for later slices: MoE, pipeline execution (and the 1F1B fused
loss), dropout, ``segment_ids``, ``recompute``, and the dense
``generate``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.functional import cross_entropy, layer_norm_arrays
from ..ops.flash_attention import flash_attention_arrays

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "gpt_test_config",
           "gpt2_124m_config", "gpt3_1p3b_config", "gpt3_6p7b_config"]


@dataclasses.dataclass
class GPTConfig:
    """The fields of the JAX `GPTConfig` that the port reads.  The others
    (dropout, MoE, sequence/context/pipeline parallelism, recompute, the
    block layout) select behaviour the port does not have yet, so they
    cannot be set: the port always runs the stacked-blocks layout on one
    device, without dropout."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5


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


class GPTForCausalLM(nn.Module):
    """Stacked-blocks GPT with a tied LM head.

    Weights are drawn on the CPU from ``generator`` (a seeded
    `torch.Generator`; default: a fresh one seeded 0) — normal with std
    ``initializer_range`` for the matrices and embeddings, ones for the
    LayerNorm scales, zeros for biases — then moved to ``device``, so one
    seed gives the same model on every device."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
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

    def forward(self, input_ids, position_ids=None):
        """[B, S] token ids -> [B, S, vocab] logits in the weights' dtype:
        ``wte[ids] + wpe[pos]``, the blocks with causal flash attention,
        the final `layer_norm_arrays`, then the tied head ``h @ wte.T`` —
        the non-pipeline branch of the JAX ``GPTModel.forward`` and
        ``GPTForCausalLM.forward``.  ``position_ids`` defaults to
        ``0 .. S-1``."""
        cfg = self.cfg
        dev = self.wte.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        pos = (torch.arange(ids.shape[-1], device=dev)
               if position_ids is None
               else torch.as_tensor(position_ids, device=dev).long())
        h = self.wte[ids] + self.wpe[pos]
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        eps = cfg.layer_norm_epsilon
        for layer in range(cfg.num_hidden_layers):
            p = {n: getattr(self, n)[layer] for n in BLOCK_PARAMS}
            h, _ = _stacked_block_body(p, h, _causal_attn, nh, hd, eps)
        h = layer_norm_arrays(h, self.lnf_w, self.lnf_b, eps)
        return h @ self.wte.t()

    def pretrain_loss(self, input_ids, labels, loss_mask=None,
                      position_ids=None):
        """``GPTPretrainingCriterion()(self(input_ids), labels,
        loss_mask)`` — the non-1F1B branch of the JAX ``pretrain_loss``."""
        return GPTPretrainingCriterion(self.cfg)(
            self(input_ids, position_ids), labels, loss_mask)

    def param_arrays(self) -> dict:
        """{name: tensor} keyed like the JAX engine's ``_param_arrays``."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def load_params(self, params: dict) -> "GPTForCausalLM":
        """Copy tensors keyed like `param_arrays` into this model (cast to
        its device and dtype); every name must be present, shapes must
        match."""
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
