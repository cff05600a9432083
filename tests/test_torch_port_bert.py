"""BERT of the port (`paddle_tpu_torch.models.bert`) against the JAX
package's (`paddle_tpu.models.bert`), on the CPU: the slice as a whole.

A BERT of 2 layers, hidden 128, 2 heads of 64, intermediate 256 and vocab
512 is built in the JAX package from ``seed(0)``; its ``state_dict()``
goes to the port's model as numpy (`convert.params_from_numpy`, then
`Layer.set_state_dict` under the same structured names).  The batch is
B=2, S=32 with key lengths (32, 20): a [B, 1, 1, S] bool padding mask.

- the names of every parameter, in JAX's order;
- each module in eval mode, weights carried: `BertEmbeddings` (with and
  without token types and positions), `BertPooler`, `BertModel`'s
  sequence and pooled outputs, the classifier's logits;
- fine-tuning with dropout 0.1 at every site (the embeddings, each
  block's attention output after the flash call, its two residual
  branches and its FFN activation, the pooled output) and the padding
  mask: both packages ``seed`` the same number after carrying the
  weights, so every dropout mask is the same bit for bit (JAX's keys);
  three AdamW steps of cross entropy over 2 classes.

Limits.  Logits within 1e-5 max-abs, losses within 1e-5 relative,
parameters within 1e-5 max-abs, or ``2 * LR * STEPS`` where JAX's
gradient of the element falls below ``GRAD_FLOOR`` at some step (Adam's
normalised step turns fp32 noise in a tiny gradient into a step of up to
lr: ROADMAP "Differences by design").  The JAX side runs once, in a
module fixture.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import BertForSequenceClassification as JaxBert
from paddle_tpu.models import bert_base_config as jax_bert_config

import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import (BertForSequenceClassification,
                                     bert_base_config)

CFG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, vocab_size=512)
B, S, LENS = 2, 32, (32, 20)
STEPS, LR, GRAD_FLOOR, SEED = 3, 1e-3, 1e-5, 11


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    types = (np.arange(S)[None, :] >= S // 2).repeat(B, 0).astype(np.int32)
    labels = np.array([0, 1], np.int64)
    mask = np.arange(S)[None, None, None, :] < np.array(LENS)[:, None,
                                                               None, None]
    return ids, types, labels, mask


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's initial weights, then three AdamW steps in training
    mode: each step's logits and loss, the final weights, and per weight
    where its gradient fell below the floor."""
    paddle.seed(0)
    jm = JaxBert(jax_bert_config(**CFG), num_classes=2)
    init = {k: _np(v) for k, v in jm.state_dict().items()}
    names = list(init)
    jm.eval()
    ids, types, labels, mask = _batch()
    tids, tmask = paddle.to_tensor(ids), paddle.to_tensor(mask)
    bert = jm.bert
    modules = {"embeddings": bert.embeddings(tids),
               "embeddings_types": bert.embeddings(
                   tids, paddle.to_tensor(types),
                   paddle.to_tensor(np.arange(S)[::-1].copy()))}
    seq, pooled = bert(tids, attention_mask=tmask)
    modules.update(sequence=seq, pooled=pooled,
                   logits=jm(tids, attention_mask=tmask))
    modules = {k: _np(v) for k, v in modules.items()}
    jm.train()
    opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    paddle.seed(SEED)
    logits, losses, small = [], [], {}
    for _ in range(STEPS):
        out = jm(tids, attention_mask=tmask)
        loss = JF.cross_entropy(out, paddle.to_tensor(labels))
        loss.backward()
        for n, p in jm.named_parameters():
            small[n] = small.get(n, False) | (np.abs(_np(p.grad))
                                              < GRAD_FLOOR)
        opt.step()
        opt.clear_grad()
        logits.append(_np(out))
        losses.append(float(loss.numpy()))
    final = {k: _np(v) for k, v in jm.state_dict().items()}
    return dict(init=init, names=names, modules=modules, logits=logits,
                losses=losses, small=small, final=final)


def _port_model(run):
    pm = BertForSequenceClassification(bert_base_config(**CFG),
                                       num_classes=2, device="cpu")
    missing, unexpected = pm.set_state_dict(
        params_from_numpy(run["init"], device="cpu"))
    assert missing == [] and unexpected == []
    return pm


def test_parameter_names_in_jax_order(jax_run):
    pm = _port_model(jax_run)
    assert list(pm.state_dict()) == jax_run["names"]
    assert "bert.encoder.layers.0.self_attn.q_proj.weight" in jax_run["names"]
    assert pm.bert.embeddings.layer_norm._epsilon == 1e-12
    assert pm.bert.encoder.layers[1].norm1._epsilon == 1e-5


def test_modules_match_jax(jax_run):
    pm = _port_model(jax_run)
    pm.eval()
    ids, types, _, mask = (torch.from_numpy(a) for a in _batch())
    bert = pm.bert
    got = {"embeddings": bert.embeddings(ids),
           "embeddings_types": bert.embeddings(
               ids, types, torch.arange(S - 1, -1, -1))}
    seq, pooled = bert(ids, attention_mask=mask)
    got.update(sequence=seq, pooled=pooled,
               logits=pm(ids, attention_mask=mask))
    for name, want in jax_run["modules"].items():
        np.testing.assert_allclose(_np(got[name]), want, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_fine_tune_with_dropout_matches_jax(jax_run):
    pm = _port_model(jax_run)
    pm.train()
    opt = topt.AdamW(learning_rate=LR, parameters=pm.named_parameters())
    ids, _, labels, mask = (torch.from_numpy(a) for a in _batch())
    paddle_tpu_torch.seed(SEED)
    logits, losses = [], []
    for _ in range(STEPS):
        out = pm(ids, attention_mask=mask)
        loss = PF.cross_entropy(out, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        logits.append(_np(out))
        losses.append(loss.item())
    for step, (g, w) in enumerate(zip(logits, jax_run["logits"])):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5, atol=0)
    assert losses[-1] < losses[0]
    got = {k: _np(v) for k, v in pm.state_dict().items()}
    for name, want in jax_run["final"].items():
        s = jax_run["small"][name]
        np.testing.assert_allclose(got[name][s], want[s],
                                   atol=2 * LR * STEPS, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name][~s], want[~s], atol=1e-5,
                                   rtol=0, err_msg=name)


def test_eval_mode_draws_no_key(jax_run):
    """Without dropout (eval mode) nothing is drawn, in either package."""
    pm = _port_model(jax_run)
    pm.eval()
    state = paddle_tpu_torch.core.random.get_state()
    ids, _, _, mask = (torch.from_numpy(a) for a in _batch())
    pm(ids, attention_mask=mask)
    assert torch.equal(paddle_tpu_torch.core.random.get_state(), state)
