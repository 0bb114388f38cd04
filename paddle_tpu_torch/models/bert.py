"""BERT encoder forward (port of `paddle_tpu/models/bert.py:21-83`).

The embeddings (word + position + token type when given, then LayerNorm
at the config's ε), post-LN encoder layers as `paddle_tpu.nn.layer
.transformer.TransformerEncoderLayer` computes them
(`normalize_before=False`, exact GELU, its LayerNorm ε 1e-5: `BertModel`
does not pass the config's), then the pooler, tanh over h[:, 0].

A 0/1 attention mask [b, s] becomes the reference's additive mask
(1 - mask) · -1e4 in f32, broadcast as [b, 1, 1, s]. With a mask the
reference never reaches a Pallas kernel (`_use_pallas` is False), so the
attention here is plain torch, as its `_sdpa_reference`: scores in the
model dtype scaled by 1/sqrt(hd), the mask added, softmax in f32, the
probabilities cast back before P V.

The tree keeps the reference layout ([in, out] matrices), the encoder
layers stacked on a leading [num_layers] dim:

    {"word_emb": [V, H], "pos_emb": [P, H], "type_emb": [T, H],
     "emb_ln_w": [H], "emb_ln_b": [H],
     "layers": {"wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln1_w",
                "ln1_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ln2_w",
                "ln2_b"} each [L, ...],
     "pool_w": [H, H], "pool_b": [H]}
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.gpt import _layer_norm, check_tree
from paddle_tpu_torch.models.llama import _param

__all__ = ["BertConfig", "BERT_LAYER_KEYS", "init_bert_params", "Bert",
           "bert_forward"]

BERT_LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln1_w",
                   "ln1_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ln2_w",
                   "ln2_b")
# TransformerEncoderLayer's default (transformer.py:79): the encoder's norms
ENCODER_LN_EPS = 1e-5
MASK_VALUE = -1e4


class BertConfig(NamedTuple):
    """`paddle_tpu.models.bert.BertConfig`'s shape fields and defaults
    (BERT-base)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def _shapes(cfg):
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    layers = {k: (L, h) for k in BERT_LAYER_KEYS}
    layers.update(wq=(L, h, h), wk=(L, h, h), wv=(L, h, h), wo=(L, h, h),
                  fc1_w=(L, h, f), fc1_b=(L, f), fc2_w=(L, f, h))
    return {"word_emb": (cfg.vocab_size, h),
            "pos_emb": (cfg.max_position_embeddings, h),
            "type_emb": (cfg.type_vocab_size, h), "emb_ln_w": (h,),
            "emb_ln_b": (h,), "layers": layers, "pool_w": (h, h),
            "pool_b": (h,)}


def init_bert_params(cfg: BertConfig, generator=None, *, device=None,
                     dtype=torch.float32):
    """A random BERT tree: matrices and embeddings ~ N(0, 0.02), biases 0,
    LayerNorm weights 1; each layer drawn on its own. On `device` (CUDA
    unless device="cpu") from `generator` (default: seeded 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    ones = {"emb_ln_w", "ln1_w", "ln2_w"}
    zeros = {"emb_ln_b", "ln1_b", "ln2_b", "pool_b", "bq", "bk", "bv", "bo",
             "fc1_b", "fc2_b"}

    def leaf(key, shape):
        if key in ones:
            return torch.ones(shape, device=dev, dtype=dtype)
        if key in zeros:
            return torch.zeros(shape, device=dev, dtype=dtype)
        w = torch.empty(shape, device=dev, dtype=dtype)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(cfg)
    out = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return out


class Bert(nn.Module):
    """Inference weights of a BERT encoder (no gradients).

    params: a tree as `init_bert_params` returns it, on `device` (CUDA
    unless device="cpu"); None draws one there from `generator` in
    `dtype`."""

    def __init__(self, cfg: BertConfig, params=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_bert_params(cfg, generator, device=dev, dtype=dtype)
        check_tree(params, _shapes(cfg), dev, "BERT")
        self.cfg = cfg
        for k in ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b",
                  "pool_w", "pool_b"):
            setattr(self, k, _param(params[k]))
        self.layers = nn.ParameterDict(
            {k: _param(params["layers"][k]) for k in BERT_LAYER_KEYS})

    @property
    def device(self):
        return self.word_emb.device

    @property
    def dtype(self):
        return self.word_emb.dtype

    def layer(self, i):
        return {k: v[i] for k, v in self.layers.items()}

    def forward(self, ids, attention_mask=None, token_type_ids=None):
        """`bert_forward`: (h [b, s, H], pooled [b, H])."""
        return bert_forward(self, ids, attention_mask, token_type_ids)


def _self_attention(q, k, v, mask):
    """The reference's `_sdpa_reference` with an additive mask: q/k/v
    [b, s, nh, hd] -> [b, s, nh, hd]."""
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)) * \
        (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return (probs @ v.transpose(1, 2)).transpose(1, 2)


def _encoder_layer(lp, h, mask, nh):
    """A post-LN encoder layer (`TransformerEncoderLayer.forward`,
    normalize_before=False)."""
    b, s, H = h.shape
    hd = H // nh
    q = (h @ lp["wq"] + lp["bq"]).view(b, s, nh, hd)
    k = (h @ lp["wk"] + lp["bk"]).view(b, s, nh, hd)
    v = (h @ lp["wv"] + lp["bv"]).view(b, s, nh, hd)
    a = _self_attention(q, k, v, mask).reshape(b, s, H) @ lp["wo"] + lp["bo"]
    h = _layer_norm(h + a, lp["ln1_w"], lp["ln1_b"], ENCODER_LN_EPS)
    f = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
    return _layer_norm(h + f, lp["ln2_w"], lp["ln2_b"], ENCODER_LN_EPS)


@torch.no_grad()
def bert_forward(model, ids, attention_mask=None, token_type_ids=None):
    """ids [b, s] (and a 0/1 attention_mask [b, s], token_type_ids [b, s])
    -> (h [b, s, H], pooled [b, H]) in the model dtype."""
    cfg = model.cfg
    s = ids.shape[1]
    h = model.word_emb[ids.long()] + model.pos_emb[:s]
    if token_type_ids is not None:
        h = h + model.type_emb[token_type_ids.long()]
    h = _layer_norm(h, model.emb_ln_w, model.emb_ln_b, cfg.layer_norm_eps)
    mask = None
    if attention_mask is not None:
        if attention_mask.dim() != 2:
            raise ValueError(f"attention_mask must be a 0/1 [b, s] mask, "
                             f"got shape {tuple(attention_mask.shape)}")
        mask = ((1.0 - attention_mask.float()) * MASK_VALUE)[:, None, None]
    for i in range(cfg.num_hidden_layers):
        h = _encoder_layer(model.layer(i), h, mask, cfg.num_attention_heads)
    pooled = torch.tanh(h[:, 0] @ model.pool_w + model.pool_b)
    return h, pooled
