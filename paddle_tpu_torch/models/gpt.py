"""GPT-2 generation over a stripe KV cache (port of the GPT-2 family in
`paddle_tpu/models/generation.py:759-931` and the config of
`paddle_tpu/models/gpt.py:24-37`).

Pre-LN decoder blocks, learned positions, a head tied to the word
embedding. The parameter tree keeps the reference's stacked layout
(`gpt_params_from_layer`, generation.py:781): every matrix [in, out],
the decoder-layer leaves stacked on a leading [num_layers] dim:

    {"word_emb": [V, H], "pos_emb": [P, H],
     "layers": {"ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv",
                "wo", "bo", "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w",
                "fc2_b"} each [L, ...],
     "lnf_w": [H], "lnf_b": [H]}

Attention goes through the Llama path's `generation._cached_attention`,
as the reference shares one function between the two families: a decode
step (s == 1) runs kernel B4, a prefill window of at most
`attention.WINDOW_MAX_ROWS` rows kernel B5, a longer one the plain masked
attention. The learned position table bounds every sequence at
`max_position_embeddings`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.device import check_device, resolve_device
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.llama import _param

__all__ = ["GPTConfig", "GPTGenArgs", "GPT_LAYER_KEYS", "init_gpt_params",
           "Gpt", "gpt_generate"]

GPT_LAYER_KEYS = ("ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv",
                  "wo", "bo", "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w",
                  "fc2_b")


class GPTConfig(NamedTuple):
    """`paddle_tpu.models.gpt.GPTConfig`'s shape fields and defaults
    (GPT-2 small, 124M; the vocab padded to 50304)."""

    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5


class GPTGenArgs(NamedTuple):
    """Static GPT shape (`generation.GPTGenArgs`), plus the FFN width the
    reference reads off its weights (None: 4 × hidden, GPT-2's)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    max_position_embeddings: int
    ln_eps: float = 1e-5
    intermediate_size: Optional[int] = None

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size

    @staticmethod
    def from_config(cfg):
        return GPTGenArgs(cfg.vocab_size, cfg.hidden_size,
                          cfg.num_hidden_layers, cfg.num_attention_heads,
                          cfg.max_position_embeddings,
                          getattr(cfg, "layer_norm_eps", 1e-5),
                          cfg.intermediate_size)


def _shapes(args):
    h, f, L = args.hidden_size, args.ffn_size, args.num_layers
    layers = {k: (L, h) for k in GPT_LAYER_KEYS}
    layers.update(wq=(L, h, h), wk=(L, h, h), wv=(L, h, h), wo=(L, h, h),
                  fc1_w=(L, h, f), fc1_b=(L, f), fc2_w=(L, f, h))
    return {"word_emb": (args.vocab_size, h),
            "pos_emb": (args.max_position_embeddings, h),
            "layers": layers, "lnf_w": (h,), "lnf_b": (h,)}


def init_gpt_params(args: GPTGenArgs, generator=None, *, device=None,
                    dtype=torch.float32):
    """A random GPT tree: matrices and embeddings ~ N(0, 0.02), biases 0,
    LayerNorm weights 1. Drawn on `device` (CUDA unless device="cpu")
    from `generator`, a torch.Generator there (default: seeded 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")

    ones = {"ln1_w", "ln2_w", "lnf_w"}
    zeros = {"ln1_b", "ln2_b", "lnf_b", "bq", "bk", "bv", "bo", "fc1_b",
             "fc2_b"}

    def leaf(key, shape):
        if key in ones:
            return torch.ones(shape, device=dev, dtype=dtype)
        if key in zeros:
            return torch.zeros(shape, device=dev, dtype=dtype)
        w = torch.empty(shape, device=dev, dtype=dtype)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(args)
    out = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return out


def check_tree(params, shapes, device, what):
    """Raise unless `params` has exactly the keys and shapes of `shapes`
    (one level of "layers"), on `device`, in one float dtype."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in params["layers"].items()})
    want = {k: v for k, v in shapes.items() if k != "layers"}
    want.update({f"layers.{k}": v for k, v in shapes["layers"].items()})
    if set(flat) != set(want):
        raise ValueError(f"{what} keys {sorted(flat)} != {sorted(want)}")
    for k, t in flat.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, the config "
                             f"wants {want[k]}")
        check_device(t.device, device, what=f"{what} parameter {k}")
    if len({t.dtype for t in flat.values()}) != 1:
        raise ValueError(f"{what} parameters must share one dtype")


class Gpt(nn.Module):
    """Inference weights of a GPT-2 decoder (no gradients).

    params: a tree as `init_gpt_params` returns it, on `device` (CUDA
    unless device="cpu"); None draws one there from `generator` in
    `dtype`."""

    def __init__(self, args: GPTGenArgs, params=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_gpt_params(args, generator, device=dev, dtype=dtype)
        check_tree(params, _shapes(args), dev, "GPT")
        self.args = args
        for k in ("word_emb", "pos_emb", "lnf_w", "lnf_b"):
            setattr(self, k, _param(params[k]))
        self.layers = nn.ParameterDict(
            {k: _param(params["layers"][k]) for k in GPT_LAYER_KEYS})

    @property
    def device(self):
        return self.word_emb.device

    @property
    def dtype(self):
        """The compute dtype: the embedding's."""
        return self.word_emb.dtype

    def layer(self, i):
        """Layer i's weights as a dict of views."""
        return {k: v[i] for k, v in self.layers.items()}

    def forward(self, ids, caches_k, caches_v, pos, last_idx=None):
        """`_gpt_forward_cached`: next-token logits [b, vocab] f32; the
        caches are written in place."""
        return _gpt_forward_cached(self, ids, caches_k, caches_v, pos,
                                   last_idx)


def _layer_norm(x, w, b, eps):
    """LayerNorm in the reference's rounding order (generation.py:818):
    normalise in f32, cast to x's dtype, then `* w + b` in that dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _gpt_layer_step(lp, h, cache_k, cache_v, pos, args: GPTGenArgs):
    """One pre-LN block over h [b, s, hid] with this layer's cache [b, nh,
    max_len, hd], written in place before attending. pos: an int (rows at
    one depth, slots [pos, pos+s) written) or an int32 [b] tensor (s must
    be 1: the serving decode step, row r at pos[r])."""
    b, s = h.shape[0], h.shape[1]
    nh, hd = args.num_heads, args.head_dim
    hin = _layer_norm(h, lp["ln1_w"], lp["ln1_b"], args.ln_eps)
    q = (hin @ lp["wq"] + lp["bq"]).view(b, s, nh, hd)
    k = (hin @ lp["wk"] + lp["bk"]).view(b, s, nh, hd)
    v = (hin @ lp["wv"] + lp["bv"]).view(b, s, nh, hd)
    if torch.is_tensor(pos) and pos.dim() == 1:
        if s != 1:
            raise ValueError(f"per-row pos vector requires s == 1 (got s={s})")
        rows = torch.arange(b, device=h.device)
        cache_k[rows, :, pos.long()] = k[:, 0]
        cache_v[rows, :, pos.long()] = v[:, 0]
    else:
        p = int(pos)
        cache_k[:, :, p:p + s] = k.transpose(1, 2)
        cache_v[:, :, p:p + s] = v.transpose(1, 2)
    attn = gen._cached_attention(q, cache_k, cache_v, pos)
    h = h + (attn.reshape(b, s, nh * hd) @ lp["wo"] + lp["bo"])
    hin = _layer_norm(h, lp["ln2_w"], lp["ln2_b"], args.ln_eps)
    act = F.gelu(hin @ lp["fc1_w"] + lp["fc1_b"])
    return h + (act @ lp["fc2_w"] + lp["fc2_b"])


@torch.no_grad()
def _gpt_forward_cached(model, ids, caches_k, caches_v, pos, last_idx=None):
    """ids [b, s] -> (next-token logits [b, vocab] f32, caches_k,
    caches_v), the caches [L, b, nh, max_len, hd] written in place. pos:
    an int, or an int32 [b] tensor of per-row positions (s == 1).
    last_idx: the last real token of each row (an int or a [b] tensor) —
    padded prefills take their logits there; None takes h[:, -1]."""
    args = model.args
    b, s = ids.shape
    steps = torch.arange(s, device=ids.device)
    if torch.is_tensor(pos) and pos.dim() == 1:
        pe = model.pos_emb[pos.long()[:, None] + steps[None]]
    else:
        pe = model.pos_emb[int(pos) + steps][None]
    h = model.word_emb[ids.long()] + pe
    for i in range(args.num_layers):
        h = _gpt_layer_step(model.layer(i), h, caches_k[i], caches_v[i],
                            pos, args)
    h = _layer_norm(h, model.lnf_w, model.lnf_b, args.ln_eps)
    if last_idx is None:
        hl = h[:, -1]
    else:
        idx = torch.as_tensor(last_idx, device=h.device).long()
        hl = h[torch.arange(b, device=h.device), idx.reshape(-1).expand(b)]
    return (hl @ model.word_emb.t()).float(), caches_k, caches_v


def gpt_cache(model, b, max_len):
    """Zeroed stripe caches [L, b, nh, max_len, hd] in the model dtype."""
    a = model.args
    ck = torch.zeros((a.num_layers, b, a.num_heads, max_len, a.head_dim),
                     dtype=model.dtype, device=model.device)
    return ck, torch.zeros_like(ck)


def gpt_generate(model, prompt_ids, max_new_tokens=32, temperature=0.0,
                 top_p=1.0, generator=None, eos_token_id=None,
                 pad_token_id=0, device=None):
    """`generation.gpt_generate`: max_new_tokens after the prompt [b, s];
    returns [b, s + max_new_tokens] int32, with `generate`'s sampling and
    EOS semantics (rows that emit eos_token_id produce pad_token_id
    afterwards). The learned position table bounds s + max_new_tokens."""
    dev = resolve_device(device)
    check_device(model.device, dev)
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int32)).to(dev)
    if max_new_tokens <= 0:
        return ids
    b, s = ids.shape
    if s + max_new_tokens > model.args.max_position_embeddings:
        raise ValueError(
            f"prompt {s} + max_new_tokens {max_new_tokens} exceeds the "
            f"learned position table ({model.args.max_position_embeddings})")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = bool(np.any(np.asarray(temperature) != 0.0))
    ck, cv = gpt_cache(model, b, s + max_new_tokens)

    def fwd(x, pos):
        return _gpt_forward_cached(model, x, ck, cv, pos)[0]

    use_eos = eos_token_id is not None
    return gen._decode_loop(fwd, ids, max_new_tokens, sample,
                            temperature if sample else 1.0, top_p, generator,
                            use_eos, int(eos_token_id) if use_eos else 0,
                            int(pad_token_id))
