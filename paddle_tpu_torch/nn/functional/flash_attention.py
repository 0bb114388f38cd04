"""Flash attention on the eager Tensor (`paddle_tpu/nn/functional/
flash_attention.py`; reference dispatch
`python/paddle/nn/functional/flash_attention.py:486-530`).

Layout is Paddle's [batch, seqlen, nheads, headdim]. A call routes by
shape before it launches anything, as the JAX package's `_use_pallas`
(:56) does:
  - no mask, no dropout in training, and B1's gate
    (`kernels.flash_attention.supports`: head_dim 64/128, H % Hk == 0, one
    dtype of bf16/f32) -> kernel B1 through the differentiable
    `flash_attention_fwd`, on q/k/v made dense first (a strided view, such
    as q/k/v split off a fused projection, is copied, not sent elsewhere);
    backward runs B2 and B3. On a CPU tensor the wrappers run their plain
    versions;
  - anything else -> a plain PyTorch softmax(QKᵀ)V (`_sdpa_reference`),
    with attention dropout drawn from the framework generator.
A failed build or launch raises: nothing falls back to the plain path, and
no switch changes the route.

`flash_attn_unpadded` and `sdp_kernel` are ported with the rest of nn
(ROADMAP A10b).
"""

import math

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.kernels import flash_attention as _fa


def _sdpa_reference(q, k, v, causal=False, dropout=0.0, scale=None,
                    mask=None, generator=None):
    """softmax(QKᵀ·scale)V over [B, L, H, D] in f32 probabilities; GQA by
    repeating kv heads; a bool mask keeps True; dropout on the
    probabilities before the value product."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.to(logits.dtype)
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = torch.where(keep, logits, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    if dropout > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=generator) < 1.0 - dropout
        probs = torch.where(keep, probs / (1.0 - dropout), 0.0)
    out = torch.matmul(probs.to(q.dtype), vh)
    return out.transpose(1, 2)


def _use_kernel(q, k, v, dropout=0.0, training=True, mask=None):
    if mask is not None:
        return False
    if dropout > 0.0 and training:
        # B1-B3 are deterministic; attention dropout takes the plain path
        return False
    return _fa.supports(q, k, v)


def _dense(t):
    """t as B1 reads it: contiguous and 16-byte aligned (a fresh copy,
    differentiable, when a view is not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _attend(query, key, value, causal, dropout, training, mask, name):
    drop = dropout if training else 0.0

    def fn(q, k, v):
        if _use_kernel(q, k, v, drop, training, mask):
            return _fa.flash_attention_fwd(_dense(q), _dense(k), _dense(v),
                                           causal=causal)
        gen = _rng.generator(q.device) if drop > 0.0 else None
        return _sdpa_reference(q, k, v, causal=causal, dropout=drop,
                               mask=mask, generator=gen)

    return apply(fn, query, key, value, _name=name)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """(out [B, S, H, D], None): attention of query over key/value, which
    may carry fewer (kv) heads."""
    return _attend(query, key, value, causal, dropout, training, None,
                   "flash_attention"), None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """Packed QKV (reference flash_attn_qkvpacked): qkv [b, s, 3, h, d]
    unpacked into q, k, v, then `flash_attention`."""
    from paddle_tpu_torch.ops.manipulation import split, squeeze

    q, k, v = (squeeze(t, axis=2) for t in split(qkv, 3, axis=2))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    mask = attn_mask._data if isinstance(attn_mask, Tensor) else attn_mask
    return _attend(query, key, value, is_causal, dropout_p, training, mask,
                   "sdpa")
