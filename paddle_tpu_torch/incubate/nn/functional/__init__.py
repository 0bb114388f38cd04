"""Fused functional ops of the port (`paddle_tpu/incubate/nn/functional/
__init__.py`; reference `python/paddle/incubate/nn/functional/`, backed by
`paddle/phi/kernels/fusion/gpu/*`).

The API is the reference's, so incubate users port unchanged. Two of them
reach the port's kernels through the same gates as the rest of
`nn.functional`:
  - `fused_multi_head_attention` computes its attention with
    `F.scaled_dot_product_attention`: unmasked and without attention
    dropout in training, on B1's gate, it is kernel B1 forward and B2/B3
    backward on the card; otherwise the plain softmax(QKᵀ)V;
  - `fused_rms_norm` is `F.rms_norm` (B9 forward and B10 backward on the
    card and on B9's gate), whose plain version is the JAX package's
    composite: f32 statistics, the normalized value cast to x's dtype,
    then times the weight.
The rest are plain PyTorch compositions of the JAX package's.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply

__all__ = [
    "fused_multi_head_attention", "fused_feedforward", "fused_linear",
    "fused_bias_dropout_residual_layer_norm", "fused_rms_norm",
    "fused_rotary_position_embedding", "swiglu", "fused_dropout_add",
    "fused_layer_norm", "masked_multihead_attention", "fused_moe",
]


def swiglu(x, y=None, name=None):
    """reference `incubate/nn/functional/swiglu.py`: silu(x) * y (or split)."""
    if y is None:
        def fn(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return torch.nn.functional.silu(a1) * a2

        return apply(fn, x, _name="swiglu")
    return apply(lambda a, b: torch.nn.functional.silu(a) * b, x, y,
                 _name="swiglu")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    def fn(a, w, *b):
        w = w.T if transpose_weight else w
        out = a @ w
        return out + b[0] if b else out

    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, _name="fused_linear")


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, name=None):
    """reference fused_rms_norm (phi fusion kernel), over the last axis with
    f32 statistics: `F.rms_norm` (B9/B10 on the card), plus the bias."""
    from paddle_tpu_torch.nn.functional.norm import rms_norm

    out = rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        out = apply(torch.add, out, norm_bias, _name="fused_rms_norm")
    return out


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    name=None):
    """reference `incubate/nn/functional/fused_rotary_position_embedding`;
    q/k: [b, s, h, d]."""
    from paddle_tpu_torch.models.llama_functional import (apply_rope,
                                                          rope_tables)

    def fn(qd, kd):
        s, d = qd.shape[1], qd.shape[-1]
        if sin is None:
            c, sn = rope_tables(s, d, 10000.0, qd.device)
        else:
            # the tables are constants of the op, as in the JAX package
            c = (cos._data if isinstance(cos, Tensor) else
                 torch.as_tensor(cos)).detach().reshape(s, d).to(qd.device)
            sn = (sin._data if isinstance(sin, Tensor) else
                  torch.as_tensor(sin)).detach().reshape(s, d).to(qd.device)
        return apply_rope(qd, kd, c, sn)

    if k is None:
        out = apply(lambda qd: fn(qd, qd)[0], q, _name="fused_rope")
        return out, None, None
    qo, ko = apply(fn, q, k, _name="fused_rope")
    return qo, ko, v


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    from paddle_tpu_torch.nn.functional.common import dropout

    return dropout(x, p=p, training=training, mode=mode) + y


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, mode="upscale_in_train",
                                           name=None):
    """reference fused_bias_dropout_residual_layer_norm
    (`fusion/gpu/fused_bias_dropout_residual_layer_norm_kernel.cu`)."""
    from paddle_tpu_torch.nn.functional.common import dropout
    from paddle_tpu_torch.nn.functional.norm import layer_norm

    h = x if bias is None else x + bias
    h = dropout(h, p=dropout_rate, training=training, mode=mode)
    h = h + residual
    return layer_norm(h, h.shape[-1:], weight=ln_scale, bias=ln_bias,
                      epsilon=ln_epsilon)


def fused_multi_head_attention(x, qkv_weight, linear_weight, pre_layer_norm=False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               name=None):
    """reference FusedMultiHeadAttention functional
    (`incubate/nn/layer/fused_transformer.py:213`): [pre-LN ->] qkv matmul ->
    attention (B1-B3 when unmasked, on the card) -> out proj -> dropout ->
    [residual] -> [post-LN]."""
    from paddle_tpu_torch.nn.functional.common import dropout
    from paddle_tpu_torch.nn.functional.flash_attention import \
        scaled_dot_product_attention
    from paddle_tpu_torch.nn.functional.norm import layer_norm

    residual = x
    if pre_layer_norm:
        x = layer_norm(x, x.shape[-1:], weight=pre_ln_scale, bias=pre_ln_bias,
                       epsilon=pre_ln_epsilon)
    b, s, h = x.shape
    # qkv_weight: [3, n_heads, head_dim, h] (the reference layout)
    nh = qkv_weight.shape[1]
    hd = qkv_weight.shape[2]

    def qkv_fn(a, w, *bias):
        qkv = torch.einsum("bsh,tndh->tbsnd", a, w)
        if bias:
            qkv = qkv + bias[0].reshape(3, 1, 1, nh, hd)
        return qkv[0], qkv[1], qkv[2]

    args = (x, qkv_weight) + ((qkv_bias,) if qkv_bias is not None else ())
    q, k, v = apply(qkv_fn, *args, _name="fused_qkv")
    out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                       dropout_p=attn_dropout_rate,
                                       is_causal=False, training=training)
    out = apply(lambda o: o.reshape(b, s, nh * hd), out, _name="reshape")
    proj_args = (out, linear_weight) + ((linear_bias,) if linear_bias is not None else ())
    out = apply(lambda o, w, *bb: (o @ w) + bb[0] if bb else o @ w,
                *proj_args, _name="fused_out_proj")
    out = dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = layer_norm(out, out.shape[-1:], weight=ln_scale, bias=ln_bias,
                         epsilon=ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None):
    """reference FusedFeedForward (`incubate/nn/layer/fused_transformer.py:534`)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional.common import dropout
    from paddle_tpu_torch.nn.functional.norm import layer_norm

    residual = x
    if pre_layer_norm:
        x = layer_norm(x, x.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                       epsilon=ln1_epsilon)
    act = getattr(F, activation)
    h = apply(lambda a, w: a @ w, x, linear1_weight, _name="ffn1")
    if linear1_bias is not None:
        h = h + linear1_bias
    h = act(h)
    h = dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = apply(lambda a, w: a @ w, h, linear2_weight, _name="ffn2")
    if linear2_bias is not None:
        h = h + linear2_bias
    h = dropout(h, p=dropout2_rate, training=training, mode=mode)
    if add_residual:
        h = residual + h
    if not pre_layer_norm:
        h = layer_norm(h, h.shape[-1:], weight=ln2_scale, bias=ln2_bias,
                       epsilon=ln2_epsilon)
    return h


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=1, bias=None, residual=None, name=None):
    """reference fused_layer_norm (norm_helper.h fusion): optional
    bias+residual add, then LayerNorm over the trailing axes, fp32 stats.
    Returns (out, residual_out) when residual is given, else out."""
    def fn(a, w, b2, *extra):
        off = 0
        if bias is not None:
            a = a + extra[off]
            off += 1
        res_out = None
        if residual is not None:
            a = a + extra[off]
            res_out = a
        a32 = a.float()
        axes = tuple(range(begin_norm_axis % a.ndim, a.ndim))
        mu = a32.mean(dim=axes, keepdim=True)
        var = a32.var(dim=axes, unbiased=False, keepdim=True)
        out = ((a32 - mu) * torch.rsqrt(var + epsilon)).to(a.dtype)
        # the reference's convention: weight/bias are 1-D over the
        # flattened normalized tail; reshape them to broadcast over it
        tail = tuple(a.shape[begin_norm_axis % a.ndim:])
        out = out * w.reshape(tail) + b2.reshape(tail)
        return (out, res_out) if res_out is not None else out

    args = [x, norm_weight, norm_bias]
    if bias is not None:
        args.append(bias)
    if residual is not None:
        args.append(residual)
    return apply(fn, *args, _name="fused_layer_norm")


def masked_multihead_attention(x, cache_kv, src_mask=None, seq_len=None,
                               rotary_embs=None, beam_width=1, name=None):
    """Single-token decode attention against a KV cache (reference
    masked_multihead_attention_ kernel used by generation). x: [B, 3*H*D]
    packed qkv for one step; cache_kv: [2, B, H, max_len, D]; seq_len: the
    current cache length (int); rotary_embs: optional (cos, sin) tables
    [max_len, D] applied to q/k at position seq_len. Returns
    (out [B, H*D], new_cache). Plain PyTorch: one query a row, as the JAX
    package computes it."""
    if beam_width != 1:
        raise NotImplementedError(
            "beam_width > 1 (beam-search cache layout) is not supported")
    t = seq_len if seq_len is not None else 0
    m = src_mask._data if isinstance(src_mask, Tensor) else src_mask
    rot = None
    if rotary_embs is not None:
        rot = tuple(r._data if isinstance(r, Tensor) else torch.as_tensor(r)
                    for r in rotary_embs)

    def fn(xd, cache):
        _, b, h, max_len, d = cache.shape
        q, k, v = torch.split(xd.reshape(b, 3, h, d), 1, dim=1)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [B, H, D]
        if rot is not None:
            cos, sin = rot[0][t].to(xd.device), rot[1][t].to(xd.device)

            def rope(u):
                u1, u2 = torch.chunk(u.float(), 2, dim=-1)
                ur = torch.cat([-u2, u1], dim=-1)
                return (u.float() * cos + ur * sin).to(u.dtype)

            q, k = rope(q), rope(k)
        cache = cache.clone()
        cache[0, :, :, t] = k
        cache[1, :, :, t] = v
        keys, vals = cache[0], cache[1]  # [B, H, L, D]
        logits = torch.einsum("bhd,bhld->bhl", q.float(),
                              keys.float()) / math.sqrt(d)
        pos_mask = torch.arange(max_len, device=xd.device)[None, None, :] <= t
        logits = torch.where(pos_mask, logits, -1e30)
        if m is not None:
            logits = logits + m.to(logits.dtype).reshape(
                b, 1, -1)[..., :max_len]
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhl,bhld->bhd", probs, vals.float())
        return out.reshape(b, h * d).to(xd.dtype), cache

    return apply(fn, x, cache_kv, _name="masked_multihead_attention")


def fused_moe(x, gate_weight, expert_weights1, expert_weights2, k=2,
              name=None):
    """Token-choice MoE (reference fused_moe.py): softmax gate -> top-k
    dispatch -> stacked-expert FFN (tanh-approximated GELU, as the JAX
    package's `jax.nn.gelu`) -> weighted combine. expert_weights1:
    [E, H, I]; expert_weights2: [E, I, H]."""
    def fn(a, gw, w1, w2):
        b = a.reshape(-1, a.shape[-1])  # [T, H]
        logits = b @ gw  # [T, E]
        probs = torch.softmax(logits, dim=-1)
        topv, topi = torch.topk(probs, k, dim=-1)  # [T, k]
        topv = topv / topv.sum(dim=-1, keepdim=True)
        # dense dispatch: every expert sees every token, the combine is
        # masked (the reference's scatter path saves memory on the GPU)
        hidden = torch.einsum("th,ehi->tei", b, w1)
        hidden = torch.nn.functional.gelu(hidden, approximate="tanh")
        expert_out = torch.einsum("tei,eih->teh", hidden, w2)  # [T, E, H]
        weight = torch.zeros_like(probs).scatter(1, topi, topv)
        out = torch.einsum("teh,te->th", expert_out, weight)
        return out.reshape(a.shape)

    return apply(fn, x, gate_weight, expert_weights1, expert_weights2,
                 _name="fused_moe")
