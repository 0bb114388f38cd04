"""Transformer layers (`paddle_tpu/nn/layer/transformer.py`; reference
`python/paddle/nn/layer/transformer.py`)."""

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn.layer.common import Linear, Dropout
from paddle_tpu_torch.nn.layer.norm import LayerNorm
from paddle_tpu_torch.nn.layer.container import LayerList
from paddle_tpu_torch.nn import functional as F
import paddle_tpu_torch.ops.manipulation as _mp
import paddle_tpu_torch.ops.linalg as _la
import paddle_tpu_torch.ops.math as _m


class MultiHeadAttention(Layer):
    """reference: `python/paddle/nn/layer/transformer.py` MultiHeadAttention.

    Attention runs `F.scaled_dot_product_attention`: with no mask and no
    dropout, on B1's gate (head_dim 64/128, bf16 or f32), kernel B1 forward
    and B2/B3 backward on the card; else the plain softmax(QK^T)V.
    """

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, lq = query.shape[0], query.shape[1]
        lk = key.shape[1]

        q = _mp.reshape(self.q_proj(query), [b, lq, self.num_heads, self.head_dim])
        k = _mp.reshape(self.k_proj(key), [b, lk, self.num_heads, self.head_dim])
        v = _mp.reshape(self.v_proj(value), [b, lk, self.num_heads, self.head_dim])

        if cache is not None:
            k = _mp.concat([cache.k, k], axis=1)
            v = _mp.concat([cache.v, v], axis=1)

        mask = attn_mask
        if mask is not None and mask.ndim == 3:
            mask = _mp.unsqueeze(mask, 1)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=self.dropout if self.training else 0.0)
        out = _mp.reshape(out, [b, lq, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None:
            return out, type(cache)(k, v)
        return out

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def gen_cache(self, key, value=None, type=None):
        b = key.shape[0]
        import paddle_tpu_torch as paddle

        k = paddle.zeros([b, 0, self.num_heads, self.head_dim], dtype=key.dtype)
        v = paddle.zeros([b, 0, self.num_heads, self.head_dim], dtype=key.dtype)
        return MultiHeadAttention.Cache(k, v)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout if act_dropout is not None else dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout if attn_dropout is not None else dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout if act_dropout is not None else dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before)
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before)
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              LayerNorm(d_model) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=_device.place()).tril()
        return Tensor(torch.where(keep, 0.0, float("-inf")))
