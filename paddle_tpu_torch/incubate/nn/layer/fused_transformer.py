"""Fused transformer layers of the port (`paddle_tpu/incubate/nn/layer/
fused_transformer.py`; reference
`python/paddle/incubate/nn/layer/fused_transformer.py:213,534,750`).

They keep the reference's parameter layout (qkv_weight [3, n, d, h]), so a
state dict carries across both packages, and compute through the fused
functional ops: an unmasked attention without attention dropout is B1
forward and B2/B3 backward on the card.
"""

from __future__ import annotations

from paddle_tpu_torch import nn
from paddle_tpu_torch.incubate.nn import functional as F_inc


class FusedMultiHeadAttention(nn.Layer):
    """reference fused_transformer.py:213."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False, qkv_weight_attr=None,
                 qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None,
                 pre_ln_bias_attr=None, ln_scale_attr=None, ln_bias_attr=None,
                 epsilon=1e-5, nranks=1, ring_id=-1, name=None):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon

        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr,
            default_initializer=nn.initializer.XavierUniform())
        self.qkv_bias = self.create_parameter(
            [3 * num_heads * self.head_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=nn.initializer.XavierUniform())
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr,
            default_initializer=nn.initializer.Constant(1.0))
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr,
            default_initializer=nn.initializer.Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], attr=ln_bias_attr,
                                             is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        return F_inc.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads)


class FusedFeedForward(nn.Layer):
    """reference fused_transformer.py:534."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.d_model = d_model
        self.dim_feedforward = dim_feedforward
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self._epsilon = epsilon

        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr,
            default_initializer=nn.initializer.XavierUniform())
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr,
            default_initializer=nn.initializer.XavierUniform())
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True)
        self.ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr,
            default_initializer=nn.initializer.Constant(1.0))
        self.ln1_bias = self.create_parameter([d_model], attr=ln1_bias_attr,
                                              is_bias=True)
        self.ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr,
            default_initializer=nn.initializer.Constant(1.0))
        self.ln2_bias = self.create_parameter([d_model], attr=ln2_bias_attr,
                                              is_bias=True)

    def forward(self, src, cache=None):
        return F_inc.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self._epsilon, ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Layer):
    """reference fused_transformer.py:750: FusedMHA + FusedFFN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)
