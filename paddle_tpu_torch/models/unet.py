"""Diffusion UNet (`paddle_tpu/models/unet.py`; config 5 of BASELINE:
Stable-Diffusion UNet inference through the Predictor, the model family
the reference serves with `AnalysisPredictor`,
`paddle/fluid/inference/api/analysis_predictor.cc`).

Built from the port's own nn layers, with the JAX package's layer names
and state-dict keys, so `models.weights.layer_from_numpy` carries a JAX
UNet's state across unchanged (Conv2D weights [out, in, kh, kw], Linear
weights [in, out] in both packages). The spatial attention goes through
`nn.functional.flash_attention.scaled_dot_product_attention`, which routes
an inference call by B1's gate: head_dim 32, 64 or 128 in bf16, fp16 or
f32 launches B1, anything else takes the plain attention (a call that
needs a gradient routes by B2/B3's gate, head_dim 64 or 128 in bf16 or
f32). At `unet_sd_like`'s 64x64 latents every attention block launches B1
in bf16 and in fp16: level 1 (1024 tokens, head_dim 32), level 2 and the
middle block (256 tokens, head_dim 64).

Every shape the forward computes from the input's keeps the batch as it
comes (a `torch.SymInt` under `torch.export`), so `jit.save` with a
dynamic batch serves any batch from one program.
"""

from __future__ import annotations

import math

import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.nn.functional.flash_attention import \
    scaled_dot_product_attention

__all__ = ["UNetModel", "unet_tiny", "unet_sd_like"]


class TimestepEmbedding(nn.Layer):
    """Sinusoidal timestep features + 2-layer MLP (SD time_embed)."""

    def __init__(self, base_channels, out_dim):
        super().__init__()
        self.base = base_channels
        self.fc1 = nn.Linear(base_channels, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)
        self.act = nn.SiLU()

    def forward(self, t):
        half = self.base // 2

        def sinusoid(tt):
            freqs = torch.exp(-math.log(10000.0) * torch.arange(
                half, dtype=torch.float32, device=tt.device) / half)
            args = tt.to(torch.float32)[:, None] * freqs[None, :]
            return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

        emb = apply(sinusoid, t, _name="timestep_embedding")
        # deploy precision: bf16 weights must not promote to f32
        emb = emb.astype(self.fc1.weight.dtype)
        return self.fc2(self.act(self.fc1(emb)))


class ResnetBlock(nn.Layer):
    def __init__(self, c_in, c_out, temb_dim, groups=8):
        super().__init__()
        self.norm1 = nn.GroupNorm(min(groups, c_in), c_in)
        self.conv1 = nn.Conv2D(c_in, c_out, 3, padding=1)
        self.temb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = nn.GroupNorm(min(groups, c_out), c_out)
        self.conv2 = nn.Conv2D(c_out, c_out, 3, padding=1)
        self.act = nn.SiLU()
        self.skip = (nn.Conv2D(c_in, c_out, 1) if c_in != c_out
                     else None)

    def forward(self, x, temb):
        h = self.conv1(self.act(self.norm1(x)))
        t = self.temb_proj(self.act(temb))
        h = h + paddle.unsqueeze(paddle.unsqueeze(t, -1), -1)
        h = self.conv2(self.act(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Layer):
    """Spatial self-attention over H*W tokens (SD attention blocks)."""

    def __init__(self, channels, num_heads=4, groups=8):
        super().__init__()
        self.norm = nn.GroupNorm(min(groups, channels), channels)
        self.qkv = nn.Conv2D(channels, channels * 3, 1)
        self.proj = nn.Conv2D(channels, channels, 1)
        self.num_heads = num_heads
        self.channels = channels

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(self.norm(x))  # [B, 3C, H, W]
        qkv = paddle.reshape(qkv, [b, 3, c, h * w])
        qkv = paddle.transpose(qkv, [1, 0, 3, 2])  # [3, B, HW, C]
        q, k, v = qkv[0], qkv[1], qkv[2]
        hd = c // self.num_heads
        q = paddle.reshape(q, [b, h * w, self.num_heads, hd])
        k = paddle.reshape(k, [b, h * w, self.num_heads, hd])
        v = paddle.reshape(v, [b, h * w, self.num_heads, hd])
        out = scaled_dot_product_attention(q, k, v)
        out = paddle.reshape(out, [b, h * w, c])
        out = paddle.transpose(out, [0, 2, 1])
        out = paddle.reshape(out, [b, c, h, w])
        return x + self.proj(out)


class Downsample(nn.Layer):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2D(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2x(nn.Layer):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2D(channels, channels, 3, padding=1)

    def forward(self, x):
        x = nn.functional.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class UNetModel(nn.Layer):
    """Classic diffusion UNet: down path with resnet(+attention) blocks,
    middle block, up path with skip concats; conditioned on timestep."""

    def __init__(self, in_channels=4, out_channels=4, base_channels=64,
                 channel_mult=(1, 2, 4), num_res_blocks=2,
                 attention_levels=(2,), num_heads=4):
        super().__init__()
        temb_dim = base_channels * 4
        self.time_embed = TimestepEmbedding(base_channels, temb_dim)
        self.conv_in = nn.Conv2D(in_channels, base_channels, 3, padding=1)

        self.down_blocks = nn.LayerList()
        self.down_attn = nn.LayerList()
        self.downsamplers = nn.LayerList()
        skip_channels = [base_channels]
        ch = base_channels
        for level, mult in enumerate(channel_mult):
            out_ch = base_channels * mult
            for _ in range(num_res_blocks):
                self.down_blocks.append(ResnetBlock(ch, out_ch, temb_dim))
                self.down_attn.append(
                    AttentionBlock(out_ch, num_heads)
                    if level in attention_levels else None)
                ch = out_ch
                skip_channels.append(ch)
            if level != len(channel_mult) - 1:
                self.downsamplers.append(Downsample(ch))
                skip_channels.append(ch)
            else:
                self.downsamplers.append(None)

        self.mid_block1 = ResnetBlock(ch, ch, temb_dim)
        self.mid_attn = AttentionBlock(ch, num_heads)
        self.mid_block2 = ResnetBlock(ch, ch, temb_dim)

        self.up_blocks = nn.LayerList()
        self.up_attn = nn.LayerList()
        self.upsamplers = nn.LayerList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            out_ch = base_channels * mult
            for _ in range(num_res_blocks + 1):
                self.up_blocks.append(
                    ResnetBlock(ch + skip_channels.pop(), out_ch, temb_dim))
                self.up_attn.append(
                    AttentionBlock(out_ch, num_heads)
                    if level in attention_levels else None)
                ch = out_ch
            if level != 0:
                self.upsamplers.append(Upsample2x(ch))
            else:
                self.upsamplers.append(None)

        self.norm_out = nn.GroupNorm(min(8, ch), ch)
        self.act = nn.SiLU()
        self.conv_out = nn.Conv2D(ch, out_channels, 3, padding=1)
        self._levels = len(channel_mult)
        self._num_res_blocks = num_res_blocks

    def forward(self, x, t):
        temb = self.time_embed(t)
        h = self.conv_in(x)
        skips = [h]
        i = 0
        for level in range(self._levels):
            for _ in range(self._num_res_blocks):
                h = self.down_blocks[i](h, temb)
                if self.down_attn[i] is not None:
                    h = self.down_attn[i](h)
                skips.append(h)
                i += 1
            if self.downsamplers[level] is not None:
                h = self.downsamplers[level](h)
                skips.append(h)

        h = self.mid_block1(h, temb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, temb)

        i = 0
        for idx in range(self._levels):
            for _ in range(self._num_res_blocks + 1):
                h = self.up_blocks[i](paddle.concat([h, skips.pop()], axis=1),
                                      temb)
                if self.up_attn[i] is not None:
                    h = self.up_attn[i](h)
                i += 1
            if self.upsamplers[idx] is not None:
                h = self.upsamplers[idx](h)

        return self.conv_out(self.act(self.norm_out(h)))


def unet_tiny(**kwargs):
    """CPU-testable config exercising every block type."""
    cfg = dict(in_channels=4, out_channels=4, base_channels=16,
               channel_mult=(1, 2), num_res_blocks=1, attention_levels=(1,),
               num_heads=2)
    cfg.update(kwargs)
    return UNetModel(**cfg)


def unet_sd_like(**kwargs):
    """SD-class channel layout (scaled for a single card): 4-channel
    latents at 64x64."""
    cfg = dict(in_channels=4, out_channels=4, base_channels=128,
               channel_mult=(1, 2, 4), num_res_blocks=2,
               attention_levels=(1, 2), num_heads=8)
    cfg.update(kwargs)
    return UNetModel(**cfg)
