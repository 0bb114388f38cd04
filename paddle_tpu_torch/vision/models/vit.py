"""Vision Transformer (`paddle_tpu/vision/models/vit.py`): patch embedding,
pre-LN `nn.TransformerEncoderLayer` blocks, a class-token head. The blocks'
attention has no mask and, at the default dropout 0.0, none in training:
on the card it runs kernel B1 forward and B2/B3 backward
(`nn.functional.scaled_dot_product_attention`, head_dim 64 for ViT-B/16).
"""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["VisionTransformer", "vit_b_16", "vit_tiny", "vit_pipeline_descs"]


class PatchEmbed(nn.Layer):
    """Image -> patch tokens (+ class token + learned position embedding)."""

    def __init__(self, image_size=224, patch_size=16, in_channels=3,
                 embed_dim=768):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("patch_size must evenly divide image_size")
        self.num_patches = (image_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_channels, embed_dim, kernel_size=patch_size,
                              stride=patch_size)
        self.cls_token = self.create_parameter(
            [1, 1, embed_dim], default_initializer=nn.initializer.Normal(std=0.02))
        self.pos_embed = self.create_parameter(
            [1, self.num_patches + 1, embed_dim],
            default_initializer=nn.initializer.Normal(std=0.02))

    def forward(self, x):
        b = x.shape[0]
        x = self.proj(x)                      # [b, d, h/p, w/p]
        d = x.shape[1]
        x = paddle.transpose(
            paddle.reshape(x, [b, d, -1]), [0, 2, 1])  # [b, n, d]
        cls = paddle.expand(self.cls_token, [b, 1, d])
        x = paddle.concat([cls, x], axis=1)
        return x + self.pos_embed


class ViTHead(nn.Layer):
    def __init__(self, embed_dim, num_classes):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim)
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, x):
        return self.head(self.norm(x)[:, 0])


class VisionTransformer(nn.Layer):
    def __init__(self, image_size=224, patch_size=16, in_channels=3,
                 embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                 dropout=0.0, num_classes=1000):
        super().__init__()
        self.patch_embed = PatchEmbed(image_size, patch_size, in_channels,
                                      embed_dim)
        blk = lambda: nn.TransformerEncoderLayer(  # noqa: E731
            d_model=embed_dim, nhead=num_heads,
            dim_feedforward=int(embed_dim * mlp_ratio), dropout=dropout,
            activation="gelu", normalize_before=True)
        self.blocks = nn.LayerList([blk() for _ in range(depth)])
        self.head = ViTHead(embed_dim, num_classes)

    def forward(self, x):
        x = self.patch_embed(x)
        for b in self.blocks:
            x = b(x)
        return self.head(x)


def vit_pipeline_descs(image_size=32, patch_size=4, in_channels=3,
                       embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0,
                       dropout=0.0, num_classes=10):
    """The LayerDesc stack of a pipelined ViT: pipeline parallelism across
    cards is ROADMAP A9."""
    from paddle_tpu_torch.ops._common import waits_for

    raise waits_for("vision.models.vit_pipeline_descs", "A9",
                    "pipeline parallelism across cards")


def vit_b_16(num_classes=1000, **kwargs):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12,
                             num_classes=num_classes, **kwargs)


def vit_tiny(image_size=32, patch_size=4, num_classes=10, **kwargs):
    cfg = dict(embed_dim=64, depth=4, num_heads=4, dropout=0.0)
    cfg.update(kwargs)
    return VisionTransformer(image_size=image_size, patch_size=patch_size,
                             num_classes=num_classes, **cfg)
