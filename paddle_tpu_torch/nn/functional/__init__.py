"""paddle.nn.functional of the port. So far only flash attention
(`flash_attention`, `flash_attn_qkvpacked`, `scaled_dot_product_attention`);
the rest is ported with ROADMAP A10b."""

from paddle_tpu_torch.nn.functional.flash_attention import (  # noqa: F401
    flash_attention, flash_attn_qkvpacked, scaled_dot_product_attention)
