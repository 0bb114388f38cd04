"""paddle.nn.functional of the port (`paddle_tpu/nn/functional/`;
reference `python/paddle/nn/functional/__init__.py`): activations, common
functionals, convolutions, pooling, norms, losses, flash attention (B1-B3
on the card) and the rest (`extra_fns`). `rms_norm` runs B9/B10 on the
card; the other functionals are plain PyTorch."""

from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.conv import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.pooling import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attn_qkvpacked,
    flash_attn_unpadded,
    flash_attn_varlen_qkvpacked,
    scaled_dot_product_attention,
    sdp_kernel,
)
from paddle_tpu_torch.nn.functional.extra_fns import *  # noqa: F401,F403
