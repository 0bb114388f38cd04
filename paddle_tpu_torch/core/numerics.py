"""Low-level numeric helpers (port of `paddle_tpu/core/numerics.py`)."""

from __future__ import annotations

import torch

__all__ = ["stochastic_round_bf16"]

_HIGH_HALF = -65536   # 0xFFFF0000 as an int32


def stochastic_round_bf16(x32, generator=None):
    """Unbiased f32 -> bf16 cast (`stochastic_round_bf16` :10): add uniform
    noise to the 16 bits bf16 drops, then truncate, so E[result] == x32 and
    a bf16-stored EMA keeps increments far below its own ulp. The noise is
    drawn from `generator` (a torch.Generator on x32's device): JAX's
    threefry bits cannot be matched, the distribution can.

    The sum runs on the int32 view of the bits; it wraps where the
    reference's uint32 sum wraps. The only inputs whose sum can overflow
    int32 are NaNs, and non-finite inputs are returned as they are."""
    if x32.dtype != torch.float32:
        raise TypeError(f"stochastic_round_bf16 takes float32, got "
                        f"{x32.dtype}")
    noise = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                          dtype=torch.int32, device=x32.device)
    bits = noise.add_(x32.view(torch.int32)).bitwise_and_(_HIGH_HALF)
    rounded = torch.where(torch.isfinite(x32), bits.view(torch.float32), x32)
    return rounded.to(torch.bfloat16)
