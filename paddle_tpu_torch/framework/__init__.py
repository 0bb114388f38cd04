"""paddle.framework of the port: dtypes, device, flags and the RNG."""

from paddle_tpu_torch.framework import dtypes, device, flags, random  # noqa: F401
from paddle_tpu_torch.framework.dtypes import (  # noqa: F401
    get_default_dtype, set_default_dtype)
from paddle_tpu_torch.framework.random import seed  # noqa: F401


def in_dynamic_mode():
    return True


def in_pir_mode():
    return False


def use_pir_api():
    return False
