"""AMP (`paddle_tpu/amp/__init__.py`; reference
`python/paddle/amp/auto_cast.py:462`, `grad_scaler.py`).

`auto_cast` sets this thread's scope on the dispatch waist
(`core.tensor.amp_local`): inside it, `apply` casts the float32 inputs of
a white-list op to the AMP dtype (bf16 by default), so `paddle.matmul`,
`F.linear`, the convolutions and attention run in bf16 (attention on
B1-B3's bf16 path on the card), while black-list ops such as `softmax`
keep float32. `decorate` (O2) casts a model's float parameters and
buffers. `GradScaler` does real dynamic loss scaling: it skips a step
whose gradients hold inf or NaN and multiplies the scale by `decr_ratio`.

`debugging` holds the nan/inf checker and the operator stats on the same
waist (`amp/debugging.py`).
"""

import contextlib

import torch

from paddle_tpu_torch.core.tensor import amp_local as _amp_local
from paddle_tpu_torch.framework import dtypes

# O1 white/black lists (reference: `python/paddle/amp/amp_lists.py`)
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm", "einsum",
              "flash_attention", "sdpa"}
BLACK_LIST = {"log", "exp", "pow", "square", "softmax", "log_softmax", "cross_entropy",
              "mean", "sum", "norm", "layer_norm", "batch_norm", "rms_norm", "cumsum"}


def amp_state():
    return getattr(_amp_local, "state", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="bfloat16", use_promote=True):
    prev = amp_state()
    if enable:
        _amp_local.state = {
            "level": level,
            "dtype": dtypes.convert_dtype(dtype),
            "white": WHITE_LIST | set(custom_white_list or ()),
            "black": BLACK_LIST | set(custom_black_list or ()),
        }
    else:
        _amp_local.state = None
    try:
        yield
    finally:
        _amp_local.state = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """O2: cast model params to low precision (reference `amp/auto_cast.py` decorate)."""
    dt = dtypes.convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m._to_dtype(dt)
        m._casted_by_pure_fp16 = True
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (reference: `python/paddle/amp/grad_scaler.py`)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = False
        for p in optimizer._parameter_list or []:
            if p.grad is not None:
                g = p._data.grad * inv
                p.grad = g
                found = found or bool(torch.any(~torch.isfinite(g)))
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


# imported with amp, so its flag watchers are registered before any script
# sets FLAGS_check_nan_inf without touching paddle.amp.debugging
from paddle_tpu_torch.amp import debugging  # noqa: F401,E402
