"""Dtype registry (`paddle_tpu/framework/dtypes.py`): Paddle's names for
torch dtypes, and `convert_dtype` from strings, numpy dtypes and torch
dtypes.

Widths follow Paddle: `float64` and `int64` are real, where the JAX
package (x64 off) narrows them to 32 bits. bfloat16 is `torch.bfloat16`;
numpy has no bfloat16 here (no `ml_dtypes`), so a string or an object whose
`name` is "bfloat16" maps to it.
"""

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "half": float16, "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}


def convert_dtype(dtype):
    """A torch dtype from a string ("float32", "paddle.int64", "bf16"), a
    numpy dtype or scalar type, a torch dtype, or anything named
    "bfloat16". None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _ALIASES:
            return _ALIASES[key]
        return _ALIASES[np.dtype(key).name]
    if getattr(dtype, "name", None) == "bfloat16" or \
            getattr(dtype, "__name__", None) == "bfloat16":
        return bfloat16
    return _ALIASES[np.dtype(dtype).name]


def dtype_name(dtype):
    """Paddle's name of a torch dtype: "float32", "bool", ..."""
    return str(dtype).replace("torch.", "")


_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return dtype_name(_default_dtype)


def default_float():
    """The default floating dtype as a torch dtype."""
    return _default_dtype


def is_floating_point(dtype):
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype):
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == bool_)
