"""paddle.fft (`paddle_tpu/fft.py`; reference `python/paddle/fft.py`, the
fft_c2c / fft_r2c / fft_c2r ops) over `torch.fft`.

`norm` is Paddle's: "backward" (the default: no scaling forward, 1/n
inverse), "ortho" or "forward". `fftfreq` and `rfftfreq` with no place
land on the creation place (the card unless the caller chose the CPU).
"""

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
    "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "fftfreq",
    "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"norm {norm!r} is not backward, ortho or forward")
    return norm


def _wrap1(tfn, op_name):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return apply(lambda a: tfn(a, n=n, dim=axis, norm=_norm(norm)), x,
                     _name=op_name)

    op.__name__ = op_name
    return op


def _wrapn(tfn, op_name, default_axes):
    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        return apply(lambda a: tfn(a, s=s, dim=axes, norm=_norm(norm)), x,
                     _name=op_name)

    op.__name__ = op_name
    return op


fft = _wrap1(torch.fft.fft, "fft")        # fft_c2c
ifft = _wrap1(torch.fft.ifft, "ifft")
rfft = _wrap1(torch.fft.rfft, "rfft")     # fft_r2c
irfft = _wrap1(torch.fft.irfft, "irfft")  # fft_c2r
hfft = _wrap1(torch.fft.hfft, "hfft")
ihfft = _wrap1(torch.fft.ihfft, "ihfft")
fft2 = _wrapn(torch.fft.fft2, "fft2", (-2, -1))
ifft2 = _wrapn(torch.fft.ifft2, "ifft2", (-2, -1))
rfft2 = _wrapn(torch.fft.rfft2, "rfft2", (-2, -1))
irfft2 = _wrapn(torch.fft.irfft2, "irfft2", (-2, -1))
fftn = _wrapn(torch.fft.fftn, "fftn", None)
ifftn = _wrapn(torch.fft.ifftn, "ifftn", None)
rfftn = _wrapn(torch.fft.rfftn, "rfftn", None)
irfftn = _wrapn(torch.fft.irfftn, "irfftn", None)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.fftfreq(
        n, d, dtype=_dtypes.convert_dtype(dtype or "float32"),
        device=_device.place()))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.rfftfreq(
        n, d, dtype=_dtypes.convert_dtype(dtype or "float32"),
        device=_device.place()))


def fftshift(x, axes=None, name=None):
    return apply(lambda a: torch.fft.fftshift(a, dim=axes), x,
                 _name="fftshift")


def ifftshift(x, axes=None, name=None):
    return apply(lambda a: torch.fft.ifftshift(a, dim=axes), x,
                 _name="ifftshift")
