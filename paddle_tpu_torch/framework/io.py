"""paddle.save / paddle.load (`paddle_tpu/framework/io.py`; reference
`python/paddle/framework/io.py:773`), in the JAX package's file format.

A file is a pickle of the object with every Tensor replaced by the tuple
("__tensor__", numpy array), so either package loads the other's files.
The write is atomic (`atomic_write`): a crash mid-save leaves the old file
whole.

bfloat16 needs care, because numpy knows that dtype only through
`ml_dtypes`, which the port does not import:
  - the port writes a bf16 leaf as a reduce to `numpy.ndarray(shape,
    "bfloat16", raw bytes)`, which a process that registered the name (the
    JAX package's, through ml_dtypes) unpickles into a bfloat16 array;
  - the port reads through `_Unpickler.find_class`: the JAX package's bf16
    arrays (whose pickle names `ml_dtypes.bfloat16`) and the port's own
    come back as raw 16-bit words and become torch.bfloat16 tensors, bit
    for bit, without ml_dtypes.
`load(return_numpy=True)` gives a bf16 leaf as its uint16 bits, as the
port's `Tensor.numpy()` does. A bare numpy array in the object (not a
Tensor) loads as a numpy array, as in the JAX package; a bare bf16 one,
which numpy cannot hold without ml_dtypes, as its uint16 bits. Loaded
Tensors land on the creation place (the card unless the caller chose the
CPU).
"""

import os
import pickle
import tempfile

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device

__all__ = ["save", "load", "atomic_write"]

# probed once: mkstemp creates 0600 files; atomic_write re-applies the
# process umask so a replaced file keeps conventional permissions
_UMASK = None


def _umask():
    global _UMASK
    if _UMASK is None:
        cur = os.umask(0)
        os.umask(cur)
        _UMASK = cur
    return _UMASK


def atomic_write(path, write_fn, mode="wb"):
    """Crash-safe file write: a temporary file in the target directory ->
    flush -> fsync -> os.replace. Readers see the old bytes or the whole
    new bytes, never a torn file."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".part")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o666 & ~_umask())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _BF16:
    """A bf16 array as (shape, little-endian 16-bit words). Pickled as
    `numpy.ndarray(shape, "bfloat16", words)`; read back by the port as
    itself."""

    __slots__ = ("shape", "words")

    def __init__(self, shape, words):
        self.shape = tuple(int(s) for s in shape)
        self.words = words

    def __reduce__(self):
        return np.ndarray, (self.shape, "bfloat16", self.words)

    def bits(self):
        return np.frombuffer(self.words, np.uint16).reshape(self.shape).copy()

    def tensor(self):
        return torch.from_numpy(self.bits().view(np.int16)).view(
            torch.bfloat16)


def _host_array(d):
    """A torch tensor as a file holds it: a numpy array, or for bf16 the
    `_BF16` that pickles as one."""
    d = d.detach()
    if d.dtype == torch.bfloat16:
        return _BF16(d.shape, d.contiguous().view(torch.int16).cpu().numpy()
                     .tobytes())
    return d.cpu().resolve_conj().numpy()


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        return ("__tensor__", _host_array(obj._data))
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    atomic_write(path, lambda f: pickle.dump(_to_saveable(obj), f,
                                             protocol=protocol))


# -- reading without ml_dtypes ----------------------------------------------


class _BF16Type:
    """Stands for `ml_dtypes.bfloat16` while unpickling."""


class _BF16Dtype:
    """Stands for `numpy.dtype(ml_dtypes.bfloat16)`; takes the dtype's
    pickled state and ignores it."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=False):
    if obj is _BF16Type:
        return _BF16Dtype()
    return np.dtype(obj, align, copy)


def _ndarray(shape, dtype=float, buffer=None, *args):
    """`numpy.ndarray` as a callable: the port's bf16 reduce gives a
    `_BF16`; anything else is numpy's."""
    if dtype == "bfloat16":
        return _BF16(shape, bytes(buffer))
    return np.ndarray(shape, dtype, buffer, *args)


class _Array:
    """An ndarray being unpickled (`_reconstruct`, then `__setstate__`):
    a bf16 one becomes a `_BF16`, any other a numpy array."""

    __slots__ = ("value",)

    def __setstate__(self, state):
        _, shape, dtype, fortran, data = state
        if isinstance(dtype, _BF16Dtype):
            self.value = _BF16(shape, bytes(data))
            return
        arr = np.empty((0,), np.int8)
        arr.__setstate__(state)
        self.value = arr


def _reconstruct(cls, shape, typecode):
    return _Array()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16Type
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "numpy" and name == "ndarray":
            return _ndarray
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        return super().find_class(module, name)


def _leaf(v, return_numpy, dev):
    if isinstance(v, _Array):
        v = v.value
    if isinstance(v, _BF16):
        return v.bits() if return_numpy else Tensor(v.tensor().to(dev))
    if return_numpy:
        return v
    return Tensor(torch.from_numpy(np.array(v)).to(dev))


def _from_saveable(obj, return_numpy, dev):
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__tensor__":
        return _leaf(obj[1], return_numpy, dev)
    if isinstance(obj, _Array):
        obj = obj.value
    if isinstance(obj, _BF16):
        return obj.bits()
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy, dev)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_saveable(v, return_numpy, dev) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_from_saveable(v, return_numpy, dev) for v in obj)
    return obj


def load(path, **configs):
    """The object `save` wrote (by either package), its Tensors on the
    creation place, or numpy arrays with `return_numpy=True`."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return_numpy = configs.get("return_numpy", False)
    return _from_saveable(obj, return_numpy,
                          None if return_numpy else _device.place())
