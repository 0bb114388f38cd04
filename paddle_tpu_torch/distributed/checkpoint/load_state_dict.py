"""Checkpoint load into the caller's tensors, in place (port of
`paddle_tpu/distributed/checkpoint/load_state_dict.py`).

Every tensor is assembled on the host from the saved shards that cover it
(any number of v2/v3 shards: a checkpoint the JAX package wrote from a
mesh loads too),
read through `np.load(mmap_mode="r")`, then copied into the caller's
tensor on its own device and in its own dtype. A bf16 shard ('<V2', raw
2-byte words) is read as int16 and viewed as bf16, without `ml_dtypes`.
The preflight checks every needed shard before anything is placed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint.integrity import (
    CheckpointCorruptError, is_committed, verify_shard_file)
from paddle_tpu_torch.distributed.checkpoint.metadata import Metadata
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
    _flatten_state)

__all__ = ["load_state_dict"]


def _stored(dtype):
    """The numpy dtype a shard of metadata dtype `dtype` is read as."""
    return np.dtype(np.int16) if dtype == "bfloat16" else np.dtype(dtype)


def _preflight(md, path, flat):
    """Validate the checkpoint before placing anything: every shard file a
    needed tensor references exists with its recorded size, its dtype
    parses, and its rectangles stay in bounds and cover the tensor. A
    partial checkpoint fails here naming the shard."""
    missing = [k for k in flat if k not in md.tensors]
    if missing:
        raise ValueError(f"checkpoint at {path} is missing tensors "
                         f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    for name in flat:
        tm = md.tensors[name]
        try:
            _stored(tm.dtype)
        except TypeError as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: tensor {name!r} has unparseable dtype "
                f"{tm.dtype!r}") from e
        if tm.shards is None:
            raise CheckpointCorruptError(
                f"checkpoint {path}: tensor {name!r} has no shard list (a "
                "pre-v2 checkpoint, which the port does not read)")
        shape = tuple(tm.shape)
        volume = int(np.prod(shape, dtype=np.int64)) if shape else 1
        covered = 0
        for sm in tm.shards:
            try:
                verify_shard_file(path, sm, deep=False)
            except CheckpointCorruptError as e:
                raise CheckpointCorruptError(
                    f"tensor {name!r}: {e}") from None
            if (len(sm.offsets) != len(shape)
                    or any(o < 0 or o + ln > d for o, ln, d
                           in zip(sm.offsets, sm.lengths, shape))):
                raise CheckpointCorruptError(
                    f"checkpoint {path}: tensor {name!r} shard {sm.file!r} "
                    f"rectangle offsets={sm.offsets} lengths={sm.lengths} "
                    f"falls outside the saved shape {list(shape)}")
            covered += int(np.prod(sm.lengths, dtype=np.int64)) if shape else 1
        if covered < volume:
            raise CheckpointCorruptError(
                f"checkpoint {path}: tensor {name!r} shards cover only "
                f"{covered} of {volume} elements: a shard file is missing "
                "(partial or torn checkpoint)")


def _read(path, fname, dtype):
    arr = np.load(os.path.join(path, fname), mmap_mode="r")
    return arr.view(np.int16) if dtype == "bfloat16" else arr


def _assemble(tm, path):
    """The whole tensor `tm` as a host ndarray (bf16 as int16 words), from
    the shards that cover it (the preflight checked their cover)."""
    out = np.empty(tuple(tm.shape), _stored(tm.dtype))
    for sm in tm.shards:
        dst = tuple(slice(o, o + ln) for o, ln in zip(sm.offsets,
                                                     sm.lengths))
        out[dst] = _read(path, sm.file, tm.dtype)
    return out


def _as_tensor(host, dtype):
    t = torch.from_numpy(host)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def load_state_dict(state_dict, path, verify=False):
    """Fill `state_dict`'s tensors in place from the snapshot at `path`, by
    `copy_` (onto each tensor's device, into its dtype). The preflight
    always runs before anything is placed; `verify=True` also re-reads
    every needed shard for its CRC32. Returns `state_dict`."""
    md = Metadata.load_dir(path)
    if md.version >= 3 and not is_committed(path):
        raise CheckpointCorruptError(
            f"checkpoint {path} was never committed (missing COMMITTED "
            "manifest): refusing to load a possibly torn snapshot")
    flat = _flatten_state(state_dict)
    _preflight(md, path, flat)
    if verify:
        for name in flat:
            for sm in md.tensors[name].shards or []:
                verify_shard_file(path, sm, deep=True)
    for name, leaf in flat.items():
        tm = md.tensors[name]
        if list(tm.shape) != list(leaf.shape):
            raise ValueError(f"{name}: saved shape {list(tm.shape)} != "
                             f"target {list(leaf.shape)}")
    for name, leaf in flat.items():
        tm = md.tensors[name]
        with torch.no_grad():
            leaf.copy_(_as_tensor(_assemble(tm, path), tm.dtype))
    return state_dict
