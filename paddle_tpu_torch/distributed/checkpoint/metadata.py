"""Checkpoint metadata (a copy of
`paddle_tpu/distributed/checkpoint/metadata.py`, the same JSON).

Every tensor is stored as one or more shard files, each covering a
hyper-rectangle [offset, offset + length) of the global shape; format v3
records each shard file's byte length and in-stream CRC32. The port saves
one shard a tensor (one process, one card) and loads any number, so a
checkpoint the JAX package wrote on a mesh loads here too. Dtypes are
numpy names; a bf16 leaf is "bfloat16", its file raw 2-byte words with the
descr '<V2', as numpy writes `ml_dtypes.bfloat16`.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import tempfile
from typing import Dict, List, Optional

__all__ = ["ShardMetadata", "TensorMetadata", "Metadata", "atomic_write",
           "META_FILE"]

META_FILE = "metadata.json"


def atomic_write(path, write_fn, mode="wb"):
    """Crash-safe file write: a temporary file in the target's directory,
    flushed and fsync'd, then os.replace: readers see the old bytes or the
    complete new ones, never a torn file."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".part")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclasses.dataclass
class ShardMetadata:
    file: str
    offsets: List[int]   # global start per dim
    lengths: List[int]   # extent per dim
    nbytes: Optional[int] = None
    crc32: Optional[int] = None


@dataclasses.dataclass
class TensorMetadata:
    name: str
    shape: List[int]
    dtype: str
    file: Optional[str] = None   # v1's whole-tensor file; the port reads v2+
    shards: Optional[List[ShardMetadata]] = None
    # the JAX package's sharding at save time, informational
    mesh_shape: Optional[List[int]] = None
    mesh_axes: Optional[List[str]] = None
    partition_spec: Optional[List] = None

    def __post_init__(self):
        if self.shards is not None:
            self.shards = [s if isinstance(s, ShardMetadata)
                           else ShardMetadata(**s) for s in self.shards]


@dataclasses.dataclass
class Metadata:
    tensors: Dict[str, TensorMetadata] = dataclasses.field(default_factory=dict)
    version: int = 3

    def dump(self, path):
        atomic_write(path, lambda f: json.dump({
            "version": self.version,
            "tensors": {k: dataclasses.asdict(v)
                        for k, v in self.tensors.items()},
        }, f, indent=1), mode="w")

    @staticmethod
    def load(path):
        with open(path) as f:
            raw = json.load(f)
        md = Metadata(version=raw.get("version", 1))
        for k, v in raw["tensors"].items():
            md.tensors[k] = TensorMetadata(**v)
        return md

    @staticmethod
    def load_dir(ckpt_dir):
        """Merge every process's metadata file (`metadata.json`, and
        `metadata.{p}.json` from the other processes of a multi-host JAX
        save)."""
        paths = sorted(glob.glob(os.path.join(ckpt_dir, "metadata*.json")))
        if not paths:
            raise FileNotFoundError(
                f"no metadata*.json in checkpoint dir {ckpt_dir}")
        merged = None
        for p in paths:
            md = Metadata.load(p)
            if merged is None:
                merged = md
                continue
            for name, tm in md.tensors.items():
                if name in merged.tensors and tm.shards:
                    have = merged.tensors[name]
                    have.shards = (have.shards or []) + tm.shards
                elif name not in merged.tensors:
                    merged.tensors[name] = tm
        return merged
