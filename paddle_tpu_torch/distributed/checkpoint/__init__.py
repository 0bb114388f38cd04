"""Checkpoints on one process, in the JAX package's on-disk format: the
atomic commit, CRC integrity, retention GC and resume."""

from paddle_tpu_torch.distributed.checkpoint.integrity import (
    CheckpointCorruptError, is_committed, verify_snapshot)
from paddle_tpu_torch.distributed.checkpoint.load_state_dict import (
    load_state_dict)
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.distributed.checkpoint.metadata import (Metadata,
                                                              TensorMetadata)
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
    AsyncSaveHandle, save_state_dict)

__all__ = ["AsyncSaveHandle", "save_state_dict", "load_state_dict",
           "Metadata", "TensorMetadata", "CheckpointCorruptError",
           "is_committed", "verify_snapshot", "CheckpointManager"]
