"""fleet.UtilBase (`paddle_tpu/distributed/fleet/base/util_factory.py`;
reference `python/paddle/distributed/fleet/base/util_factory.py`): small
cross-worker utilities over the port's collectives once the ranks are
joined; with one process they are identities (the reference's contract at
world size 1)."""

from __future__ import annotations

import numpy as np

__all__ = ["UtilBase"]


class UtilBase:
    def __init__(self):
        self.role_maker = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    @staticmethod
    def _world():
        from paddle_tpu_torch.distributed import collective, parallel

        return parallel.get_world_size() if collective.is_initialized() \
            else 1

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        if self._world() <= 1:
            return np.asarray(input)
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.distributed import communication as comm

        t = paddle.to_tensor(np.asarray(input))
        op = {"sum": comm.ReduceOp.SUM, "max": comm.ReduceOp.MAX,
              "min": comm.ReduceOp.MIN}[mode]
        comm.all_reduce(t, op=op)
        return t.numpy()

    def all_gather(self, input, comm_world="worker"):
        if self._world() <= 1:
            return [input]
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.distributed import communication as comm

        out = []
        comm.all_gather(out, paddle.to_tensor(np.asarray(input)))
        return [o.numpy() for o in out]

    def barrier(self, comm_world="worker"):
        if self._world() <= 1:
            return
        from paddle_tpu_torch.distributed import communication as comm

        comm.barrier()

    def get_file_shard(self, files):
        """Split a file list over the workers: contiguous blocks, the
        remainder to the first workers (reference get_file_shard)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file names")
        rm = self.role_maker
        n = rm.worker_num() if rm is not None else 1
        idx = rm.worker_index() if rm is not None else 0
        per, rem = divmod(len(files), n)
        start = idx * per + min(idx, rem)
        return files[start:start + per + (1 if idx < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        rm = self.role_maker
        me = rm.worker_index() if rm is not None else 0
        if me == rank_id:
            print(message)
