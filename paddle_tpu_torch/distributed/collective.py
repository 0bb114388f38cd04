"""Communication groups (`paddle_tpu/distributed/collective.py`; reference
`python/paddle/distributed/collective.py:151-180` and
`communication/group.py:29`).

The port is Paddle's own model: one process per rank, each holding its own
tensors. A `Group` wraps a `torch.distributed` process group: the world's
(`init_parallel_env`) or a subgroup (`new_group`), on NCCL for the card and
gloo for the CPU. As in torch, every rank of the world calls `new_group`
for every group, in the same order, members or not; a rank outside a group
gets a Group whose `rank` is -1 and which it cannot communicate over.
"""

from __future__ import annotations

import threading

import torch.distributed as tdist

__all__ = ["Group", "new_group", "get_group", "is_initialized",
           "destroy_process_group"]

_lock = threading.Lock()
_group_map = {}
_next_gid = [0]
_default_store = None


class Group:
    """A set of global ranks over one `torch.distributed` process group
    (`pg`, None for a rank outside it)."""

    def __init__(self, rank_in_group, gid, ranks, name=None, pg=None):
        self.rank = rank_in_group
        self.id = gid
        self.ranks = list(ranks)
        self.name = name or f"_default_pg{gid}"
        self._pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    @property
    def process_group(self):
        """The torch process group (`torch.distributed.ProcessGroup`)."""
        return self._pg

    @property
    def backend(self):
        """"NCCL" or "GLOO", Paddle's names."""
        return tdist.get_backend(self._pg).upper()

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


def _new_gid():
    with _lock:
        gid = _next_gid[0]
        _next_gid[0] += 1
        return gid


def new_group(ranks=None, backend=None, timeout=None):
    """A group over the global `ranks` (all ranks when None), on the
    world's backend. Every rank of the world must call it, in the same
    order (torch's rule). `timeout` (seconds) defaults to the world's."""
    world = _get_global_group()
    ranks = sorted(world.ranks) if ranks is None else [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks) or not set(ranks) <= set(world.ranks):
        raise ValueError(f"new_group: ranks {ranks} must be distinct ranks "
                         f"of the world {world.ranks}")
    if ranks == world.ranks:
        pg = world.process_group  # the world itself: no second communicator
    else:
        kw = {}
        if timeout is not None:
            import datetime

            kw["timeout"] = datetime.timedelta(seconds=float(timeout))
        pg = tdist.new_group(ranks, backend=backend, **kw)
    me = tdist.get_rank()
    g = Group(ranks.index(me) if me in ranks else -1, _new_gid(), ranks,
              pg=pg if me in ranks else None)
    with _lock:
        _group_map[g.id] = g
    return g


def get_group(gid=0):
    return _group_map.get(gid)


def _get_global_group():
    """The world's Group; `init_parallel_env()` first when there is none."""
    g = _group_map.get(0)
    if g is None:
        from paddle_tpu_torch.distributed.parallel import init_parallel_env

        init_parallel_env()
        g = _group_map[0]
    return g


def _register_global_group(g):
    with _lock:
        _group_map[0] = g
        _next_gid[0] = max(_next_gid[0], 1)


def is_initialized():
    return 0 in _group_map


def destroy_process_group(group=None):
    """Destroy `group`, or, with None, every group, the world's process
    group, the comm monitor and the rendezvous store; `init_parallel_env`
    may then run again."""
    global _default_store
    with _lock:
        if group is not None:
            _group_map.pop(group.id, None)
            if group.id != 0 and group.process_group is not None and \
                    group.process_group is not tdist.group.WORLD:
                tdist.destroy_process_group(group.process_group)
            return
        _group_map.clear()
        _next_gid[0] = 0
    from paddle_tpu_torch.distributed import comm_monitor, parallel

    comm_monitor.stop_comm_monitor()
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _default_store = None
    parallel._env = None


def _set_default_store(store):
    global _default_store
    _default_store = store
