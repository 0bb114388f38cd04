"""The process helpers of `paddle_tpu/distributed/api_extras.py` (:682-800;
reference `communication/broadcast.py`, `gather.py`, `scatter.py`,
`wait.py`, `spawn.py` and the gloo trio of `parallel_with_gloo.py`): the
object collectives, `gather`, `wait`, `is_available`, `spawn` and
`gloo_init_parallel_env`/`gloo_barrier`/`gloo_release`. The rest of that
module (the sharding and auto-parallel API, the PS datasets and entries)
waits for ROADMAP A9c and A9f.

`spawn` starts its workers from a module-level target under the "spawn"
context, so the target pickles (the JAX package's local target raises,
ROADMAP §C); `func` itself must be a module-level function.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket

import torch
import torch.distributed as tdist

from paddle_tpu_torch.distributed import comm_monitor
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed.communication import _group, _src

__all__ = ["broadcast_object_list", "gather", "scatter_object_list", "wait",
           "is_available", "spawn", "gloo_init_parallel_env", "gloo_barrier",
           "gloo_release"]


def broadcast_object_list(object_list, src=0, group=None):
    """Every rank's `object_list` becomes the global rank `src`'s (pickled
    over the group's backend)."""
    g = _group(group)
    with comm_monitor.guard("broadcast_object_list"):
        tdist.broadcast_object_list(object_list, src, group=g.process_group)
    return object_list


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank sends `tensor` to the global rank `dst`, whose
    `gather_list` receives them in rank order; others' lists are not
    touched."""
    g = _group(group)
    src = _src(tensor)
    root = tdist.get_rank() == dst
    outs = [torch.empty_like(src) for _ in range(g.nranks)] if root else None
    with comm_monitor.guard("gather"):
        tdist.gather(src, outs, dst=dst, group=g.process_group)
    if root and gather_list is not None:
        gather_list[:] = [Tensor(o) for o in outs]


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Rank i of the group receives `in_object_list[i]` of the global rank
    `src`; `out_object_list` becomes [that object]."""
    g = _group(group)
    out = [None]
    with comm_monitor.guard("scatter_object_list"):
        tdist.scatter_object_list(
            out, in_object_list if tdist.get_rank() == src else None,
            src=src, group=g.process_group)
    out_object_list[:] = out


def wait(tensor, group=None, use_calc_stream=True):
    """Fence: wait for the card's queued work on `tensor`'s device (the
    collectives' streams included); nothing to wait for on the CPU."""
    d = tensor._data
    if d.is_cuda:
        torch.cuda.synchronize(d.device)
    return tensor


def is_available():
    return tdist.is_available()


def _free_master():
    """127.0.0.1:port with port and port + 1 (the native store's) free."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        return f"127.0.0.1:{port}"


def _spawn_target(func, args, env):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start `nprocs` processes running `func(*args)` with rank r's
    PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK and a shared
    PADDLE_MASTER (a free localhost port unless the environment sets one),
    so `init_parallel_env()` inside `func` joins them. `nprocs=-1` takes a
    process a visible card (one without a card). With `join`, waits for
    all and raises if any exits non-zero. Returns the processes."""
    if nprocs == -1:
        nprocs = max(1, torch.cuda.device_count())
    master = os.environ.get("PADDLE_MASTER") or _free_master()
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_LOCAL_RANK": str(rank), "PADDLE_MASTER": master}
        p = ctx.Process(target=_spawn_target, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"spawn: worker exit codes {codes}")
    return procs


_gloo = None   # (torch TCPStore, ProcessGroupGloo) of the gloo trio


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """A gloo context of its own over `rank_num` processes meeting at
    `server_endpoint` ("ip:port", served by rank 0), for CPU barriers
    beside the training backend (reference `gloo_init_parallel_env`)."""
    global _gloo
    host, port = server_endpoint.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=comm_monitor._timeout_flag())
    store = tdist.TCPStore(host, int(port), rank_num, rank_id == 0,
                           timeout=timeout)
    _gloo = (store, tdist.ProcessGroupGloo(store, rank_id, rank_num,
                                           timeout))


def gloo_barrier():
    if _gloo is None:
        raise RuntimeError("gloo_barrier: call gloo_init_parallel_env first")
    with comm_monitor.guard("gloo_barrier"):
        _gloo[1].barrier().wait()


def gloo_release():
    global _gloo
    _gloo = None
