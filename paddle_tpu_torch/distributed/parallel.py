"""The parallel environment and `DataParallel` (`paddle_tpu/distributed/
parallel.py`; reference `python/paddle/distributed/parallel.py:978`
init_parallel_env and `:219` DataParallel, with the EagerReducer of
`paddle/fluid/distributed/collective/reducer.cc:1089`).

One process per rank. `init_parallel_env()` reads `PADDLE_TRAINER_ID`,
`PADDLE_TRAINERS_NUM` and `PADDLE_MASTER` ("host:port", a numeric IPv4
host), as the JAX package does. With more than one rank, rank 0 hosts the
port's native `TCPStore` on port + 1; every rank meets there
(`init_parallel_env` barrier), starts the comm monitor's heartbeats on it,
and joins `torch.distributed.init_process_group` on the master port. One
rank needs no port (an in-memory store).

The backend follows the port's device (`framework.device`): after
`paddle.set_device("cpu")` the ranks run gloo; otherwise NCCL on the card
(rank r takes card `PADDLE_LOCAL_RANK`, else r, modulo the cards it
sees). With no card and no `set_device("cpu")` it raises, as
`device.resolve_device(None)` does. A store that cannot be made raises: no
rank runs on without its peers (the JAX package drops the store then).

Deadlines: the store's barrier, the process group and every collective
wait at most `FLAGS_distributed_timeout_seconds`.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import weakref

import torch
import torch.distributed as tdist

from paddle_tpu_torch.distributed import collective as _collective
from paddle_tpu_torch.distributed import comm_monitor
from paddle_tpu_torch.distributed.communication import _group, _wait

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel", "is_initialized"]

_env = None


def _trainer_env():
    """(rank, world size, master) from the PADDLE_* environment."""
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            os.environ.get("PADDLE_MASTER", ""))


def _rank_device(rank, nprocs):
    """The device this rank runs on: the one `set_device` chose, else a
    card (raises when there is none)."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.framework import device as _device

    if _device._current is not None:
        dev = _device._current
    else:
        dev = resolve_device(None)
        if nprocs > 1:
            local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class ParallelEnv:
    """This rank's view of the environment (reference `ParallelEnv`)."""

    def __init__(self, device=None):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.nranks = self.world_size
        self.local_rank = int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))
        self.device_type = "gpu" if device is not None and \
            device.type == "cuda" else "cpu"
        self.dev_id = device.index if device is not None and \
            device.type == "cuda" else 0
        self.trainer_endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def device_id(self):
        return self.dev_id


def init_parallel_env():
    """Join the ranks (reference parallel.py:978); returns the
    `ParallelEnv`. Idempotent; `destroy_process_group()` undoes it."""
    global _env
    if _env is not None:
        return _env
    rank, nprocs, master = _trainer_env()
    dev = _rank_device(rank, nprocs)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = comm_monitor._timeout_flag()
    kw = dict(backend=backend, rank=rank, world_size=nprocs,
              timeout=datetime.timedelta(seconds=timeout))
    if nprocs > 1:
        if not master:
            raise ValueError(f"init_parallel_env: {nprocs} ranks need "
                             "PADDLE_MASTER (host:port)")
        from paddle_tpu_torch.core import native

        host, port = master.rsplit(":", 1)
        store = native.TCPStore(host, int(port) + 1, is_master=rank == 0,
                                world_size=nprocs, timeout=timeout)
        store.barrier("init_parallel_env", rank, nprocs, timeout=timeout)
        _collective._set_default_store(store)
        comm_monitor.start_comm_monitor(store, rank, nprocs)
        tdist.init_process_group(init_method=f"tcp://{master}", **kw)
    else:
        tdist.init_process_group(store=tdist.HashStore(), **kw)
    _env = ParallelEnv(dev)
    world = list(range(nprocs))
    _collective._register_global_group(_collective.Group(
        rank, 0, world, name="_default_pg0", pg=tdist.group.WORLD))
    return _env


def is_initialized():
    return _collective.is_initialized()


def get_rank(group=None):
    """This process's rank (in `group` when given); before
    `init_parallel_env`, `PADDLE_TRAINER_ID`."""
    if group is not None:
        return group.rank
    if tdist.is_initialized():
        return tdist.get_rank()
    return _trainer_env()[0]


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if tdist.is_initialized():
        return tdist.get_world_size()
    return _trainer_env()[1]


# -- DataParallel ------------------------------------------------------------


class _Bucket:
    __slots__ = ("params", "pending", "flat", "work", "inplace")

    def __init__(self, params):
        self.params = params      # indices into the reducer's parameters
        self.pending = len(params)
        self.flat = self.work = None
        self.inplace = False      # flat is the one parameter's gradient


class _Reducer:
    """Bucketed gradient all-reduce (reference EagerReducer).

    Buckets hold parameters in reverse order (their gradients come first
    in backward), one dtype and device a bucket: the first up to
    `last_comm_buffer_size` MB, the rest up to `comm_buffer_size` MB; a
    larger parameter is a bucket alone. Each parameter's torch leaf gets a
    post-accumulate-grad hook. Buckets are all-reduced (SUM) strictly in
    bucket order, as the reference's MarkGroupReady does: when a bucket's
    last gradient lands, it and every ready bucket after it are launched,
    asynchronously, on the backend's own stream (NCCL's on the card), so
    the backward's kernels stay on the stream they run on. The backends
    pair collectives by the order they are issued, so every rank issues
    every bucket, in the same order, whatever order its gradients land in.
    A callback at the end of backward first marks the parameters that got
    no gradient (zeros, or their accumulated gradient if they have one),
    launching the buckets left, then waits for every bucket, divides by the
    group's size (the mean over ranks, `lax.pmean`'s order) and writes each
    gradient back, so every `.grad` holds the mean when `backward()`
    returns. Without `find_unused_parameters` a parameter that got no
    gradient then raises naming it, after its rank took its part in every
    bucket: its peers never wait for it."""

    def __init__(self, named_params, group, comm_buffer_size,
                 last_comm_buffer_size, find_unused_parameters):
        self.group = group
        self.params = [(n, p) for n, p in named_params if not p.stop_gradient]
        self.find_unused = find_unused_parameters
        self.buckets, self.bucket_of = [], {}
        limit, cur, cur_bytes = last_comm_buffer_size * 2**20, [], 0

        def key(i):
            d = self.params[i][1]._data
            return d.dtype, d.device

        for i in reversed(range(len(self.params))):
            d = self.params[i][1]._data
            nbytes = d.numel() * d.element_size()
            if cur and (cur_bytes + nbytes > limit or key(i) != key(cur[0])):
                self.buckets.append(_Bucket(cur))
                limit, cur, cur_bytes = comm_buffer_size * 2**20, [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            self.buckets.append(_Bucket(cur))
        for b in self.buckets:
            for i in b.params:
                self.bucket_of[i] = b
        self._hooked = {}
        self.sync = True
        self.armed = False
        self._ready = set()
        self._queued = False
        self._next = 0            # the first bucket not launched yet
        self.all_reduces = 0      # buckets all-reduced, over the reducer's life
        self.reduced = set()      # parameters whose gradient it reduced

    def prepare(self):
        """Before a forward: hook every parameter's current torch leaf (an
        optimizer step rebinds it) and arm the next backward."""
        for i, (_, p) in enumerate(self.params):
            leaf = p._data
            ref = self._hooked.get(i)
            if ref is None or ref() is not leaf:
                leaf.register_post_accumulate_grad_hook(
                    functools.partial(self._on_grad, i))
                self._hooked[i] = weakref.ref(leaf)
        self.armed = self.sync and torch.is_grad_enabled()
        self._ready.clear()
        self._queued = False
        self._next = 0
        for b in self.buckets:
            b.pending, b.flat, b.work = len(b.params), None, None

    def _on_grad(self, i, leaf):
        if not self.armed or i in self._ready:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
            self._queued = True
        self._mark(i)

    def _mark(self, i):
        self._ready.add(i)
        b = self.bucket_of[i]
        b.pending -= 1
        while self._next < len(self.buckets) and \
                self.buckets[self._next].pending == 0:
            self._launch(self.buckets[self._next])
            self._next += 1

    def _launch(self, b):
        grads = [self.params[i][1]._data.grad for i in b.params]
        b.inplace = len(grads) == 1 and grads[0].is_contiguous()
        b.flat = grads[0] if b.inplace else torch.cat(
            [g.reshape(-1) for g in grads])
        b.work = tdist.all_reduce(b.flat, op=tdist.ReduceOp.SUM,
                                  group=self.group.process_group,
                                  async_op=True)
        self.all_reduces += 1

    def _finalize(self):
        self.armed = False
        unused = [i for i in range(len(self.params)) if i not in self._ready]
        with comm_monitor.guard("DataParallel.all_reduce") as deadline:
            for i in unused:
                d = self.params[i][1]._data
                if d.grad is None:
                    d.grad = torch.zeros_like(d)
                self._mark(i)
            for b in self.buckets:
                _wait(b.work, self.group, deadline)
        n = self.group.nranks
        for b in self.buckets:
            b.flat.div_(n)
            if not b.inplace:
                off = 0
                for i in b.params:
                    g = self.params[i][1]._data.grad
                    g.copy_(b.flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
            b.flat = b.work = None
        self.reduced.update(range(len(self.params)))
        if unused and not self.find_unused:
            names = [self.params[i][0] for i in unused]
            raise RuntimeError(
                f"DataParallel: parameter(s) {names} received no gradient in "
                "this step; pass find_unused_parameters=True to reduce zeros "
                "for them")


class DataParallel:
    """Data parallelism over the ranks of `group` (the world by default;
    reference parallel.py:219). Each rank feeds its own batch.

    Construction broadcasts the layer's parameters and buffers from the
    group's first rank (Paddle's `sync_params_buffers`). In backward the
    reducer (`_Reducer`) all-reduces the gradients in buckets of
    `comm_buffer_size` MB as they land, and `loss.backward()` returns with
    every parameter's `.grad` the mean over the ranks. Inside `no_sync()`
    a backward only accumulates. `scale_loss` returns the loss unchanged
    (the mean is taken on the gradients)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        init_parallel_env()
        self._layers = layers
        self._group = _group(group)
        self.find_unused_parameters = find_unused_parameters
        pg, src = self._group.process_group, self._group.ranks[0]
        with torch.no_grad():
            for t in list(layers.parameters()) + list(layers.buffers()):
                tdist.broadcast(t._data, src, group=pg)
        self._reducer = _Reducer(layers.named_parameters(), self._group,
                                 comm_buffer_size, last_comm_buffer_size,
                                 find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        self._reducer.prepare()
        return self._layers(*inputs, **kwargs)

    __call__ = forward

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside the block accumulate gradients locally; the
        first synced backward after it reduces the accumulated sum."""
        prev, self._reducer.sync = self._reducer.sync, False
        try:
            yield
        finally:
            self._reducer.sync = prev

    # the wrapped Layer's surface
    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def train(self):
        self._layers.train()

    def eval(self):
        self._layers.eval()
