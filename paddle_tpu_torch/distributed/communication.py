"""Collectives over `torch.distributed` (`paddle_tpu/distributed/
communication.py`; reference `python/paddle/distributed/communication/`,
ProcessGroupNCCL `process_group_nccl.cc:267`).

One process per rank, each holding its own tensor: rank r's result is what
shard r of the JAX package's in-trace collective gives under `shard_map`
(ROADMAP, expected differences). A collective takes the port's Tensors;
an output's value is replaced by the result and its history cut, as
Paddle's in-place collectives do. It returns a task: with `sync_op=False`
the result lands when `task.wait()` returns.

Routes. The card's groups run on NCCL, and each collective calls NCCL's own
primitive (`ReduceOp.AVG` is NCCL's average). The CPU's run on gloo, and
where the JAX package's order of operations is not gloo's primitive the
CPU route builds it from primitives gloo has, in the JAX order: AVG is a
SUM and then a divide by the group's size (`lax.pmean`); a reduce-scatter
is a SUM all-reduce of the stacked inputs, of which a rank keeps its own
chunk (`lax.psum_scatter`). The route is chosen by the group's backend,
never by trying one and falling back.

Departures from the JAX package (ROADMAP §C): `PROD` is the
product (the JAX in-trace route computes exp(psum(log x)), NaN for a
negative entry); `reduce` defines the result on `dst` only, as Paddle does
(other ranks keep their input; the JAX package gives every rank the
result); `get_backend` gives "NCCL" or "GLOO" (the JAX package's "XLA").

Every collective runs inside `comm_monitor.guard`, which gives its wait a
deadline and turns a dead peer into `RankFailure`.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as tdist

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import comm_monitor
from paddle_tpu_torch.distributed.collective import _get_global_group

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "all_gather_object", "reduce",
    "broadcast", "scatter", "reduce_scatter", "alltoall", "alltoall_single",
    "send", "recv", "isend", "irecv", "barrier", "get_backend",
    "P2POp", "batch_isend_irecv",
]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM,
              ReduceOp.MAX: tdist.ReduceOp.MAX,
              ReduceOp.MIN: tdist.ReduceOp.MIN,
              ReduceOp.PROD: tdist.ReduceOp.PRODUCT}


def _group(group):
    g = group or _get_global_group()
    if not g.is_member():
        raise ValueError(f"this rank is not a member of {g}")
    return g


def _nccl(g):
    return g.backend == "NCCL"


def _torch_op(op, g):
    """torch's op for `op` on g's route: AVG is NCCL's own on the card and
    a SUM (divided afterwards, `_avg`) on gloo."""
    if op == ReduceOp.AVG:
        return tdist.ReduceOp.AVG if _nccl(g) else tdist.ReduceOp.SUM
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    return _TORCH_OPS[op]


def _avg(op, g, buf):
    """gloo's AVG: the SUM divided by the group's size, after it."""
    if op == ReduceOp.AVG and not _nccl(g):
        buf.div_(g.nranks)


def _src(x):
    """The contiguous torch data a collective reads from Tensor `x`."""
    return x._data.detach().contiguous()


def _buf(x):
    """A contiguous copy of Tensor `x` for a collective to write; `_settle`
    makes it x's value."""
    return x._data.detach().clone(memory_format=torch.contiguous_format)


def _settle(x, buf):
    x._refill(buf)
    return x


def _wait(work, g, deadline):
    """Wait for torch `Work` of group g under `deadline` seconds. On NCCL
    the wait orders the current stream after NCCL's (the deadline is the
    process group's own timeout); gloo's wait takes the deadline."""
    if work is None:
        return
    if _nccl(g):
        work.wait()
    else:
        work.wait(datetime.timedelta(seconds=deadline))


class _Task:
    """A collective in flight over torch `Work`s: `wait()` waits for them
    (under the collective's deadline), puts the result in place and
    returns it."""

    def __init__(self, name, g, works, finish=None, value=None):
        self._name, self._g = name, g
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._value = value
        self._done = False

    def _wait_all(self, deadline):
        for w in self._works:
            _wait(w, self._g, deadline)
        if self._finish is not None:
            self._value = self._finish()
        self._done = True

    def wait(self):
        if not self._done:
            with comm_monitor.guard(self._name) as deadline:
                self._wait_all(deadline)
        return self._value

    def is_completed(self):
        return self._done or all(w.is_completed() for w in self._works)


def _launch(name, g, start, finish, value, sync_op):
    with comm_monitor.guard(name) as deadline:
        task = _Task(name, g, start(), finish, value)
        if sync_op:
            task._wait_all(deadline)
    return task


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    g = _group(group)
    buf = _buf(tensor)

    def finish():
        _avg(op, g, buf)
        return _settle(tensor, buf)

    return _launch("all_reduce", g, lambda: [tdist.all_reduce(
        buf, op=_torch_op(op, g), group=g.process_group, async_op=True)],
        finish, tensor, sync_op)


def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True,
               axis=0):
    """List form `all_gather(out_list, tensor)`: fills `out_list` with every
    rank's tensor, in rank order. Functional form `all_gather(tensor)`
    (the JAX package's extension): returns the ranks' tensors concatenated
    along `axis` (`lax.all_gather(tiled=True)`), at once."""
    g = _group(group)
    t = tensor_or_list if tensor is None else tensor
    src = _src(t)
    outs = [torch.empty_like(src) for _ in range(g.nranks)]

    def finish():
        if tensor is None:
            return Tensor(torch.cat(outs, dim=axis))
        tensor_or_list[:] = [Tensor(o) for o in outs]
        return tensor_or_list

    task = _launch("all_gather", g, lambda: [tdist.all_gather(
        outs, src, group=g.process_group, async_op=True)], finish, None,
        sync_op or tensor is None)
    return task.wait() if tensor is None else task


def all_gather_object(object_list, obj, group=None):
    g = _group(group)
    out = [None] * g.nranks
    with comm_monitor.guard("all_gather_object"):
        tdist.all_gather_object(out, obj, group=g.process_group)
    object_list[:] = out


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to the global rank `dst`: only `dst` holds the result;
    every other rank's tensor keeps its value (Paddle's contract)."""
    g = _group(group)
    buf = _buf(tensor)
    root = tdist.get_rank() == dst

    def finish():
        if root:
            _avg(op, g, buf)
            tensor._refill(buf)
        return tensor

    return _launch("reduce", g, lambda: [tdist.reduce(
        buf, dst, op=_torch_op(op, g), group=g.process_group,
        async_op=True)], finish, tensor, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    g = _group(group)
    buf = _buf(tensor)
    return _launch("broadcast", g, lambda: [tdist.broadcast(
        buf, src, group=g.process_group, async_op=True)],
        lambda: _settle(tensor, buf), tensor, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives `tensor_list[i]` of the global rank
    `src` (which alone needs to pass the list)."""
    g = _group(group)
    buf = _buf(tensor)
    chunks = None
    if tdist.get_rank() == src:
        chunks = [_src(t) for t in tensor_list]
    return _launch("scatter", g, lambda: [tdist.scatter(
        buf, chunks, src=src, group=g.process_group, async_op=True)],
        lambda: _settle(tensor, buf), tensor, sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Rank i receives the reduction over ranks of chunk i: of the list's
    i-th tensor, or of the i-th of n equal chunks along dim 0 of a single
    tensor. The card calls NCCL's reduce-scatter; gloo's route all-reduces
    the stacked chunks and keeps its own (see the module's docstring)."""
    g = _group(group)
    inp = tensor_or_tensor_list
    if isinstance(inp, (list, tuple)):
        chunks = [_src(t) for t in inp]
    else:
        chunks = [c.contiguous() for c in
                  inp._data.detach().chunk(g.nranks, dim=0)]
    if len(chunks) != g.nranks:
        raise ValueError(f"reduce_scatter needs {g.nranks} chunks, got "
                         f"{len(chunks)}")
    buf = _buf(tensor)
    if _nccl(g):
        def start():
            return [tdist.reduce_scatter(buf, chunks, op=_torch_op(op, g),
                                         group=g.process_group,
                                         async_op=True)]

        def finish():
            return _settle(tensor, buf)
    else:
        stacked = torch.stack(chunks)

        def start():
            return [tdist.all_reduce(stacked, op=_torch_op(op, g),
                                     group=g.process_group, async_op=True)]

        def finish():
            mine = stacked[g.rank]
            _avg(op, g, mine)
            buf.copy_(mine.reshape(buf.shape))
            return _settle(tensor, buf)

    return _launch("reduce_scatter", g, start, finish, tensor, sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i sends `in_tensor_list[j]` to rank j and receives rank j's
    i-th tensor into `out_tensor_list[j]` (the MoE token exchange)."""
    g = _group(group)
    ins = [_src(t) for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]

    def finish():
        out_tensor_list[:] = [Tensor(o) for o in outs]
        return out_tensor_list

    return _launch("alltoall", g, lambda: [tdist.all_to_all(
        outs, ins, group=g.process_group, async_op=True)], finish,
        out_tensor_list, sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """`alltoall` over dim 0 of one tensor: equal chunks, or the split
    sizes given."""
    g = _group(group)
    src = _src(in_tensor)
    buf = _buf(out_tensor)

    def start():
        return [tdist.all_to_all_single(
            buf, src, output_split_sizes=out_split_sizes,
            input_split_sizes=in_split_sizes, group=g.process_group,
            async_op=True)]

    return _launch("alltoall_single", g, start,
                   lambda: _settle(out_tensor, buf), out_tensor, sync_op)


def send(tensor, dst=0, group=None, sync_op=True):
    g = _group(group)
    src = _src(tensor)
    return _launch("send", g, lambda: [tdist.isend(
        src, dst, group=g.process_group)], None, tensor, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    g = _group(group)
    buf = _buf(tensor)
    return _launch("recv", g, lambda: [tdist.irecv(
        buf, src, group=g.process_group)], lambda: _settle(tensor, buf),
        tensor, sync_op)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One point-to-point op of `batch_isend_irecv`: `op` is `isend` or
    `irecv`, `peer` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp's op must be isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every op of the list together (torch's batch_isend_irecv);
    returns a task an op, each to wait on."""
    ops, finishes = [], []
    g = None
    for p in p2p_op_list:
        g = _group(p.group)
        if p.op in (isend, send):
            buf = _src(p.tensor)
            ops.append(tdist.P2POp(tdist.isend, buf, p.peer,
                                   group=g.process_group))
            finishes.append(None)
        else:
            buf = _buf(p.tensor)
            ops.append(tdist.P2POp(tdist.irecv, buf, p.peer,
                                   group=g.process_group))
            finishes.append(lambda t=p.tensor, b=buf: _settle(t, b))
    with comm_monitor.guard("batch_isend_irecv"):
        works = tdist.batch_isend_irecv(ops) if ops else []
    # NCCL coalesces the batch into one Work; then every op waits on it
    per_op = [[w] for w in works] if len(works) == len(ops) else \
        [works] * len(ops)
    return [_Task("batch_isend_irecv", g, w, f, p.tensor)
            for w, f, p in zip(per_op, finishes, p2p_op_list)]


def barrier(group=None):
    g = _group(group)
    kw = {"device_ids": [torch.cuda.current_device()]} if _nccl(g) else {}
    return _launch("barrier", g, lambda: [tdist.barrier(
        group=g.process_group, async_op=True, **kw)], None, None, True)


def get_backend(group=None):
    """"NCCL" on the card, "GLOO" on the CPU (Paddle's names)."""
    return _group(group).backend
