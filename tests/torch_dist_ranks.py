"""The ranks of the port's multi-process CPU tests (no JAX here): each case
runs as N gloo processes started together by `launch`, one process a rank
with PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER set as a
launcher sets them. Each rank writes what it computed under the output
directory (`.npy`/`.npz`/`.json`), and the test holds it against the JAX
package's result in the test's own process.

    python tests/torch_dist_ranks.py CASE RANK NRANKS OUT_DIR
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PORT_IN_USE = ("port in use", "Address already in use", "EADDRINUSE")


# -- inputs shared with the tests --------------------------------------------

def rank_input(r, shape=(4, 6)):
    """Rank r's float32 input, from seed 100 + r; entries of both signs."""
    return np.random.default_rng(100 + r).standard_normal(shape).astype(
        np.float32)


def linear_data(seed=7):
    """A global batch of 8 for Linear(16, 4) and its initial weights."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 4)).astype(np.float32) * 0.3,
            "b": rng.standard_normal(4).astype(np.float32) * 0.1,
            "x": rng.standard_normal((8, 16)).astype(np.float32),
            "y": rng.standard_normal((8, 4)).astype(np.float32)}


def llama_batch(vocab=512, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (batch, seq)).astype(np.int64),
            rng.integers(0, vocab, (batch, seq)).astype(np.int64))


def skip_data(seed=8):
    """Weights of the second Linear(16, 4) of the uneven-skip case."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 4)).astype(np.float32) * 0.3,
            "b": rng.standard_normal(4).astype(np.float32) * 0.1}


LINEAR_STEPS = 3
SKIP_STEPS = 2
LLAMA_STEPS = 3
LLAMA_LR = 1e-3


# -- the launcher ------------------------------------------------------------

def launch(case, nranks, out, timeout=120, ranks=None, env=None, tries=3):
    """Run `case` as `nranks` rank processes (only those of `ranks` when
    given) under one timeout, each rank's output in `out/<case>.<rank>.log`;
    a run that lost its port to another process is started again on a new
    one. A rank left alone gives up at its own deadline, 60 s unless `env`
    sets FLAGS_distributed_timeout_seconds. Returns [(exit code, negative
    for a rank killed by a signal, output)] a rank."""
    from paddle_tpu_torch.distributed.api_extras import _free_master

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    ranks = list(range(nranks)) if ranks is None else ranks
    for _ in range(tries):
        base = {**os.environ, "PYTHONPATH": str(ROOT),
                "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
                "PADDLE_TRAINERS_NUM": str(nranks),
                "PADDLE_MASTER": _free_master(),
                "FLAGS_distributed_timeout_seconds": "60", **(env or {})}
        logs = [out / f"{case}.{r}.log" for r in ranks]
        procs = []
        for r, log in zip(ranks, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, case, str(r), str(nranks),
                     str(out)], cwd=ROOT,
                    env=dict(base, PADDLE_TRAINER_ID=str(r)), stdout=f,
                    stderr=subprocess.STDOUT))
        # until all end, the deadline, or a rank fails (its peers cannot
        # finish without it)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline and any(
                    p.poll() is None for p in procs) and not any(
                    p.poll() for p in procs):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = [(p.returncode, log.read_text())
                   for p, log in zip(procs, logs)]
        if not any(m in text for _, text in results for m in PORT_IN_USE):
            return results
    return results


# -- the cases ---------------------------------------------------------------

def _port():
    import torch

    import paddle_tpu_torch as P

    torch.set_num_threads(1)
    P.set_device("cpu")
    return P


def _save(out, name, value):
    np.save(Path(out) / f"{name}.npy", np.asarray(value))


def case_collectives(rank, n, out):
    P = _port()
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env()
    x = rank_input(rank)
    T = P.to_tensor
    res = {"backend": dist.get_backend(), "rank": dist.get_rank(),
           "world": dist.get_world_size()}
    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("avg", dist.ReduceOp.AVG),
                     ("prod", dist.ReduceOp.PROD)):
        t = T(x)
        dist.all_reduce(t, op=op)
        _save(out, f"all_reduce_{name}_r{rank}", t.numpy())
    t = T(x)
    task = dist.all_reduce(t, sync_op=False)
    res["async_value_is_input"] = task.wait() is t
    _save(out, f"all_reduce_async_r{rank}", t.numpy())

    chunks = []
    dist.all_gather(chunks, T(x))
    _save(out, f"all_gather_list_r{rank}", np.stack([c.numpy()
                                                     for c in chunks]))
    _save(out, f"all_gather_tiled_r{rank}", dist.all_gather(T(x)).numpy())

    t = T(np.zeros((2, 6), np.float32))
    dist.reduce_scatter(t, T(x))
    _save(out, f"reduce_scatter_r{rank}", t.numpy())
    t = T(np.zeros((2, 6), np.float32))
    dist.reduce_scatter(t, [T(x[:2]), T(x[2:])])
    _save(out, f"reduce_scatter_list_r{rank}", t.numpy())
    t = T(np.zeros((2, 6), np.float32))
    dist.reduce_scatter(t, T(x), op=dist.ReduceOp.AVG)
    _save(out, f"reduce_scatter_avg_r{rank}", t.numpy())

    t = T(x)
    dist.broadcast(t, src=1)
    _save(out, f"broadcast_r{rank}", t.numpy())

    outs = []
    dist.alltoall(outs, [T(x[:2]), T(x[2:])])
    _save(out, f"alltoall_r{rank}", np.concatenate([o.numpy()
                                                    for o in outs]))
    t = T(np.zeros_like(x))
    dist.alltoall_single(t, T(x))
    _save(out, f"alltoall_single_r{rank}", t.numpy())

    t = T(x)
    dist.reduce(t, dst=0)
    _save(out, f"reduce_r{rank}", t.numpy())

    t = T(np.zeros_like(x))
    dist.scatter(t, [T(x), T(2 * x)] if rank == 1 else None, src=1)
    _save(out, f"scatter_r{rank}", t.numpy())

    # point to point: rank 0 -> 1 with send/recv, 1 -> 0 with isend/irecv,
    # then a swap through batch_isend_irecv
    peer = 1 - rank
    got = T(np.zeros_like(x))
    if rank == 0:
        dist.send(T(x), dst=1)
        dist.irecv(got, src=1).wait()
    else:
        dist.recv(got, src=0)
        dist.isend(T(x), dst=0).wait()
    _save(out, f"p2p_r{rank}", got.numpy())
    got = T(np.zeros_like(x))
    tasks = dist.batch_isend_irecv([dist.P2POp(dist.isend, T(3 * x), peer),
                                    dist.P2POp(dist.irecv, got, peer)])
    for task in tasks:
        task.wait()
    _save(out, f"batch_p2p_r{rank}", got.numpy())

    dist.barrier()
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "tag": f"r{rank}"})
    res["all_gather_object"] = objs
    blist = [f"from {rank}", rank * 10]
    dist.broadcast_object_list(blist, src=1)
    res["broadcast_object_list"] = blist
    sc = []
    dist.scatter_object_list(sc, [{"to": 0}, {"to": 1}] if rank == 0
                             else None, src=0)
    res["scatter_object_list"] = sc
    gl = []
    dist.gather(T(x), gl, dst=1)
    res["gather_len"] = len(gl)
    if gl:
        _save(out, f"gather_r{rank}", np.stack([g.numpy() for g in gl]))

    # a subgroup of one rank: every rank makes both, each reduces on its own
    groups = [dist.new_group([0]), dist.new_group([1])]
    mine = groups[rank]
    t = T(x)
    dist.all_reduce(t, group=mine)
    res["subgroup_is_identity"] = bool(np.array_equal(t.numpy(), x))
    res["other_group_member"] = groups[peer].is_member()
    (Path(out) / f"collectives_r{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _linear(P, d):
    m = P.nn.Linear(16, 4)
    m.weight.set_value(d["w"])
    m.bias.set_value(d["b"])
    return m


def case_data_parallel(rank, n, out):
    P = _port()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.models.weights import layer_from_numpy

    dist.init_parallel_env()
    out = Path(out)
    d = linear_data()
    lo, hi = rank * 8 // n, (rank + 1) * 8 // n
    x, y = P.to_tensor(d["x"][lo:hi]), P.to_tensor(d["y"][lo:hi])
    res = {}

    # (a) Linear(16, 4), SGD 0.1, LINEAR_STEPS steps
    dp = P.DataParallel(_linear(P, d))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
    for s in range(LINEAR_STEPS):
        loss = ((dp(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.savez(out / f"linear_r{rank}_s{s}.npz", w=dp.weight.numpy(),
                 b=dp.bias.numpy())
    r = dp._reducer
    res["linear"] = {"buckets": len(r.buckets), "all_reduces": r.all_reduces,
                     "reduced": len(r.reduced)}

    # (b) no_sync: micro-batch A accumulates, B reduces the sum, one step
    dp = P.DataParallel(_linear(P, d))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
    mid = (lo + hi) // 2
    xa, ya = P.to_tensor(d["x"][lo:mid]), P.to_tensor(d["y"][lo:mid])
    xb, yb = P.to_tensor(d["x"][mid:hi]), P.to_tensor(d["y"][mid:hi])
    with dp.no_sync():
        ((dp(xa) - ya) ** 2).mean().backward()
    local = dp.weight.grad.numpy().copy()
    ((dp(xb) - yb) ** 2).mean().backward()
    opt.step()
    np.savez(out / f"nosync_r{rank}.npz", w=dp.weight.numpy(),
             b=dp.bias.numpy(), local=local)
    res["nosync_all_reduces"] = dp._reducer.all_reduces

    # (c) a parameter the forward never uses
    class Two(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.used = _linear(P, d)
            self.unused = P.nn.Linear(4, 3)

        def forward(self, a):
            return self.used(a)

    for find in (True, False):
        dp = P.DataParallel(Two(), find_unused_parameters=find)
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
        try:
            ((dp(x) - y) ** 2).mean().backward()
            opt.step()
            res[f"unused_{find}"] = {
                "grad": dp.unused.weight.grad.numpy().tolist(),
                "w": dp.used.weight.numpy().tolist()}
        except RuntimeError as exc:
            res[f"unused_{find}"] = {"error": str(exc)}
        # the ranks still agree after a refused step
        t = P.to_tensor(np.ones(2, np.float32))
        dist.all_reduce(t)
        res[f"after_unused_{find}"] = t.numpy().tolist()

    # (d) only the last rank skips `b`, whose parameters come last and so
    # sit in the first buckets (a bucket a parameter): the others launch
    # b's buckets first in backward, the last rank only in its finalize
    class Skip(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = _linear(P, d)
            self.b = _linear(P, skip_data())

        def forward(self, z, use_b):
            return self.a(z) + self.b(z) if use_b else self.a(z)

    dp = P.DataParallel(Skip(), comm_buffer_size=1e-5,
                        last_comm_buffer_size=1e-5,
                        find_unused_parameters=True)
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
    for s in range(SKIP_STEPS):
        ((dp(x, rank != n - 1) - y) ** 2).mean().backward()
        grads = {f"grad.{k}": p.grad.numpy() for k, p in
                 dp.named_parameters()}
        opt.step()
        opt.clear_grad()
        np.savez(out / f"skip_r{rank}_s{s}.npz", **grads,
                 **{k: p.numpy() for k, p in dp.named_parameters()})
    r = dp._reducer
    res["skip"] = {"buckets": [[r.params[i][0] for i in b.params]
                               for b in r.buckets],
                   "all_reduces": r.all_reduces}
    # the same without find_unused_parameters: the last rank raises, after
    # taking its part in every bucket, so its peers finish the step
    dp = P.DataParallel(Skip(), comm_buffer_size=1e-5,
                        last_comm_buffer_size=1e-5)
    try:
        ((dp(x, rank != n - 1) - y) ** 2).mean().backward()
        res["skip_False"] = None
    except RuntimeError as exc:
        res["skip_False"] = str(exc)
    t = P.to_tensor(np.ones(2, np.float32))
    dist.all_reduce(t)
    res["after_skip_False"] = t.numpy().tolist()

    # (e) the tiny layer Llama, LLAMA_STEPS AdamW steps, half the batch a rank
    state = dict(np.load(out / "llama_state.npz"))
    model = layer_from_numpy(tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(num_hidden_layers=2)), state)
    ids, labels = llama_batch()
    per = ids.shape[0] // n
    ids = P.to_tensor(ids[rank * per:(rank + 1) * per])
    labels = P.to_tensor(labels[rank * per:(rank + 1) * per])
    dp = P.DataParallel(model)
    opt = P.optimizer.AdamW(LLAMA_LR, parameters=dp.parameters(),
                            weight_decay=0.01)
    losses = []
    for s in range(LLAMA_STEPS):
        loss = dp(ids, labels=labels)
        loss.backward()
        grads = {f"grad.{k}": p.grad.numpy() for k, p in
                 dp.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        np.savez(out / f"llama_r{rank}_s{s}.npz", **grads,
                 **{k: p.numpy() for k, p in dp.named_parameters()})
    r = dp._reducer
    res["llama"] = {"losses": losses, "buckets": len(r.buckets),
                    "all_reduces": r.all_reduces, "reduced": len(r.reduced),
                    "params": len(r.params)}
    (out / f"data_parallel_r{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def case_fleet(rank, n, out):
    P = _port()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    res = {"mode": hcg.get_parallel_mode(),
           "worker_index": fleet.worker_index(),
           "worker_num": fleet.worker_num()}
    for axis, g in (("dp", hcg.get_data_parallel_group()),
                    ("mp", hcg.get_model_parallel_group()),
                    ("pp", hcg.get_pipe_parallel_group()),
                    ("sharding", hcg.get_sharding_parallel_group()),
                    ("sep", hcg.get_sep_parallel_group())):
        t = P.to_tensor(np.full(3, rank + 1, np.float32))
        dist.all_reduce(t, group=g)
        res[axis] = {"ranks": g.ranks, "rank_in_group": g.rank,
                     "sum": t.numpy().tolist()}
    res["coord"] = [hcg.get_data_parallel_rank(),
                    hcg.get_model_parallel_rank()]
    try:
        fleet.distributed_model(P.nn.Linear(2, 2))
        res["tensor_parallel_model"] = None
    except NotImplementedError as exc:
        res["tensor_parallel_model"] = str(exc)
    # again over the joined world: dp inferred (-1) as 4, pure data
    # parallelism
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    hcg = fleet.get_hybrid_communicate_group()
    dp_model = fleet.distributed_model(P.nn.Linear(2, 2))
    res["dp4"] = {"mode": hcg.get_parallel_mode(),
                  "model": type(dp_model).__name__,
                  "group": dp_model._group.ranks}
    (Path(out) / f"fleet_r{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def case_monitor(rank, n, out):
    """Rank 1 exits after the first barrier while rank 0 goes straight on
    to an all-reduce: the collective fails and the heartbeat names the dead
    rank, RankFailure well within the deadline, not a hang."""
    P = _port()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import comm_monitor

    dist.init_parallel_env()
    dist.barrier()
    if rank == 1:
        os._exit(0)
    mon = comm_monitor.get_comm_monitor()
    t0 = time.monotonic()
    res = {"interval": mon.interval, "miss_limit": mon.miss_limit}
    try:
        dist.all_reduce(P.to_tensor(np.ones(4, np.float32)))
        res["error"] = None
    except Exception as exc:   # noqa: BLE001 - the type is the result
        res["error"] = type(exc).__name__
        res["message"] = str(exc)
    res["seconds"] = time.monotonic() - t0
    res["failed"] = sorted(mon.failed_ranks)
    res["deadline"] = mon.collective_timeout
    (Path(out) / "monitor_r0.json").write_text(json.dumps(res))
    os._exit(0)


def case_never_joins(rank, n, out):
    """Rank 0 of 2 alone: `init_parallel_env` ends in a timeout error."""
    _port()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core import native

    native.available()   # a first build of the library is not the wait
    t0 = time.monotonic()
    res = {}
    try:
        dist.init_parallel_env()
        res["error"] = None
    except Exception as exc:   # noqa: BLE001 - the type is the result
        res["error"] = type(exc).__name__
        res["message"] = str(exc)
    res["seconds"] = time.monotonic() - t0
    (Path(out) / "never_joins_r0.json").write_text(json.dumps(res))
    os._exit(0)


def spawn_worker(out):
    """`distributed.spawn`'s target: a module-level function."""
    P = _port()
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env()
    t = P.to_tensor(np.full(2, dist.get_rank() + 1, np.float32))
    dist.all_reduce(t)
    (Path(out) / f"spawn_r{dist.get_rank()}.json").write_text(json.dumps(
        {"world": dist.get_world_size(), "sum": t.numpy().tolist(),
         "backend": dist.get_backend()}))
    dist.destroy_process_group()


def case_spawn(rank, n, out):
    """One process that spawns `n` workers of `spawn_worker`."""
    import paddle_tpu_torch.distributed as dist

    os.environ.pop("PADDLE_MASTER", None)
    dist.spawn(spawn_worker, args=(out,), nprocs=n)


if __name__ == "__main__":
    case, rank, nranks, out_dir = sys.argv[1:5]
    globals()[f"case_{case}"](int(rank), int(nranks), out_dir)
