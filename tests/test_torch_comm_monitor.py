"""The port's comm monitor and process helpers
(`paddle_tpu_torch.distributed.comm_monitor`, `spawn`): `CommMonitor` over
a fake store as the JAX package's `test_observability.py:404` holds it;
`retry_store_op` against the JAX package's on the same flaky store op;
`guard`'s deadline and its RankFailure; three multi-process legs started
together (`tests/torch_dist_ranks.py`): 2 ranks where one exits and the
other's all-reduce ends in RankFailure well within the deadline, one rank
of 2 whose peer never joins (a timeout error, not a hang), and `spawn` of a
module-level function at nprocs=2, with a `ref_departs` case asserting the
JAX package's `spawn` still raises on its local target (ROADMAP §C)."""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

import paddle_tpu.distributed as jdist
import torch_dist_ranks as R
from paddle_tpu.distributed import comm_monitor as jmon
from paddle_tpu_torch.distributed import comm_monitor as mon
from paddle_tpu_torch.observability.registry import MetricsRegistry

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

DEADLINE = 20       # FLAGS_distributed_timeout_seconds of the legs
NEVER_JOINS = 3     # ... of the leg whose peer never joins
LEGS = {
    "monitor": dict(nranks=2, env={"PADDLE_HEARTBEAT_INTERVAL": "0.2",
                                   "FLAGS_distributed_timeout_seconds":
                                   str(DEADLINE)}),
    "never_joins": dict(nranks=2, ranks=[0], env={
        "FLAGS_distributed_timeout_seconds": str(NEVER_JOINS)}),
    "spawn": dict(nranks=2, ranks=[0]),
}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    root = tmp_path_factory.mktemp("comm_monitor")
    with ThreadPoolExecutor(len(LEGS)) as pool:
        runs = {case: pool.submit(R.launch, case, kw["nranks"], root / case,
                                  ranks=kw.get("ranks"), env=kw.get("env"))
                for case, kw in LEGS.items()}
        results = {case: run.result() for case, run in runs.items()}
    for case, res in results.items():
        for code, text in res:
            assert code == 0, (case, text[-4000:])
    return root


def _read(root, case, name):
    return json.loads((root / case / f"{name}.json").read_text())


class _FakeStore:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v

    def get(self, k, timeout=None):
        return self.d[k]


def _wait_for(cond, seconds):
    end = time.time() + seconds
    while not cond() and time.time() < end:
        time.sleep(0.02)


def test_heartbeat_gauges_and_dead_rank_counter():
    reg = MetricsRegistry()
    store = _FakeStore()
    store.set("hb/1", "t0")   # the peer heartbeats once, then goes silent
    m = mon.CommMonitor(store, rank=0, world_size=2, heartbeat_interval=0.05,
                        miss_limit=2, registry=reg)
    try:
        _wait_for(lambda: reg.counter("comm/ranks_declared_dead") > 0, 3.0)
        at_death = reg.gauge("comm/heartbeat_age_s", labels={"rank": 1})
        # a dead rank's age keeps advancing
        _wait_for(lambda: reg.gauge("comm/heartbeat_age_s",
                                    labels={"rank": 1}) > at_death, 3.0)
        assert reg.gauge("comm/heartbeat_age_s",
                         labels={"rank": 1}) > at_death
    finally:
        m.stop()
    assert reg.gauge("comm/heartbeat_age_s", labels={"rank": 0}) == 0.0
    assert reg.counter("comm/ranks_declared_dead") == 1
    assert 1 in m.failed_ranks
    with pytest.raises(mon.RankFailure, match=r"rank\(s\) \[1\] are dead"):
        m.check_peers()


def test_never_heartbeated_rank_gets_an_age_gauge_then_dies():
    reg = MetricsRegistry()
    m = mon.CommMonitor(_FakeStore(), rank=0, world_size=2,
                        heartbeat_interval=0.02, miss_limit=2, registry=reg)
    try:
        _wait_for(lambda: reg.gauge("comm/heartbeat_age_s",
                                    labels={"rank": 1}) > 0.0, 5.0)
        visible_before_death = reg.counter("comm/ranks_declared_dead") == 0
        _wait_for(lambda: reg.counter("comm/ranks_declared_dead") > 0, 5.0)
    finally:
        m.stop()
    assert visible_before_death and 1 in m.failed_ranks
    assert reg.gauge("comm/heartbeat_age_s", labels={"rank": 1}) > 0


class _Flaky:
    def __init__(self, fails):
        self.fails, self.calls = fails, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise ConnectionError(f"attempt {self.calls}")
        return "ok"


@pytest.mark.parametrize("fails,attempts", [(0, 4), (2, 4), (3, 4), (4, 4),
                                            (1, 0)])
def test_retry_store_op_retries_as_the_jax_packages(fails, attempts):
    out = []
    for module in (jmon, mon):
        fn, sleeps = _Flaky(fails), []
        try:
            got = module.retry_store_op(fn, attempts=attempts,
                                        sleep=sleeps.append)
        except ConnectionError as exc:
            got = str(exc)
        out.append((got, fn.calls, len(sleeps)))
    assert out[0] == out[1]


def test_retry_store_op_starts_no_retry_past_its_deadline():
    fn, sleeps = _Flaky(5), []
    with pytest.raises(ConnectionError, match="attempt 1"):
        mon.retry_store_op(fn, attempts=5, sleep=sleeps.append,
                           deadline=time.monotonic())
    assert fn.calls == 1 and not sleeps


def test_guard_gives_the_flags_deadline_and_names_a_dead_peer():
    with mon.guard("all_reduce") as deadline:
        assert deadline == 300.0   # FLAGS_distributed_timeout_seconds
    with mon.guard("all_reduce", timeout=7) as deadline:
        assert deadline == 7
    # a live peer: its heartbeat advances at every read
    live = _FakeStore()
    live.get = lambda k, timeout=None: repr(time.monotonic())
    m = mon.CommMonitor(live, rank=0, world_size=2, heartbeat_interval=0.05,
                        registry=MetricsRegistry())
    try:
        with pytest.raises(ValueError, match="its own error"):
            with m.guard("all_reduce"):
                raise ValueError("its own error")   # no peer declared dead
        # the peer dies while the collective runs
        with pytest.raises(mon.RankFailure, match="all_reduce aborted"):
            with m.guard("all_reduce"):
                m._declare_dead(1, 9.0)
                raise RuntimeError("Connection closed by peer")
        with pytest.raises(mon.RankFailure):
            with m.guard("barrier"):
                pass
    finally:
        m.stop()


def test_a_rank_that_exits_ends_its_peers_all_reduce_in_rank_failure(legs):
    res = _read(legs, "monitor", "monitor_r0")
    assert res["error"] == "RankFailure" and res["failed"] == [1]
    assert "rank(s) [1] are dead" in res["message"]
    assert res["deadline"] == DEADLINE and res["seconds"] < DEADLINE / 2


def test_a_rank_that_never_joins_ends_in_a_timeout_error(legs):
    res = _read(legs, "never_joins", "never_joins_r0")
    assert res["error"] == "RuntimeError" and "timed out" in res["message"]
    assert NEVER_JOINS <= res["seconds"] < NEVER_JOINS + 10


def test_spawn_runs_a_module_level_function_at_two_processes(legs):
    for r in range(2):
        res = _read(legs, "spawn", f"spawn_r{r}")
        assert res == {"world": 2, "sum": [3.0, 3.0], "backend": "GLOO"}


def test_ref_departs_jax_spawn_cannot_pickle_its_local_target():
    with pytest.raises(AttributeError, match="local object"):
        jdist.spawn(print, args=("x",), nprocs=1)
