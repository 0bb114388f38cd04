"""Communication watchdog and heartbeat failure detection
(`paddle_tpu/distributed/comm_monitor.py`; reference `CommTaskManager`,
`paddle/phi/core/distributed/comm_task_manager.cc:152-168`, and the launch
watcher, `launch/controllers/watcher.py`).

`init_parallel_env` starts one `CommMonitor` a process when the world has
more than one rank. It heartbeats `hb/<rank>` into the rendezvous store
(the port's native `TCPStore`) and watches its peers: a rank whose
heartbeat stops advancing for `miss_limit * interval` seconds is declared
dead. Every collective of `communication` runs inside `guard`:

- before the collective starts, a peer already declared dead raises
  `RankFailure`;
- the collective's wait gets a deadline, `guard`'s `timeout` (the monitor's
  `collective_timeout`, else `FLAGS_distributed_timeout_seconds`), and the
  native watchdog reports a collective that outlives it;
- a collective that fails (a peer's connection closed, a timeout) raises
  `RankFailure` when a peer is declared dead by then, else its own error.

So a rank that exits or never joins ends a collective in `RankFailure` or a
timeout error, never in a hang.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import random
import sys
import threading
import time

__all__ = ["CommMonitor", "RankFailure", "start_comm_monitor",
           "get_comm_monitor", "stop_comm_monitor", "guard",
           "retry_store_op"]

_monitor = None


class RankFailure(RuntimeError):
    pass


def retry_store_op(fn, attempts=4, base_delay=0.05, max_delay=1.0,
                   jitter=0.5, sleep=time.sleep, deadline=None):
    """Run a store get/set with exponential backoff and jitter.

    A transient failure is retried `attempts` times with delays base * 2^i
    capped at `max_delay`, each stretched by up to `jitter` at random; the
    last failure propagates. `deadline` (time.monotonic()) stops retrying:
    the first attempt always runs, and no retry starts past it."""
    attempts = max(1, attempts)
    for i in range(attempts):
        try:
            return fn()
        except Exception:
            delay = min(max_delay, base_delay * (2 ** i)) * (
                1.0 + random.random() * jitter)
            out_of_time = (deadline is not None
                           and time.monotonic() + delay >= deadline)
            if i == attempts - 1 or out_of_time:
                raise
            sleep(delay)


def _timeout_flag():
    from paddle_tpu_torch.framework import flags

    return float(flags.get_flags("FLAGS_distributed_timeout_seconds")[
        "FLAGS_distributed_timeout_seconds"] or 300.0)


class CommMonitor:
    def __init__(self, store, rank, world_size, heartbeat_interval=1.0,
                 miss_limit=5, on_failure=None, collective_timeout=300.0,
                 registry=None, store_retries=4):
        from paddle_tpu_torch.core import native
        from paddle_tpu_torch.observability.registry import global_registry

        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.interval = heartbeat_interval
        self.miss_limit = miss_limit
        self.collective_timeout = collective_timeout
        self.store_retries = store_retries
        self.failed_ranks = set()
        self.stale_ages = {}   # rank -> heartbeat age (s) when declared dead
        # per-rank heartbeat-age gauges, read back by the training monitor
        self.registry = registry if registry is not None else global_registry()
        self._on_failure = on_failure
        self._stop = threading.Event()
        self._timeouts = []
        self._wd = None
        if native.available():
            self._wd = native.Watchdog(
                poll_interval=min(1.0, heartbeat_interval),
                on_timeout=self._on_wd_timeout)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- watchdog bracket for collectives -----------------------------------
    def _on_wd_timeout(self, name, ms):
        self._timeouts.append(name)
        self.registry.inc("comm/watchdog_timeouts", labels={"op": name})
        self.registry.inc("fault_events", labels={"kind": "watchdog_timeout"})
        print(f"[comm-watchdog] rank {self.rank}: '{name}' exceeded {ms} ms "
              f"— peer ranks may be dead or desynchronized (failed so far: "
              f"{sorted(self.failed_ranks) or 'none'})", file=sys.stderr,
              flush=True)

    @contextlib.contextmanager
    def guard(self, name, timeout=None):
        """Bracket a collective with a deadline; yields it in seconds."""
        self.check_peers()
        timeout = timeout or self.collective_timeout
        if self._wd is not None:
            self._wd.begin(name, timeout)
        try:
            yield timeout
        except RankFailure:
            raise
        except Exception as exc:
            # a peer's death shows first as a closed connection; give the
            # heartbeat its grace to name it
            end = time.monotonic() + self.miss_limit * self.interval * 2
            while not self.failed_ranks and time.monotonic() < end:
                time.sleep(self.interval / 2)
            if self.failed_ranks:
                raise RankFailure(self._dead_message(name)) from exc
            raise
        finally:
            if self._wd is not None:
                self._wd.end(name)

    # -- heartbeats ----------------------------------------------------------
    def _run(self):
        # a dead rank's last heartbeat stays readable in the store, so
        # liveness is "the value keeps advancing", not "the read succeeds"
        last_value, last_change = {}, {}
        started = time.monotonic()
        grace = self.miss_limit * self.interval
        while not self._stop.is_set():
            try:
                retry_store_op(
                    lambda: self.store.set(f"hb/{self.rank}",
                                           repr(time.time())),
                    attempts=self.store_retries,
                    max_delay=self.interval / 2,
                    deadline=time.monotonic() + self.interval / 2)
            except Exception:
                pass  # the store itself died; peers will notice us missing
            self.registry.set_gauge("comm/heartbeat_age_s", 0.0,
                                    labels={"rank": self.rank})
            round_deadline = time.monotonic() + self.interval
            for r in range(self.world_size):
                if r == self.rank:
                    continue
                if r in self.failed_ranks:
                    # a dead rank's age keeps advancing
                    self.registry.set_gauge(
                        "comm/heartbeat_age_s",
                        time.monotonic() - last_change.get(r, started),
                        labels={"rank": r})
                    continue
                try:
                    val = retry_store_op(
                        lambda: self.store.get(f"hb/{r}", timeout=0.5),
                        attempts=self.store_retries,
                        max_delay=self.interval / 2,
                        deadline=round_deadline)
                except Exception:
                    val = None
                now = time.monotonic()
                if val is not None and val != last_value.get(r):
                    last_value[r] = val
                    last_change[r] = now
                if r in last_change:
                    stale = now - last_change[r]
                    self.registry.set_gauge("comm/heartbeat_age_s", stale,
                                            labels={"rank": r})
                    if stale > grace:
                        self._declare_dead(r, stale)
                else:
                    self.registry.set_gauge("comm/heartbeat_age_s",
                                            now - started,
                                            labels={"rank": r})
                    if now - started > 10 * grace:
                        self._declare_dead(r, now - started)
            self._stop.wait(self.interval)

    def _declare_dead(self, r, stale):
        if r in self.failed_ranks:
            return
        self.stale_ages[r] = stale
        self.failed_ranks.add(r)
        self.registry.inc("comm/ranks_declared_dead")
        self.registry.inc("fault_events", labels={"kind": "dead_rank"})
        print(f"[comm-monitor] rank {self.rank}: rank {r} missed heartbeats "
              f"for {stale:.1f}s — declaring it DEAD", file=sys.stderr,
              flush=True)
        if self._on_failure is not None:
            self._on_failure(r)

    def _dead_message(self, what="the run"):
        ages = ", ".join(
            f"rank {r} last heartbeat {self.stale_ages.get(r, 0):.1f}s stale"
            for r in sorted(self.failed_ranks))
        return (f"rank(s) {sorted(self.failed_ranks)} are dead (no "
                f"heartbeat): {ages}; {what} aborted per the "
                "failure-detection policy")

    def check_peers(self):
        """Raise RankFailure if any peer has been declared dead."""
        if self.failed_ranks:
            raise RankFailure(self._dead_message())

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._wd is not None:
            self._wd.stop()
            self._wd = None


def start_comm_monitor(store, rank, world_size, **kwargs):
    """The process's monitor (one a process): heartbeat interval from
    `PADDLE_HEARTBEAT_INTERVAL`, else `FLAGS_heartbeat_interval_seconds`;
    collective deadline `FLAGS_distributed_timeout_seconds`."""
    global _monitor
    if _monitor is not None:
        return _monitor
    from paddle_tpu_torch.framework import flags

    flag = flags.get_flags("FLAGS_heartbeat_interval_seconds")[
        "FLAGS_heartbeat_interval_seconds"] or 1.0
    interval = float(os.environ.get("PADDLE_HEARTBEAT_INTERVAL", flag))
    kwargs.setdefault("collective_timeout", _timeout_flag())
    _monitor = CommMonitor(store, rank, world_size,
                           heartbeat_interval=kwargs.pop(
                               "heartbeat_interval", interval), **kwargs)
    # the native watchdog's thread must be joined before the interpreter
    # exits, also when the program never destroys its process group
    atexit.register(stop_comm_monitor)
    return _monitor


def get_comm_monitor():
    return _monitor


def stop_comm_monitor():
    global _monitor
    if _monitor is not None:
        _monitor.stop()
        _monitor = None


@contextlib.contextmanager
def guard(name, timeout=None):
    """The bracket every collective runs in; yields its deadline in
    seconds. Without a monitor (one rank) the deadline is
    `FLAGS_distributed_timeout_seconds` and nothing else is checked."""
    if _monitor is None:
        yield timeout or _timeout_flag()
    else:
        with _monitor.guard(name, timeout) as t:
            yield t
