"""paddle.profiler of the port (`paddle_tpu/profiler/__init__.py`; reference
`python/paddle/profiler/profiler.py`: the Profiler context, the scheduler,
the chrome-trace export; C++ side `paddle/fluid/platform/profiler/`).

`Profiler` runs `torch.profiler.profile` with CPU activity always and CUDA
activity when a card is present, and writes its trace into `log_dir`
(`PADDLE_PROFILER_LOG_DIR`, else `./profiler_log`). On `stop` the card's
lanes are read back from that trace (`_parse_device_trace`): every kernel,
copy and memset event, by kernel name, which fills the Kernel Summary.
The host side is the per-op times of the dispatch waist: while a Profiler
records, `core.tensor._op_tracer` is set and every op reports its host
seconds (the reference's RecordEvent bracket in every generated API,
`api_base.py:1356`). `RecordEvent` adds a user range to both: a
`torch.profiler.record_function` in the trace and a host duration in the
summary. `timer_only=True` records the host side and the step times only.
"""

from __future__ import annotations

import time
from collections import defaultdict
from enum import Enum

__all__ = [
    "Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "load_profiler_result",
    "LoadedProfilerResult", "SortedKeys", "SummaryView",
]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


from paddle_tpu_torch.profiler.profiler_statistic import (  # noqa: E402
    SortedKeys, StatisticData, SummaryView, build_table)


def make_scheduler(*, closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Step-state schedule (reference profiler.make_scheduler)."""
    period = closed + ready + record

    def schedule(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = (step - skip_first) % max(period, 1)
        if s < closed:
            return ProfilerState.CLOSED
        if s < closed + ready:
            return ProfilerState.READY
        return ProfilerState.RECORD

    return schedule


_events = defaultdict(list)  # user RecordEvent name -> [durations]
_op_events = defaultdict(list)  # op name -> [host dispatch durations]

# the categories of a torch.profiler chrome trace that are the card's lanes
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class RecordEvent:
    """User annotation (reference `profiler/utils.py` RecordEvent): a range
    in the torch.profiler trace and a row of the host summary."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._t0 = None
        self._ann = None

    def begin(self):
        import torch

        self._t0 = time.perf_counter()
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            _events[self.name].append(time.perf_counter() - self._t0)
            self._ann = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def export_chrome_tracing(dir_name, worker_name=None):
    """on_trace_ready handler writing a merged chrome trace (reference
    `platform/profiler/chrometracing_logger.cc`): host op dispatches and
    the card's kernel lanes in one chrome://tracing-loadable file.
    Repeated sessions get a run-index suffix (worker.json, worker_1.json,
    ...) instead of overwriting the previous trace."""
    def handler(prof):
        import os

        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or "worker"
        path = os.path.join(dir_name, f"{name}.json")
        idx = 1
        while os.path.exists(path):
            path = os.path.join(dir_name, f"{name}_{idx}.json")
            idx += 1
        prof.export_chrome_trace(path)

    return handler


def _parse_trace_data(data, per_op=None, raw=None):
    """The device-lane events of one chrome-trace dict: in a torch.profiler
    trace, the events of category kernel, gpu_memcpy and gpu_memset (one
    lane a stream); in an xprof-style trace, the events of a process named
    `/device:...` or of an `XLA Ops` / `XLA Modules` thread. Merges into
    per_op/raw and returns (per_op, module_busy_seconds, raw_events); raw
    events carry the pid."""
    per_op = defaultdict(list) if per_op is None else per_op
    raw = [] if raw is None else raw
    module_busy = 0.0
    evs = data.get("traceEvents", [])
    procs, threads = {}, {}
    for e in evs:
        if e.get("ph") == "M":
            nm = (e.get("args") or {}).get("name", "")
            if e.get("name") == "process_name":
                procs[e.get("pid")] = nm
            elif e.get("name") == "thread_name":
                threads[(e.get("pid"), e.get("tid"))] = nm
    for e in evs:
        if e.get("ph") != "X":
            continue
        pn = str(procs.get(e.get("pid"), ""))
        tn = str(threads.get((e.get("pid"), e.get("tid")), ""))
        if e.get("cat") in _DEVICE_CATS:
            lane = f"stream {e.get('tid')}"
        elif "/device:" in pn or "XLA Ops" in tn or "XLA Modules" in tn:
            lane = tn or pn
        else:
            continue
        dur_s = float(e.get("dur", 0.0)) / 1e6
        raw.append({"name": e.get("name", "?"), "ts": e.get("ts", 0),
                    "dur": e.get("dur", 0.0), "lane": lane,
                    "pid": e.get("pid", 0)})
        if "Modules" in lane:
            module_busy += dur_s  # a whole-module span: busy, not per-op
        else:
            per_op[e.get("name", "?")].append(dur_s)
    return per_op, module_busy, raw


def _parse_device_trace(log_dir):
    """Per-kernel device time from the newest torch.profiler trace
    (`*.pt.trace.json`) under `log_dir`. Returns ({kernel name:
    [dur_seconds]}, device_busy_seconds, raw_events); empty for a trace
    without device lanes (a run on the CPU)."""
    import glob
    import json
    import os

    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                   key=os.path.getmtime)
    if not files:
        return {}, 0.0, []
    with open(files[-1]) as f:
        data = json.load(f)
    per_op, module_busy, raw = _parse_trace_data(data)
    busy = module_busy or sum(sum(v) for v in per_op.values())
    return dict(per_op), busy, raw


class LoadedProfilerResult:
    """Offline view over a saved trace: the same StatisticData the live
    Profiler builds, so `summary()` renders the full table set without the
    original process."""

    def __init__(self, statistic_data):
        self.statistic_data = statistic_data

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None, row_limit=100):
        table = build_table(self.statistic_data,
                            sorted_by=sorted_by or SortedKeys.CPUTotal,
                            views=views, time_unit=time_unit,
                            row_limit=row_limit, op_detail=op_detail)
        print(table)
        return table


def load_profiler_result(path):
    """Load a saved profiling run back into a summarizable result
    (reference `profiler/profiler.py` load_profiler_result):

      - a chrome trace written by `Profiler.export_chrome_trace` /
        `export_chrome_tracing`, the port's or the JAX package's (host
        `cat:"op"` lane, device `cat:"device"` lanes) -> host op stats and
        device attribution;
      - a torch.profiler trace file, or a log dir holding one -> device
        lanes only (`_parse_device_trace`).

    Returns a `LoadedProfilerResult`; `.summary()` works offline."""
    import gzip
    import json
    import os

    if os.path.isdir(path):
        dev_events, dev_total, _ = _parse_device_trace(path)
        data = StatisticData({}, {}, [], device_events=dev_events,
                             device_total=dev_total)
        return LoadedProfilerResult(data)

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        trace = json.loads(f.read())
    op_events, dev_events = defaultdict(list), defaultdict(list)
    module_busy = 0.0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        dur_s = float(e.get("dur", 0.0)) / 1e6
        cat = e.get("cat")
        if cat == "op":
            op_events[e.get("name", "?")].append(dur_s)
        elif cat == "device":
            lane = (e.get("args") or {}).get("lane", "")
            if "Modules" in lane:
                module_busy += dur_s
            else:
                dev_events[e.get("name", "?")].append(dur_s)
    if not op_events and not dev_events and not module_busy:
        # not a merged export (no cat "op"/"device" events): a raw trace,
        # whose device lanes are read by category or process/thread name
        dev, total, _ = _parse_trace_data(trace)
        total = total or sum(sum(v) for v in dev.values())
        return LoadedProfilerResult(StatisticData({}, {}, [],
                                                  device_events=dev,
                                                  device_total=total))
    dev_total = module_busy or sum(sum(v) for v in dev_events.values())
    data = StatisticData(dict(op_events), {}, [],
                         device_events=dict(dev_events),
                         device_total=dev_total)
    return LoadedProfilerResult(data)


class Profiler:
    """reference `profiler/profiler.py` Profiler: start/stop/step, a
    torch.profiler trace in `log_dir`, the summary tables and the merged
    chrome export."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, log_dir=None):
        import os

        self.targets = targets or [ProfilerTarget.CPU, ProfilerTarget.GPU]
        self.scheduler = scheduler if callable(scheduler) else None
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        # the default dump dir follows PADDLE_PROFILER_LOG_DIR, so a test
        # rig or a batch job can redirect every profiler without touching
        # call sites
        self.log_dir = log_dir or os.environ.get("PADDLE_PROFILER_LOG_DIR",
                                                 "./profiler_log")
        self.current_state = ProfilerState.CLOSED
        self._step = 0
        self._prof = None
        self._step_times = []
        self._last_step_t = None
        self._records = []      # (name, end_ts, dur) for the chrome export
        self.device_events = {}  # the card's kernels: name -> [dur_s]
        self.device_total = 0.0
        self._device_raw = []

    def _activities(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and any(
                t in self.targets for t in (ProfilerTarget.GPU,
                                            ProfilerTarget.CUSTOM_DEVICE)):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self):
        # fresh op, export and device tables a session: successive runs do
        # not mix per-op stats or chrome-trace events (user RecordEvents
        # keep their own lifetime)
        _op_events.clear()
        self._records = []
        self.device_events = {}
        self.device_total = 0.0
        self._device_raw = []
        self._last_step_t = time.perf_counter()
        if not self.timer_only:
            import torch

            self._prof = torch.profiler.profile(
                activities=self._activities(),
                record_shapes=self.record_shapes,
                profile_memory=self.profile_memory)
            self._prof.__enter__()
        # per-op host tracing on the dispatch waist
        from paddle_tpu_torch.core import tensor as _core_tensor

        def _trace(name, dur):
            _op_events[name].append(dur)
            self._records.append((name, time.perf_counter(), dur))

        _core_tensor._op_tracer = _trace
        self.current_state = ProfilerState.RECORD

    def stop(self):
        import os

        from paddle_tpu_torch.core import tensor as _core_tensor

        _core_tensor._op_tracer = None
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.log_dir, f"paddle_{os.getpid()}_{time.time_ns()}"
                ".pt.trace.json"))
            self._prof = None
            # the card's kernels from the trace just written
            (self.device_events, self.device_total,
             self._device_raw) = _parse_device_trace(self.log_dir)
        self.current_state = ProfilerState.CLOSED
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._step += 1
        if self._prof is not None:
            self._prof.step()

    def step_info(self, unit=None):
        if not self._step_times:
            return ""
        unit = unit or "ms"
        scale = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(unit)
        if scale is None:
            raise ValueError(f"unit must be 's', 'ms' or 'us', got {unit!r}")
        avg = sum(self._step_times) / len(self._step_times)
        return (f"avg step time {avg * scale:.2f} {unit} over "
                f"{len(self._step_times)} steps")

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms", views=None, row_limit=100):
        """The aggregated statistic tables (reference profiler_statistic.py
        `_build_table`): Overview / Model / Operator / UserDefined /
        Memory / Kernel views with sort keys, over the host op times, the
        RecordEvent brackets, the step times and the card's kernels."""
        data = StatisticData(_op_events, _events, self._step_times,
                             device_events=self.device_events,
                             device_total=self.device_total)
        table = build_table(data, sorted_by=sorted_by, views=views,
                            time_unit=time_unit, row_limit=row_limit,
                            op_detail=op_detail)
        print(table)
        return table

    def export_chrome_trace(self, path):
        """Write one chrome://tracing-loadable JSON merging the host op
        dispatches and the card's kernel lanes (reference
        chrometracing_logger.cc), in the JAX package's layout. The host
        clock and the trace's have unrelated epochs, so each lane is
        rebased to its own t=0: durations and order within a lane are
        exact, alignment across lanes is approximate (the torch.profiler
        trace in `log_dir` is the precise view)."""
        import json
        import os

        evs = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "host: op dispatch"}},
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "device (from torch.profiler)"}},
        ]
        host0 = min(((end - dur) for _, end, dur in self._records),
                    default=0.0)
        for name, end_ts, dur in self._records:
            evs.append({"name": name, "ph": "X", "pid": 0, "tid": 0,
                        "ts": (end_ts - dur - host0) * 1e6,
                        "dur": dur * 1e6, "cat": "op"})
        dev0 = min((e["ts"] for e in self._device_raw), default=0.0)
        for e in self._device_raw:
            evs.append({"name": e["name"], "ph": "X", "pid": 1, "tid": 0,
                        "ts": e["ts"] - dev0, "dur": e["dur"],
                        "cat": "device", "args": {"lane": e["lane"]}})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": evs}, f)
        return path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
