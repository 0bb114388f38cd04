"""Profiler statistics of the port (`paddle_tpu/profiler/
profiler_statistic.py`; reference `python/paddle/profiler/
profiler_statistic.py`): `StatisticData` over the recorded events and
`build_table`, rendering the Overview / Model / Operator / UserDefined /
Memory / Kernel summaries with sort keys and time units.

The host side is the per-op times of the dispatch waist (`_op_tracer` in
`core/tensor.py`), the `RecordEvent` brackets and the step times of
`Profiler.step()`; the device side is the card's kernels by name, read
from `torch.profiler`'s trace (`profiler._parse_device_trace`).
"""

from __future__ import annotations

from collections import defaultdict
from enum import Enum

import torch

__all__ = ["SortedKeys", "SummaryView", "EventStats", "StatisticData",
           "build_table"]


class SortedKeys(Enum):
    """reference profiler_statistic.py SortedKeys (CPU is the host; the GPU
    keys sort the Operator Summary by its host totals, as in the JAX
    package: device time is by kernel, in the Kernel Summary)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    UDFView = 7


class EventStats:
    """Aggregate of one event name: calls / total / avg / max / min."""

    __slots__ = ("name", "calls", "total", "max", "min")

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")

    def add(self, dur):
        self.calls += 1
        self.total += dur
        self.max = max(self.max, dur)
        self.min = min(self.min, dur)

    @property
    def avg(self):
        return self.total / self.calls if self.calls else 0.0


_SORT_FIELD = {
    SortedKeys.CPUTotal: lambda s: s.total,
    SortedKeys.CPUAvg: lambda s: s.avg,
    SortedKeys.CPUMax: lambda s: s.max,
    SortedKeys.CPUMin: lambda s: s.min,
    SortedKeys.GPUTotal: lambda s: s.total,
    SortedKeys.GPUAvg: lambda s: s.avg,
    SortedKeys.GPUMax: lambda s: s.max,
    SortedKeys.GPUMin: lambda s: s.min,
}

# canonical model phases (reference _build_table ModelView rows; hapi and
# user code emit RecordEvents with these names)
_PHASES = ("dataloader", "forward", "backward", "optimizer", "other")


class StatisticData:
    """Aggregated views over (op_events, user_events, step_times[,
    device_events]). device_events are the card's kernels by name from
    the torch.profiler trace (profiler._parse_device_trace)."""

    def __init__(self, op_events, user_events, step_times,
                 device_events=None, device_total=0.0):
        self.ops = self._agg(op_events)
        self.user = self._agg(user_events)
        self.step_times = list(step_times)
        self.device = self._agg(device_events or {})
        self.device_total = device_total

    def device_for_op(self, op_name):
        """Device total attributed to a host op: the kernels whose name is
        the op's name, or starts with it or with `jit_<op>` at a word
        boundary (`relu` does not absorb `relu6`'s time). The port's
        kernels are named by their CUDA function, so an op that launches a
        library kernel shows "-"."""
        def anchored(base, stem):
            if base == stem:
                return True
            if not base.startswith(stem):
                return False
            nxt = base[len(stem)]
            return not (nxt.isalnum() or nxt == "_")

        total = 0.0
        for name, st in self.device.items():
            base = name.split("(")[0]
            if anchored(base, op_name) or anchored(base, f"jit_{op_name}"):
                total += st.total
        return total

    @staticmethod
    def _agg(events):
        out = {}
        for name, durs in events.items():
            st = EventStats(name)
            for d in durs:
                st.add(d)
            if st.calls:
                out[name] = st
        return out

    def sorted_ops(self, sorted_by=SortedKeys.CPUTotal):
        return sorted(self.ops.values(), key=_SORT_FIELD[sorted_by],
                      reverse=True)

    def phase_stats(self):
        """ModelView rows: user events bucketed into canonical phases by
        name prefix (case-insensitive)."""
        buckets = defaultdict(lambda: EventStats(""))
        for name, st in self.user.items():
            low = name.lower()
            phase = next((p for p in _PHASES[:-1] if low.startswith(p)),
                         "other")
            b = buckets[phase]
            b.name = phase
            b.calls += st.calls
            b.total += st.total
            b.max = max(b.max, st.max)
            b.min = min(b.min, st.min)
        return [buckets[p] for p in _PHASES if p in buckets]


# --------------------------------------------------------------------------
# table rendering (reference _build_table)
# --------------------------------------------------------------------------

_UNIT = {"s": 1.0, "ms": 1e3, "us": 1e6}


def _fmt_row(cols, widths):
    return "  ".join(str(c).ljust(w) if i == 0 else str(c).rjust(w)
                     for i, (c, w) in enumerate(zip(cols, widths)))


def _table(title, headers, rows):
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(headers)]
    sep = "-" * (sum(widths) + 2 * (len(widths) - 1))
    out = [sep, title.center(len(sep)), sep, _fmt_row(headers, widths), sep]
    out += [_fmt_row(r, widths) for r in rows]
    out.append(sep)
    return "\n".join(out)


def _t(x, scale):
    return f"{x * scale:.3f}"


def _stat_rows(stats, total, scale):
    rows = []
    for s in stats:
        ratio = (s.total / total * 100.0) if total else 0.0
        rows.append((s.name, s.calls, _t(s.total, scale), _t(s.avg, scale),
                     _t(s.max, scale), _t(s.min, scale), f"{ratio:.2f}%"))
    return rows


def build_table(data: StatisticData, sorted_by=SortedKeys.CPUTotal,
                views=None, time_unit="ms", row_limit=100, op_detail=True):
    """Render the summary views (reference `_build_table`). Returns str."""
    if isinstance(views, SummaryView):
        views = [views]
    scale = _UNIT.get(time_unit, 1e3)
    total_host = sum(s.total for s in data.ops.values())
    blocks = []

    def want(v):
        return views is None or v in views

    if want(SummaryView.OverView):
        rows = [("ProfileStep", len(data.step_times),
                 _t(sum(data.step_times), scale),
                 _t(sum(data.step_times) / len(data.step_times)
                    if data.step_times else 0.0, scale)),
                ("OperatorDispatch (host)",
                 sum(s.calls for s in data.ops.values()),
                 _t(total_host, scale),
                 _t(total_host / max(len(data.step_times), 1), scale)),
                ("UserDefined events",
                 sum(s.calls for s in data.user.values()),
                 _t(sum(s.total for s in data.user.values()), scale),
                 "-"),
                ("Device busy (kernels)",
                 sum(s.calls for s in data.device.values()),
                 _t(data.device_total, scale),
                 _t(data.device_total / max(len(data.step_times), 1),
                    scale))]
        blocks.append(_table(
            f"Overview Summary (time unit: {time_unit})",
            ("Event", "Calls", "Total", "Avg/Step"), rows))

    phases = data.phase_stats()
    if want(SummaryView.ModelView) and phases:
        total_u = sum(s.total for s in phases)
        blocks.append(_table(
            f"Model Summary (time unit: {time_unit})",
            ("Phase", "Calls", "Total", "Avg", "Max", "Min", "Ratio"),
            _stat_rows(phases, total_u, scale)))

    if want(SummaryView.OperatorView) and op_detail and data.ops:
        stats = data.sorted_ops(sorted_by)[:row_limit]
        rows = []
        for s, base in zip(stats, _stat_rows(stats, total_host, scale)):
            dv = data.device_for_op(s.name)
            rows.append(base[:6] + (_t(dv, scale) if dv else "-",)
                        + base[6:])
        blocks.append(_table(
            f"Operator Summary (host dispatch + device, time unit: "
            f"{time_unit}, sorted by {sorted_by.name})",
            ("Operator", "Calls", "Total", "Avg", "Max", "Min",
             "DevTotal", "Ratio"), rows))

    if want(SummaryView.UDFView) and data.user:
        stats = sorted(data.user.values(), key=lambda s: -s.total)[:row_limit]
        total_u = sum(s.total for s in stats)
        blocks.append(_table(
            f"UserDefined Summary (time unit: {time_unit})",
            ("Name", "Calls", "Total", "Avg", "Max", "Min", "Ratio"),
            _stat_rows(stats, total_u, scale)))

    if want(SummaryView.MemoryView) and torch.cuda.is_available():
        blocks.append(_table(
            "Memory Summary (device, bytes)",
            ("Metric", "Value"),
            [("max_memory_allocated", torch.cuda.max_memory_allocated()),
             ("max_memory_reserved", torch.cuda.max_memory_reserved())]))

    if want(SummaryView.KernelView) or want(SummaryView.DeviceView):
        if data.device:
            stats = sorted(data.device.values(),
                           key=lambda s: -s.total)[:row_limit]
            blocks.append(_table(
                f"Kernel Summary (device, from torch.profiler, time unit: "
                f"{time_unit})",
                ("Kernel", "Calls", "Total", "Avg", "Max", "Min", "Ratio"),
                _stat_rows(stats, data.device_total, scale)))
        else:
            blocks.append(
                "Device kernel timelines: no device lanes in this trace "
                "(host-only run); on the card torch.profiler's kernel "
                "events feed the Kernel Summary and the Operator DevTotal "
                "column.")

    return "\n\n".join(blocks)
