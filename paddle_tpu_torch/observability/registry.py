"""Metrics registry (a copy of `paddle_tpu/observability/registry.py`).

Thread-safe counters (monotonic, labeled), gauges (last value + running
max, labeled) and fixed-bucket histograms with p50/p95/p99 (Prometheus
`histogram_quantile` rule, clamped to the observed [min, max]); exports a
deterministic, JSON-able `snapshot()`. The port keeps its own copy so that
it imports nothing of the JAX package. The process-global registry
(`global_registry`) is what the training monitor, the checkpoint manager
and the kernel tuner report to by default; the serving engine owns a
private registry per `Metrics`. The reference's Prometheus exporter and
declared bucket bounds are not carried over.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "global_registry",
           "set_global_registry"]

# 1-2.5-5 ladder per decade, 1us .. 5e9: wide enough that the same default
# serves second-scale timers, tokens/sec rates, and byte counts. Bounds are
# parsed from literals (not m * 10**e) so exporters print clean values.
DEFAULT_BUCKETS = tuple(float(f"{m}e{e}") for e in range(-6, 10)
                        for m in ("1", "2.5", "5"))


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(lkey):
    return ",".join(f"{k}={v}" for k, v in lkey)


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # [-1] = overflow (+Inf)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value):
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1

    def quantile(self, q):
        """Prometheus-style: interpolate inside the bucket whose cumulative
        count crosses rank q*count; the first bucket's lower edge is the
        observed min and the overflow bucket's upper edge is the observed
        max, with a final clamp to [min, max]."""
        if not self.count:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c > 0 and cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else self.min
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                v = lo + (hi - lo) * ((rank - cum) / c)
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    def stats(self):
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.sum / self.count if self.count else None,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Thread-safe counters / gauges / fixed-bucket histograms with labels."""

    def __init__(self, default_buckets=DEFAULT_BUCKETS):
        self._lock = threading.RLock()
        self._default_buckets = tuple(default_buckets)
        self._counters = {}      # name -> {lkey: value}
        self._gauges = {}        # name -> {lkey: {"value", "max"}}
        self._hists = {}         # name -> {lkey: _Histogram}

    # -- counters -----------------------------------------------------------
    def inc(self, name, value=1, labels=None):
        k = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[k] = series.get(k, 0) + value

    def counter(self, name, labels=None):
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0)

    # -- gauges -------------------------------------------------------------
    def set_gauge(self, name, value, labels=None):
        k = _label_key(labels)
        with self._lock:
            series = self._gauges.setdefault(name, {})
            g = series.get(k)
            if g is None:
                series[k] = {"value": value, "max": value}
            else:
                g["value"] = value
                g["max"] = max(g["max"], value)

    def gauge(self, name, labels=None):
        with self._lock:
            g = self._gauges.get(name, {}).get(_label_key(labels))
            return g["value"] if g else 0

    # -- histograms ---------------------------------------------------------
    def observe(self, name, value, labels=None):
        k = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            h = series.get(k)
            if h is None:
                h = series[k] = _Histogram(self._default_buckets)
            h.add(value)

    def observation(self, name, labels=None):
        """count/sum/min/max/mean + p50/p95/p99, or None if never observed
        (the serving Metrics contract)."""
        with self._lock:
            h = self._hists.get(name, {}).get(_label_key(labels))
            return h.stats() if h else None

    def quantile(self, name, q, labels=None):
        """The q-quantile of a histogram series, or None if never
        observed."""
        with self._lock:
            h = self._hists.get(name, {}).get(_label_key(labels))
            return h.quantile(q) if h else None

    @contextlib.contextmanager
    def timer(self, name, labels=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, labels=labels)

    # -- export -------------------------------------------------------------
    def snapshot(self):
        """JSON-able nested dict: {kind: {name: {label_str: stats}}}.
        Deterministic ordering (sorted names / labels)."""
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for name in sorted(self._counters):
                out["counters"][name] = {
                    _label_str(k): v
                    for k, v in sorted(self._counters[name].items())}
            for name in sorted(self._gauges):
                out["gauges"][name] = {
                    _label_str(k): dict(g)
                    for k, g in sorted(self._gauges[name].items())}
            for name in sorted(self._hists):
                out["histograms"][name] = {
                    _label_str(k): h.stats()
                    for k, h in sorted(self._hists[name].items())}
            return out

    def reset(self):
        """Clear every counter, gauge and histogram."""
        with self._lock:
            self._counters = {}
            self._gauges = {}
            self._hists = {}



_GLOBAL = MetricsRegistry()
_GLOBAL_LOCK = threading.Lock()


def global_registry():
    """The process-wide registry."""
    return _GLOBAL


def set_global_registry(registry):
    """Swap the process-wide registry (tests isolate their runs this way);
    returns the previous one."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, registry
    return prev
