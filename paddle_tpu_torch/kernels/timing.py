"""CUDA-event times of one kernel call on a cold L2 cache, as
`chip_smoke.py`'s timing phase and the kernel sweeps (`sweep_decode`,
`sweep_rms`) take them.

Before each timed call the 50 MB L2 cache is flushed by one of two
methods, and the card may be held busy while the host enqueues the call:

  "write"  256 MB of zeros written over a scratch buffer: L2 is left full
           of dirty lines, which the timed call's own reads must write back
           to evict;
  "read"   a separate 256 MB buffer read (summed): L2 is left full of clean
           lines, which evict for free.
  sleep    `torch.cuda._sleep` spins the card for about 0.2 ms after the
           flush, so that the host's work for the call (the wrapper's
           checks, allocations and launch) is enqueued before the start
           event runs and is not timed.

`METHOD` is the one the kernel table in PERF.md uses: of the four, it
alone times neither the write-back of another call's dirty lines nor the
host's work (PERF.md §6 has the comparison, all four in one process);
`methods_ms` gives all four. Needs a card.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["ColdL2", "METHOD", "METHODS", "cold_ms", "methods_ms"]

# (flush, sleep) of the kernel table
METHOD = ("read", True)
METHODS = (("write", False), ("write", True), ("read", False),
           ("read", True))
SLEEP_CYCLES = 400_000   # ~0.2 ms at the H100's clock: the host's enqueue


class ColdL2:
    """Two 256 MB buffers on `device`: one written, one read, to flush L2
    before a timed call."""

    def __init__(self, device, mb=256):
        self.dirty = torch.empty(mb * 2**20, dtype=torch.uint8, device=device)
        self.clean = torch.zeros(mb * 2**18, dtype=torch.float32,
                                 device=device)

    def flush(self, how):
        if how == "write":
            self.dirty.zero_()
        elif how == "read":
            self.sink = self.clean.sum()
        else:
            raise ValueError(f"flush by 'write' or 'read', not {how!r}")


def cold_ms(fn, l2, method=METHOD, iters=20):
    """Median device time of fn() in ms over `iters` calls, CUDA events
    around each, L2 flushed before each by `method` = (flush, sleep)."""
    how, sleep = method
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        l2.flush(how)
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


def methods_ms(fn, l2, iters=20):
    """{(flush, sleep): cold_ms} for every method of METHODS."""
    return {m: cold_ms(fn, l2, m, iters) for m in METHODS}
