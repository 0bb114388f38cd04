"""Admission queue, prompt-length buckets, page math and the slot table (a
copy of `paddle_tpu/serving/scheduler.py`; pure Python).

  - `bucket_for`: prompts prefill at the next power-of-two length (floored
    at min_bucket, capped at max_len);
  - `pages_for`: the worst-case page count a paged request reserves;
  - `AdmissionQueue`: FIFO of waiting requests, depth exported as a gauge;
  - `SlotTable`: S cache slots; admit() hands out the lowest free slot.
"""

from __future__ import annotations

from collections import deque

__all__ = ["bucket_for", "pages_for", "AdmissionQueue", "SlotTable"]


def bucket_for(n, min_bucket=16, max_bucket=None):
    """Smallest power-of-two >= n (floored at min_bucket, capped at
    max_bucket): prefill shapes come from a short ladder of lengths."""
    if n < 1:
        raise ValueError(f"bucket_for: need a non-empty prompt (n={n})")
    b = max(int(min_bucket), 1)
    while b < n:
        b *= 2
    if max_bucket is not None:
        if n > max_bucket:
            raise ValueError(
                f"prompt length {n} exceeds the largest bucket {max_bucket}")
        b = min(b, int(max_bucket))
    return b


def pages_for(prompt_len, max_new_tokens, page_size):
    """Worst-case page count for one request in the paged KV cache: KV is
    written for positions [0, prompt_len + max_new_tokens - 2] — the last
    emitted token is returned to the caller but its k/v is never written
    back (there is no further decode step to read it). This is what paged
    admission reserves up front, so a request admitted under FIFO can
    always finish without preemption."""
    last = int(prompt_len) + max(int(max_new_tokens), 1) - 2
    return max(last, 0) // int(page_size) + 1


class AdmissionQueue:
    """FIFO admission queue. Every mutation refreshes the queue-depth
    gauge on the shared metrics registry."""

    def __init__(self, metrics=None):
        self._q = deque()
        self._metrics = metrics

    def _gauge(self):
        if self._metrics is not None:
            self._metrics.set_gauge("queue_depth", len(self._q))

    def push(self, req):
        self._q.append(req)
        self._gauge()

    def pop(self):
        req = self._q.popleft()
        self._gauge()
        return req

    def peek(self):
        """Head of the queue without removing it (paged admission checks
        the head's page demand before committing a prefill step)."""
        return self._q[0]

    def peek_at(self, i):
        """Entry i without removing it (the chunked-prefill anti-convoy
        scan: a short prompt may pass queued longs while a chunk stream is
        in flight)."""
        return self._q[i]

    def pop_at(self, i):
        req = self._q[i]
        del self._q[i]
        self._gauge()
        return req

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)


class SlotTable:
    """S KV-cache slots; tracks which request owns which slot."""

    def __init__(self, n_slots):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> lowest slot
        self._owner = {}

    @property
    def free_count(self):
        return len(self._free)

    @property
    def active_slots(self):
        return sorted(self._owner)

    def owner(self, slot):
        return self._owner[slot]

    def admit(self, req):
        slot = self._free.pop()
        self._owner[slot] = req
        return slot

    def retire(self, slot):
        req = self._owner.pop(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)
        return req

    def occupancy(self):
        return len(self._owner) / self.n_slots
