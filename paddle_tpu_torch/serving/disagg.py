"""Disaggregated prefill/decode serving: KV-page migration between
role-restricted engines (port of `paddle_tpu/serving/disagg.py`).

Prefill is one large compute-bound forward, decode a memory-bound trickle;
inside one `PagedEngine` every long prompt takes whole scheduler steps
from every decoding slot. DistServe/Splitwise give each role its own
worker. A sequence's KV cache is a list of page ids, so a finished prefill
moves to the decode worker by shipping page CONTENTS and metadata, not by
recomputing anything.

  `PrefillWorker` (a `PagedEngine` whose decode path is off) admits
  requests and runs their prefills — prefix cache, chunked streams and
  length buckets unchanged. At a prompt's completion it gathers the
  slot's pages ([L, P, nkv, ps, hd], `index_select` along the pool's page
  axis; an int8 pool ships its codes AND per-(page, kv head) scales as
  they are), emits the first token, packs a `KVHandoff`, sends it, and
  retires the slot as a local retire would.

  `DecodeWorker` (a `PagedEngine` that never prefills) polls the
  transport; each hand-off that fits gets fresh pages, the shipped
  contents `index_copy_`'d into its own pool, and its block table,
  position, reservation and last token seated before the next decode
  step (kernel B6, or B7 over an int8 pool, whose key split is cut for
  the largest seated position). The bytes move bit for bit, so the
  continuation is the monolithic engine's.

  Transports: `LocalTransport`, an in-process queue that still sends
  every hand-off as `KVHandoff.to_bytes()`, and `StoreTransport`, the
  same bytes through a `torch.distributed.TCPStore` for two processes.

  `DisaggServer` wires one worker of each role over a transport in one
  process and mirrors completions back onto the submitted Requests.

The wire format is the reference's, byte for byte: an 8-byte
little-endian header length, the JSON header, the int32 prompt, then the
leaves (K then V; an int8 pool's codes then scales for each), raw.
"""

from __future__ import annotations

import json
import time
import warnings
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.models.generation import QuantizedKVPage
from paddle_tpu_torch.serving.engine import Request
from paddle_tpu_torch.serving.paged_engine import PagedEngine, _leaves
from paddle_tpu_torch.serving.scheduler import pages_for

__all__ = ["KVHandoff", "LocalTransport", "StoreTransport",
           "PrefillWorker", "DecodeWorker", "DisaggServer"]

# the numpy dtype names the reference writes into the header, for the pool
# leaves there are: f32 or bf16 pages, an int8 pool's codes and f32 scales
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}
_FROM_WIRE = {v: k for k, v in _WIRE_DTYPES.items()}


def _map_pool(fn, pool, *others):
    """fn over each tensor of a pool half (and the matching tensors of
    `others`), keeping the half's structure."""
    if isinstance(pool, QuantizedKVPage):
        return QuantizedKVPage(*(fn(*ts) for ts in zip(pool, *others)))
    return fn(pool, *others)


def _extract_pages(pool, idx):
    """Pages `idx` (int64 [P], on the pool's device) of every layer and
    every leaf: [L, P, ...]. The pool is left as it was."""
    return _map_pool(lambda t: t.index_select(1, idx), pool)


def _scatter_pages(pool, idx, data):
    """Write extracted pages `data` (any device) into pages `idx` of the
    pool in place: the inverse of `_extract_pages`, leaf by leaf (int8
    codes and scales land as they are: no re-quantization)."""
    _map_pool(lambda t, d: t.index_copy_(1, idx, d.to(t.device)), pool, data)


class KVHandoff:
    """One finished prefill, packed for migration: the request's identity
    and sampling parameters, the first (already emitted) token, and the
    slot's page contents. `pages_k`/`pages_v` mirror the pool's leaves:
    tensors, or `QuantizedKVPage(q, scale)`, on any device."""

    def __init__(self, *, request_id, prompt_ids, max_new_tokens,
                 eos_token_id, temperature, top_p, top_k, seed, first,
                 pages_k, pages_v, sent_at=None):
        self.request_id = request_id
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.first = int(first)
        self.pages_k = pages_k
        self.pages_v = pages_v
        # wall clock (time.time: comparable across processes, unlike
        # perf_counter) at send; the receiver's admit measures the
        # hand-off latency from it
        self.sent_at = sent_at

    @property
    def num_pages(self):
        return int(self._leaves()[0].shape[1])

    def _leaves(self):
        return _leaves(self.pages_k) + _leaves(self.pages_v)

    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in self._leaves())

    def to_bytes(self):
        """The wire format (module docstring), as a bytearray: each leaf
        is copied once, straight from its device into the blob."""
        leaves = self._leaves()
        meta = {
            "request_id": self.request_id,
            "max_new_tokens": self.max_new_tokens,
            "eos_token_id": self.eos_token_id,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "top_k": self.top_k,
            "seed": self.seed,
            "first": self.first,
            "sent_at": self.sent_at,
            "prompt_len": int(self.prompt_ids.size),
            "quantized": isinstance(self.pages_k, QuantizedKVPage),
            "leaves": [{"dtype": _WIRE_DTYPES[t.dtype],
                        "shape": list(t.shape),
                        "nbytes": t.numel() * t.element_size()}
                       for t in leaves],
        }
        head = json.dumps(meta).encode()
        prompt = self.prompt_ids.tobytes()
        off = 8 + len(head) + len(prompt)
        blob = bytearray(off + self.nbytes())
        blob[:8] = len(head).to_bytes(8, "little")
        blob[8:8 + len(head)] = head
        blob[8 + len(head):off] = prompt
        buf = torch.frombuffer(blob, dtype=torch.uint8)
        for t, d in zip(leaves, meta["leaves"]):
            buf[off:off + d["nbytes"]].copy_(
                t.contiguous().reshape(-1).view(torch.uint8))
            off += d["nbytes"]
        return blob

    @classmethod
    def from_bytes(cls, blob):
        """Parse a blob (bytes or bytearray); the page leaves are CPU
        tensors viewing the blob, not copies."""
        hlen = int.from_bytes(blob[:8], "little")
        meta = json.loads(bytes(blob[8:8 + hlen]).decode())
        off = 8 + hlen
        n = meta["prompt_len"]
        prompt = np.frombuffer(blob, np.int32, count=n, offset=off).copy()
        off += prompt.nbytes
        leaves = []
        with warnings.catch_warnings():
            # a `bytes` blob is read-only; the views are only ever read
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable", UserWarning)
            for d in meta["leaves"]:
                raw = torch.frombuffer(blob, dtype=torch.uint8,
                                       count=d["nbytes"], offset=off)
                leaves.append(raw.view(_FROM_WIRE[d["dtype"]])
                              .view(d["shape"]))
                off += d["nbytes"]
        if meta["quantized"]:
            pages_k = QuantizedKVPage(leaves[0], leaves[1])
            pages_v = QuantizedKVPage(leaves[2], leaves[3])
        else:
            pages_k, pages_v = leaves
        return cls(request_id=meta["request_id"], prompt_ids=prompt,
                   max_new_tokens=meta["max_new_tokens"],
                   eos_token_id=meta["eos_token_id"],
                   temperature=meta["temperature"], top_p=meta["top_p"],
                   top_k=meta["top_k"], seed=meta["seed"],
                   first=meta["first"], pages_k=pages_k, pages_v=pages_v,
                   sent_at=meta["sent_at"])


class LocalTransport:
    """In-process hand-off queue. Every payload still goes through
    `KVHandoff.to_bytes()`, the byte path `StoreTransport` ships."""

    def __init__(self):
        self._q = deque()

    def send(self, blob):
        self._q.append(blob)

    def recv(self):
        return self._q.popleft() if self._q else None

    @property
    def pending(self):
        return len(self._q)


class StoreTransport:
    """Byte transport over a `torch.distributed.TCPStore` (or any store
    with set/get/add): the sender publishes numbered messages under
    `channel/m{i}` and bumps the counter `channel/n`; the receiver reads
    the counter without blocking (`add(key, 0)` creates or reads it) and
    fetches in order. One direction per instance."""

    def __init__(self, store, channel="disagg"):
        self.store = store
        self.channel = channel
        self._sent = 0
        self._seen = 0

    def send(self, blob):
        self.store.set(f"{self.channel}/m{self._sent}", blob)
        self._sent += 1
        self.store.add(f"{self.channel}/n", 1)

    def recv(self):
        n = int(self.store.add(f"{self.channel}/n", 0))
        if self._seen >= n:
            return None
        blob = self.store.get(f"{self.channel}/m{self._seen}")
        self._seen += 1
        return blob

    @property
    def pending(self):
        return int(self.store.add(f"{self.channel}/n", 0)) - self._seen


def _no_draft(kw, role):
    if kw.get("draft_params") is not None:
        raise ValueError(f"disaggregated workers do not run speculative "
                         f"decoding ({role})")


class PrefillWorker(PagedEngine):
    """A `PagedEngine` in the PREFILL role: `_decodable_slots` is empty, so
    a step only ever prefills (whole or chunk-streamed), and a completed
    prompt is extracted, sent, and retired instead of staying seated for
    decode. Prefix cache, chunked prefill, buckets and page accounting are
    the base engine's."""

    def __init__(self, model, *, transport, **kw):
        _no_draft(kw, "the draft mirror belongs to the decode role")
        self.transport = transport
        super().__init__(model, **kw)

    def _decodable_slots(self):
        return []

    def _build_handoff(self, req, slot, first):
        idx = torch.tensor(self._bt[slot], dtype=torch.long,
                           device=self.device)
        with self.metrics.timer("page_extract_s"):
            pk = _extract_pages(self._pk, idx)
            pv = _extract_pages(self._pv, idx)
        return KVHandoff(
            request_id=req.request_id, prompt_ids=req.prompt_ids,
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.eos_token_id, temperature=req.temperature,
            top_p=req.top_p, top_k=req.top_k, seed=req.seed, first=first,
            pages_k=pk, pages_v=pv, sent_at=time.time())

    def _complete_prefill(self, req, slot, bucket, first, n):
        ev = super()._complete_prefill(req, slot, bucket, first, n)
        if not req.finished:
            pkg = self._build_handoff(req, slot, first)
            with self.metrics.timer("handoff_pack_s"):
                blob = pkg.to_bytes()
            self.transport.send(blob)
            self.metrics.inc("handoffs_sent")
            self.metrics.inc("handoff_pages", pkg.num_pages)
            self.metrics.inc("handoff_bytes", pkg.nbytes())
            # the decode worker owns the sequence now: release the pages
            # and refund the reservation here; _retire also registers the
            # prompt's pages in this worker's prefix cache
            self._retire(slot)
            ev = dict(ev, type="prefill_handoff")
        return ev


class DecodeWorker(PagedEngine):
    """A `PagedEngine` in the DECODE role: it never admits from its own
    queue (`_can_prefill` is False); each step drains the transport and
    seats every hand-off that fits, then runs the batched paged decode
    over all seated slots. `completion_cb(req)` fires at each request's
    retirement (the `DisaggServer` mirror hook)."""

    def __init__(self, model, *, transport, completion_cb=None, **kw):
        _no_draft(kw, "the draft has no prompt mirror on the decode side")
        self.transport = transport
        self.completion_cb = completion_cb
        self._inbox = deque()
        super().__init__(model, **kw)

    def _can_prefill(self):
        return False

    def _can_admit(self, pkg):
        if not self.slots.free_count:
            return False
        # fresh pages for the shipped contents plus the decode tail's
        # reservation, as a local admission would post
        total = pages_for(pkg.prompt_ids.size, pkg.max_new_tokens,
                          self.page_size)
        return total <= self._alloc.available - self._reserved_total

    def admit_handoff(self, pkg):
        """Seat one migrated sequence; returns its (local) Request. The
        caller has checked `_can_admit`."""
        n = int(pkg.prompt_ids.size)
        req = Request(pkg.prompt_ids, pkg.max_new_tokens,
                      eos_token_id=pkg.eos_token_id,
                      request_id=pkg.request_id,
                      temperature=pkg.temperature, top_p=pkg.top_p,
                      top_k=pkg.top_k, seed=pkg.seed)
        req.submit_time = time.perf_counter()
        req.submit_step = self.step_count
        # the prefill side emitted the first token: eos and length
        # accounting continue from it
        req.token_ids = [pkg.first]
        slot = self._admit(req)
        pages = [self._alloc.alloc() for _ in range(pkg.num_pages)]
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        with self.metrics.timer("page_scatter_s"):
            _scatter_pages(self._pk, idx, pkg.pages_k)
            _scatter_pages(self._pv, idx, pkg.pages_v)
        self._bt[slot] = pages
        resv = pages_for(n, pkg.max_new_tokens, self.page_size) - len(pages)
        self._resv[slot] = resv
        self._reserved_total += resv
        # the next KV write lands at the prompt length (the first token's
        # k/v is written by the next decode step, as after a local
        # prefill); the decode step cuts its key split from _npos
        self._npos[slot] = n
        self._last_tok[slot] = pkg.first
        self.metrics.inc("handoffs_admitted")
        if pkg.sent_at is not None:
            self.metrics.observe("handoff_latency_s",
                                 max(0.0, time.time() - pkg.sent_at))
        return req

    def _drain_inbox(self):
        while True:
            blob = self.transport.recv()
            if blob is None:
                break
            self._inbox.append(KVHandoff.from_bytes(blob))
        admitted = 0
        while self._inbox and self._can_admit(self._inbox[0]):
            self.admit_handoff(self._inbox.popleft())
            admitted += 1
        if self._inbox:
            self.metrics.inc("handoff_defer_steps")
        return admitted

    def _step_action(self):
        admitted = self._drain_inbox()
        if self._decodable_slots():
            ev = self._decode_step()
            if admitted:
                ev = dict(ev, admitted=admitted)
            return ev
        if admitted:
            return {"type": "handoff_admit", "count": admitted}
        return {"type": "idle"}

    @property
    def busy(self):
        return bool(self.slots.active_slots or self._inbox)

    def _retire(self, slot):
        req = self.slots.owner(slot)
        super()._retire(slot)
        if req is not None and self.completion_cb is not None:
            self.completion_cb(req)


class DisaggServer:
    """One PrefillWorker and one DecodeWorker over a transport
    (`LocalTransport` by default), each with its own page pool, as two
    hosts would have, on one device. `submit()` goes to the prefill side;
    completions are mirrored back onto the submitted Requests, so callers
    see a monolithic engine's surface. `kw` goes to both workers
    (`device=`: CUDA unless "cpu" is passed)."""

    def __init__(self, model, *, transport=None, **kw):
        self.transport = transport if transport is not None \
            else LocalTransport()
        self.prefill = PrefillWorker(model, transport=self.transport, **kw)
        self.decode = DecodeWorker(model, transport=self.transport,
                                   completion_cb=self._on_complete, **kw)
        self._orig = {}

    def _on_complete(self, twin):
        orig = self._orig.pop(twin.request_id, None)
        if orig is None or orig is twin:
            return
        # twin.token_ids[0] is the first token the prefill side already
        # emitted into orig: mirror the whole list
        orig.token_ids = list(twin.token_ids)
        orig.finished = twin.finished
        orig.finish_reason = twin.finish_reason
        orig.finish_time = twin.finish_time

    def submit(self, req):
        if not isinstance(req, Request):
            req = Request(req)
        self._orig[req.request_id] = req
        return self.prefill.submit(req)

    def step(self):
        self.prefill.step()
        self.decode.step()

    def _prefill_busy(self):
        p = self.prefill
        return bool(p.queue or p.slots.active_slots or p._chunk_streams)

    @property
    def busy(self):
        return bool(self._prefill_busy() or self.transport.pending
                    or self.decode.busy)

    def run_until_idle(self):
        stalled = 0
        while self.busy:
            self.step()
            progressed = (self._prefill_busy() or self.transport.pending
                          or self.decode.slots.active_slots)
            stalled = 0 if progressed else stalled + 1
            if stalled > 8 and self.decode._inbox:
                pkg = self.decode._inbox[0]
                need = pages_for(pkg.prompt_ids.size, pkg.max_new_tokens,
                                 self.decode.page_size)
                raise RuntimeError(
                    f"decode worker cannot seat handoff {pkg.request_id!r}: "
                    f"needs {need} pages, pool has "
                    f"{self.decode._alloc.available} available")

    def serve(self, requests):
        reqs = [self.submit(r) for r in requests]
        self.run_until_idle()
        return reqs
