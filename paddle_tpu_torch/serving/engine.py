"""Continuous-batching serving engine with a slot-based KV cache (port of
`paddle_tpu/serving/engine.py`).

Iteration-level scheduling (Orca, OSDI'22) over one fixed KV cache
[L, S, nkv, max_len, hd] whose batch axis is S SLOTS, each owned by at most
one in-flight request. Every `step()` either PREFILLS the next queued
request into a free slot (prompt right-padded to a power-of-two bucket, the
next-token logits taken at the true last token) or runs ONE batched decode
step across all S slots with a per-row position vector. Rows that emit
their EOS or reach max_new_tokens retire at once and their slot takes the
next waiting request on a later step.

Host/device split: the scheduler (queue, slot table, retire/admit,
streaming callbacks, metrics) runs in Python between steps; the steps run
the model on the engine's device, writing the cache in place. Greedy by
default; per-request sampling rides the same steps (`Request(temperature=,
top_p=, top_k=, seed=)`), greedy rows staying exact argmax.

`PagedEngine` (serving/paged_engine.py) subclasses this scheduler loop
with a paged KV cache and prefix reuse.
"""

from __future__ import annotations

import itertools
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch.device import check_device, resolve_device
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models import llama_functional as lf
from paddle_tpu_torch.serving.metrics import Metrics
from paddle_tpu_torch.serving.sampler import SlotSampler, pick
from paddle_tpu_torch.serving.scheduler import (AdmissionQueue, SlotTable,
                                                bucket_for)

__all__ = ["Request", "Engine"]

_req_ids = itertools.count()


class Request:
    """One generation request.

    stream_cb(request, token_id, finished) fires once per generated token,
    in emission order, from the host scheduler. After completion:
    `token_ids` (generated tokens, incl. the EOS if one was emitted),
    `finish_reason` ('eos' | 'length'), `ttft_s` (first emitted token),
    `prefill_done_s` (prompt fully in the KV cache).

    Sampling: temperature 0 (default) is exactly greedy; temperature > 0
    samples with optional nucleus top_p and top-k cutoffs. `seed` fixes
    the request's own stream: its tokens depend only on (seed, position),
    not on the other requests in its steps (default: the request id).
    """

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 stream_cb=None, request_id=None, temperature=0.0,
                 top_p=1.0, top_k=0, seed=None):
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.stream_cb = stream_cb
        self.request_id = (next(_req_ids) if request_id is None
                           else request_id)
        self.temperature = float(temperature)
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        if seed is None:
            try:
                seed = int(self.request_id)
            except (TypeError, ValueError):
                # stable across processes, unlike hash() of a str
                seed = zlib.crc32(str(self.request_id).encode())
        self.seed = int(seed) & 0x7FFFFFFF
        self.token_ids = []
        self.finished = False
        self.finish_reason = None
        self.submit_time = None
        self.submit_step = None
        self.first_token_time = None
        self.finish_time = None
        self.ttft_s = None
        self.ttft_steps = None
        self.prefill_done_s = None
        self.prefill_done_steps = None

    def output_ids(self):
        """prompt + generated tokens."""
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.token_ids, np.int32)])


class Engine:
    """Continuous-batching engine over a `models.llama.Llama`.

    max_slots: S — concurrent in-flight requests (the decode batch).
    max_len:   per-slot KV capacity; prompt_len + max_new_tokens must stay
               within it.
    min_bucket: smallest prefill length bucket (power-of-two ladder up to
               max_len).
    device:    where the engine runs: CUDA unless "cpu" is passed; the
               model must live there.
    """

    def __init__(self, model, *, max_slots=4, max_len=256, min_bucket=16,
                 pad_id=0, metrics=None, device=None):
        self.device = resolve_device(device)
        check_device(model.device, self.device)
        self.model = model
        self.args = model.args
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.min_bucket = int(min_bucket)
        self.pad_id = int(pad_id)
        self.metrics = metrics if metrics is not None else Metrics()

        self.queue = AdmissionQueue(self.metrics)
        self.slots = SlotTable(self.max_slots)
        self._npos = np.zeros(self.max_slots, np.int32)   # next write pos
        self._last_tok = np.full(self.max_slots, self.pad_id, np.int32)
        self.sampler = SlotSampler(self.max_slots)
        self.step_count = 0
        self._stall_steps = 0     # decode work delayed by a prefill step
        self._setup_device_state()

    def _setup_device_state(self):
        """Allocate the KV cache (subclass hook: the paged engine replaces
        the per-slot stripes with a page pool)."""
        a = self.args
        self._ck = torch.zeros(
            (a.num_layers, self.max_slots, a.num_kv_heads, self.max_len,
             a.head_dim), dtype=self.model.dtype, device=self.device)
        self._cv = torch.zeros_like(self._ck)
        self._cos, self._sin = lf.rope_tables(self.max_len, a.head_dim,
                                              a.rope_theta, self.device)

    # -- admission ----------------------------------------------------------
    def submit(self, req):
        """Queue a Request (or raw prompt ids). Returns the Request."""
        if not isinstance(req, Request):
            req = Request(req)
        n = int(req.prompt_ids.size)
        bucket_for(n, self.min_bucket, self.max_len)  # length must fit
        if n + req.max_new_tokens > self.max_len + 1:
            raise ValueError(
                f"request needs {n} prompt + {req.max_new_tokens} new "
                f"tokens but the slot capacity is max_len={self.max_len}")
        req.submit_time = time.perf_counter()
        req.submit_step = self.step_count
        self.queue.push(req)
        self.metrics.inc("requests_submitted")
        return req

    # -- the iteration-level scheduler --------------------------------------
    def step(self):
        """One engine iteration: admit-and-prefill if a request is waiting
        and a slot is free (paged engines also require page capacity),
        else one batched decode step over all active slots, else idle.
        Returns a small event dict."""
        ev = self._step_action()
        self.step_count += 1
        self.metrics.observe("slot_occupancy", self.slots.occupancy())
        self.metrics.set_gauge("active_slots", len(self.slots.active_slots))
        return ev

    def _step_action(self):
        """This iteration's unit of work (subclass hook: the paged engine
        interleaves chunked-prefill streams and swaps decode for
        speculate-and-verify)."""
        if self._can_prefill():
            self._note_prefill_stall()
            return self._prefill_step()
        if self._decodable_slots():
            return self._decode_step()
        return {"type": "idle"}

    def _note_prefill_stall(self):
        """Count a prefill step taken while decodable slots waited."""
        if self._decodable_slots():
            self._stall_steps += 1
            self.metrics.set_gauge("prefill_stall_steps", self._stall_steps)

    def _decodable_slots(self):
        """Slots a batched decode step advances (subclass hook: the paged
        engine leaves out slots whose prompt is still mid-chunked-prefill)."""
        return self.slots.active_slots

    def _can_prefill(self):
        """True when the queue head can be admitted this step (subclass
        hook: the paged engine also checks page-pool capacity)."""
        return bool(self.queue and self.slots.free_count)

    def run_until_idle(self):
        """Drive step() until every queued/active request completes."""
        while self.queue or self.slots.active_slots:
            self.step()

    def serve(self, requests):
        """Submit all, run to completion, return them."""
        reqs = [self.submit(r) for r in requests]
        self.run_until_idle()
        return reqs

    def replay(self, trace):
        """Replay an arrival trace: each entry {'arrival_step', 'prompt',
        'max_new_tokens'[, 'eos_token_id', 'request_id', 'temperature',
        'top_p', 'top_k', 'seed']} is submitted once the engine reaches its
        arrival step. Returns the Requests in trace order."""
        pending = sorted(trace, key=lambda t: t["arrival_step"])
        out = {}
        i = 0
        while i < len(pending) or self.queue or self.slots.active_slots:
            while (i < len(pending)
                   and pending[i]["arrival_step"] <= self.step_count):
                t = pending[i]
                req = Request(t["prompt"], t["max_new_tokens"],
                              eos_token_id=t.get("eos_token_id"),
                              request_id=t.get("request_id"),
                              temperature=t.get("temperature", 0.0),
                              top_p=t.get("top_p", 1.0),
                              top_k=t.get("top_k", 0),
                              seed=t.get("seed"))
                out[id(t)] = self.submit(req)
                i += 1
            self.step()
        return [out[id(t)] for t in trace]

    def reset(self):
        """Forget all requests and slots and clear the metrics."""
        if self.queue or self.slots.active_slots:
            raise RuntimeError("reset() with requests still in flight")
        self.metrics.reset()
        self.queue = AdmissionQueue(self.metrics)
        self.slots = SlotTable(self.max_slots)
        self._npos[:] = 0
        self._last_tok[:] = self.pad_id
        self.sampler.reset()
        self.step_count = 0
        self._stall_steps = 0

    # -- internals ----------------------------------------------------------
    def _admit(self, req):
        slot = self.slots.admit(req)
        self.sampler.admit(slot, req)
        return slot

    def _record_prefill_done(self, req):
        if req.prefill_done_s is not None:
            return
        req.prefill_done_s = time.perf_counter() - req.submit_time
        req.prefill_done_steps = self.step_count - req.submit_step
        self.metrics.observe("prefill_done_s", req.prefill_done_s)
        self.metrics.observe("prefill_done_steps", req.prefill_done_steps)

    def _record_first_token(self, req):
        now = time.perf_counter()
        req.first_token_time = now
        req.ttft_s = now - req.submit_time
        req.ttft_steps = self.step_count - req.submit_step
        self.metrics.observe("ttft_s", req.ttft_s)
        self.metrics.observe("ttft_steps", req.ttft_steps)

    def _prefill_step(self):
        req = self.queue.pop()
        slot = self._admit(req)
        n = int(req.prompt_ids.size)
        bucket, first = self._prefill_device(req, slot, n)
        return self._complete_prefill(req, slot, bucket, first, n)

    def _complete_prefill(self, req, slot, bucket, first, n):
        """Book-keep a finished prefill: TTFT, counters, position, the
        first emitted token."""
        self._record_prefill_done(req)
        self._record_first_token(req)
        self.metrics.inc("prefills")
        self.metrics.inc("tokens_generated")
        self._npos[slot] = n
        self._last_tok[slot] = first
        self._emit(req, first)
        if req.finished:
            self._retire(slot)
        return {"type": "prefill", "request_id": req.request_id,
                "slot": slot, "bucket": bucket, "token": first}

    def _pick_first(self, logits, req, pos):
        return int(pick(logits, req.temperature > 0, req.temperature,
                        req.top_p, req.top_k, [req.seed], [pos])[0])

    def _prefill_device(self, req, slot, n):
        """Prefill the prompt into the slot's stripe (zeroed first, then
        written in place). Returns (bucket, first_token)."""
        bucket = bucket_for(n, self.min_bucket, self.max_len)
        padded = np.full((1, bucket), self.pad_id, np.int32)
        padded[0, :n] = req.prompt_ids
        with self.metrics.timer("prefill_s"):
            sck = self._ck[:, slot:slot + 1]
            scv = self._cv[:, slot:slot + 1]
            sck.zero_()
            scv.zero_()
            logits, _, _ = gen._forward_cached(
                self.model, torch.from_numpy(padded).to(self.device), sck,
                scv, 0, self._cos, self._sin, last_idx=n - 1)
            first = self._pick_first(logits, req, n)
        return bucket, first

    def _decode_step(self):
        active = self._decodable_slots()
        nxt = self._decode_device(active)
        emitted = {}
        for slot in active:
            self._npos[slot] += 1
            tok = int(nxt[slot])
            self._last_tok[slot] = tok
            req = self.slots.owner(slot)
            self._emit(req, tok)
            emitted[req.request_id] = tok
            if req.finished:
                self._retire(slot)
        self.metrics.inc("decode_steps")
        self.metrics.inc("tokens_generated", len(active))
        self.metrics.observe("tokens_per_decode_step", len(active))
        return {"type": "decode", "tokens": emitted}

    def _pick_batch(self, logits, active):
        temp, top_p, top_k, seeds = self.sampler.args()
        nxt = pick(logits, self.sampler.any_sampling(active), temp, top_p,
                   top_k, seeds, self._npos + 1)
        return nxt.cpu().numpy()

    def _decode_device(self, active):
        """One batched decode step over all S slots (inactive rows decode a
        pad at position 0, never read). Returns next tokens [S] on host."""
        with self.metrics.timer("decode_step_s"):
            logits, _, _ = gen._forward_cached(
                self.model,
                torch.from_numpy(self._last_tok).to(self.device)[:, None],
                self._ck, self._cv,
                torch.from_numpy(self._npos).to(self.device), self._cos,
                self._sin)
            return self._pick_batch(logits, active)

    def _emit(self, req, token):
        req.token_ids.append(token)
        finished, reason = False, None
        if req.eos_token_id is not None and token == req.eos_token_id:
            finished, reason = True, "eos"
        elif len(req.token_ids) >= req.max_new_tokens:
            finished, reason = True, "length"
        if req.stream_cb is not None:
            req.stream_cb(req, token, finished)
        if finished:
            req.finished = True
            req.finish_reason = reason
            req.finish_time = time.perf_counter()
            self.metrics.inc("requests_finished")

    def _retire(self, slot):
        self.slots.retire(slot)
        self._npos[slot] = 0
        self._last_tok[slot] = self.pad_id
        self.sampler.clear(slot)
