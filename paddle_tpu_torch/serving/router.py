"""SLO-aware multi-model router: one front door over many engines (port of
`paddle_tpu/serving/router.py`).

The engines below this layer serve one model each and treat every request
alike. A chat turn (someone watching tokens appear) and a batch job share
the pool, and many models share the card: the batch job should soak up
idle capacity and get out of the way the moment an interactive request
needs a slot.

  - MULTI-MODEL: a `Router` fronts named backends — Llama on a
    `PagedEngine`, GPT-2 on `GptEngine` (the stripe scheduler re-pointed
    at `models.gpt._gpt_forward_cached`: learned per-row positions, kernel
    B4 in decode and B5 in short prefills), and BERT on `BertBackend`, a
    model with no KV cache and no decode loop: pending embedding requests
    batch into one padded forward a step.
  - SLO CLASSES: every request carries `slo="interactive"|"batch"`. The
    router holds per-class queues and feeds an engine interactive-first;
    arrival order breaks ties within a class.
  - PREEMPTION: when an interactive request is blocked (no slot or no
    pages) and a batch request holds a slot, the router calls the paged
    engine's `preempt()`: the victim keeps its block table and page refs
    and is `resume()`d once no interactive work waits, continuing as an
    uninterrupted run would. Preempted requests outrank new batch
    admissions; interactive traffic can starve batch by design.
  - PER-TENANT / PER-MODEL TELEMETRY: labelled series on the router's
    registry — `router_requests` / `router_completed` /
    `router_tokens` counters, `router_ttft_s` and `router_tokens_per_s`
    histograms per model, `router_preemptions` / `router_resumes` per
    model and tenant, `router_queue_depth` and `router_preempted_held`
    gauges.

The router is host-side policy: everything it does is queue surgery
between `step()` calls, so the engines' parity guarantees pass through.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.device import check_device, resolve_device
from paddle_tpu_torch.models import gpt as gpt_m
from paddle_tpu_torch.serving.engine import Engine, Request
from paddle_tpu_torch.serving.metrics import Metrics
from paddle_tpu_torch.serving.scheduler import bucket_for

__all__ = ["SLO_CLASSES", "GptEngine", "EmbeddingRequest", "BertBackend",
           "Router"]

SLO_CLASSES = ("interactive", "batch")


# -- GPT on the stripe scheduler --------------------------------------------
class GptEngine(Engine):
    """The continuous-batching stripe scheduler serving a `models.gpt.Gpt`:
    the same queue, slot table and retire/admit loop, with the prefill and
    decode steps of `_gpt_forward_cached` over one cache [L, S, nh,
    max_len, hd]. The learned position table bounds `max_len`."""

    def _setup_device_state(self):
        args = self.args
        if self.max_len > args.max_position_embeddings:
            raise ValueError(
                f"max_len={self.max_len} exceeds the learned position "
                f"table ({args.max_position_embeddings})")
        self._ck, self._cv = gpt_m.gpt_cache(self.model, self.max_slots,
                                             self.max_len)

    def _prefill_device(self, req, slot, n):
        bucket = bucket_for(n, self.min_bucket, self.max_len)
        padded = np.full((1, bucket), self.pad_id, np.int32)
        padded[0, :n] = req.prompt_ids
        with self.metrics.timer("prefill_s"):
            sck = self._ck[:, slot:slot + 1]
            scv = self._cv[:, slot:slot + 1]
            sck.zero_()
            scv.zero_()
            logits, _, _ = gpt_m._gpt_forward_cached(
                self.model, torch.from_numpy(padded).to(self.device), sck,
                scv, 0, last_idx=n - 1)
            first = self._pick_first(logits, req, n)
        return bucket, first

    def _decode_device(self, active):
        with self.metrics.timer("decode_step_s"):
            logits, _, _ = gpt_m._gpt_forward_cached(
                self.model,
                torch.from_numpy(self._last_tok).to(self.device)[:, None],
                self._ck, self._cv,
                torch.from_numpy(self._npos).to(self.device))
            return self._pick_batch(logits, active)


# -- BERT as a non-autoregressive model class -------------------------------
_embed_ids = itertools.count()


class EmbeddingRequest:
    """A non-autoregressive request: one forward, the pooled [CLS] vector
    on `.embedding` (float32 numpy). Mirrors `Request`'s bookkeeping
    (submit/finish times, ttft) so the router meters both kinds alike."""

    def __init__(self, prompt_ids, request_id=None):
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")
        self.request_id = (next(_embed_ids) if request_id is None
                           else request_id)
        self.max_new_tokens = 0
        self.token_ids = []
        self.embedding = None
        self.finished = False
        self.finish_reason = None
        self.submit_time = None
        self.first_token_time = None
        self.finish_time = None
        self.ttft_s = None


class BertBackend:
    """Serves a `models.bert.Bert` encoder as embeddings: each `step()`
    takes up to `max_batch` pending requests, right-pads them to one
    length with a 0/1 attention mask, and runs one forward. No KV state,
    so nothing to preempt: SLO order is feed order. Runs on `device`
    (CUDA unless "cpu" is passed); the model must live there."""

    def __init__(self, model, *, max_batch=8, metrics=None, device=None):
        self.device = resolve_device(device)
        check_device(model.device, self.device)
        self.model = model
        self.max_batch = int(max_batch)
        self.metrics = metrics if metrics is not None else Metrics()
        self.queue = deque()
        self.step_count = 0

    def submit(self, req):
        if not isinstance(req, EmbeddingRequest):
            req = EmbeddingRequest(req)
        req.submit_time = time.perf_counter()
        self.queue.append(req)
        self.metrics.inc("requests_submitted")
        return req

    @property
    def busy(self):
        return bool(self.queue)

    def step(self):
        self.step_count += 1
        if not self.queue:
            return {"type": "idle"}
        k = min(self.max_batch, len(self.queue))
        batch = [self.queue.popleft() for _ in range(k)]
        s = max(int(r.prompt_ids.size) for r in batch)
        ids = np.zeros((k, s), np.int64)
        mask = np.zeros((k, s), np.int64)
        for i, r in enumerate(batch):
            ids[i, :r.prompt_ids.size] = r.prompt_ids
            mask[i, :r.prompt_ids.size] = 1
        with self.metrics.timer("embed_step_s"):
            _, pooled = self.model(torch.from_numpy(ids).to(self.device),
                                   torch.from_numpy(mask).to(self.device))
            pooled = pooled.float().cpu().numpy()
        now = time.perf_counter()
        for i, r in enumerate(batch):
            r.embedding = pooled[i]
            r.finished = True
            r.finish_reason = "embedding"
            r.first_token_time = now
            r.finish_time = now
            r.ttft_s = now - r.submit_time
            self.metrics.observe("ttft_s", r.ttft_s)
        self.metrics.inc("requests_finished", k)
        self.metrics.inc("embeds")
        self.metrics.observe("embed_batch_size", k)
        return {"type": "embed", "count": k}

    def run_until_idle(self):
        while self.busy:
            self.step()


# -- the router --------------------------------------------------------------
class Router:
    """Front door over named backends (`Engine`/`PagedEngine`/`GptEngine`
    instances or `BertBackend`s). Each `step()`, per backend:

      feed      an interactive request whenever the engine's admission
                queue is empty; else resume a preempted batch request if
                nothing interactive waits and capacity allows; else feed
                a batch request (never while preempted work waits);
      preempt   if the blocked queue head is (or is behind) interactive
                work, no admission is possible, and a batch request is
                decoding on a preemption-capable engine;
      step      the backend's own scheduler once.

    Completions are harvested after every sweep into labelled counters and
    histograms on `self.metrics.registry`.
    """

    def __init__(self, backends, *, metrics=None):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends = dict(backends)
        self.metrics = metrics if metrics is not None else Metrics()
        self._waiting = {m: {slo: deque() for slo in SLO_CLASSES}
                         for m in self.backends}
        self._preempted = {m: deque() for m in self.backends}
        self._meta = {}        # id(req) -> (model, tenant, slo)
        self._inflight = []
        self.step_count = 0

    # -- admission -----------------------------------------------------------
    def submit(self, model, prompt_ids, *, tenant="default",
               slo="interactive", max_new_tokens=32, **kw):
        if model not in self.backends:
            raise KeyError(f"unknown model {model!r}; have "
                           f"{sorted(self.backends)}")
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}")
        if isinstance(self.backends[model], BertBackend):
            req = EmbeddingRequest(prompt_ids,
                                   request_id=kw.get("request_id"))
        else:
            req = Request(prompt_ids, max_new_tokens, **kw)
        self._meta[id(req)] = (model, tenant, slo)
        self._waiting[model][slo].append(req)
        self._inflight.append(req)
        self.metrics.registry.inc(
            "router_requests",
            labels={"model": model, "tenant": tenant, "slo": slo})
        return req

    def _slo_of(self, req):
        return self._meta.get(id(req), (None, None, "interactive"))[2]

    # -- policy --------------------------------------------------------------
    def _feed(self, model, engine):
        waiting = self._waiting[model]
        if len(engine.queue) > 0:
            return
        if waiting["interactive"]:
            engine.submit(waiting["interactive"].popleft())
            return
        pre = self._preempted[model]
        if pre:
            # preempted batch work outranks new batch admissions; while it
            # cannot fit, new batch feeds stay blocked too (they would take
            # the pages the resume waits for)
            if engine.can_resume(pre[0]):
                state = pre.popleft()
                engine.resume(state)
                tenant = self._meta[id(state["req"])][1]
                self.metrics.registry.inc(
                    "router_resumes",
                    labels={"model": model, "tenant": tenant})
            return
        if waiting["batch"]:
            engine.submit(waiting["batch"].popleft())

    def _maybe_preempt(self, model, engine):
        if not hasattr(engine, "preempt"):
            return            # stripe engines checkpoint no KV state
        if not len(engine.queue) or engine._can_prefill():
            return
        head_is_interactive = (
            self._slo_of(engine.queue.peek()) == "interactive"
            or bool(self._waiting[model]["interactive"]))
        if not head_is_interactive:
            return
        streams = getattr(engine, "_chunk_streams", {})
        victims = [s for s in engine.slots.active_slots
                   if self._slo_of(engine.slots.owner(s)) == "batch"
                   and s not in streams]
        if not victims:
            return
        # the batch slot with the least decode progress (ties: the highest
        # slot): resume loses nothing either way, and the least-progressed
        # victim refunds the most reservation
        victim = min(victims,
                     key=lambda s: (len(engine.slots.owner(s).token_ids),
                                    -s))
        req = engine.slots.owner(victim)
        state = engine.preempt(victim)
        self._preempted[model].append(state)
        tenant = self._meta[id(req)][1]
        self.metrics.registry.inc(
            "router_preemptions", labels={"model": model, "tenant": tenant})

    # -- the loop ------------------------------------------------------------
    def step(self):
        for model, backend in self.backends.items():
            if isinstance(backend, BertBackend):
                waiting = self._waiting[model]
                for slo in SLO_CLASSES:
                    while waiting[slo]:
                        backend.submit(waiting[slo].popleft())
                backend.step()
                continue
            self._feed(model, backend)
            self._maybe_preempt(model, backend)
            backend.step()
        self.step_count += 1
        self._harvest()
        self._export_depth()

    def _harvest(self):
        reg = self.metrics.registry
        still = []
        for req in self._inflight:
            if not req.finished:
                still.append(req)
                continue
            model, tenant, slo = self._meta.pop(id(req))
            reg.inc("router_completed",
                    labels={"model": model, "tenant": tenant, "slo": slo})
            reg.inc("router_tokens", len(req.token_ids),
                    labels={"model": model, "tenant": tenant})
            if req.ttft_s is not None:
                reg.observe("router_ttft_s", req.ttft_s,
                            labels={"model": model})
            dur = (req.finish_time or 0) - (req.submit_time or 0)
            if req.token_ids and dur > 0:
                reg.observe("router_tokens_per_s",
                            len(req.token_ids) / dur,
                            labels={"model": model})
        self._inflight = still

    def _export_depth(self):
        reg = self.metrics.registry
        for model, waiting in self._waiting.items():
            for slo in SLO_CLASSES:
                reg.set_gauge("router_queue_depth", len(waiting[slo]),
                              labels={"model": model, "slo": slo})
            reg.set_gauge("router_preempted_held",
                          len(self._preempted[model]),
                          labels={"model": model})

    def _backend_busy(self, backend):
        if isinstance(backend, BertBackend):
            return backend.busy
        return bool(len(backend.queue) or backend.slots.active_slots
                    or getattr(backend, "_chunk_streams", None))

    @property
    def busy(self):
        return bool(self._inflight
                    or any(self._backend_busy(b)
                           for b in self.backends.values())
                    or any(self._preempted.values()))

    def run_until_idle(self):
        while self.busy:
            self.step()

    @staticmethod
    def _request_kw(entry):
        return {k: entry[k] for k in ("temperature", "top_p", "top_k",
                                      "seed", "eos_token_id", "request_id")
                if k in entry}

    def serve(self, requests):
        """Submit a list of dicts (`model`, `prompt` + Request kwargs +
        optional `tenant`/`slo`), run to completion, return the request
        objects in order."""
        out = [self.submit(r["model"], r["prompt"],
                           tenant=r.get("tenant", "default"),
                           slo=r.get("slo", "interactive"),
                           max_new_tokens=r.get("max_new_tokens", 32),
                           **self._request_kw(r))
               for r in requests]
        self.run_until_idle()
        return out

    def replay(self, trace):
        """Replay an arrival trace: entries with `arrival_step` (ROUTER
        steps), `model`, `prompt` (+ optional `max_new_tokens`, default 8,
        `tenant`, `slo` and Request kwargs). Returns the request objects in
        trace order."""
        pending = sorted(trace, key=lambda t: t["arrival_step"])
        out = {}
        i = 0
        while i < len(pending) or self.busy:
            while (i < len(pending)
                   and pending[i]["arrival_step"] <= self.step_count):
                t = pending[i]
                out[id(t)] = self.submit(
                    t["model"], t["prompt"],
                    tenant=t.get("tenant", "default"),
                    slo=t.get("slo", "interactive"),
                    max_new_tokens=t.get("max_new_tokens", 8),
                    **self._request_kw(t))
                i += 1
            self.step()
        return [out[id(t)] for t in trace]
