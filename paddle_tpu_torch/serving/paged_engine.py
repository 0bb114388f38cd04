"""Paged-KV serving engine with radix prefix reuse, chunked prefill and
speculative decoding (port of `paddle_tpu/serving/paged_engine.py`).

`Engine` reserves a whole `max_len` stripe per slot; `PagedEngine` keeps
ONE page pool [L, num_pages, nkv, page_size, hd] and a per-slot BLOCK
TABLE mapping sequence positions to pages (vLLM's PagedAttention memory
model), on the same iteration-level scheduler:

  - PREFIX CACHE: every prefilled prompt is registered in
    `BlockAllocator`'s radix tree and reused by later requests sharing a
    prefix at TOKEN granularity (refcounted; a mid-page divergence shares
    the straddled page through a copy-on-write split);
  - PREFILL: gather the slot's pages into a contiguous scratch stripe,
    run the suffix forward at position h (the cached token count), write
    the freshly computed pages back;
  - DECODE: one batched step through the block tables (kernel B6);
  - ADMISSION reserves the worst-case page count minus hits and defers
    the FIFO head under page pressure;
  - INT8 POOL (`kv_dtype="int8"`): int8 pages with per-(page, kv head)
    absmax scales (`generation.QuantizedKVPage`). Prefill gathers the
    slot's pages dequantized into the scratch stripe and quantizes the
    pages it writes back over their valid positions only; decode writes
    keep a running absmax (`generation._kv_quant_write`) and attend
    through kernel B7. KV bytes per page are about half of bf16's, so an
    equal byte budget holds about twice the pages;
  - CHUNKED PREFILL (`prefill_chunk=`): a prompt suffix longer than the
    chunk becomes a STREAM of page-aligned windows, and the scheduler
    alternates one chunk with one unit of other work (an admission, a
    decode or speculation step), so a long prompt no longer stalls every
    decoding slot for its whole prefill. While a stream is in flight a
    short prompt may pass queued long ones (the anti-convoy bypass);
  - SPECULATIVE DECODING (`draft_params=`, a draft `Llama` such as
    `generation.draft_from_params(model, n)`): a decode step becomes a
    round of `serving/spec_decode.py::SpecDecoder`: the draft proposes
    `spec_tokens` tokens, the target verifies them in one paged window
    forward, greedy rows commit the longest exact match plus the target's
    next token (the target's greedy output, token for token), sampling
    rows accept by rejection sampling. A chunk-streamed prompt is mirrored
    into the draft's cache window by window, never ahead of the target.

The pool, the scratch stripe and the block tables live on the engine's
device and are written in place. Greedy output is token-for-token the
reference engine's.

Not ported yet (raises NotImplementedError naming its ROADMAP item):
tensor parallelism (`mesh=`).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models import llama_functional as lf
from paddle_tpu_torch.serving.block_manager import NULL_PAGE, BlockAllocator
from paddle_tpu_torch.serving.engine import Engine, Request
from paddle_tpu_torch.serving.scheduler import bucket_for, pages_for
from paddle_tpu_torch.serving.spec_decode import SpecDecoder

__all__ = ["PagedEngine"]


def _leaves(pool):
    """The tensors of a pool half: itself, or the codes and scales."""
    return tuple(pool) if isinstance(pool, gen.QuantizedKVPage) else (pool,)


def _gather_pages(pool, idx, dtype):
    """Pages `idx` of every layer as [L, n, nkv, ps, hd] in `dtype`; an
    int8 pool dequantizes in f32 (code * scale / 127) before the cast."""
    if isinstance(pool, gen.QuantizedKVPage):
        raw = pool.q[:, idx].float()
        return (raw * (pool.scale[:, idx] / 127.0)[..., None, None]).to(dtype)
    return pool[:, idx]


def _scatter_pages(pool, idx, new, valid):
    """Write pages [L, n, nkv, ps, hd] into pages `idx` of the pool. An
    int8 pool quantizes each (layer, page, kv head) by the absmax over the
    positions where `valid` [n, ps] holds, and stores 0 elsewhere: the
    scratch stripe past the window's last real token is padding and
    forward junk that would inflate the scale."""
    if not isinstance(pool, gen.QuantizedKVPage):
        pool[:, idx] = new
        return
    x = torch.where(valid[None, :, None, :, None], new.float(), 0.0)
    s = x.abs().amax(dim=(3, 4))                                # [L, n, nkv]
    q = torch.round(x / s.clamp_min(1e-9)[..., None, None] * 127.0)
    pool.q[:, idx] = q.clamp_(-127, 127).to(torch.int8)
    pool.scale[:, idx] = s


def _paged_prefill(model, ids, h, last_idx, pages, pk, pv, cos, sin,
                   page_size, pages_per_slot):
    """Prefill a window whose first `h` positions are already cached:
    gather the slot's seated `pages` into a contiguous scratch stripe
    [L, 1, nkv, P*ps + sb, hd] in the model dtype (the bucket padding
    keeps the write at [h, h+sb) inside it), forward the window ids
    [1, sb] at position h, write the pages the window touched back into
    the pool. h may sit mid-page (a radix hit): the straddled page's
    cached half [base, h) is gathered and written back with the new
    tokens — the COW copy's content. Returns the next-token logits
    [1, vocab]."""
    L, _, nkv, ps, hd = _leaves(pk)[0].shape
    sb = ids.shape[1]
    n_seated = len(pages)
    idx = torch.tensor(pages, dtype=torch.long, device=model.device)
    temp_k = torch.zeros((L, 1, nkv, pages_per_slot * ps + sb, hd),
                         dtype=model.dtype, device=model.device)
    temp_v = torch.zeros_like(temp_k)
    temp_k[:, 0, :, :n_seated * ps] = _gather_pages(
        pk, idx, model.dtype).transpose(1, 2).reshape(L, nkv, n_seated * ps,
                                                      hd)
    temp_v[:, 0, :, :n_seated * ps] = _gather_pages(
        pv, idx, model.dtype).transpose(1, 2).reshape(L, nkv, n_seated * ps,
                                                      hd)

    logits, temp_k, temp_v = gen._forward_cached(
        model, ids, temp_k, temp_v, h, cos, sin, last_idx=last_idx)

    first_page = h // ps
    n_touch = n_seated - first_page
    base = first_page * ps
    touched = idx[first_page:]
    pos_abs = base + torch.arange(n_touch * ps, device=model.device)
    valid = (pos_abs < h + last_idx + 1).reshape(n_touch, ps)
    for pool, temp in ((pk, temp_k), (pv, temp_v)):
        _scatter_pages(pool, touched,
                       temp[:, 0, :, base:base + n_touch * ps].reshape(
                           L, nkv, n_touch, ps, hd).transpose(1, 2), valid)
    return logits


class PagedEngine(Engine):
    """Continuous-batching engine over a paged KV cache with prefix reuse.

    page_size: tokens per KV page. Prefix sharing is token-granular (radix
               cache); page_size sets the COW-copy unit of a mid-page
               divergence.
    num_pages: pool size INCLUDING the reserved null page 0. Defaults to
               max_slots * (max_len / page_size) + 1.
    max_len:   per-request cap (block tables hold max_len / page_size
               entries), not a per-slot reservation.
    prefix_policy: "radix" (default) or "hash" (full-page exact match).
    kv_dtype:  None (pool in the model dtype) or "int8" (int8 pages with
               per-(page, kv head) absmax scales; outputs track the model
               dtype pool to an agreement bar, not bit for bit).
    prefill_chunk: None, or the chunk length (a positive multiple of
               page_size): prompt suffixes longer than it prefill in chunks
               interleaved with decode steps.
    draft_params: None, or a draft `Llama` on the same device with the
               target's vocabulary: decode steps become speculation rounds
               of `spec_tokens` drafts.
    device:    CUDA unless "cpu" is passed; the model must live there.
    """

    def __init__(self, model, *, max_slots=4, max_len=256, page_size=16,
                 num_pages=None, min_bucket=16, pad_id=0, metrics=None,
                 prefix_policy="radix", kv_dtype=None, mesh=None,
                 prefill_chunk=None, draft_params=None, spec_tokens=4,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet: "
                "ROADMAP A9")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r} must be None (the "
                             "model dtype) or 'int8'")
        self.kv_dtype = kv_dtype
        if prefix_policy not in ("radix", "hash"):
            raise ValueError(f"prefix_policy={prefix_policy!r} must be "
                             "'radix' or 'hash'")
        if max_len % page_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.prefix_policy = prefix_policy
        self.page_size = int(page_size)
        self.pages_per_slot = int(max_len) // self.page_size
        self.num_pages = (int(num_pages) if num_pages is not None
                          else int(max_slots) * self.pages_per_slot + 1)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1 or prefill_chunk % self.page_size:
                raise ValueError(f"prefill_chunk={prefill_chunk} must be a "
                                 f"positive multiple of page_size="
                                 f"{page_size}")
        self.prefill_chunk = prefill_chunk
        self.draft_params = draft_params
        self.spec_tokens = int(spec_tokens)
        if draft_params is not None:
            if self.spec_tokens < 1:
                raise ValueError("spec_tokens must be >= 1")
            if draft_params.args.vocab_size != model.args.vocab_size:
                raise ValueError("draft and target must share a vocab")
            if draft_params.device != model.device:
                raise ValueError(f"draft on {draft_params.device}, target "
                                 f"on {model.device}")
        super().__init__(model, max_slots=max_slots, max_len=max_len,
                         min_bucket=min_bucket, pad_id=pad_id,
                         metrics=metrics, device=device)

    # -- device state -------------------------------------------------------
    def _setup_device_state(self):
        a = self.args
        shape = (a.num_layers, self.num_pages, a.num_kv_heads,
                 self.page_size, a.head_dim)
        if self.kv_dtype == "int8":
            # scales start at 0: the first write into a page sets them
            def half():
                return gen.QuantizedKVPage(
                    torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=self.device))

            self._pk, self._pv = half(), half()
        else:
            self._pk = torch.zeros(shape, dtype=self.model.dtype,
                                   device=self.device)
            self._pv = torch.zeros_like(self._pk)
        self.metrics.set_gauge("kv_pool_bytes", self._pool_bytes())
        # 2 * max_len: a suffix window writes [h, h + bucket), which can
        # reach past max_len before the mask trims it
        self._cos, self._sin = lf.rope_tables(2 * self.max_len, a.head_dim,
                                              a.rope_theta, self.device)
        self._alloc = BlockAllocator(self.num_pages, self.page_size,
                                     metrics=self.metrics,
                                     policy=self.prefix_policy)
        self._bt = [[] for _ in range(self.max_slots)]   # host block tables
        self._resv = {}            # slot -> pages still reserved for decode
        self._reserved_total = 0
        self._chunk_streams = {}   # slot -> state of its chunked prefill
        self._chunk_turn = False
        self._admit_idx = None     # _can_prefill's admission scan
        self._spec = SpecDecoder(self) if self.spec_enabled else None

    @property
    def spec_enabled(self):
        return self.draft_params is not None

    def _pool_bytes(self):
        """K and V pools together, codes and scales of an int8 pool."""
        return 2 * sum(t.numel() * t.element_size()
                       for t in _leaves(self._pk))

    def _copy_page(self, src, dst):
        """Device half of copy-on-write: clone page src into dst across
        every layer, in place (an int8 pool's codes and scales)."""
        for t in _leaves(self._pk) + _leaves(self._pv):
            t[:, dst] = t[:, src]

    # -- admission ----------------------------------------------------------
    def submit(self, req):
        if not isinstance(req, Request):
            req = Request(req)
        need = pages_for(req.prompt_ids.size, req.max_new_tokens,
                         self.page_size)
        if need > self._alloc.capacity:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self._alloc.capacity} (num_pages={self.num_pages}, "
                f"page_size={self.page_size})")
        return super().submit(req)

    def _peek_hits(self, req):
        """The prefix match of a queued request, without side effects,
        memoized on the allocator's prefix_version: the anti-convoy scan
        runs every step while a chunk stream is in flight, and the answer
        only changes when the prefix index does (a registration, split or
        eviction bumps the version)."""
        ver = self._alloc.prefix_version
        cached = getattr(req, "_hits_memo", None)
        if cached is not None and cached[0] == ver:
            return cached[1]
        peek = self._alloc.match_prefix(req.prompt_ids, commit=False)
        req._hits_memo = (ver, peek)
        return peek

    def _admission_index(self):
        """Queue index to admit next: FIFO, except while a chunk stream is
        in flight, when the first prompt whose suffix fits one chunk passes
        queued long ones (a streaming long prefill must not convoy every
        short one behind the next long). Longs keep FIFO order among
        themselves, and the bypass exists only while a stream is active,
        so they cannot starve."""
        if not self.queue:
            return None
        if not (self.prefill_chunk and self._chunk_streams):
            return 0
        for i in range(len(self.queue)):
            req = self.queue.peek_at(i)
            if (req.prompt_ids.size - self._peek_hits(req).matched
                    <= self.prefill_chunk):
                return i
        return 0

    def _can_prefill(self):
        self._admit_idx = None
        if not (self.queue and self.slots.free_count):
            return False
        # the scan is kept for the _prefill_step that follows a True answer
        self._admit_idx = self._admission_index()
        req = self.queue.peek_at(self._admit_idx)
        peek = self._peek_hits(req)
        # reviving a cached (refcount-0) hit consumes availability like a
        # fresh alloc; an actively shared hit is free. A mid-page partial
        # hit nets out: its COW copy costs one alloc but saves one page of
        # suffix — so `need` stays pages_for - full hits
        hit_pages = list(peek.pages)
        if peek.partial_page is not None:
            hit_pages.append(peek.partial_page)
        revive = sum(1 for p in hit_pages if self._alloc.refcount(p) == 0)
        need = (pages_for(req.prompt_ids.size, req.max_new_tokens,
                          self.page_size) - len(peek.pages) + revive)
        return need <= self._alloc.available - self._reserved_total

    # -- the interleaving scheduler -----------------------------------------
    def _step_action(self):
        """While a prompt is mid-stream, alternate one chunk with one unit
        of other work (admit a waiting request, or run a decode step: a
        speculation round when a draft model is loaded)."""
        if self._chunk_streams and self._chunk_turn:
            self._chunk_turn = False
            self._note_prefill_stall()
            return self._chunk_step()
        if self._can_prefill():
            self._chunk_turn = True
            self._note_prefill_stall()
            return self._prefill_step()
        if self._decodable_slots():
            self._chunk_turn = True
            if self.spec_enabled:
                return self._spec.step()
            return self._decode_step()
        if self._chunk_streams:
            return self._chunk_step()
        return {"type": "idle"}

    def _decodable_slots(self):
        active = self.slots.active_slots
        if not self._chunk_streams:
            return active
        return [s for s in active if s not in self._chunk_streams]

    # -- prefill ------------------------------------------------------------
    def _begin_paged_prefill(self, req, slot, n):
        """Match prefix hits, seat the block table, and reserve the
        request's remaining worst-case pages (the prompt pages still to be
        written draw from it chunk by chunk, the decode tail at page
        boundaries). Returns h — the cached token count the first window
        starts at."""
        ps = self.page_size
        hit = self._alloc.match_prefix(req.prompt_ids)   # refs hit pages
        h = hit.matched
        self._bt[slot] = list(hit.pages)
        held = len(hit.pages)
        if hit.partial_page is not None:
            # mid-page hit: the straddled page is frozen (tree-registered),
            # so split copy-on-write — the window then overwrites [h, ...)
            # of the copy
            src = hit.partial_page
            copy, _ = self._alloc.ensure_writable(src)
            self._copy_page(src, copy)
            self._bt[slot].append(copy)
            held += 1
        resv = pages_for(n, req.max_new_tokens, ps) - held
        self._resv[slot] = resv
        self._reserved_total += resv
        self.metrics.inc("prompt_tokens", n)
        self.metrics.inc("prefix_tokens_hit", h)
        self.metrics.inc("prefix_pages_hit", len(hit.pages))
        self.metrics.inc("prefix_pages_queried", (n - 1) // ps)
        return h

    def _window_prefill_device(self, req, slot, start, end, n):
        """Run the prefill window [start, end) of the prompt (the whole
        suffix, or one chunk of it) through the suffix forward. A window
        that starts mid-page rewrites the straddled page from the gathered
        stripe plus its new tokens (the partial hit's COW copy on a first
        window, the slot's own tail page on later chunks). Returns (bucket,
        token); the token means something for the final window (end == n)
        only, which also registers the prompt's full pages."""
        ps = self.page_size
        n_now = -(-end // ps) - len(self._bt[slot])
        new_pages = [self._alloc.alloc() for _ in range(n_now)]
        self._resv[slot] -= n_now
        self._reserved_total -= n_now
        self._bt[slot].extend(new_pages)
        pages = self._bt[slot]

        sb = bucket_for(end - start, self.min_bucket, self.max_len)
        padded = np.full((1, sb), self.pad_id, np.int32)
        padded[0, :end - start] = req.prompt_ids[start:end]
        with self.metrics.timer("prefill_s"):
            logits = _paged_prefill(
                self.model, torch.from_numpy(padded).to(self.device), start,
                end - 1 - start, pages, self._pk, self._pv, self._cos,
                self._sin, ps, self.pages_per_slot)
            first = self._pick_first(logits, req, end)
        if end == n:
            # the prompt's FULL pages become hittable at once; the partial
            # tail page waits for _retire (decode keeps writing into it)
            self._alloc.register_prefix(req.prompt_ids, pages[:n // ps])
            # a chunk-streamed prompt is mirrored into the draft window by
            # window (_chunk_step) instead
            if self.spec_enabled and slot not in self._chunk_streams:
                self._spec.prefill_slot(req, slot, n)
        return sb, first

    def _prefill_device(self, req, slot, n):
        """Monolithic prefill (no chunking, or a suffix within a chunk)."""
        h = self._begin_paged_prefill(req, slot, n)
        return self._window_prefill_device(req, slot, h, n, n)

    def _prefill_step(self):
        """Admit the request `_can_prefill` chose; a suffix longer than
        `prefill_chunk` becomes a chunk stream that later steps advance."""
        if self.prefill_chunk is None:
            return super()._prefill_step()
        idx = self._admit_idx if self._admit_idx is not None \
            else self._admission_index()
        req = self.queue.pop_at(idx)
        slot = self._admit(req)
        n = int(req.prompt_ids.size)
        h = self._begin_paged_prefill(req, slot, n)
        if n - h <= self.prefill_chunk:
            bucket, first = self._window_prefill_device(req, slot, h, n, n)
            self.metrics.observe("chunks_per_prompt", 1)
            return self._complete_prefill(req, slot, bucket, first, n)
        self._chunk_streams[slot] = {"req": req, "n": n, "done": h,
                                     "ddone": 0, "chunks": 0,
                                     "bucket": None, "first": None}
        self.metrics.inc("chunked_prefills")
        return self._chunk_step()

    def _chunk_step(self):
        """Advance the oldest chunk stream by one bounded unit of prefill:
        a target chunk or, under speculation when the draft's mirror lags
        the target, one draft window of the same size (the mirror never
        runs ahead of the target, and never in one piece)."""
        slot = next(iter(self._chunk_streams))
        st = self._chunk_streams[slot]
        req, n = st["req"], st["n"]
        if self.spec_enabled and st["ddone"] < n and \
                (st["ddone"] < st["done"] or st["done"] == n):
            dstart = st["ddone"]
            dend = min(dstart + self.prefill_chunk, n)
            self._spec.prefill_window(req, slot, dstart, dend)
            st["ddone"] = dend
            self.metrics.inc("draft_prefill_chunks")
            if dend < n or st["done"] < n:
                return {"type": "draft_prefill_chunk",
                        "request_id": req.request_id, "slot": slot,
                        "from": dstart, "to": dend}
            return self._finish_stream(slot, st)
        start = st["done"]
        end = min(start + self.prefill_chunk, n)
        bucket, first = self._window_prefill_device(req, slot, start, end, n)
        st["done"] = end
        st["chunks"] += 1
        self.metrics.inc("prefill_chunks")
        self.metrics.inc("prefill_chunk_tokens", end - start)
        if end == n:
            st["bucket"], st["first"] = bucket, first
            # the target's prompt KV is complete; the first token is
            # emitted at _finish_stream, which may wait for the draft
            self._record_prefill_done(req)
            if not (self.spec_enabled and st["ddone"] < n):
                return self._finish_stream(slot, st)
        return {"type": "prefill_chunk", "request_id": req.request_id,
                "slot": slot, "from": start, "to": end}

    def _finish_stream(self, slot, st):
        """The target's chunks and (under speculation) the draft's mirror
        are complete: close the stream and emit the first token."""
        del self._chunk_streams[slot]
        self.metrics.observe("chunks_per_prompt", st["chunks"])
        return self._complete_prefill(st["req"], slot, st["bucket"],
                                      st["first"], st["n"])

    # -- decode -------------------------------------------------------------
    def _ensure_tail_pages(self, slot, top):
        """Make the slot's KV positions [npos, top] writable: COW the
        current tail page if it is shared or registered, then draw
        page-boundary allocations from the slot's reservation. Plain
        decode (top == npos) and the speculation window (top == min(npos
        + g, limit)) both go through it."""
        ps = self.page_size
        pages = self._bt[slot]
        pi = int(self._npos[slot]) // ps
        if pi < len(pages):
            old = pages[pi]
            page, copied = self._alloc.ensure_writable(old)
            if copied:
                self._copy_page(old, page)
                pages[pi] = page
        while len(pages) * ps <= top:
            pages.append(self._alloc.alloc())
            self._resv[slot] -= 1
            self._reserved_total -= 1

    def _decode_device(self, active):
        for slot in active:
            self._ensure_tail_pages(slot, int(self._npos[slot]))
        bt = np.full((self.max_slots, self.pages_per_slot), NULL_PAGE,
                     np.int32)
        for slot in active:
            bt[slot, :len(self._bt[slot])] = self._bt[slot]
        with self.metrics.timer("decode_step_s"):
            logits, _, _ = gen._paged_forward_decode(
                self.model,
                torch.from_numpy(self._last_tok).to(self.device)[:, None],
                self._pk, self._pv, torch.from_numpy(bt).to(self.device),
                torch.from_numpy(self._npos).to(self.device), self._cos,
                self._sin, self.page_size, max_pos=int(self._npos.max()))
            return self._pick_batch(logits, active)

    # -- lifecycle ----------------------------------------------------------
    def _retire(self, slot):
        # the slot stops writing here, so its partial PROMPT tail page is
        # frozen: hang it on the radix tree. Only prompt positions are
        # cached: their bytes came from prefill, so later hits replay the
        # values a fresh prefill would compute
        req = self.slots.owner(slot)
        if int(self._npos[slot]) >= req.prompt_ids.size:
            n_pages = -(-int(req.prompt_ids.size) // self.page_size)
            self._alloc.register_prefix(req.prompt_ids,
                                        self._bt[slot][:n_pages])
        for p in self._bt[slot]:
            self._alloc.release(p)
        self._bt[slot] = []
        self._reserved_total -= self._resv.pop(slot, 0)
        if self.spec_enabled:
            self._spec.retire(slot)
        super()._retire(slot)

    # -- preemption ---------------------------------------------------------
    def preempt(self, slot):
        """Evict a DECODING request from its slot without losing work: the
        returned state holds its block table (the page refs stay held, so
        the pages are neither handed out nor evicted), its write position
        and last token. `resume` re-seats it, and the continuation is the
        one it would have had. The slot's remaining page reservation is
        refunded while it waits."""
        req = self.slots.owner(slot)
        if slot in self._chunk_streams:
            raise ValueError(f"slot {slot} is mid-prefill-stream; only "
                             "decoding slots are preemptible")
        if self.spec_enabled:
            raise ValueError("preemption with speculative decoding is "
                             "unsupported (the draft's stripe cache is "
                             "not checkpointed)")
        state = {"req": req, "pages": self._bt[slot],
                 "npos": int(self._npos[slot]),
                 "last_tok": int(self._last_tok[slot]),
                 "resv": self._resv.get(slot, 0)}
        self._bt[slot] = []
        self._reserved_total -= self._resv.pop(slot, 0)
        self.slots.retire(slot)
        self._npos[slot] = 0
        self._last_tok[slot] = self.pad_id
        self.sampler.clear(slot)
        self.metrics.inc("preemptions")
        return state

    def can_resume(self, state):
        return bool(self.slots.free_count) and \
            state["resv"] <= self._alloc.available - self._reserved_total

    def resume(self, state):
        """Re-seat a preempted request (see `preempt`); returns its new
        slot. The caller checks `can_resume` first."""
        req = state["req"]
        slot = self._admit(req)
        self._bt[slot] = state["pages"]
        self._resv[slot] = state["resv"]
        self._reserved_total += state["resv"]
        self._npos[slot] = state["npos"]
        self._last_tok[slot] = state["last_tok"]
        self.metrics.inc("resumes")
        return slot

    def reset(self):
        """Forget all requests, block tables AND the prefix cache (the
        pool's bytes stay allocated)."""
        super().reset()
        self.metrics.set_gauge("kv_pool_bytes", self._pool_bytes())
        self._alloc = BlockAllocator(self.num_pages, self.page_size,
                                     metrics=self.metrics,
                                     policy=self.prefix_policy)
        self._bt = [[] for _ in range(self.max_slots)]
        self._resv = {}
        self._reserved_total = 0
        self._chunk_streams = {}
        self._chunk_turn = False
        if self.spec_enabled:
            self._spec.reset()
