"""Draft-model speculative decoding over the paged engine (port of
`paddle_tpu/serving/spec_decode.py::SpecDecoder` :202).

A round of Leviathan-style speculation (Leviathan et al. 2023):

  PROPOSE  the draft model (e.g. `generation.draft_from_params`) runs g + 1
           decode steps over its own stripe cache. Step j of row r feeds
           the committed tokens the draft has not ingested yet (forced-feed
           catch-up: after a fully accepted round the draft is one token
           behind) and its own previous output after that. The reference
           traces the steps into one scan; here they are a Python loop of
           draft decode steps (kernel B4 on the card).
  VERIFY   the target scores the window [last committed token, draft_1 ..
           draft_g] in one batched paged forward
           (`generation._paged_forward_verify`): the window's K/V go into
           the row's tail pages first, writes past the row's page
           reservation go to the null page; attention runs kernel B5 over
           the gathered pages.
  ACCEPT   a greedy row commits the longest prefix of drafts equal to the
           target's greedy tokens plus the target's own next token: 1 to
           g + 1 tokens a round, exactly the target's greedy sequence. A
           sampling row accepts draft i with probability min(1, p_t / p_d)
           and resamples its first rejection from normalize(max(0, p_t -
           p_d)); a fully accepted window draws a bonus token from the
           target through the sequential (seed, position) stream.
  ROLL BACK  the watermark and the block table are cut back to the
           committed positions: window pages wholly past them return to
           the pool with their reservation, so after an all-rejected round
           the block table and refcounts are those of a plain decode step.

Randomness: the reference draws the accept and resample decisions from
threefry keys of (seed, position, salt); the port from its own per-row
streams (`generation._row_uniforms`) of the same triple, so a decision is
a pure function of the request and position, never of the schedule. The
bits differ from the reference's; the properties (exactness of the
committed distribution, reproducibility, draft == target giving the
sequential seeded sample) hold (tests/test_torch_spec_chunk.py).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models import llama_functional as lf
from paddle_tpu_torch.serving.block_manager import NULL_PAGE
from paddle_tpu_torch.serving.scheduler import bucket_for

__all__ = ["SpecDecoder"]

_ACCEPT_SALT = 0xAC          # the acceptance test's uniform
_RESAMPLE_SALT = 0x5E        # the residual resample's gumbel draw


def _host_uniforms(seed, pos, n, salt):
    """n uniforms of the (seed, pos, salt) stream, as float64 on the host."""
    return gen._row_uniforms([seed], [pos], n, "cpu", salt)[0].double()\
        .numpy()


class SpecDecoder:
    """The speculative half of a `PagedEngine`: owns the draft model's stripe
    cache and runs the propose -> verify -> accept -> roll-back round. It
    changes the engine's block tables, positions and reservations in place:
    it is the engine's decode step while a draft model is loaded."""

    def __init__(self, engine):
        self.eng = engine
        self.g = engine.spec_tokens
        self.draft = engine.draft_params
        a = self.draft.args
        # g + 1 positions past max_len: a row's proposal steps write at
        # [dpos, dpos + g], which may run past its last legal position
        self._cache_len = engine.max_len + self.g + 1
        shape = (a.num_layers, engine.max_slots, a.num_kv_heads,
                 self._cache_len, a.head_dim)
        self._dck = torch.zeros(shape, dtype=self.draft.dtype,
                                device=engine.device)
        self._dcv = torch.zeros_like(self._dck)
        self._dcos, self._dsin = lf.rope_tables(2 * engine.max_len,
                                                a.head_dim, a.rope_theta,
                                                engine.device)
        self._dpos = np.zeros(engine.max_slots, np.int32)

    # -- the draft's mirror of the prompt -----------------------------------
    def _window(self, req, slot, start, end):
        """Forward prompt window [start, end) through the draft into the
        slot's stripe at `start` (logits unused: the draft needs the KV).
        The window is right-padded to its bucket, cut at the stripe's
        end: padding only writes positions past `end`."""
        eng = self.eng
        sb = min(bucket_for(end - start, eng.min_bucket, eng.max_len),
                 self._cache_len - start)
        padded = np.full((1, sb), eng.pad_id, np.int32)
        padded[0, :end - start] = req.prompt_ids[start:end]
        with eng.metrics.timer("draft_prefill_s"):
            gen._forward_cached(
                self.draft, torch.from_numpy(padded).to(eng.device),
                self._dck[:, slot:slot + 1], self._dcv[:, slot:slot + 1],
                start, self._dcos, self._dsin, last_idx=end - 1 - start)

    def prefill_slot(self, req, slot, n):
        """Mirror a prompt prefilled in one piece into the draft's stripe."""
        self._window(req, slot, 0, n)
        self._dpos[slot] = n

    def prefill_window(self, req, slot, start, end):
        """Advance the draft's mirror of a chunk-streamed prompt by one
        window [start, end) (windows start at 0: the draft has no prefix
        cache). The frontier moves with each window: a round for other
        slots runs the propose steps over every row, and a mid-stream
        row's writes then land at its frontier, which the next window
        rewrites, never on the prefix mirrored already."""
        self._window(req, slot, start, end)
        self._dpos[slot] = end

    def retire(self, slot):
        self._dpos[slot] = 0

    def reset(self):
        self._dpos[:] = 0

    # -- the round -----------------------------------------------------------
    def _seq_token(self, req, idx):
        """Committed token at sequence index idx (prompt, then outputs)."""
        n = req.prompt_ids.size
        return int(req.prompt_ids[idx]) if idx < n \
            else int(req.token_ids[idx - n])

    def _limit(self, slot):
        """A row's last legal KV write index: the top of its admission-time
        page reservation (`scheduler.pages_for`)."""
        req = self.eng.slots.owner(slot)
        return int(req.prompt_ids.size) + req.max_new_tokens - 2

    def _propose_device(self, forced, n_forced, start, sample=False):
        """g + 1 draft decode steps over every row (a method of its own so
        that tests can put an adversarial draft in). Returns (proposals
        [S, g + 1] on the host, the draft's warped distributions [S, g + 1,
        vocab] on the host when sampling, else None)."""
        eng = self.eng
        dev = eng.device
        temp, top_p, top_k, seeds = eng.sampler.args()
        forced_t = torch.from_numpy(forced).to(dev)
        n_forced_t = torch.from_numpy(n_forced).to(dev)
        outs, probs = [], []
        with eng.metrics.timer("draft_propose_s"):
            prev = forced_t[:, 0]
            for j in range(forced.shape[1]):
                tok = torch.where(n_forced_t > j, forced_t[:, j], prev)
                pos = torch.from_numpy(start + j).to(dev)
                logits, _, _ = gen._forward_cached(
                    self.draft, tok[:, None], self._dck, self._dcv, pos,
                    self._dcos, self._dsin)
                if sample:
                    prev = gen._sample(logits, True, temp, top_p, top_k,
                                       seeds=seeds, pos=start + j + 1)
                    masked, _ = gen._warp_logits(logits, temp, top_p, top_k)
                    probs.append(torch.softmax(masked, dim=-1))
                else:
                    prev = logits.argmax(dim=-1).to(torch.int32)
                outs.append(prev)
            outs = torch.stack(outs, dim=1).cpu().numpy()
            if sample:
                return outs, torch.stack(probs, dim=1).cpu().numpy()
        return outs, None

    def _verify_device(self, ids, limit, active, sample):
        """The target's verify forward over the windows ids [S, g + 1] (the
        rows of `active`; the others write the null page).
        Returns (greedy tokens [S, g + 1] on the host, and when sampling
        the warped logits [S, g + 1, vocab] on the device and their
        softmax on the host)."""
        eng = self.eng
        dev = eng.device
        bt = np.full((eng.max_slots, eng.pages_per_slot), NULL_PAGE, np.int32)
        for slot in active:
            bt[slot, :len(eng._bt[slot])] = eng._bt[slot]
        with eng.metrics.timer("verify_s"):
            logits, _, _ = gen._paged_forward_verify(
                eng.model, torch.from_numpy(ids).to(dev), eng._pk, eng._pv,
                torch.from_numpy(bt).to(dev),
                torch.from_numpy(eng._npos).to(dev),
                torch.from_numpy(limit).to(dev), eng._cos, eng._sin,
                eng.page_size)
            tgt = logits.argmax(dim=-1).cpu().numpy()
            if not sample:
                return tgt, None, None
            S, W, V = logits.shape
            temp, top_p, top_k, _ = eng.sampler.args()
            masked, _ = gen._warp_logits(logits.reshape(S * W, V),
                                         np.repeat(temp, W),
                                         np.repeat(top_p, W),
                                         np.repeat(top_k, W))
            masked = masked.reshape(S, W, V)
            return tgt, masked, torch.softmax(masked, dim=-1).cpu().numpy()

    def step(self):
        """One speculation round over the decodable slots (module
        docstring). Returns the event dict of an engine step."""
        eng = self.eng
        active = eng._decodable_slots()
        S, g = eng.max_slots, self.g
        steps = g + 1

        # ---- propose: every row steps, each at its own frontier ----------
        forced = np.zeros((S, steps), np.int32)
        n_forced = np.ones(S, np.int32)
        start = self._dpos.astype(np.int32)
        lag = {}
        for slot in active:
            req = eng.slots.owner(slot)
            lag[slot] = int(eng._npos[slot]) - int(self._dpos[slot])
            n_forced[slot] = lag[slot] + 1
            for j in range(min(lag[slot] + 1, steps)):
                forced[slot, j] = self._seq_token(req,
                                                  int(self._dpos[slot]) + j)
        sampling = eng.sampler.any_sampling(active)
        outs, dprobs = self._propose_device(forced, n_forced, start,
                                            sampling)

        # ---- the verify window's tail pages ------------------------------
        limit = np.full(S, -1, np.int32)
        for slot in active:
            limit[slot] = self._limit(slot)
            eng._ensure_tail_pages(
                slot, min(int(eng._npos[slot]) + g, int(limit[slot])))

        # ---- verify --------------------------------------------------------
        ids = np.full((S, g + 1), eng.pad_id, np.int32)
        for slot in active:
            ids[slot, 0] = eng._last_tok[slot]
            for i in range(1, g + 1):
                j = lag[slot] + i - 1            # the draft for npos + i
                ids[slot, i] = outs[slot, min(j, outs.shape[1] - 1)]
        tgt, tmasked, tprobs = self._verify_device(ids, limit, active,
                                                   sampling)

        # ---- accept, then roll back --------------------------------------
        emitted = {}
        for slot in active:
            req = eng.slots.owner(slot)
            p = int(eng._npos[slot])
            drafts = [int(ids[slot, i]) for i in range(1, g + 1)]
            if sampling and eng.sampler.any_sampling([slot]):
                a, commit = self._accept_sampled(req, slot, p, drafts,
                                                 lag[slot], dprobs, tprobs,
                                                 tmasked)
            else:
                # greedy rows keep exact-match acceptance, even in a
                # sampling batch
                a = 0
                while a < g and drafts[a] == int(tgt[slot, a]):
                    a += 1
                commit = drafts[:a] + [int(tgt[slot, a])]
            k = 0
            for tok in commit:
                eng._emit(req, tok)
                k += 1
                if req.finished:
                    break
            eng._npos[slot] = p + k
            eng._last_tok[slot] = req.token_ids[-1]
            self._dpos[slot] = min(int(start[slot]) + steps,
                                   p + min(a, k) + 1, p + k)
            emitted[req.request_id] = commit[:k]
            eng.metrics.inc("draft_tokens_proposed", g)
            eng.metrics.inc("draft_tokens_accepted", min(a, k))
            eng.metrics.inc("tokens_generated", k)
            eng.metrics.observe("spec_commit_len", k)
            eng.metrics.observe("spec_acceptance_rate", min(a, k) / g)
            if req.finished:
                eng._retire(slot)
            else:
                self._rollback_tail(slot, p + k)
        eng.metrics.inc("spec_rounds")
        eng.metrics.observe("tokens_per_decode_step",
                            sum(len(v) for v in emitted.values()))
        return {"type": "spec_decode", "tokens": emitted}

    def _accept_sampled(self, req, slot, p, drafts, lag, dprobs, tprobs,
                        tmasked):
        """Rejection sampling for one sampling row (`_accept_sampled`
        :460): draft i is accepted with probability min(1, p_t(d) /
        p_d(d)); the first rejection commits one token drawn from
        normalize(max(0, p_t - p_d)) and ends the round; a fully accepted
        window commits a bonus token drawn by gumbel-max from the target's
        warped logits with the sequential sampler's (seed, position)
        stream, so that draft == target gives the sequential seeded
        sample. Returns (accepted count, committed tokens)."""
        g = self.g
        commit = []
        for i in range(1, g + 1):
            d = drafts[i - 1]
            pd = dprobs[slot, min(lag + i - 1, dprobs.shape[1] - 1)]
            pt = tprobs[slot, i - 1]
            ratio = float(pt[d]) / max(float(pd[d]), 1e-30)
            u = _host_uniforms(req.seed, p + i, 1, _ACCEPT_SALT)[0]
            if u < min(1.0, ratio):
                commit.append(d)
                continue
            residual = np.maximum(pt.astype(np.float64)
                                  - pd.astype(np.float64), 0.0)
            tot = float(residual.sum())
            if tot <= 0.0:
                # the draft dominates everywhere, which only rounding
                # makes possible: draw from the target itself
                residual, tot = pt.astype(np.float64), float(pt.sum())
            u = _host_uniforms(req.seed, p + i, residual.size,
                               _RESAMPLE_SALT)
            logp = np.where(residual > 0,
                            np.log(np.maximum(residual / tot, 1e-300)),
                            -np.inf)
            commit.append(int(np.argmax(logp - np.log(-np.log(u)))))
            self.eng.metrics.inc("spec_resamples")
            return i - 1, commit
        masked = tmasked[slot, g]
        u = gen._row_uniforms([req.seed], [p + g + 1], masked.shape[-1],
                              masked.device)[0]
        commit.append(int((masked - torch.log(-torch.log(u))).argmax()))
        return g, commit

    def _rollback_tail(self, slot, npos):
        """Cut the slot's block table to the pages that hold the committed
        positions [0, npos): window pages wholly past the watermark return
        to the pool and their reservation is refunded. The rejected K/V in
        the kept tail page stay as garbage that the next write overwrites
        before any read."""
        eng = self.eng
        keep = (npos - 1) // eng.page_size + 1
        pages = eng._bt[slot]
        while len(pages) > keep:
            eng._alloc.release(pages.pop())
            eng._resv[slot] += 1
            eng._reserved_total += 1
            eng.metrics.inc("spec_pages_rewound")
