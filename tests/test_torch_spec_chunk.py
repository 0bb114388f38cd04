"""Chunked prefill and speculative decoding in the port's `PagedEngine`
against the JAX `PagedEngine`, on the CPU, in f32.

  - the mixed trace (`serving/trace.py`) is the reference's, seed for seed;
  - chunked prefill (`prefill_chunk=`) on a long-prompt burst with prefix
    hits and a mid-page partial hit: the same greedy tokens, the same step
    sequence (admissions in the same order: the anti-convoy bypass), the
    same chunk and prefix counters; a chunk that starts mid-page rewrites
    the straddled page as a monolithic prefill writes it;
  - speculative decoding (`draft_params=`): the same greedy tokens and spec
    counters as the reference, with and without chunking (the draft's
    mirror follows the target), over the model-dtype and the int8 pool
    (and the int8 pool within the reference's agreement bar of sequential
    greedy); an EOS inside a window retires the request there; an
    all-rejected round leaves block tables and refcounts bit-identical to
    a plain decode step's;
  - sampled speculation, held within the port (the accept and resample
    draws come from the port's own (seed, position, salt) streams, not
    threefry's): draft == target gives the sequential seeded sample, seeds
    reproduce, a greedy row in a sampled batch stays exact, a disagreeing
    draft reaches the resample branch, and the committed tokens of the
    rejection rule follow the target distribution (chi-square);
  - `draft_from_params` validates and shares storage; bad options raise.

The reference's `test_disagreeing_draft_hits_resample_branch` fails on the
reference (ROADMAP C) and is not an oracle here.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models import draft_from_params, quantize_params
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.serving import (PagedEngine, Request, make_mixed_trace,
                                      trace_stats)
from paddle_tpu_torch.serving.block_manager import NULL_PAGE
from paddle_tpu_torch.serving.spec_decode import SpecDecoder
from paddle_tpu_torch.kernels import attention as at
from tools import serving_trace

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
CPU = "cpu"
ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, min_bucket=8)
COUNTERS = ("prefills", "decode_steps", "tokens_generated", "prompt_tokens",
            "prefix_tokens_hit", "prefix_pages_hit", "prefix_pages_queried",
            "prefix_partial_hits", "radix_splits", "cow_copies",
            "requests_finished", "chunked_prefills", "prefill_chunks",
            "prefill_chunk_tokens", "draft_prefill_chunks", "spec_rounds",
            "draft_tokens_proposed", "draft_tokens_accepted",
            "spec_pages_rewound")


@pytest.fixture(scope="module")
def jparams():
    return jlf.init_params(ARGS, jax.random.key(0))


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             tlf.LlamaArgs(*ARGS), device=CPU)


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ARGS.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _trace():
    """A long-prompt burst into a short stream, then two requests that hit
    the longs' cached prompts: one cut mid-page (21 tokens of 8-token
    pages, a partial hit and COW split) with a suffix longer than a chunk,
    one the whole long prompt plus 3 tokens."""
    trace = serving_trace.make_mixed_trace(
        seed=0, n_short=8, short_len_choices=(3, 5, 9, 12), n_long=2,
        long_len=40, mean_interarrival_steps=2.0, new_tokens_choices=(5,),
        long_new_tokens=5, vocab_size=ARGS.vocab_size)
    longs = [t["prompt"] for t in trace if t["long"]]
    tail = _prompts([20, 3], seed=41)
    last = max(t["arrival_step"] for t in trace)
    trace.append({"request_id": 100, "arrival_step": last + 6,
                  "prompt": np.concatenate([longs[0][:21], tail[0]]),
                  "max_new_tokens": 5})
    trace.append({"request_id": 101, "arrival_step": last + 7,
                  "prompt": np.concatenate([longs[1], tail[1]]),
                  "max_new_tokens": 5})
    return trace


def _drive(eng, trace, request_cls):
    """`replay` that also records each step's (type, request id): the order
    of admissions, chunks and draft windows."""
    pending = sorted(trace, key=lambda t: t["arrival_step"])
    out, events, i = {}, [], 0
    while i < len(pending) or eng.queue or eng.slots.active_slots:
        while (i < len(pending)
               and pending[i]["arrival_step"] <= eng.step_count):
            t = pending[i]
            out[id(t)] = eng.submit(request_cls(
                t["prompt"], t["max_new_tokens"],
                eos_token_id=t.get("eos_token_id"),
                request_id=t["request_id"]))
            i += 1
        ev = eng.step()
        events.append((ev["type"], ev.get("request_id")))
    return [out[id(t)] for t in trace], events


def _counters(eng):
    c = eng.metrics.summary()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _chunk_stats(eng):
    m = eng.metrics.summary()
    obs = m["observations"].get("chunks_per_prompt") or {}
    stall = m["gauges"].get("prefill_stall_steps", {}).get("max", 0)
    return obs.get("count", 0), obs.get("sum", 0), stall


def _engines(jparams, model, kv_dtype=None, chunk=None, spec=False, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if spec:
        jd, jda = jgen.draft_from_params(jparams, ARGS, 1)
        jkw.update(draft_params=jd, draft_args=jda, spec_tokens=3)
        tkw.update(draft_params=draft_from_params(model, 1), spec_tokens=3)
    jeng = JPagedEngine(jparams, ARGS, kv_dtype=kv_dtype,
                        prefill_chunk=chunk, **ENGINE_KW, **jkw)
    teng = PagedEngine(model, kv_dtype=kv_dtype, prefill_chunk=chunk,
                       device=CPU, **ENGINE_KW, **tkw)
    return jeng, teng


def _assert_same_run(jeng, teng, trace):
    jreqs, jev = _drive(jeng, trace, JRequest)
    treqs, tev = _drive(teng, trace, Request)
    for j, t in zip(jreqs, treqs):
        assert t.finished
        assert list(t.token_ids) == list(j.token_ids), t.request_id
    assert tev == jev
    assert _counters(teng) == _counters(jeng)
    assert _chunk_stats(teng) == _chunk_stats(jeng)
    assert teng._alloc.pages_in_use == 0
    return _counters(teng), tev


def test_mixed_trace_is_the_reference_trace():
    kw = dict(seed=3, n_short=12, short_len_choices=(24, 40, 57, 96),
              n_long=2, long_len=300, mean_interarrival_steps=2.5,
              new_tokens_choices=(32,), long_new_tokens=32, vocab_size=32000)
    ours = make_mixed_trace(**kw)
    ref = serving_trace.make_mixed_trace(**kw)
    assert [(t["request_id"], t["arrival_step"], t["max_new_tokens"],
             t["long"]) for t in ours] == \
        [(t["request_id"], t["arrival_step"], t["max_new_tokens"],
          t["long"]) for t in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
    assert trace_stats(ours) == serving_trace.trace_stats(ref)


def test_chunked_prefill_matches_reference(jparams, model):
    trace = _trace()
    c, events = _assert_same_run(*_engines(jparams, model, chunk=16), trace)
    assert c["chunked_prefills"] >= 3
    assert c["prefix_partial_hits"] >= 1 and c["prefix_tokens_hit"] > 0
    kinds = [k for k, _ in events]
    first, last = kinds.index("prefill_chunk"), \
        len(kinds) - 1 - kinds[::-1].index("prefill_chunk")
    assert "decode" in kinds[first:last]           # the interleave


def test_short_prompt_passes_a_queued_long_one(jparams, model):
    """The anti-convoy admission: while a stream is in flight, a short
    prompt behind a queued long one is admitted first (as the reference's
    engine admits it), and every output stays the sequential greedy one."""
    long_a, long_b = _prompts([30, 29], seed=12)
    (short,) = _prompts([3], seed=13)
    eng = PagedEngine(model, prefill_chunk=8, device=CPU,
                      **dict(ENGINE_KW, max_slots=4))
    ra = eng.submit(Request(long_a, 4))
    eng.step()
    rb = eng.submit(Request(long_b, 4))
    rs = eng.submit(Request(short, 4))
    eng.run_until_idle()
    assert rs.ttft_steps < rb.ttft_steps
    for r, s in zip((ra, rb, rs), _sequential(jparams,
                                              [long_a, long_b, short], 4)):
        np.testing.assert_array_equal(np.asarray(r.token_ids), s)


def test_chunked_and_speculative_match_reference(jparams, model):
    """Chunking under speculation: the draft mirrors each streamed prompt
    window by window, never ahead of the target."""
    trace = _trace()
    jeng, teng = _engines(jparams, model, chunk=16, spec=True)
    mirror_ok = []
    orig = teng._spec.prefill_window

    def watched(req, slot, start, end):
        st = teng._chunk_streams[slot]
        mirror_ok.append((start < st["done"] or st["done"] == st["n"])
                         and end - start <= 16)
        return orig(req, slot, start, end)

    teng._spec.prefill_window = watched
    c, events = _assert_same_run(jeng, teng, trace)
    assert c["draft_prefill_chunks"] > 0 and all(mirror_ok)
    assert c["spec_rounds"] > 0 and c["decode_steps"] == 0
    assert ("draft_prefill_chunk", 100) in events


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_speculative_matches_reference(jparams, model, kv_dtype):
    trace = serving_trace.make_trace(
        seed=2, n_requests=6, prompt_len_choices=(3, 7, 12, 17),
        new_tokens_choices=(6, 9), vocab_size=ARGS.vocab_size)
    c, _ = _assert_same_run(
        *_engines(jparams, model, kv_dtype=kv_dtype, spec=True), trace)
    assert c["spec_rounds"] > 0
    assert 0 < c["draft_tokens_accepted"] < c["draft_tokens_proposed"]


def _sequential(jparams, prompts, max_new, eos=None):
    return [np.asarray(jgen.generate(jparams, ARGS, p[None],
                                     max_new_tokens=max_new,
                                     eos_token_id=eos))[0][len(p):]
            for p in prompts]


def test_int8_pool_speculation_within_agreement_bar(jparams, model):
    """The reference's bar for an int8 pool under speculation
    (tests/test_paged_kv.py:891): top-1 agreement >= 0.8 with sequential
    greedy over the float cache."""
    eng = PagedEngine(model, kv_dtype="int8", draft_params=model,
                      spec_tokens=3, device=CPU, **ENGINE_KW)
    prompts = _prompts([12, 20], seed=61)
    ref = _sequential(jparams, prompts, 6)
    reqs = eng.serve([Request(p, 6) for p in prompts])
    agree = [float(np.mean(np.asarray(r.token_ids) == s))
             for r, s in zip(reqs, ref)]
    assert min(agree) >= 0.8, agree
    assert eng._alloc.pages_in_use == 0


def test_eos_inside_a_window_retires_there(jparams, model):
    prompts = _prompts([3, 5, 7], seed=11)
    eos = int(_sequential(jparams, prompts, 6)[0][2])
    ref = _sequential(jparams, prompts, 6, eos=eos)
    eng = PagedEngine(model, draft_params=draft_from_params(model, 1),
                      spec_tokens=3, device=CPU, **ENGINE_KW)
    reqs = eng.serve([Request(p, 6, eos_token_id=eos) for p in prompts])
    for r, s in zip(reqs, ref):
        idx = np.nonzero(s == eos)[0]
        want = s[:idx[0] + 1] if idx.size else s
        assert r.finished
        np.testing.assert_array_equal(np.asarray(r.token_ids), want)
    assert reqs[0].finish_reason == "eos"
    assert eng.slots.free_count == eng.max_slots
    assert eng._alloc.pages_in_use == 0


def test_all_rejected_round_state_matches_plain_decode(jparams, model):
    """A draft the target rejects every time: each round commits one token,
    and after every round the block tables, refcounts, free and available
    counts and reservations equal a plain engine's on the same request."""
    (p,) = _prompts([20], seed=51)
    ref = _sequential(jparams, [p], 10)[0]
    used = set(ref.tolist()) | set(p.tolist())
    bad = next(t for t in range(1, ARGS.vocab_size) if t not in used)
    plain = PagedEngine(model, device=CPU, **ENGINE_KW)
    spec = PagedEngine(model, draft_params=draft_from_params(model, 1),
                       spec_tokens=3, device=CPU, **ENGINE_KW)
    spec._spec._propose_device = \
        lambda forced, n_forced, start, sample=False: (np.full(
            (spec.max_slots, spec.spec_tokens + 1), bad, np.int32), None)

    def state(eng):
        return (tuple(tuple(row) for row in eng._bt),
                tuple(tuple(eng._alloc.refcount(pg) for pg in row)
                      for row in eng._bt),
                eng._alloc.free_count, eng._alloc.available,
                dict(eng._resv), eng._reserved_total)

    rp = plain.submit(Request(p, 10))
    rs = spec.submit(Request(p, 10))
    plain.step(), spec.step()
    assert state(plain) == state(spec)
    while not rs.finished:
        ev = spec.step()
        assert ev["type"] == "spec_decode"
        (committed,) = ev["tokens"].values()
        assert len(committed) == 1
        plain.step()
        assert state(plain) == state(spec)
    assert rp.token_ids == rs.token_ids == list(ref)
    c = spec.metrics.summary()["counters"]
    assert c["spec_pages_rewound"] > 0 and c["draft_tokens_accepted"] == 0


def test_mid_page_chunk_rewrites_the_straddled_page(model):
    """A chunk stream that starts after a mid-page partial hit: the KV of
    every prompt position, gathered through the block table, equals a
    monolithic prefill's."""
    (base,) = _prompts([40], seed=5)
    prompt = np.concatenate([base[:21], _prompts([30], seed=6)[0]])

    def kv(chunk):
        eng = PagedEngine(model, prefill_chunk=chunk, device=CPU,
                          **ENGINE_KW)
        eng.serve([Request(base, 2)])
        before = eng.metrics.summary()["counters"].get("prefill_chunks", 0)
        eng.submit(Request(prompt, 3))
        while not eng.slots.active_slots or eng._chunk_streams:
            eng.step()
        (slot,) = eng.slots.active_slots
        bt = torch.full((1, eng.pages_per_slot), NULL_PAGE, dtype=torch.int32)
        bt[0, :len(eng._bt[slot])] = torch.tensor(eng._bt[slot])
        c = dict(eng.metrics.summary()["counters"])
        c["prefill_chunks"] = c.get("prefill_chunks", 0) - before
        return (torch.stack([at.paged_gather(eng._pk[i], bt)
                             for i in range(ARGS.num_layers)])[
                                 :, 0, :, :prompt.size], c)

    mono, cm = kv(None)
    chunked, cc = kv(8)
    assert cc["prefix_partial_hits"] == cm["prefix_partial_hits"] == 1
    assert cc["prefill_chunks"] == 4      # 51 - 21 = 30 tokens in 8s
    torch.testing.assert_close(chunked, mono, rtol=1e-5, atol=1e-6)


# -- sampled speculation, within the port -----------------------------------


def _spec_engine(model, draft, **kw):
    return PagedEngine(model, draft_params=draft, spec_tokens=3, device=CPU,
                       **ENGINE_KW, **kw)


def test_draft_equal_to_target_gives_the_sequential_sample(model):
    prompts = _prompts([6, 9], seed=21)
    reqs = [dict(temperature=0.7, seed=5), dict(temperature=1.0, top_k=20,
                                                 seed=9)]
    plain = PagedEngine(model, device=CPU, **ENGINE_KW).serve(
        [Request(p, 8, **kw) for p, kw in zip(prompts, reqs)])
    eng = _spec_engine(model, model)
    spec = eng.serve([Request(p, 8, **kw) for p, kw in zip(prompts, reqs)])
    for a, b in zip(plain, spec):
        assert a.token_ids == b.token_ids
    c = eng.metrics.summary()["counters"]
    assert c["spec_rounds"] > 0 and c["draft_tokens_accepted"] > 0


def test_sampled_speculation_is_reproducible(model):
    def run(seed):
        eng = _spec_engine(model, draft_from_params(model, 1))
        (p,) = _prompts([5], seed=23)
        (req,) = eng.serve([Request(p, 10, temperature=0.9, top_p=0.95,
                                    seed=seed)])
        return list(req.token_ids)

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_greedy_row_exact_in_a_sampled_batch(jparams, model):
    gp, sp = _prompts([4, 6], seed=29)
    ref = _sequential(jparams, [gp], 6)[0]
    eng = _spec_engine(model, draft_from_params(model, 1))
    greedy, sampled = eng.serve([Request(gp, 6),
                                 Request(sp, 6, temperature=0.8, seed=3)])
    np.testing.assert_array_equal(np.asarray(greedy.token_ids), ref)
    assert sampled.finished and len(sampled.token_ids) == 6


def test_disagreeing_draft_reaches_the_resample_branch(model):
    eng = _spec_engine(model, draft_from_params(model, 1))
    prompts = _prompts([4, 7], seed=31)
    reqs = eng.serve([Request(p, 12, temperature=1.0, seed=s)
                      for s, p in enumerate(prompts)])
    assert all(r.finished and len(r.token_ids) == 12 for r in reqs)
    c = eng.metrics.summary()["counters"]
    assert c["spec_resamples"] > 0
    assert c["draft_tokens_accepted"] < c["draft_tokens_proposed"]


class _Metrics:
    def __init__(self):
        self.counts = {}

    def inc(self, name, value=1):
        self.counts[name] = self.counts.get(name, 0) + value


def test_rejection_rule_commits_target_distributed_tokens():
    """Leviathan's theorem on the port's accept rule: drafts drawn from a
    draft distribution far from the target's, the committed tokens at each
    window position follow the target's distribution (chi-square, 6-token
    vocabulary, 6000 rounds, p = 0.001), while the drafts themselves do
    not (the same statistic is large)."""
    g, V, n = 3, 6, 6000
    rng = np.random.default_rng(0)
    pt = rng.dirichlet(np.ones(V), size=g + 1).astype(np.float32)
    pd = np.roll(pt, 2, axis=1)                    # mass on other tokens
    pd = (0.7 * pd + 0.3 / V).astype(np.float32)
    dec = SpecDecoder.__new__(SpecDecoder)
    dec.g = g
    dec.eng = type("E", (), {"metrics": _Metrics()})()
    tmasked = torch.log(torch.from_numpy(pt))[None]
    first = np.zeros(V)
    second = np.zeros(V)
    drafted = np.zeros(V)
    req = type("R", (), {})()
    for s in range(n):
        req.seed = s
        drafts = [int(rng.choice(V, p=pd[i] / pd[i].sum())) for i in range(g)]
        drafted[drafts[0]] += 1
        _, commit = dec._accept_sampled(req, 0, 10, drafts, 0, pd[None],
                                        pt[None], tmasked)
        first[commit[0]] += 1
        if len(commit) > 1:
            second[commit[1]] += 1

    def chi2(counts, p):
        exp = counts.sum() * p.astype(np.float64) / p.sum()
        return float(((counts - exp) ** 2 / exp).sum())

    crit = 20.515                                  # chi2(5).ppf(0.999)
    assert chi2(first, pt[0]) < crit
    assert chi2(second, pt[1]) < crit
    assert chi2(drafted, pt[0]) > 10 * crit
    assert dec.eng.metrics.counts["spec_resamples"] > n // 4


# -- construction -------------------------------------------------------------


def test_draft_from_params_validates_and_shares_storage(model):
    for bad in (0, ARGS.num_layers + 1):
        with pytest.raises(ValueError, match="draft"):
            draft_from_params(model, bad)
    d = draft_from_params(model, 1)
    assert d.args.num_layers == 1
    assert d.layers["wq"].data_ptr() == model.layers["wq"].data_ptr()
    assert d.layers["wq"].shape[0] == 1
    for name in ("embedding", "final_norm", "lm_head"):
        assert getattr(d, name).data_ptr() == getattr(model, name).data_ptr()
    q = quantize_params(model)
    dq = draft_from_params(q, 1)
    assert dq.quantized and dq.tree()["layers"]["wq"].q.shape[0] == 1
    assert dq.layers["wq_q"].data_ptr() == q.layers["wq_q"].data_ptr()


def test_bad_options_raise(model):
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedEngine(model, prefill_chunk=12, device=CPU, **ENGINE_KW)
    with pytest.raises(ValueError, match="spec_tokens"):
        PagedEngine(model, draft_params=model, spec_tokens=0, device=CPU,
                    **ENGINE_KW)
    other = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlf.init_params(
            ARGS._replace(vocab_size=64), jax.random.key(1))),
        tlf.LlamaArgs(*ARGS._replace(vocab_size=64)), device=CPU)
    with pytest.raises(ValueError, match="vocab"):
        PagedEngine(model, draft_params=other, device=CPU, **ENGINE_KW)
    eng = _spec_engine(model, draft_from_params(model, 1))
    eng.submit(Request(_prompts([5])[0], 6))
    eng.step()
    with pytest.raises(ValueError, match="speculative"):
        eng.preempt(0)


def test_preempt_and_resume_continue_bit_identically(model):
    (p,) = _prompts([13], seed=17)
    ref = PagedEngine(model, device=CPU, **ENGINE_KW).serve(
        [Request(p, 8)])[0].token_ids
    eng = PagedEngine(model, device=CPU, **ENGINE_KW)
    req = eng.submit(Request(p, 8))
    for _ in range(3):
        eng.step()
    state = eng.preempt(0)
    assert not eng.slots.active_slots
    assert eng.can_resume(state)
    eng.resume(state)
    eng.run_until_idle()
    assert req.token_ids == ref
    assert eng._alloc.pages_in_use == 0
