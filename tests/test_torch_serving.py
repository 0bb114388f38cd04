"""Serving in the PyTorch port (paddle_tpu_torch/serving) against the JAX
reference engines, on the CPU, in f32.

  - the port's `PagedEngine` emits the same greedy tokens as the JAX
    `PagedEngine` and JAX `generate`, with the same prefix-cache counters,
    on a mixed-length trace with partial-overlap prefixes (radix COW
    splits) and page-pressure deferral;
  - the port's stripe `Engine` equals sequential `generate`;
  - the copied host-side pieces (radix allocator, buckets, page math)
    behave as the reference's on the same inputs;
  - the option not ported yet (`mesh=`) raises, naming its ROADMAP item,
    and an unknown KV dtype raises ValueError, as the reference does
    (chunked prefill and speculation: tests/test_torch_spec_chunk.py).

The reference's stripe-Engine EOS path is a known reference failure
(ROADMAP §C) and is not used as an oracle.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.serving import BlockAllocator as JBlockAllocator
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu.serving import bucket_for as j_bucket_for
from paddle_tpu.serving import pages_for as j_pages_for
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.serving import (BlockAllocator, Engine, PagedEngine,
                                      Request, bucket_for, pages_for)
from tools.serving_trace import make_partial_overlap_trace

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
CPU = "cpu"
# the engines see identical traffic: counters that depend only on the
# scheduler and the prefix cache must agree exactly
SHARED_COUNTERS = ("prefills", "decode_steps", "tokens_generated",
                   "prompt_tokens", "prefix_tokens_hit", "prefix_pages_hit",
                   "prefix_pages_queried", "prefix_partial_hits",
                   "radix_splits", "cow_copies", "page_evictions",
                   "requests_finished")


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


@pytest.fixture(scope="module")
def trace():
    # 12 requests on a 22-token base prompt cut at 12 and 19 (mid-page for
    # 8-token pages) plus the whole base, each with a unique suffix
    return make_partial_overlap_trace(seed=0, n_requests=12, base_len=22,
                                      divergence_points=(12, 19),
                                      new_tokens_choices=(6, 9))


@pytest.mark.parametrize("policy", ["radix", "hash"])
def test_paged_engine_matches_reference_engine(jparams, model, trace, policy):
    """12 pages for 3 slots: admission defers under page pressure and
    cached pages get evicted; tokens and counters must match."""
    kw = dict(max_slots=3, max_len=64, page_size=8, num_pages=12,
              min_bucket=8, prefix_policy=policy)
    jeng = JPagedEngine(jparams, ARGS, **kw)
    teng = PagedEngine(model, device=CPU, **kw)
    jreqs = jeng.replay(trace)
    treqs = teng.replay(trace)
    for jr, tr in zip(jreqs, treqs):
        assert tr.finished and tr.finish_reason == "length"
        assert tr.token_ids == jr.token_ids, tr.request_id
    jm, tm = jeng.metrics.summary(), teng.metrics.summary()
    for k in SHARED_COUNTERS:
        assert tm["counters"].get(k, 0) == jm["counters"].get(k, 0), k
    assert tm["gauges"]["active_slots"]["max"] == \
        jm["gauges"]["active_slots"]["max"]
    assert teng._alloc.pages_in_use == 0
    if policy == "radix":
        assert tm["counters"]["prefix_partial_hits"] > 0
        assert tm["counters"]["radix_splits"] > 0
        assert tm["counters"]["page_evictions"] > 0


def test_paged_engine_matches_generate(jparams, model):
    """A shared 16-token prefix: later requests hit it (the short suffix
    windows run the window path) and still equal JAX generate."""
    prefix = _prompts([16], seed=41)[0]
    prompts = [np.concatenate([prefix, s])
               for s in _prompts([5, 3, 9, 30], seed=43)]
    eng = PagedEngine(model, max_slots=2, max_len=64, page_size=8,
                      min_bucket=8, device=CPU)
    reqs = eng.serve([Request(p, 7) for p in prompts])
    for r, p in zip(reqs, prompts):
        ref = np.asarray(jgen.generate(jparams, ARGS, p[None],
                                       max_new_tokens=7))[0, len(p):]
        np.testing.assert_array_equal(np.asarray(r.token_ids), ref)
    assert eng.metrics.counter("prefix_tokens_hit") >= 3 * 16
    assert eng.metrics.gauge("kv_pool_bytes") == \
        2 * eng._pk.numel() * eng._pk.element_size()


def test_admission_defers_under_page_pressure(jparams, model):
    """A pool of 4 pages holds one 3-page request at a time: the second
    waits with a slot free until the first retires, then both equal JAX
    generate."""
    prompts = _prompts([10, 10], seed=17)
    eng = PagedEngine(model, max_slots=2, max_len=32, page_size=8,
                      num_pages=5, min_bucket=8, device=CPU)
    first, second = [eng.submit(Request(p, 8)) for p in prompts]
    # per step: (event type, a request waited with a slot free, first done)
    steps = []
    while eng.queue or eng.slots.active_slots:
        waited = bool(eng.queue) and eng.slots.free_count > 0
        steps.append((eng.step()["type"], waited, first.finished))
    assert any(t == "decode" and waited for t, waited, _ in steps)
    prefills = [i for i, (t, _, _) in enumerate(steps) if t == "prefill"]
    assert len(prefills) == 2 and steps[prefills[1] - 1][2]
    for r, p in zip((first, second), prompts):
        ref = np.asarray(jgen.generate(jparams, ARGS, p[None],
                                       max_new_tokens=8))[0, len(p):]
        np.testing.assert_array_equal(np.asarray(r.token_ids), ref)


def test_stripe_engine_matches_sequential_generate(model):
    prompts = _prompts([3, 5, 9, 12, 17], seed=5)
    eng = Engine(model, max_slots=2, max_len=48, min_bucket=8, device=CPU)
    reqs = eng.serve([Request(p, 8) for p in prompts])
    for r, p in zip(reqs, prompts):
        ref = tgen.generate(model, p[None], max_new_tokens=8,
                            device=CPU)[0, len(p):]
        assert r.token_ids == ref.tolist()
    assert eng.metrics.counter("tokens_generated") == 5 * 8


def test_sampled_requests_are_seeded_and_batch_independent(model):
    prompts = _prompts([6, 10, 4], seed=13)

    def run(ps, seeds, temps):
        eng = PagedEngine(model, max_slots=3, max_len=32, page_size=8,
                          min_bucket=8, device=CPU)
        return [r.token_ids for r in eng.serve(
            [Request(p, 8, temperature=t, top_p=0.9, seed=s)
             for p, s, t in zip(ps, seeds, temps)])]

    full = run(prompts, [1, 2, 3], [0.8, 0.8, 0.0])
    assert run(prompts, [1, 2, 3], [0.8, 0.8, 0.0]) == full
    assert run(prompts[1:2], [2], [0.8]) == [full[1]]
    greedy = tgen.generate(model, prompts[2][None], max_new_tokens=8,
                           device=CPU)[0, 4:]
    assert full[2] == greedy.tolist()


def test_allocator_copy_matches_reference():
    """The same registration / match / release sequence on both
    allocators gives the same matches, refcounts and availability."""
    rng = np.random.default_rng(7)
    base = rng.integers(1, 50, 30).tolist()
    seqs = [base[:n] + rng.integers(1, 50, k).tolist()
            for n, k in ((12, 9), (19, 4), (30, 6), (5, 11), (19, 7))]
    a, b = BlockAllocator(40, 4), JBlockAllocator(40, 4)
    held = []
    for s in seqs:
        ma, mb = a.match_prefix(s), b.match_prefix(s)
        assert ma == mb
        pages = list(ma.pages)
        if ma.partial_page is not None:
            pa, _ = a.ensure_writable(ma.partial_page)
            pb, _ = b.ensure_writable(mb.partial_page)
            assert pa == pb
            pages.append(pa)
        while len(pages) * 4 < len(s):
            pa, pb = a.alloc(), b.alloc()
            assert pa == pb
            pages.append(pa)
        a.register_prefix(s, pages)
        b.register_prefix(s, pages)
        held.append(pages)
        assert (a.available, a.pages_in_use) == (b.available, b.pages_in_use)
    for pages in held[::2]:
        for p in pages:
            a.release(p)
            b.release(p)
    assert (a.available, a.pages_in_use, a.prefix_version) == \
        (b.available, b.pages_in_use, b.prefix_version)


def test_buckets_and_page_math_match_reference():
    for n in (1, 7, 16, 17, 100, 255, 256):
        assert bucket_for(n, 16, 256) == j_bucket_for(n, 16, 256)
        for new in (1, 2, 9):
            assert pages_for(n, new, 16) == j_pages_for(n, new, 16)


@pytest.mark.parametrize("kw,item", [(dict(mesh=object()), "A9")])
def test_unported_options_raise(model, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        PagedEngine(model, max_slots=1, max_len=32, page_size=8, device=CPU,
                    **kw)


@pytest.mark.parametrize("kv_dtype", ["fp8", "bfloat16"])
def test_unknown_kv_dtype_raises(model, kv_dtype):
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedEngine(model, max_slots=1, max_len=32, page_size=8, device=CPU,
                    kv_dtype=kv_dtype)


def test_engines_check_their_device(model):
    with pytest.raises(ValueError, match="unsupported device"):
        Engine(model, max_slots=1, max_len=16, device="meta")
    eng = Engine(model, max_slots=1, max_len=16, device=CPU)
    assert torch.equal(eng._ck, torch.zeros_like(eng._ck))
    with pytest.raises(ValueError, match="slot capacity"):
        eng.submit(Request(np.ones(10, np.int32), 8))
