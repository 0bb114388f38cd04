"""fp16 serving in the PyTorch port against the JAX package, on the CPU.

  - B4, B5, B6 and B7's plain versions in fp16 against the reference's
    Pallas kernels in interpret mode and its XLA oracles, and B9/B10's
    against `rms_norm(..., interpret=True)` and its VJP;
  - the gates: `_check_kernel`, `paged_route`, `rms_norm.supports` and the
    split counts the wrappers hand the C entry points take fp16 and still
    refuse f64 and mixed dtypes;
  - the tiny Llama of tests/test_torch_disagg.py in fp16: the port's
    `PagedEngine` (float and int8 pools), `Engine`, `generate` and
    `DisaggServer` give the JAX package's greedy tokens.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_kernels_cuda.py and by `chip_smoke.py`. Inputs are made
with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import quantized_matmul as jqm
from paddle_tpu.kernels import rms_norm as jrn
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import disagg as jdisagg
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.serving import (DisaggServer, Engine, PagedEngine,
                                      Request)

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

F16 = np.float16
# fp16 outputs of magnitude up to ~3: the two sides round scores,
# probabilities and (B7) dequantized values to fp16 at other places; 2e-3
# is about two fp16 units in the last place at a magnitude of 1-2
ATOL = 2e-3
EPS = 1e-6
CPU = "cpu"
ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
ENGINE_KW = dict(max_slots=4, max_len=64, page_size=8, min_bucket=8)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(out, *refs):
    assert out.dtype == torch.float16
    for ref in refs:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=ATOL)


# --------------------------------------------------------------------------
# B4-B7's plain versions in fp16 (the cases of tests/test_torch_attention.py)
# --------------------------------------------------------------------------


DECODE_CASES = [(3, 4, 2, 32, 128, [0, 57, 127]),
                (2, 4, 4, 64, 256, [200, 5]),
                (2, 8, 2, 32, 128, [9, 100]),
                (2, 4, 2, 32, 128, 77)]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_reference_fp16(case):
    b, nh, nkv, hd, max_len, pos = case
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, 1, nh, hd)).astype(F16)
    ck = rng.normal(size=(b, nkv, max_len, hd)).astype(F16)
    cv = rng.normal(size=(b, nkv, max_len, hd)).astype(F16)
    sm = 1.0 / np.sqrt(hd)
    jpos = jnp.asarray(pos, jnp.int32)
    xla = jqm._decode_attention_xla(*_j(q, ck, cv), jpos, sm)
    pallas = jqm._decode_attention_pallas(*_j(q, ck, cv), jpos, sm,
                                          block_k=64, interpret=True)
    tpos = (pos if isinstance(pos, int)
            else torch.tensor(pos, dtype=torch.int32))
    _close(at.decode_attention_plain(*_t(q, ck, cv), tpos), xla, pallas)


WINDOW_CASES = [(2, 8, 4, 2, 32, 128, [125, 40]),
                (1, 16, 8, 2, 32, 256, [0]),
                (2, 4, 4, 4, 64, 128, [127, 3])]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_plain_matches_reference_fp16(case):
    b, s, nh, nkv, hd, max_len, pos = case
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, s, nh, hd)).astype(F16)
    ck = rng.normal(size=(b, nkv, max_len, hd)).astype(F16)
    cv = rng.normal(size=(b, nkv, max_len, hd)).astype(F16)
    sm = 1.0 / np.sqrt(hd)
    jpos = jnp.asarray(pos, jnp.int32)
    xla = jqm._window_attention_xla(*_j(q, ck, cv), jpos, sm)
    pallas = jqm._window_attention_pallas(*_j(q, ck, cv), jpos, sm,
                                          block_k=64, interpret=True)
    _close(at.window_attention_plain(*_t(q, ck, cv),
                                     torch.tensor(pos, dtype=torch.int32)),
           xla, pallas)


def _tables():
    """test_torch_attention.py's layout: rows at different depths, a page
    shared by two rows, null-page tails."""
    bt = np.zeros((3, 8), np.int32)
    bt[0, :4] = [3, 7, 2, 11]
    bt[1, :8] = [5, 6, 8, 9, 10, 12, 13, 14]
    bt[2, :3] = [3, 15, 16]
    return bt, np.array([49, 127, 33], np.int32)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 2, 32), (4, 4, 128)])
def test_paged_plain_matches_reference_fp16(nh, nkv, hd):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 1, nh, hd)).astype(F16)
    pk = rng.normal(size=(20, nkv, 16, hd)).astype(F16)
    pv = rng.normal(size=(20, nkv, 16, hd)).astype(F16)
    bt, pos = _tables()
    sm = 1.0 / np.sqrt(hd)
    xla = jqm._paged_decode_attention_xla(*_j(q, pk, pv, bt, pos), sm)
    pallas = jqm._paged_decode_attention_pallas(*_j(q, pk, pv, bt, pos), sm,
                                                True)
    _close(at.paged_decode_attention_plain(*_t(q, pk, pv, bt, pos)), xla,
           pallas)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 2, 128), (4, 4, 64)])
def test_paged_q8_plain_matches_reference_fp16(nh, nkv, hd):
    """B7 with an fp16 query over an int8 pool (ps 32, GQA, one page at
    scale 0), as tests/test_torch_quantized.py runs it in f32."""
    rng = np.random.default_rng(11)
    b, ps, n_pages, P = 3, 32, 9, 4
    q = rng.normal(size=(b, 1, nh, hd)).astype(F16)

    def pool():
        return (rng.integers(-127, 128, size=(n_pages, nkv, ps, hd))
                .astype(np.int8),
                rng.uniform(0.5, 2.0, size=(n_pages, nkv)).astype(np.float32))

    (kq, ks), (vq, vs) = pool(), pool()
    bt = rng.integers(1, n_pages, size=(b, P)).astype(np.int32)
    ks[bt[1, 0]] = vs[bt[1, 0]] = 0.0
    pos = np.array([5, 37, 120], np.int32)
    sm = 1.0 / np.sqrt(hd)
    j = _j(q, kq, vq, bt, pos, ks, vs)
    xla = jqm._paged_decode_attention_xla(*j[:5], sm, j[5], j[6])
    pallas = jqm._paged_decode_attention_pallas(*j[:5], sm, True,
                                                k_scale=j[5], v_scale=j[6])
    t = _t(q, kq, vq, bt, pos, ks, vs)
    out = at.paged_decode_attention(*t[:5], k_scale=t[5], v_scale=t[6])
    assert torch.isfinite(out).all()
    _close(out, xla, pallas)


# --------------------------------------------------------------------------
# B9/B10's plain versions in fp16
# --------------------------------------------------------------------------


def _f16_ulp(y):
    """The fp16 unit in the last place of each |y| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(y), 2.0 ** -14)))
    return np.exp2(e - 10)


@pytest.mark.parametrize("rows,h", [(64, 256), (24, 128)])
def test_rms_norm_plain_matches_pallas_fp16(rows, h):
    """Forward: the port rounds twice, rnd(rnd(x r) w), the Pallas kernel
    once, rnd(x r w): at most one fp16 unit apart. Backward (the VJP of
    `rms_norm`, interpret mode): both compute in f32 and round dx to x's
    dtype and dw to w's once, so they differ by summation order: one unit
    at most."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(rows, h))
         * 10.0 ** rng.uniform(-2, 1, size=(rows, 1))).astype(F16)
    w = rng.normal(1.0, 0.5, size=h).astype(F16)
    g = rng.normal(size=(rows, h)).astype(F16)
    y_ref, vjp = jax.vjp(lambda a, b: jrn.rms_norm(a, b, EPS, True),
                         *_j(x, w))
    dx_ref, dw_ref = (np.asarray(a, np.float32) for a in vjp(jnp.asarray(g)))
    y_ref = np.asarray(y_ref, np.float32)
    tx, tw, tg = _t(x, w, g)
    y, r = rn.rms_norm_fwd_plain(tx, tw, EPS)
    dx, dw = rn.rms_norm_bwd_plain(tx, tw, r, tg)
    assert y.dtype == dx.dtype == dw.dtype == torch.float16
    for got, ref in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        diff = np.abs(got.float().numpy() - ref)
        assert (diff <= _f16_ulp(ref)).all(), diff.max()
    # the forward's two roundings differ from the one somewhere
    assert (np.abs(y.float().numpy() - y_ref) > 0).any()


# --------------------------------------------------------------------------
# gates and routes
# --------------------------------------------------------------------------


def test_kernel_gates_take_fp16_and_refuse_f64_and_mixes():
    q = torch.zeros(2, 1, 4, 64, dtype=torch.float16)
    kv = torch.zeros(2, 2, 32, 64, dtype=torch.float16)
    at._check_kernel(q, (kv, kv), 2)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        at._check_kernel(q.double(), (kv.double(), kv.double()), 2)
    with pytest.raises(TypeError, match="dtype mismatch"):
        at._check_kernel(q, (kv.bfloat16(), kv.bfloat16()), 2)
    assert at.paged_route(torch.float16) == at.paged_route(
        torch.bfloat16) == "cluster"
    assert at.paged_route(torch.float32) == "shared"
    x, w = torch.zeros(4, 64, dtype=torch.float16), torch.ones(
        64, dtype=torch.float16)
    assert rn.supports(x, w)
    assert not rn.supports(x.double(), w.double())
    assert not rn.supports(x, w.bfloat16())
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        rn._check_kernel(w.double(), x.double())
    # B10's plan reads the item size alone: fp16's is bf16's
    for h in (128, 2048, 4096, 11008, 16384):
        assert rn.bwd_plan(h, 2) == rn.bwd_plan(h, torch.float16.itemsize)


def _splits_ok(dtype, split_tiles, splits):
    """`splits_ok` of csrc/attention.cu: f32 takes the shared body (0),
    bf16 the cluster or the shared body, fp16 the cluster only."""
    if splits < 0 or splits > at.WINDOW_MAX_SPLITS or split_tiles < 1:
        return False
    return {0: splits == 0, 1: True, 2: splits >= 1}.get(dtype, False)


def test_wrappers_hand_fp16_to_the_cluster_kernels(monkeypatch):
    """What each wrapper passes the C entry points for an fp16 query (its
    launch stood in for on the CPU, the tensors' device read as a card):
    dtype code 2, a cluster of the bf16 call's size that `splits_ok`
    takes, and one launch a call counted under its fp16 variant too."""
    calls = []

    def launch(lib, fn, dev, *args):
        # (fn, dtype code, split_tiles, splits) by the signatures' order
        calls.append((fn,) + tuple(args[-4:-1]))
        return 0

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(at, "_on_card", lambda *ts: True)
    monkeypatch.setattr(at, "launches", dict.fromkeys(at.launches, 0))
    monkeypatch.setattr(at, "variant_launches",
                        dict.fromkeys(at.variant_launches, 0))
    b, nh, nkv, hd, ps, P = 2, 4, 2, 64, 16, 64
    pos = torch.tensor([700, 5], dtype=torch.int32)
    seen = {}
    for dt in (torch.bfloat16, torch.float16):
        calls.clear()
        q = torch.zeros(b, 1, nh, hd, dtype=dt)
        cache = torch.zeros(b, nkv, 1024, hd, dtype=dt)
        pool = torch.zeros(1 + b * P, nkv, ps, hd, dtype=dt)
        codes = torch.zeros(pool.shape, dtype=torch.int8)
        sc = torch.ones(1 + b * P, nkv)
        bt = torch.arange(1, 1 + b * P, dtype=torch.int32).reshape(b, P)
        at.decode_attention(q, cache, cache, 700)
        at.window_attention(torch.zeros(b, 5, nh, hd, dtype=dt), cache,
                            cache, 700)
        at.paged_decode_attention(q, pool, pool, bt, pos)
        at.paged_decode_attention(q, codes, codes, bt, pos, k_scale=sc,
                                  v_scale=sc)
        seen[dt] = list(calls)
    for (fn, code, tiles, splits), (fn16, code16, tiles16, splits16) in zip(
            seen[torch.bfloat16], seen[torch.float16]):
        assert (fn16, tiles16, splits16) == (fn, tiles, splits)
        assert (code, code16) == (1, 2)
        assert splits16 >= 1 and _splits_ok(2, tiles16, splits16)
    assert not _splits_ok(2, 8, 0) and not _splits_ok(3, 8, 1)
    assert at.launches == dict.fromkeys(at.launches, 2)
    assert at.variant_launches == dict.fromkeys(at.variant_launches, 1)


# --------------------------------------------------------------------------
# the engines in fp16
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams16():
    f32 = jlf.init_params(ARGS, jax.random.key(0))
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), f32)


@pytest.fixture(scope="module")
def model16(jparams16):
    # the fp16 values carried over as they are
    return params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jparams16),
        tlf.LlamaArgs(*ARGS), device=CPU, dtype=torch.float16)


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ARGS.vocab_size, n).astype(np.int32)
            for n in lengths]


def _run(serve, reqs):
    serve(reqs)
    return [list(r.token_ids) for r in reqs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_engine_fp16_matches_reference(jparams16, model16, kv_dtype):
    prompts = _prompts([11, 5, 17])
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    eng = PagedEngine(model16, device=CPU, **kw)
    got = _run(eng.serve, [Request(p, 8) for p in prompts])
    ref = _run(JPagedEngine(jparams16, ARGS, **kw).serve,
               [JRequest(p, 8) for p in prompts])
    assert got == ref
    leaf = eng._pk.q if kv_dtype else eng._pk
    assert leaf.dtype == (torch.int8 if kv_dtype else torch.float16)
    assert eng._alloc.pages_in_use == 0


def test_engine_and_generate_fp16_match_reference(jparams16, model16):
    prompts = _prompts([9, 4, 14], seed=7)
    kw = dict(max_slots=2, max_len=48, min_bucket=8)
    got = _run(Engine(model16, device=CPU, **kw).serve,
               [Request(p, 8) for p in prompts])
    ref = _run(JEngine(jparams16, ARGS, **kw).serve,
               [JRequest(p, 8) for p in prompts])
    assert got == ref
    for p, toks in zip(prompts, got):
        out = tgen.generate(model16, p[None], max_new_tokens=8, device=CPU)
        jout = np.asarray(jgen.generate(jparams16, ARGS, p[None],
                                        max_new_tokens=8))
        np.testing.assert_array_equal(out.numpy()[0, len(p):], toks)
        np.testing.assert_array_equal(jout[0, len(p):], toks)


def test_disagg_fp16_matches_reference(jparams16, model16):
    """The fp16 pages cross `KVHandoff.to_bytes` (the JAX package's bytes,
    tests/test_torch_disagg.py) into the decode worker's fp16 pool; the
    tokens equal the JAX `DisaggServer`'s and its monolithic engine's."""
    prompts = _prompts([11, 5, 17])
    srv = DisaggServer(model16, device=CPU, **ENGINE_KW)
    got = _run(srv.serve, [Request(p, 8, request_id=f"r{i}")
                           for i, p in enumerate(prompts)])
    jsrv = jdisagg.DisaggServer(jparams16, ARGS, **ENGINE_KW)
    ref = _run(jsrv.serve, [JRequest(p, 8, request_id=f"r{i}")
                            for i, p in enumerate(prompts)])
    assert got == ref
    assert srv.decode._pk.dtype == torch.float16
    assert srv.prefill.metrics.counter("handoff_bytes") == \
        jsrv.prefill.metrics.counter("handoff_bytes")
