"""int8 serving in the PyTorch port against the JAX reference, on the CPU.

  - weight quantization (`quantize_absmax`, `quantize_params`) gives the
    reference's codes and scales;
  - kernel B8's plain version (`dequant_matmul_plain`) agrees with the
    reference's XLA oracle and its Pallas kernel in interpret mode, on
    ragged M/K/N;
  - kernel B7's plain version (the dequantizing gather + B4's plain
    version) agrees with the reference's int8 paged kernel in interpret
    mode, with watermarks mid-page;
  - the running-absmax KV write (`_kv_quant_write`) and the int8 COW copy
    match the reference, including the scale restart at offset 0;
  - `PagedEngine` over an int8 weight tree and over an int8 page pool
    emits the reference engines' greedy tokens and prefix-cache counters;
  - the reference's CPU capacity leg (equal KV bytes, int8 vs model-dtype
    pool) gives the same sustained-slot ratio in both packages;
  - the port's `make_trace` yields the reference helper's trace.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_kernels_cuda.py. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import quantized_matmul as jqm
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.serving import PagedEngine, make_trace
from tools.serving_trace import make_partial_overlap_trace
from tools.serving_trace import make_trace as j_make_trace

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
CPU = "cpu"
SHARED_COUNTERS = ("prefills", "decode_steps", "tokens_generated",
                   "prompt_tokens", "prefix_tokens_hit", "prefix_pages_hit",
                   "prefix_pages_queried", "prefix_partial_hits",
                   "radix_splits", "cow_copies", "page_evictions",
                   "requests_finished")
# f32 on both sides: only the summation order differs (XLA vs torch), over
# K <= 300 terms of magnitude <= ~1
MATMUL_ATOL = 1e-4
ATTN_ATOL = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return jlf.init_params(ARGS, jax.random.key(0))


@pytest.fixture(scope="module")
def jqparams(jparams):
    return jgen.quantize_params(jparams)


@pytest.fixture(scope="module")
def qmodel(jqparams):
    return params_from_numpy(_np_tree(jqparams), tlf.LlamaArgs(*ARGS),
                             device=CPU)


# ---------------------------------------------------------------------------
# weight quantization and B8's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 53), (3, 64, 200), (1, 130)])
def test_quantize_absmax_matches_reference(shape):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 2.0, shape[-1])) \
        .astype(np.float32)
    w[..., 0] = 0.0                         # an all-zero column: the floor
    jq, js = jqm.quantize_absmax(jnp.asarray(w))
    q, s = qm.quantize_absmax(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


def test_quantize_params_matches_reference(jparams, jqparams, qmodel):
    """The port quantizing its float model gives the reference's int8
    tree; embedding and norms stay float, lm_head is quantized."""
    model = params_from_numpy(_np_tree(jparams), tlf.LlamaArgs(*ARGS),
                              device=CPU)
    ported = tgen.quantize_params(model)
    assert ported.quantized and not model.quantized
    assert ported.dtype == torch.float32
    layers, want_layers = ported.tree()["layers"], qmodel.tree()["layers"]
    for k in tgen._QUANT_KEYS:
        got, want = layers[k], want_layers[k]
        np.testing.assert_array_equal(got.q.numpy(), want.q.numpy())
        np.testing.assert_array_max_ulp(got.scale.numpy(),
                                        want.scale.numpy(), maxulp=1)
    np.testing.assert_array_equal(ported.lm_head.q.numpy(),
                                  np.asarray(jqparams["lm_head"].q))
    for k in ("ln1", "ln2"):
        assert not isinstance(layers[k], tgen.QuantizedWeight)
    # codes and scales are the module's parameters (no gradients)
    params = dict(ported.named_parameters())
    assert params["layers.wq_q"].dtype == torch.int8
    assert params["lm_head_scale"].dtype == torch.float32
    assert "lm_head" not in params and "layers.ln1" in params
    assert not any(t.requires_grad for t in params.values())
    # the quantized tree keeps the float leaves as they were
    assert torch.equal(ported.embedding, model.embedding)


# (M, K, N): ragged on every edge, a decode-sized M and one past the GEMV
# regime
MATMUL_CASES = [(1, 64, 128), (8, 200, 72), (19, 130, 257), (40, 300, 96)]


@pytest.mark.parametrize("case", MATMUL_CASES)
def test_dequant_matmul_plain_matches_reference(case):
    m, k, n = case
    rng = np.random.default_rng(1)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, s = jqm.quantize_absmax(jnp.asarray(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05))
    xla = jqm._dequant_matmul_xla(jnp.asarray(x), wq, s)
    pallas = jqm.fused_dequant_matmul(jnp.asarray(x), wq, s, block_m=32,
                                      block_n=128, block_k=128,
                                      interpret=True)
    tx, tq, ts = (torch.from_numpy(np.array(a)) for a in (x, wq, s))
    before = dict(qm.launches)
    out = qm.dequant_matmul_plain(tx, tq, ts)
    # a CPU tensor takes the plain version and counts no launch
    torch.testing.assert_close(qm.weight_only_matmul(tx, tq, ts), out,
                               rtol=0, atol=0)
    assert qm.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(xla),
                               atol=MATMUL_ATOL, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               atol=MATMUL_ATOL, rtol=1e-5)


def test_dequant_matmul_keeps_leading_dims_and_out_dtype():
    x = torch.randn(2, 3, 16)
    q, s = qm.quantize_absmax(torch.randn(16, 8))
    out = qm.weight_only_matmul(x, q, s, out_dtype=torch.bfloat16)
    assert out.shape == (2, 3, 8) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not fit"):
        qm.weight_only_matmul(torch.randn(3, 15), q, s)
    with pytest.raises(TypeError, match="int8"):
        qm.weight_only_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="scale"):
        qm.weight_only_matmul(x, q, s[:4])


# ---------------------------------------------------------------------------
# B7's plain version, the KV write, the COW copy
# ---------------------------------------------------------------------------


def _q8_pool(rng, n_pages, nkv, ps, hd):
    return (rng.integers(-127, 128, size=(n_pages, nkv, ps, hd))
            .astype(np.int8),
            rng.uniform(0.5, 2.0, size=(n_pages, nkv)).astype(np.float32))


@pytest.mark.parametrize("nh,nkv,hd", [(4, 2, 128), (4, 4, 64)])
def test_paged_q8_plain_matches_reference(nh, nkv, hd):
    """test_paged_kv.py's int8 kernel case: ps 32, rows at different
    depths with watermarks mid-page, GQA; one page's scales are 0 (a
    fresh page) and must read as zeros."""
    rng = np.random.default_rng(11)
    b, ps, n_pages, P = 3, 32, 9, 4
    q = rng.normal(size=(b, 1, nh, hd)).astype(np.float32)
    kq, ks = _q8_pool(rng, n_pages, nkv, ps, hd)
    vq, vs = _q8_pool(rng, n_pages, nkv, ps, hd)
    bt = rng.integers(1, n_pages, size=(b, P)).astype(np.int32)
    ks[bt[1, 0]] = 0.0
    vs[bt[1, 0]] = 0.0
    pos = np.array([5, 37, 120], np.int32)
    sm = 1.0 / np.sqrt(hd)
    j = [jnp.asarray(a) for a in (q, kq, vq, bt, pos, ks, vs)]
    xla = jqm._paged_decode_attention_xla(*j[:5], sm, j[5], j[6])
    pallas = jqm._paged_decode_attention_pallas(
        *j[:5], sm, True, k_scale=j[5], v_scale=j[6])
    t = [torch.from_numpy(a) for a in (q, kq, vq, bt, pos, ks, vs)]
    before = dict(at.launches)
    out = at.paged_decode_attention(*t[:5], k_scale=t[5], v_scale=t[6])
    assert at.launches == before
    torch.testing.assert_close(
        out, at.paged_decode_attention_plain(*t[:5], k_scale=t[5],
                                             v_scale=t[6]), rtol=0, atol=0)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATTN_ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               atol=ATTN_ATOL)
    # the dequantizing gather is the reference's, value for value
    np.testing.assert_array_equal(
        at.paged_gather(t[1], t[3], t[5]).numpy(),
        np.asarray(jqm.paged_gather(j[1], j[3], scale=j[5])))


def test_paged_q8_wrapper_rejects_what_it_cannot_take():
    rng = np.random.default_rng(12)
    kq, ks = (torch.from_numpy(a) for a in _q8_pool(rng, 5, 2, 8, 16))
    q = torch.randn(2, 1, 4, 16)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        at.paged_decode_attention(q, kq, kq, bt, pos, k_scale=ks)
    with pytest.raises(TypeError, match="int8"):
        at.paged_decode_attention(q, kq.float(), kq.float(), bt, pos,
                                  k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="num_pages"):
        at.paged_decode_attention(q, kq, kq, bt, pos, k_scale=ks[:3],
                                  v_scale=ks[:3])


def test_kv_quant_write_matches_reference():
    """Rows writing at offset 0 (scale restart over a stale page), mid-page
    below and above the page's running scale (a re-scale of the codes)."""
    rng = np.random.default_rng(5)
    n_pages, nkv, ps, hd = 6, 2, 4, 8
    qp, sc = _q8_pool(rng, n_pages, nkv, ps, hd)
    page = np.array([2, 4, 5, 1], np.int32)
    off = np.array([0, 2, 3, 1], np.int32)
    new = rng.normal(size=(4, nkv, hd)).astype(np.float32)
    new[2] *= 5.0                      # louder than the page: re-scale
    ref = jgen._kv_quant_write(jgen.QuantizedKVPage(jnp.asarray(qp),
                                                    jnp.asarray(sc)),
                               jnp.asarray(page), jnp.asarray(off),
                               jnp.asarray(new))
    pool = tgen.QuantizedKVPage(torch.from_numpy(qp.copy()),
                                torch.from_numpy(sc.copy()))
    out = tgen._kv_quant_write(pool, torch.from_numpy(page).long(),
                               torch.from_numpy(off).long(),
                               torch.from_numpy(new))
    assert out.q.data_ptr() == pool.q.data_ptr()        # in place
    np.testing.assert_array_equal(pool.q.numpy(), np.asarray(ref.q))
    np.testing.assert_allclose(pool.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)


def test_kv_quant_write_restarts_the_scale_at_offset_zero():
    """The reference's case (test_paged_kv.py:460): a stale page with
    scale 1000 and codes 100 takes a 0.25 token at offset 0."""
    nkv, ps, hd = 2, 4, 8
    pool = tgen.QuantizedKVPage(torch.full((3, nkv, ps, hd), 100,
                                           dtype=torch.int8),
                                torch.full((3, nkv), 1000.0))
    page = torch.tensor([2])
    tgen._kv_quant_write(pool, page, torch.tensor([0]),
                         torch.full((1, nkv, hd), 0.25))
    torch.testing.assert_close(pool.scale[2], torch.full((nkv,), 0.25))
    assert (pool.q[2, :, 0] == 127).all()
    tgen._kv_quant_write(pool, page, torch.tensor([1]),
                         torch.full((1, nkv, hd), 0.5))
    torch.testing.assert_close(pool.scale[2], torch.full((nkv,), 0.5))
    assert (pool.q[2, :, 0] == 64).all()


def test_int8_cow_copy_clones_codes_and_scales(qmodel):
    eng = PagedEngine(qmodel, max_slots=1, max_len=32, page_size=8,
                      kv_dtype="int8", device=CPU)
    g = torch.Generator().manual_seed(5)
    for half in (eng._pk, eng._pv):
        half.q.copy_(torch.randint(-127, 128, half.q.shape, generator=g,
                                   dtype=torch.int8))
        half.scale.copy_(torch.rand(half.scale.shape, generator=g) + 0.1)
    before = [t.clone() for half in (eng._pk, eng._pv) for t in half]
    eng._copy_page(3, 1)
    after = [t for half in (eng._pk, eng._pv) for t in half]
    for b, a in zip(before, after):
        assert torch.equal(a[:, 1], b[:, 3])
        assert torch.equal(a[:, 2], b[:, 2])
    assert eng.metrics.gauge("kv_pool_bytes") == 2 * (
        eng._pk.q.numel() + 4 * eng._pk.scale.numel())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace():
    # partial-overlap prefixes cut mid-page for 8-token pages: radix hits,
    # COW splits, page-pressure deferral with 12 pages for 3 slots
    return make_partial_overlap_trace(seed=0, n_requests=10, base_len=22,
                                      divergence_points=(12, 19),
                                      new_tokens_choices=(6, 9))


ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, num_pages=12,
                 min_bucket=8)


def _check_counters(jeng, teng):
    jm, tm = jeng.metrics.summary(), teng.metrics.summary()
    for k in SHARED_COUNTERS:
        assert tm["counters"].get(k, 0) == jm["counters"].get(k, 0), k
    assert tm["gauges"]["active_slots"]["max"] == \
        jm["gauges"]["active_slots"]["max"]
    assert teng._alloc.pages_in_use == 0
    return tm["counters"]


def test_int8_weight_engine_matches_reference(jqparams, qmodel, trace):
    """`PagedEngine` over the reference's quantize_params tree: the same
    greedy tokens as the JAX engine and as JAX `generate` over the same
    tree, the same counters, with radix hits and a COW split."""
    jeng = JPagedEngine(jqparams, ARGS, **ENGINE_KW)
    teng = PagedEngine(qmodel, device=CPU, **ENGINE_KW)
    jreqs = jeng.replay(trace)
    treqs = teng.replay(trace)
    for jr, tr in zip(jreqs, treqs):
        assert tr.finished and tr.token_ids == jr.token_ids, tr.request_id
    for t, tr in list(zip(trace, treqs))[:4]:
        ref = np.asarray(jgen.generate(jqparams, ARGS, t["prompt"][None],
                                       max_new_tokens=len(tr.token_ids)))
        np.testing.assert_array_equal(tr.token_ids, ref[0, len(t["prompt"]):])
    c = _check_counters(jeng, teng)
    assert c["prefix_tokens_hit"] > 0 and c["cow_copies"] > 0


def test_generate_over_int8_weights_matches_reference(jqparams, qmodel):
    ids = np.random.default_rng(3).integers(1, ARGS.vocab_size, (2, 11)) \
        .astype(np.int32)
    ref = np.asarray(jgen.generate(jqparams, ARGS, ids, max_new_tokens=6))
    out = tgen.generate(qmodel, ids, max_new_tokens=6, device=CPU)
    np.testing.assert_array_equal(out.numpy(), ref)
    jl, _, _ = jgen.prefill(jqparams, ARGS, ids, max_len=24)
    tl, _, _ = tgen.prefill(qmodel, ids, 24, device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_int8_kv_engine_matches_reference(jparams, jqparams, qmodel, trace,
                                          weights):
    """kv_dtype="int8" against the JAX int8-pool engine, over float and
    int8 weights: the same tokens and counters; int8 pool bytes are
    codes + scales, about half of the f32 pool's quarter."""
    jp = jparams if weights == "float" else jqparams
    model = (params_from_numpy(_np_tree(jparams), tlf.LlamaArgs(*ARGS),
                               device=CPU)
             if weights == "float" else qmodel)
    jeng = JPagedEngine(jp, ARGS, kv_dtype="int8", **ENGINE_KW)
    teng = PagedEngine(model, device=CPU, kv_dtype="int8", **ENGINE_KW)
    jreqs = jeng.replay(trace)
    treqs = teng.replay(trace)
    for jr, tr in zip(jreqs, treqs):
        assert tr.finished and tr.token_ids == jr.token_ids, tr.request_id
    _check_counters(jeng, teng)
    assert teng.metrics.gauge("kv_pool_bytes") == \
        jeng.metrics.gauge("kv_pool_bytes")


def test_int8_kv_capacity_leg_matches_reference(jparams):
    """The reference's CPU leg of `_bench_int8_kv_pool` (bench.py:892):
    the model-dtype pool gets 10 pages, the int8 pool the same KV bytes
    in pages; both packages replay the same 24-request trace. The port's
    sustained-slot ratio equals the reference's and clears 1.8; the int8
    pool's tokens agree with the port's model-dtype pool >= 0.8 per
    request."""
    args = jlf.LlamaArgs(vocab_size=512, hidden_size=128,
                         intermediate_size=352, num_layers=2, num_heads=4,
                         num_kv_heads=2, rope_theta=1e4, rms_eps=1e-6,
                         use_flash=False)
    params = jlf.init_params(args, jax.random.key(0))
    model = params_from_numpy(_np_tree(params), tlf.LlamaArgs(*args),
                              device=CPU)
    ps, max_len, slots, base_pages, min_bucket = 8, 64, 12, 10, 8
    trace = make_trace(seed=0, n_requests=24, mean_interarrival_steps=0.25,
                       prompt_len_choices=(9, 12, 17, 21),
                       new_tokens_choices=(8,), vocab_size=args.vocab_size)
    hd = args.hidden_size // args.num_heads
    int8_page_bytes = 2 * args.num_layers * args.num_kv_heads * (ps * hd + 4)

    def run(make, num_pages, kv_dtype):
        eng = make(num_pages, kv_dtype)
        reqs = eng.replay(trace)
        m = eng.metrics.summary()
        return reqs, m["gauges"]["kv_pool_bytes"]["value"], \
            m["gauges"]["active_slots"]["max"]

    def legs(make):
        base = run(make, base_pages, None)
        int8 = run(make, int(base[1]) // int8_page_bytes, "int8")
        assert int8[1] <= base[1]
        return base, int8, int8[2] / max(base[2], 1)

    kw = dict(max_slots=slots, max_len=max_len, page_size=ps,
              min_bucket=min_bucket)
    _, _, j_ratio = legs(lambda n, d: JPagedEngine(
        params, args, num_pages=n, kv_dtype=d, **kw))
    base, int8, ratio = legs(lambda n, d: PagedEngine(
        model, num_pages=n, kv_dtype=d, device=CPU, **kw))
    assert ratio == j_ratio and ratio >= 1.8
    agreement = [np.mean(np.asarray(a.token_ids) == np.asarray(b.token_ids))
                 for a, b in zip(int8[0], base[0])]
    assert min(agreement) >= 0.8, agreement


def test_make_trace_matches_reference():
    kw = dict(seed=3, n_requests=9, mean_interarrival_steps=0.5,
              prompt_len_choices=(4, 9), new_tokens_choices=(2, 5),
              vocab_size=50, pad_id=7, eos_token_id=2, shared_prefix_len=6,
              shared_prefix_ratio=0.5)
    ours, ref = make_trace(**kw), j_make_trace(**kw)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
