"""GPT-2, BERT and the SLO router in the PyTorch port against the JAX
package, on the CPU, in f32 (the tiny configs of tests/test_disagg_router.py).

  - GPT: `_gpt_forward_cached` logits (a padded prefill, then per-row
    decode) within rel 1e-5 of the JAX function on the same weights;
    `gpt_generate` and `GptEngine` give JAX's tokens; a `max_len` past the
    position table raises;
  - BERT: `BertBackend` embeddings of three prompts in one padded step
    against the JAX `BertModel`'s pooled output (the JAX `BertBackend`'s
    step) on bridged `bert_tiny` weights, atol 1e-5, and against each
    prompt alone; the encoder's hidden states under a padding mask and
    token types; an empty prompt raises;
  - Router: SLO admission order; a preempted batch request resumes to its
    uninterrupted tokens; on bench.py's mixed three-model trace (three
    tenants, both SLO classes) every Llama/GPT request's tokens and the
    per-model and per-tenant counters equal the JAX `Router`'s; an unknown
    model or SLO raises.
"""

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.models.bert import bert_tiny
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving.router import BertBackend as JBertBackend
from paddle_tpu.serving.router import GptEngine as JGptEngine
from paddle_tpu.serving.router import Router as JRouter
from paddle_tpu_torch.models import (BertConfig, GPTGenArgs,
                                     bert_params_from_numpy, gpt_generate,
                                     gpt_params_from_numpy, params_from_numpy)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.serving import (BertBackend, EmbeddingRequest,
                                      GptEngine, PagedEngine, Request, Router)

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

CPU = "cpu"
ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
ENGINE_KW = dict(max_slots=4, max_len=64, page_size=8, min_bucket=8)
GCFG = dict(vocab_size=96, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
BCFG = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128)
GPT_KW = dict(max_slots=2, max_len=64, min_bucket=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def llama():
    jparams = jlf.init_params(ARGS, jax.random.key(0))
    return jparams, params_from_numpy(_np_tree(jparams), tlf.LlamaArgs(*ARGS),
                                      device=CPU)


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(0)
    jcfg = JGPTConfig(**GCFG)
    jparams = jgen.gpt_params_from_layer(GPTForCausalLM(jcfg))
    jargs = jgen.GPTGenArgs.from_config(jcfg)
    model = gpt_params_from_numpy(_np_tree(jparams),
                                  GPTGenArgs.from_config(jcfg), device=CPU)
    return jparams, jargs, model


@pytest.fixture(scope="module")
def bert():
    paddle.seed(0)
    jmodel = bert_tiny()
    state = {k: np.asarray(v.numpy())
             for k, v in jmodel.bert.state_dict().items()}
    return jmodel, bert_params_from_numpy(state, BertConfig(**BCFG),
                                          device=CPU)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# -- GPT ---------------------------------------------------------------------
def test_gpt_forward_cached_matches_reference(gpt):
    """A padded two-row prefill (logits at each row's last real token),
    then two per-row decode steps; logits and caches within rel 1e-5."""
    jparams, jargs, model = gpt
    rng = np.random.default_rng(1)
    ids = rng.integers(1, GCFG["vocab_size"], (2, 16)).astype(np.int32)
    last = np.array([9, 15], np.int32)
    L, nh = GCFG["num_hidden_layers"], GCFG["num_attention_heads"]
    shape = (L, 2, nh, 32, GCFG["hidden_size"] // nh)
    jck = jax.numpy.zeros(shape)
    jcv = jax.numpy.zeros(shape)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    jl, jck, jcv = jgen._gpt_forward_cached(jparams, ids, jck, jcv, 0, jargs,
                                            last_idx=last)
    tl, _, _ = tgpt._gpt_forward_cached(model, torch.from_numpy(ids), ck, cv,
                                        0, last_idx=torch.from_numpy(last))
    assert _rel(tl, jl) <= 1e-5
    pos = last + 1
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(2):
        jl, jck, jcv = jgen._gpt_forward_cached(
            jparams, tok[:, None], jck, jcv, jax.numpy.asarray(pos), jargs)
        tl, _, _ = tgpt._gpt_forward_cached(
            model, torch.from_numpy(tok)[:, None], ck, cv,
            torch.from_numpy(pos))
        assert _rel(tl, jl) <= 1e-5
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    assert _rel(ck, jck) <= 1e-5 and _rel(cv, jcv) <= 1e-5


def test_gpt_generate_and_engine_match_reference(gpt):
    jparams, jargs, model = gpt
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, GCFG["vocab_size"], n).astype(np.int32)
               for n in (7, 12, 5)]
    eng = GptEngine(model, device=CPU, **GPT_KW)
    jeng = JGptEngine(jparams, jargs, **GPT_KW)
    reqs = [eng.submit(Request(p, 8)) for p in prompts]
    jreqs = [jeng.submit(JRequest(p, 8)) for p in prompts]
    eng.run_until_idle()
    jeng.run_until_idle()
    for p, r, jr in zip(prompts, reqs, jreqs):
        ref = np.asarray(jgen.gpt_generate(jparams, jargs, p[None],
                                           max_new_tokens=8))[0]
        got = gpt_generate(model, p[None], max_new_tokens=8, device=CPU)
        assert got[0].tolist() == ref.tolist()
        assert list(r.token_ids) == list(ref[len(p):]) == \
            list(jr.token_ids)


def test_gpt_bounds_raise(gpt):
    _, _, model = gpt
    with pytest.raises(ValueError, match="position"):
        GptEngine(model, max_slots=2, max_len=128, min_bucket=8, device=CPU)
    with pytest.raises(ValueError, match="position"):
        gpt_generate(model, np.ones((1, 60), np.int32), max_new_tokens=8,
                     device=CPU)


# -- BERT --------------------------------------------------------------------
def test_bert_backend_matches_reference(bert):
    jmodel, model = bert
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, BCFG["vocab_size"], n).astype(np.int32)
               for n in (5, 9, 7)]
    be = BertBackend(model, max_batch=4, device=CPU)
    jbe = JBertBackend(jmodel, max_batch=4)
    reqs = [be.submit(p) for p in prompts]
    jreqs = [jbe.submit(p) for p in prompts]
    be.run_until_idle()
    jbe.run_until_idle()
    assert be.metrics.counter("embeds") == 1      # one padded batch
    for p, r, jr in zip(prompts, reqs, jreqs):
        assert r.finished and r.embedding.dtype == np.float32
        np.testing.assert_allclose(r.embedding, jr.embedding, atol=1e-5)
        # the padding is masked out: the prompt alone gives the same vector
        _, alone = model(torch.from_numpy(p[None]),
                         torch.ones((1, p.size), dtype=torch.int64))
        np.testing.assert_allclose(r.embedding, alone[0].numpy(), atol=1e-5)


def test_bert_forward_hidden_states_match_reference(bert):
    """The whole encoder output under a padding mask, and the
    token-type embedding path."""
    jmodel, model = bert
    rng = np.random.default_rng(7)
    ids = rng.integers(1, BCFG["vocab_size"], (2, 6)).astype(np.int64)
    mask = np.array([[1] * 6, [1] * 4 + [0] * 2], np.int64)
    types = np.array([[0, 0, 0, 1, 1, 1]] * 2, np.int64)
    jh, jp = jmodel.bert(paddle.to_tensor(ids), paddle.to_tensor(types),
                         paddle.to_tensor(mask))
    th, tp = model(torch.from_numpy(ids), torch.from_numpy(mask),
                   torch.from_numpy(types))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh.numpy()), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp.numpy()), atol=1e-5)


def test_empty_prompt_rejected():
    with pytest.raises(ValueError, match="empty"):
        EmbeddingRequest([])


# -- the router --------------------------------------------------------------
def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ARGS.vocab_size, n).astype(np.int32)
            for n in lengths]


def test_slo_admission_ordering(llama):
    """An interactive request submitted after two batch ones reaches the
    engine first and finishes no later than either."""
    _, model = llama
    eng = PagedEngine(model, device=CPU, **ENGINE_KW)
    router = Router({"llama": eng})
    prompts = _prompts([5, 5, 5], seed=8)
    b1 = router.submit("llama", prompts[0], slo="batch", max_new_tokens=4)
    b2 = router.submit("llama", prompts[1], slo="batch", max_new_tokens=4)
    i1 = router.submit("llama", prompts[2], max_new_tokens=4)
    router.step()
    active = eng.slots.active_slots
    assert active and eng.slots.owner(active[0]) is i1
    router.run_until_idle()
    assert all(r.finished for r in (b1, b2, i1))
    assert i1.finish_time <= min(b1.finish_time, b2.finish_time)


def test_preempt_resume_gives_uninterrupted_tokens(llama):
    jparams, model = llama
    prompt = _prompts([11])[0]
    jeng = JPagedEngine(jparams, ARGS, **ENGINE_KW)
    ref = jeng.submit(JRequest(prompt, 24))
    jeng.run_until_idle()

    eng = PagedEngine(model, device=CPU,
                      **dict(ENGINE_KW, max_slots=1, num_pages=9))
    router = Router({"llama": eng})
    batch = router.submit("llama", prompt, slo="batch", tenant="nightly",
                          max_new_tokens=24)
    for _ in range(6):
        router.step()
    assert not batch.finished
    inter = router.submit("llama", _prompts([11, 5], seed=9)[1],
                          tenant="acme", max_new_tokens=6)
    router.run_until_idle()
    assert inter.finished and batch.finished
    assert list(batch.token_ids) == list(ref.token_ids)
    reg = router.metrics.registry
    labels = {"model": "llama", "tenant": "nightly"}
    assert reg.counter("router_preemptions", labels=labels) == 1
    assert reg.counter("router_resumes", labels=labels) == 1
    assert eng._alloc.pages_in_use == 0 and eng._reserved_total == 0


def _bench_trace(seed=1):
    """bench.py `_bench_router_trace` (:1303-1321) at the tiny sizes."""
    rng = np.random.default_rng(seed)
    tenants = ("acme", "globex", "initech")
    trace = []
    for i in range(6):
        trace.append({"model": "llama", "arrival_step": i,
                      "prompt": rng.integers(1, ARGS.vocab_size, 12 + i)
                      .astype(np.int32), "max_new_tokens": 8,
                      "tenant": tenants[i % 3],
                      "slo": "interactive" if i % 2 == 0 else "batch"})
    for i in range(4):
        trace.append({"model": "gpt", "arrival_step": 2 * i + 1,
                      "prompt": rng.integers(1, GCFG["vocab_size"], 9 + i)
                      .astype(np.int32), "max_new_tokens": 6,
                      "tenant": tenants[i % 3], "slo": "interactive"})
    for i in range(4):
        trace.append({"model": "bert", "arrival_step": 3 * i,
                      "prompt": rng.integers(1, BCFG["vocab_size"], 10 + i)
                      .astype(np.int32), "tenant": tenants[(i + 1) % 3],
                      "slo": "batch"})
    return trace


def test_mixed_three_model_trace_matches_reference(llama, gpt, bert):
    """Two Llama slots, so interactive arrivals preempt batch slots; the
    tokens, the embeddings and every labelled counter equal the JAX
    router's."""
    jparams, model = llama
    gj, gjargs, gmodel = gpt
    bj, bmodel = bert
    kw = dict(max_slots=2, max_len=128, page_size=16, min_bucket=16)
    router = Router({
        "llama": PagedEngine(model, device=CPU, **kw),
        "gpt": GptEngine(gmodel, device=CPU, **GPT_KW),
        "bert": BertBackend(bmodel, max_batch=4, device=CPU)})
    jrouter = JRouter({
        "llama": JPagedEngine(jparams, ARGS, **kw),
        "gpt": JGptEngine(gj, gjargs, **GPT_KW),
        "bert": JBertBackend(bj, max_batch=4)})
    out = router.replay(_bench_trace())
    ref = jrouter.replay(_bench_trace())
    assert all(r.finished for r in out)
    for r, jr in zip(out, ref):
        if isinstance(r, EmbeddingRequest):
            np.testing.assert_allclose(r.embedding, jr.embedding, atol=1e-5)
        else:
            assert list(r.token_ids) == list(jr.token_ids)
    snap = router.metrics.registry.snapshot()
    jsnap = jrouter.metrics.registry.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert sum(snap["counters"]["router_preemptions"].values()) >= 1
    assert snap["gauges"].keys() == jsnap["gauges"].keys()
    assert router.step_count == jrouter.step_count


def test_unknown_model_and_bad_slo(llama):
    _, model = llama
    router = Router({"llama": PagedEngine(model, device=CPU, **ENGINE_KW)})
    with pytest.raises(KeyError, match="unknown model"):
        router.submit("nope", [1, 2])
    with pytest.raises(ValueError, match="slo"):
        router.submit("llama", [1, 2], slo="bronze")
