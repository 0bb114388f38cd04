"""Disaggregated prefill/decode serving in the PyTorch port against the
JAX package, on the CPU, in f32 (the tiny ARGS/ENGINE_KW of
tests/test_disagg_router.py).

  - wire format: `KVHandoff.to_bytes()` equals the JAX package's byte for
    byte (f32, bf16, fp16 and int8-pool pages, the same `sent_at`), and a blob
    from either package decodes in the other;
  - a JAX `PrefillWorker`'s blobs seated in the port's `DecodeWorker`
    continue to the JAX monolithic engine's greedy tokens;
  - the port's `DisaggServer` equals the JAX `DisaggServer` and the JAX
    monolithic `PagedEngine` token for token (greedy, int8 pool, chunked
    prefill); in bf16 it equals the port's monolithic engine over a bf16
    pool; sampled, it equals the port's monolithic engine at the same
    seeds (torch's streams are not threefry's);
  - refcounts and reservations drain to 0, a hand-off waits (metered)
    until the decode pool frees pages, and a draft model is rejected;
  - `StoreTransport` over a `torch.distributed.TCPStore` master and
    client, and a two-process leg (prefill and decode in their own
    processes, under a subprocess timeout) that holds the steady stream's
    tokens per scheduler step within 1.00 ± 10% through a burst.
"""

import datetime
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.models.generation import QuantizedKVPage as JQuantizedKVPage
from paddle_tpu.serving import PagedEngine as JPagedEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import disagg as jdisagg
from paddle_tpu_torch.models import QuantizedKVPage, params_from_numpy
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.serving import (DecodeWorker, DisaggServer, KVHandoff,
                                      LocalTransport, PagedEngine,
                                      PrefillWorker, Request, StoreTransport)
from paddle_tpu_torch.serving.disagg import _extract_pages, _scatter_pages
from paddle_tpu_torch.serving.paged_engine import _leaves

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
ENGINE_KW = dict(max_slots=4, max_len=64, page_size=8, min_bucket=8)


@pytest.fixture(scope="module")
def jparams():
    return jlf.init_params(ARGS, jax.random.key(0))


def _model(jparams, dtype=torch.float32):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             tlf.LlamaArgs(*ARGS), device=CPU, dtype=dtype)


@pytest.fixture(scope="module")
def model(jparams):
    return _model(jparams)


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ARGS.vocab_size, n).astype(np.int32)
            for n in lengths]


def _run(serve, reqs):
    serve(reqs)
    return [list(r.token_ids) for r in reqs]


def _torch_bits(a):
    """A numpy array (bf16 from ml_dtypes included) as a torch tensor of
    the same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _handoffs(kind):
    """The same hand-off as (the port's KVHandoff, the JAX KVHandoff)."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 2, 8, 16)
    if kind == "int8":
        leaves = [rng.integers(-127, 128, shape).astype(np.int8),
                  rng.random(shape[:3]).astype(np.float32)] * 2
        leaves[2] = leaves[2][::-1].copy()
        jk, jv = JQuantizedKVPage(*leaves[:2]), JQuantizedKVPage(*leaves[2:])
        tk = QuantizedKVPage(*map(_torch_bits, leaves[:2]))
        tv = QuantizedKVPage(*map(_torch_bits, leaves[2:]))
    else:
        dt = ml_dtypes.bfloat16 if kind == "bfloat16" else np.dtype(kind)
        jk, jv = (rng.standard_normal(shape).astype(dt) for _ in range(2))
        tk, tv = _torch_bits(jk), _torch_bits(jv)
    meta = dict(request_id=f"r-{kind}", prompt_ids=[5, 1, 9, 3],
                max_new_tokens=6, eos_token_id=2 if kind == "int8" else None,
                temperature=0.7, top_p=0.9, top_k=5, seed=11, first=42,
                sent_at=1234.5)
    return (KVHandoff(pages_k=tk, pages_v=tv, **meta),
            jdisagg.KVHandoff(pages_k=jk, pages_v=jv, **meta))


def _leaf_bits(x):
    """The raw bytes of a leaf (a torch tensor or a numpy array)."""
    if torch.is_tensor(x):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float16", "int8"])
def test_wire_format_is_the_references(kind):
    pkg, jpkg = _handoffs(kind)
    blob = pkg.to_bytes()
    jblob = jpkg.to_bytes()
    assert bytes(blob) == jblob
    assert pkg.nbytes() == jpkg.nbytes() and pkg.num_pages == 3
    for got, ref in ((KVHandoff.from_bytes(jblob), jpkg),
                     (jdisagg.KVHandoff.from_bytes(blob), jpkg)):
        assert (got.request_id, got.max_new_tokens, got.eos_token_id,
                got.temperature, got.top_p, got.top_k, got.seed, got.first,
                got.sent_at) == \
            (ref.request_id, ref.max_new_tokens, ref.eos_token_id,
             ref.temperature, ref.top_p, ref.top_k, ref.seed, ref.first,
             ref.sent_at)
        np.testing.assert_array_equal(got.prompt_ids, ref.prompt_ids)
        gl, rl = got._leaves(), ref._leaves()
        assert len(gl) == len(rl) == (4 if kind == "int8" else 2)
        for g, r in zip(gl, rl):
            np.testing.assert_array_equal(_leaf_bits(g), _leaf_bits(r))
    # the port's decode keeps the dtype and gives views of the blob
    back = KVHandoff.from_bytes(blob)
    assert back._leaves()[0].dtype == pkg._leaves()[0].dtype
    assert bytes(back.to_bytes()) == jblob


def test_extract_scatter_roundtrip():
    """extract(pages) then scatter into another pool at fresh ids lands
    the exact bytes there and touches nothing else, for both pool kinds."""
    g = torch.Generator().manual_seed(2)
    pk = torch.randn(2, 6, 2, 4, 8, generator=g)
    qpool = QuantizedKVPage(torch.randint(-127, 128, (2, 6, 2, 4, 8),
                                          dtype=torch.int8, generator=g),
                            torch.rand(2, 6, 2, generator=g))
    src, dst, rest = (torch.tensor(x) for x in ([4, 1, 3], [0, 5, 2],
                                                [1, 3, 4]))
    for pool in (pk, qpool):
        data = _extract_pages(pool, src)
        other = _extract_pages(pool, torch.arange(6).flip(0))  # a copy
        before = _extract_pages(other, rest)
        _scatter_pages(other, dst, data)
        for t, o, b in zip(_leaves(pool), _leaves(other), _leaves(before)):
            assert torch.equal(o[:, dst], t[:, src])
            assert torch.equal(o[:, rest], b)


def test_reference_blobs_seat_in_the_port(jparams, model):
    """A JAX PrefillWorker ships; the port's DecodeWorker decodes on from
    the reference's pages to the JAX monolithic engine's tokens."""
    prompts = _prompts([11, 5, 17])
    jeng = JPagedEngine(jparams, ARGS, **ENGINE_KW)
    ref = _run(jeng.serve, [JRequest(p, 10, request_id=f"r{i}")
                            for i, p in enumerate(prompts)])
    transport = LocalTransport()
    pre = jdisagg.PrefillWorker(jparams, ARGS, transport=transport,
                                **ENGINE_KW)
    done = {}
    dec = DecodeWorker(model, transport=transport, device=CPU,
                       completion_cb=lambda r: done.setdefault(
                           r.request_id, list(r.token_ids)), **ENGINE_KW)
    for i, p in enumerate(prompts):
        pre.submit(JRequest(p, 10, request_id=f"r{i}"))
    for _ in range(200):
        pre.step()
        dec.step()
        if len(done) == 3:
            break
    assert done == {f"r{i}": t for i, t in enumerate(ref)}
    assert dec._alloc.pages_in_use == 0 and dec._reserved_total == 0


@pytest.mark.parametrize("engine_kw", [
    {}, {"kv_dtype": "int8"}, {"prefill_chunk": 16}],
    ids=["greedy", "int8_pool", "chunked"])
def test_disagg_matches_reference_and_monolithic(jparams, model, engine_kw):
    lengths = [37, 41] if engine_kw.get("prefill_chunk") else [11, 5, 17]
    prompts = _prompts(lengths)
    kw = dict(ENGINE_KW, **engine_kw)
    srv = DisaggServer(model, device=CPU, **kw)
    got = _run(srv.serve, [Request(p, 8, request_id=f"r{i}")
                           for i, p in enumerate(prompts)])
    jsrv = jdisagg.DisaggServer(jparams, ARGS, **kw)
    jref = _run(jsrv.serve, [JRequest(p, 8, request_id=f"r{i}")
                             for i, p in enumerate(prompts)])
    mono = _run(JPagedEngine(jparams, ARGS, **kw).serve,
                [JRequest(p, 8, request_id=f"r{i}")
                 for i, p in enumerate(prompts)])
    assert got == jref == mono
    m = srv.prefill.metrics
    assert m.counter("handoffs_sent") == len(prompts) == \
        srv.decode.metrics.counter("handoffs_admitted")
    assert m.counter("handoff_bytes") == \
        jsrv.prefill.metrics.counter("handoff_bytes")
    assert srv.decode.metrics.registry.quantile(
        "handoff_latency_s", 0.99) >= 0.0
    assert srv.decode.metrics.observation("handoff_latency_s")["count"] == \
        len(prompts)
    for worker in (srv.prefill, srv.decode):
        assert worker._alloc.pages_in_use == 0
        assert worker._reserved_total == 0
        assert worker.slots.free_count == worker.max_slots


def test_bf16_disagg_matches_monolithic(jparams):
    model = _model(jparams, torch.bfloat16)
    prompts = _prompts([9, 13])
    srv = DisaggServer(model, device=CPU, **ENGINE_KW)
    got = _run(srv.serve, [Request(p, 10) for p in prompts])
    mono = _run(PagedEngine(model, device=CPU, **ENGINE_KW).serve,
                [Request(p, 10) for p in prompts])
    assert got == mono
    assert srv.decode._pk.dtype == torch.bfloat16


def test_sampled_disagg_matches_monolithic_and_reproduces(model):
    prompts = _prompts([11, 5, 17])

    def reqs():
        return [Request(p, 10, request_id=f"r{i}", temperature=0.9,
                        top_p=0.9, seed=7 + i)
                for i, p in enumerate(prompts)]

    got = _run(DisaggServer(model, device=CPU, **ENGINE_KW).serve, reqs())
    again = _run(DisaggServer(model, device=CPU, **ENGINE_KW).serve, reqs())
    mono = _run(PagedEngine(model, device=CPU, **ENGINE_KW).serve, reqs())
    assert got == again == mono
    greedy = _run(PagedEngine(model, device=CPU, **ENGINE_KW).serve,
                  [Request(p, 10) for p in prompts])
    assert got != greedy


def test_handoff_defers_until_pages_free(jparams, model):
    """A decode pool that holds one sequence at a time parks the others in
    its inbox (metered) and still finishes each with the reference's
    tokens."""
    prompts = _prompts([17, 17, 17], seed=5)
    ref = _run(JPagedEngine(jparams, ARGS, **ENGINE_KW).serve,
               [JRequest(p, 12) for p in prompts])
    transport = LocalTransport()
    pre = PrefillWorker(model, transport=transport, device=CPU, **ENGINE_KW)
    dec = DecodeWorker(model, transport=transport, device=CPU,
                       **dict(ENGINE_KW, max_slots=1, num_pages=9))
    done = {}
    dec.completion_cb = lambda twin: done.setdefault(twin.request_id,
                                                     list(twin.token_ids))
    for i, p in enumerate(prompts):
        pre.submit(Request(p, 12, request_id=f"r{i}"))
    for _ in range(400):
        pre.step()
        dec.step()
        if not (pre.queue or pre.slots.active_slots or transport.pending
                or dec.busy):
            break
    assert done == {f"r{i}": t for i, t in enumerate(ref)}
    assert dec.metrics.counter("handoff_defer_steps") > 0
    assert dec._alloc.pages_in_use == 0


def test_workers_reject_a_draft(model):
    for cls in (PrefillWorker, DecodeWorker):
        with pytest.raises(ValueError, match="speculative"):
            cls(model, transport=LocalTransport(), draft_params=model,
                device=CPU, **ENGINE_KW)


def test_store_transport_over_tcpstore():
    timeout = datetime.timedelta(seconds=30)
    master = torch.distributed.TCPStore("localhost", 0, 2, True,
                                        timeout=timeout,
                                        wait_for_workers=False)
    client = torch.distributed.TCPStore("localhost", master.port, 2, False,
                                        timeout=timeout)
    send, recv = StoreTransport(master, "kv"), StoreTransport(client, "kv")
    assert recv.recv() is None and recv.pending == 0
    pkg, jpkg = _handoffs("bfloat16")
    send.send(pkg.to_bytes())
    send.send(b"second")
    assert recv.pending == 2
    assert recv.recv() == jpkg.to_bytes()
    assert client.get("kv/m1") == b"second"
    assert int(client.add("kv/n", 0)) == 2
    assert recv.recv() == b"second" and recv.recv() is None


TWO_PROCESS = textwrap.dedent("""
    import datetime, os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.models import LlamaArgs, Llama, generate, init_params
    from paddle_tpu_torch.serving import (DecodeWorker, PagedEngine,
                                          PrefillWorker, Request,
                                          StoreTransport)

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    wait = datetime.timedelta(seconds=60)
    store = torch.distributed.TCPStore("localhost", port, 2, rank == 0,
                                       timeout=wait)
    args = LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6)
    # one seed on both ranks: the same weights, none shipped
    model = Llama(args, init_params(args, device="cpu"))
    rng = np.random.default_rng(3)
    steady_prompt = rng.integers(1, 128, 8).astype(np.int32)
    burst = [rng.integers(1, 128, 40).astype(np.int32) for _ in range(4)]
    kw = dict(max_slots=4, max_len=64, page_size=8, min_bucket=8,
              num_pages=40, device="cpu")
    transport = StoreTransport(store, channel="kv")

    if rank == 0:
        # PREFILL: chunked, so the burst spans many scheduler steps
        eng = PrefillWorker(model, transport=transport, prefill_chunk=16, **kw)

        def drain():
            while eng.queue or eng.slots.active_slots or eng._chunk_streams:
                eng.step()

        eng.submit(Request(steady_prompt, 48, request_id="steady"))
        drain()
        store.set("phase/steady_sent", "1")
        store.wait(["phase/baseline_done"])
        for i, p in enumerate(burst):
            eng.submit(Request(p, 8, request_id=f"burst{i}"))
        drain()
        assert eng.metrics.counter("handoffs_sent") == 5
        assert eng._alloc.pages_in_use == 0
        store.wait(["phase/done"])
        print("PREFILL_OK", flush=True)
        sys.exit(0)

    # DECODE
    done = {}
    eng = DecodeWorker(model, transport=transport,
                       completion_cb=lambda r: done.setdefault(
                           r.request_id, list(r.token_ids)), **kw)
    store.wait(["phase/steady_sent"])
    while not eng.slots.active_slots:
        eng.step()
    for _ in range(6):
        eng.step()

    def rate(k):
        req = next(eng.slots.owner(s) for s in eng.slots.active_slots
                   if eng.slots.owner(s).request_id == "steady")
        n0 = len(req.token_ids)
        for _ in range(k):
            eng.step()
        return (len(req.token_ids) - n0) / k

    base = rate(14)
    store.set("phase/baseline_done", "1")
    burst_rate = rate(14)          # the burst runs on the other process
    deadline = time.time() + 60
    while len(done) < 5 and time.time() < deadline:
        eng.step()
        if not eng.busy:
            time.sleep(0.002)
    assert set(done) == {"steady"} | {f"burst{i}" for i in range(4)}, done
    for rid, p, m in [("steady", steady_prompt, 48)] + [
            (f"burst{i}", p, 8) for i, p in enumerate(burst)]:
        ref = generate(model, p[None], max_new_tokens=m, device="cpu")
        assert done[rid] == ref[0, len(p):].tolist(), rid
    assert eng.metrics.counter("handoffs_admitted") == 5
    assert eng._alloc.pages_in_use == 0 and eng._reserved_total == 0
    # the same schedule on one engine: burst chunks take the stream's steps
    mono = PagedEngine(model, prefill_chunk=16, **kw)
    s = mono.submit(Request(steady_prompt, 48))
    while not mono.slots.active_slots:
        mono.step()
    for _ in range(6):
        mono.step()
    for p in burst:
        mono.submit(Request(p, 8))
    n0 = len(s.token_ids)
    for _ in range(14):
        mono.step()
    mono_rate = (len(s.token_ids) - n0) / 14
    store.set("phase/done", "1")
    print(f"DECODE_OK base={base} burst={burst_rate} mono={mono_rate}",
          flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_handoff_keeps_the_steady_rate(tmp_path):
    script = tmp_path / "disagg_rank.py"
    script.write_text(TWO_PROCESS)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert "PREFILL_OK" in outs[0]
    line = next(ln for ln in outs[1].splitlines()
                if ln.startswith("DECODE_OK"))
    stats = dict(kv.split("=") for kv in line.split()[1:])
    base, burst, mono = (float(stats[k]) for k in ("base", "burst", "mono"))
    assert base == 1.0
    assert 0.9 <= burst / base <= 1.1
    # the counterfactual has teeth: one engine loses steps to the burst
    assert mono < 0.9 * base
