"""The port's `amp.debugging` and `profiler` against the JAX package's on the
CPU:

  - the nan/inf checker on the dispatch waist: the same message as the JAX
    checker for the same op, abort at level 0, log only at
    `FLAGS_check_nan_inf_level` 1 and in `CHECK_NAN_INF` mode, nothing for
    an op of `skipped_op_list`, the flag alone turning it on, the hook None
    when off; `check_numerics`, `assert_finite`;
  - operator stats: the same (op, dtype) -> [calls, nan, inf] table as the
    JAX package's for the same ops, checker and stats composed;
  - `tensor_stats` and `compare_accuracy` over the same nest: equal keys,
    statistics and mismatch records;
  - the profiler (`tests/test_subsystems.py:78,641,860`,
    `tests/test_observability.py:595-652`): the summary tables over the
    same training loop (the same tables, operator rows and call counts as
    the JAX package's), `step_info`, sort keys and views, the op tracer
    hook set only while recording, the chrome export through
    `export_chrome_tracing` and back through `load_profiler_result`, the
    JAX package's export read by the port's loader and the port's by the
    JAX package's, the card's kernel lanes read from a torch.profiler
    trace, `PADDLE_PROFILER_LOG_DIR`.
"""

import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu import profiler as jprof
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.amp import debugging as pdbg
from paddle_tpu_torch.core import tensor as core_tensor
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

X = np.array([[1.0, 0.0, -1.0], [2.0, 3.0, 0.5]], "float32")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev
    for M in (J, P):
        M.set_flags({"FLAGS_check_nan_inf": False,
                     "FLAGS_check_nan_inf_level": 0})
    pdbg._checker_config = pdbg.TensorCheckerConfig(enable=False)
    jdbg._checker_config = jdbg.TensorCheckerConfig(enable=False)
    pdbg._install_hook()
    jdbg._install_hook()


def _both(fn):
    """fn(package, debugging module) on the JAX package, then the port."""
    return fn(J, jdbg), fn(P, pdbg)


def test_the_checker_raises_the_jax_packages_message():
    def run(M, D):
        D.enable_tensor_checker()
        with pytest.raises(FloatingPointError) as e:
            M.log(M.to_tensor(X))
        D.disable_tensor_checker()
        return str(e.value)

    want, got = _both(run)
    assert got == want
    assert "op 'log' produced 2 non-finite value(s)" in got
    assert core_tensor._sanitizer is None   # off: one None check an op


def test_levels_modes_and_the_skip_list_log_or_stay_quiet(capsys):
    def run(M, D):
        out = []
        M.set_flags({"FLAGS_check_nan_inf": True,
                     "FLAGS_check_nan_inf_level": 1})
        M.log(M.to_tensor(X))                       # logs, no raise
        out.append(capsys.readouterr().out)
        M.set_flags({"FLAGS_check_nan_inf_level": 0})
        D.enable_tensor_checker(D.TensorCheckerConfig(
            debug_mode=D.DebugMode.CHECK_NAN_INF))
        M.log(M.to_tensor(X))
        out.append(capsys.readouterr().out)
        D.enable_tensor_checker(D.TensorCheckerConfig(
            skipped_op_list=["log"]))
        M.log(M.to_tensor(X))
        out.append(capsys.readouterr().out)
        with pytest.raises(FloatingPointError, match="'divide'"):
            M.to_tensor(X) / M.to_tensor(np.zeros_like(X))
        D.disable_tensor_checker()
        return out

    want, got = _both(run)
    assert got == want
    assert "[check_nan_inf] op 'log'" in got[0] and got[0] == got[1]
    assert got[2] == ""


def test_check_numerics_and_assert_finite():
    def run(M, D):
        n, i = D.check_numerics(M.to_tensor(np.array([np.nan, np.inf, 1.0],
                                                     "float32")),
                                debug_mode=D.DebugMode.CHECK_NAN_INF)
        with pytest.raises(FloatingPointError) as e1:
            D.check_numerics(M.to_tensor(np.array([np.inf], "float32")),
                             "matmul", "out")
        with pytest.raises(FloatingPointError) as e2:
            D.assert_finite({"loss": M.to_tensor(np.float32(1.0)),
                             "g": [M.to_tensor(np.array([np.nan], "float32"))]},
                            where="step 3")
        D.assert_finite({"ok": M.to_tensor(X), "ids": np.arange(3)})
        return int(n.numpy()), int(i.numpy()), str(e1.value), str(e2.value)

    want, got = _both(run)
    assert got == want == (1, 1, "[check_numerics] 'matmul:out': 0 nan, 1 inf",
                           "[check_nan_inf] step 3: leaf 0 has 1 non-finite "
                           "value(s)")


def test_operator_stats_match_and_compose_with_the_checker(capsys):
    def run(M, D):
        x = M.to_tensor(X)
        with D.collect_operator_stats():
            M.log(x)
            M.exp(x)
            M.matmul(x, M.transpose(x, [1, 0]))
        stats = D._op_stats
        D.enable_operator_stats_collection()
        D.enable_tensor_checker()
        with pytest.raises(FloatingPointError):
            M.log(x)
        D.disable_tensor_checker()
        table = D.disable_operator_stats_collection()
        return stats, table, capsys.readouterr().out

    (_, jtable, jout), (pstats, ptable, pout) = _both(run)
    assert pstats is None
    assert ptable == jtable == {("log", "float32"): [1, 1, 1]}
    assert pout == jout


def test_tensor_stats_and_compare_accuracy():
    rng = np.random.default_rng(0)
    a = {"w": rng.normal(size=(3, 4)).astype("float32"),
         "layers": [rng.normal(size=(5,)).astype("float32"),
                    rng.normal(size=(2, 2)).astype("float32")]}
    b = {"w": a["w"] + 1e-3, "layers": [a["layers"][0],
                                        a["layers"][1][:1]]}

    def run(M, D):
        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            if isinstance(t, list):
                return [conv(v) for v in t]
            return M.to_tensor(t)

        stats = D.tensor_stats(conv(a))
        recs = D.compare_accuracy(conv(a), conv(b))
        recs += D.compare_accuracy(conv(a), {"w": conv(a["w"])})
        with pytest.raises(AssertionError, match="accuracy_check"):
            D.compare_accuracy(conv(a), conv(b), raise_on_mismatch=True)
        return stats, recs

    (jstats, jrecs), (pstats, precs) = _both(run)
    assert list(pstats) == list(jstats)
    for k in jstats:
        assert pstats[k][0] == jstats[k][0]
        np.testing.assert_allclose(pstats[k][1:], jstats[k][1:], rtol=1e-6)
    assert [r["tensor"] for r in precs] == [r["tensor"] for r in jrecs]
    for p, j in zip(precs, jrecs):
        assert p.keys() == j.keys()
        for k in p:
            if isinstance(p[k], float):
                assert p[k] == pytest.approx(j[k], rel=1e-5)
            else:
                assert p[k] == j[k]


# -- the profiler --------------------------------------------------------------


def _train_loop(M, prof):
    M.seed(0)
    net = M.nn.Sequential(M.nn.Linear(16, 32), M.nn.ReLU(),
                          M.nn.Linear(32, 4))
    opt = M.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
    loss_fn = M.nn.CrossEntropyLoss()
    x = M.to_tensor(np.random.default_rng(0).normal(size=(8, 16))
                    .astype("float32"))
    y = M.to_tensor(np.zeros((8,), "int64"))
    p = prof.Profiler(timer_only=True)
    p.start()
    assert core_tensor._op_tracer is not None or M is J
    for _ in range(3):
        with prof.RecordEvent("forward"):
            loss = loss_fn(net(x), y)
        with prof.RecordEvent("backward"):
            loss.backward()
        with prof.RecordEvent("optimizer_step"):
            opt.step()
            opt.clear_grad()
        p.step()
    p.stop()
    return p


def _titles(table):
    """The table titles, without the Memory Summary (the JAX package reads
    the host's memory on the CPU, the port only a card's)."""
    return [ln.strip() for ln in table.splitlines()
            if "Summary" in ln and not ln.startswith("Device kernel")
            and "Memory Summary" not in ln]


def _op_rows(table):
    """{operator: calls} of the Operator Summary block."""
    rows, inside = {}, False
    for ln in table.splitlines():
        if ln.strip().startswith("Operator Summary"):
            inside = True
            continue
        if inside and ln.strip().endswith("Summary") or \
                (inside and "Summary (" in ln and "Operator" not in ln):
            break
        parts = ln.split()
        if inside and len(parts) >= 8 and parts[1].isdigit():
            rows[parts[0]] = int(parts[1])
    return rows


def test_summary_tables_match_the_jax_packages(capsys):
    jp, pp = _train_loop(J, jprof), _train_loop(P, pprof)
    assert core_tensor._op_tracer is None
    assert pp.step_info().startswith("avg step time ")
    assert pp.step_info().endswith("over 3 steps")
    with pytest.raises(ValueError, match="unit"):
        pp.step_info("h")
    for kw in ({}, {"sorted_by": pprof.SortedKeys.CPUAvg},
               {"views": [pprof.SummaryView.ModelView,
                          pprof.SummaryView.UDFView]}):
        jkw = {k: (getattr(jprof.SortedKeys, v.name) if k == "sorted_by"
                   else [getattr(jprof.SummaryView, s.name) for s in v])
               for k, v in kw.items()}
        pt, jt = pp.summary(**kw), jp.summary(**jkw)
        assert _titles(pt) == _titles(jt)
    pt, jt = pp.summary(), jp.summary()
    assert "forward" in pt and "optimizer" in pt and "backward" in pt
    assert _op_rows(pt) == _op_rows(jt)
    assert _op_rows(pt) == {"cross_entropy": 3, "linear": 6, "relu": 3}
    assert "Device kernel timelines: no device lanes" in pt
    assert "Device busy (kernels)" in pt
    capsys.readouterr()


def _fabricated(prof):
    p = prof.Profiler(timer_only=True)
    p._records = [("matmul", 10.0, 0.002), ("matmul", 10.1, 0.004),
                  ("relu", 10.2, 0.001)]
    p._device_raw = [
        {"name": "flash_fwd_tma_kernel", "ts": 0.0, "dur": 500.0,
         "lane": "stream 7"},
        {"name": "jit_step", "ts": 0.0, "dur": 800.0, "lane": "XLA Modules"},
    ]
    return p


def _check_loaded(res):
    ops = res.statistic_data.ops
    assert ops["matmul"].calls == 2
    assert ops["matmul"].total == pytest.approx(0.006)
    assert ops["relu"].calls == 1
    dev = res.statistic_data.device
    assert dev["flash_fwd_tma_kernel"].total == pytest.approx(500e-6)
    assert "jit_step" not in dev
    assert res.statistic_data.device_total == pytest.approx(800e-6)


def test_chrome_export_round_trips_across_both_packages(tmp_path, capsys):
    for (src, name), loader in [((pprof, "p"), pprof), ((jprof, "j"), pprof),
                                ((pprof, "p2"), jprof)]:
        path = str(tmp_path / f"{name}.json")
        _fabricated(src).export_chrome_trace(path)
        res = loader.load_profiler_result(path)
        _check_loaded(res)
        assert "matmul" in res.summary()
    # export_chrome_tracing numbers repeated sessions
    handler = pprof.export_chrome_tracing(str(tmp_path / "chrome"), "w0")
    for _ in range(2):
        handler(_fabricated(pprof))
    assert sorted(os.listdir(tmp_path / "chrome")) == ["w0.json",
                                                       "w0_1.json"]
    with pytest.raises(OSError):
        pprof.load_profiler_result(str(tmp_path / "nope.json"))
    capsys.readouterr()


def test_a_live_session_exports_host_ops_and_reads_a_torch_trace(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PADDLE_PROFILER_LOG_DIR", str(tmp_path / "log"))
    out_dir = str(tmp_path / "chrome")
    p = pprof.Profiler(on_trace_ready=pprof.export_chrome_tracing(out_dir,
                                                                  "w0"))
    assert p.log_dir == str(tmp_path / "log")
    p.start()
    (P.ones([4, 4]) + P.ones([4, 4])).numpy()
    p.step()
    p.stop()
    assert any(f.endswith(".pt.trace.json")
               for f in os.listdir(tmp_path / "log"))
    trace = json.load(open(os.path.join(out_dir, "w0.json")))
    assert "add" in {e.get("name") for e in trace["traceEvents"]}
    assert {e.get("cat") for e in trace["traceEvents"]
            if e.get("ph") == "X"} >= {"op"}
    assert p.device_total == 0.0        # a run on the CPU has no card lane
    # the card's lanes: a torch.profiler trace with kernel events
    fake = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "b8_gemv_mma_kernel", "ts": 5.0,
         "dur": 40.0, "tid": 7, "pid": 0},
        {"ph": "X", "cat": "kernel", "name": "b8_gemv_mma_kernel", "ts": 60.0,
         "dur": 20.0, "tid": 7, "pid": 0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1.0,
         "dur": 2.0, "tid": 8, "pid": 0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 9.0, "tid": 1, "pid": 1}]}
    d = tmp_path / "card"
    d.mkdir()
    (d / "run.pt.trace.json").write_text(json.dumps(fake))
    dev, busy, raw = pprof._parse_device_trace(str(d))
    assert dev == {"b8_gemv_mma_kernel": [40e-6, 20e-6],
                   "Memcpy HtoD": [2e-6]}
    assert busy == pytest.approx(62e-6) and len(raw) == 3
    table = pprof.load_profiler_result(str(d)).summary(
        views=pprof.SummaryView.KernelView)
    assert "b8_gemv_mma_kernel" in table and "Kernel Summary" in table
    capsys.readouterr()
