"""The port's `DataParallel` at 2 gloo ranks, each rank taking half the
global batch, against the JAX package's `DataParallel` over
`ProcessMesh(np.arange(2), ["dp"])` on the whole batch (2 of the 8 virtual
CPU devices): a `Linear(16, 4)` with SGD (`test_distributed_core.py:125`)
and the tiny layer Llama (its weights carried across with
`models.weights.layer_from_numpy`) for 3 AdamW steps, the parameters after
each step at rtol 1e-5, atol 1e-6 (AdamW: all but a few elements where the
halves' gradients cancel, see the Llama test); `no_sync` accumulation over
two micro-steps against two accumulated backwards on the JAX side; a
parameter the forward never uses, with `find_unused_parameters` True
(zeros) and False (an error naming it, and no hang); a parameter that only
one rank skips, in an earlier bucket than used ones, against the JAX
`DataParallel` with that rank's rows masked out of it. The ranks run once
for the file (`tests/torch_dist_ranks.py`, case `data_parallel`) while the
JAX side computes."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.distributed as jdist
import torch_dist_ranks as R
from paddle_tpu.models import llama as jllama

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

N = 2
RTOL, ATOL = 1e-5, 1e-6
OFF_BAR = 32   # of the tiny Llama's 533120 parameters (see the test)
G_CANCEL = 1e-3   # of a leaf's RMS gradient: the halves cancel (ditto)
G_SPREAD = 1e-4   # a leaf's gradient departure, ||dg|| / ||g||, steps 1-2


def _mesh():
    return jdist.ProcessMesh(np.arange(N), ["dp"])


def _jax_linear():
    d = R.linear_data()
    layer = paddle_tpu.nn.Linear(16, 4)
    layer.weight.set_value(d["w"])
    layer.bias.set_value(d["b"])
    return layer, d


def _sq(model, x, y):
    return ((model(paddle_tpu.to_tensor(x)) - paddle_tpu.to_tensor(y))
            ** 2).mean()


def _jax_results(state):
    """Every JAX-side result the tests hold the ranks to."""
    got = {}
    # Linear(16, 4), SGD 0.1, on the global batch
    layer, d = _jax_linear()
    dp = jdist.DataParallel(layer, mesh=_mesh())
    opt = paddle_tpu.optimizer.SGD(learning_rate=0.1,
                                   parameters=dp.parameters())
    got["linear"] = []
    for _ in range(R.LINEAR_STEPS):
        _sq(dp, d["x"], d["y"]).backward()
        opt.step()
        opt.clear_grad()
        got["linear"].append((layer.weight.numpy(), layer.bias.numpy()))
    # two accumulated backwards over the ranks' micro-batches A and B
    layer, d = _jax_linear()
    dp = jdist.DataParallel(layer, mesh=_mesh())
    opt = paddle_tpu.optimizer.SGD(learning_rate=0.1,
                                   parameters=dp.parameters())
    for idx in ([0, 1, 4, 5], [2, 3, 6, 7]):
        _sq(dp, d["x"][idx], d["y"][idx]).backward()
    opt.step()
    got["nosync"] = (layer.weight.numpy(), layer.bias.numpy())
    got["local"] = []
    for r in range(N):   # a rank's own micro-batch A, alone
        solo, _ = _jax_linear()
        a = slice(4 * r, 4 * r + 2)
        _sq(solo, d["x"][a], d["y"][a]).backward()
        got["local"].append(solo.weight.grad.numpy())
    # a second Linear `b` the last rank skips: its rows masked out of b
    class Skip(paddle_tpu.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = _jax_linear()[0]
            self.b = paddle_tpu.nn.Linear(16, 4)
            e = R.skip_data()
            self.b.weight.set_value(e["w"])
            self.b.bias.set_value(e["b"])

        def forward(self, z, mask):
            return self.a(z) + mask * self.b(z)

    model = Skip()
    dp = jdist.DataParallel(model, mesh=_mesh())
    opt = paddle_tpu.optimizer.SGD(learning_rate=0.1,
                                   parameters=dp.parameters())
    mask = np.ones((8, 1), np.float32)
    mask[8 * (N - 1) // N:] = 0
    got["skip"] = []
    for _ in range(R.SKIP_STEPS):
        out = dp(paddle_tpu.to_tensor(d["x"]), paddle_tpu.to_tensor(mask))
        ((out - paddle_tpu.to_tensor(d["y"])) ** 2).mean().backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        got["skip"].append((grads, {n: np.asarray(p.numpy())
                                    for n, p in model.named_parameters()}))
    # the tiny layer Llama, AdamW
    paddle_tpu.seed(0)
    model = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_hidden_layers=2))
    model.set_state_dict(state)
    dp = jdist.DataParallel(model, mesh=_mesh())
    opt = paddle_tpu.optimizer.AdamW(R.LLAMA_LR, parameters=dp.parameters(),
                                     weight_decay=0.01)
    ids, labels = (paddle_tpu.to_tensor(a) for a in R.llama_batch())
    got["llama"] = []
    for s in range(R.LLAMA_STEPS):
        loss = dp(ids, labels=labels)
        loss.backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        got["llama"].append((float(loss), grads, {
            n: np.asarray(p.numpy()) for n, p in model.named_parameters()}))
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' output directory, the JAX results), the JAX side
    computed while the ranks run."""
    out = tmp_path_factory.mktemp("data_parallel")
    paddle_tpu.seed(0)
    ref = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_hidden_layers=2))
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    np.savez(out / "llama_state.npz", **state)
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(R.launch, "data_parallel", N, out)
        want = _jax_results(state)
        results = run.result()
    for code, text in results:
        assert code == 0, text[-4000:]
    return out, want


def _json(out, r):
    return json.loads((out / f"data_parallel_r{r}.json").read_text())


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_linear_sgd_steps_equal_the_jax_data_parallel(ranks):
    out, want = ranks
    for s, (w, b) in enumerate(want["linear"]):
        for r in range(N):
            got = np.load(out / f"linear_r{r}_s{s}.npz")
            _close(got["w"], w)
            _close(got["b"], b)
    # two parameters of 256 and 16 bytes: one bucket, reduced each step
    assert _json(out, 0)["linear"] == {
        "buckets": 1, "all_reduces": R.LINEAR_STEPS, "reduced": 2}


def test_no_sync_accumulates_then_reduces_the_sum(ranks):
    """Each rank's micro-batch A under no_sync, B synced, one SGD step:
    the JAX DataParallel's two accumulated backwards over the global A and
    B, then the step. Inside no_sync the gradient stays the rank's own."""
    out, want = ranks
    for r in range(N):
        got = np.load(out / f"nosync_r{r}.npz")
        _close(got["w"], want["nosync"][0])
        _close(got["b"], want["nosync"][1])
        _close(got["local"], want["local"][r])
    assert _json(out, 0)["nosync_all_reduces"] == 1


def test_unused_parameter_reduces_zeros_when_found(ranks):
    out, want = ranks
    for r in range(N):
        res = _json(out, r)["unused_True"]
        assert np.array_equal(res["grad"], np.zeros((4, 3)))
        _close(np.asarray(res["w"], np.float32), want["linear"][0][0])


def test_unused_parameter_raises_naming_it_and_never_hangs(ranks):
    out, _ = ranks
    for r in range(N):
        res = _json(out, r)
        err = res["unused_False"]["error"]
        assert "unused.weight" in err and "unused.bias" in err
        assert "find_unused_parameters" in err
        # both ranks went on to the next collective together
        assert res["after_unused_False"] == [float(N)] * 2


def test_uneven_skip_keeps_the_buckets_in_order(ranks):
    """Only the last rank skips `b`, with find_unused_parameters=True, and
    b's parameters sit in the first buckets: the other rank has b's
    gradients first in backward, the last rank last. The ranks still pair
    bucket with bucket (the reducer launches in bucket order), so every
    gradient is the mean with the last rank's zeros for b: the JAX
    `DataParallel` on the whole batch with the last rank's rows of b
    masked out, gradients and parameters after each SGD step."""
    out, want = ranks
    for s, (grads, params) in enumerate(want["skip"]):
        for r in range(N):
            got = np.load(out / f"skip_r{r}_s{s}.npz")
            for name, g in grads.items():
                _close(got[f"grad.{name}"], g)
            for name, w in params.items():
                _close(got[name], w)
    for r in range(N):
        assert _json(out, r)["skip"] == {
            "buckets": [["b.bias"], ["b.weight"], ["a.bias"], ["a.weight"]],
            "all_reduces": R.SKIP_STEPS * 4}


def test_uneven_skip_without_find_unused_raises_on_its_rank_only(ranks):
    """Without find_unused_parameters only the rank that skipped `b`
    raises, naming b's parameters; it took its part in every bucket first,
    so its peer's step ends and both meet at the next collective."""
    out, _ = ranks
    for r in range(N):
        res = _json(out, r)
        err = res["skip_False"]
        if r == N - 1:
            assert "b.weight" in err and "b.bias" in err
            assert "a.weight" not in err
        else:
            assert err is None
        assert res["after_skip_False"] == [float(N)] * 2


def test_llama_adamw_steps_equal_the_jax_data_parallel(ranks):
    """After each step every parameter leaf within ||d|| / ||ref|| 1e-5
    and elementwise but for at most OFF_BAR elements, each within 2 lr a
    step. The first step's mean gradient (the reducer's output from equal
    weights) is held elementwise, and the first step's off-bar elements are
    where the two halves' gradients cancel: the JAX side's |g| is under
    G_CANCEL times its leaf's RMS gradient (under 2e-7 against 2e-3 to
    5e-3 here). AdamW divides each element by its own root mean square and
    so scales each side's rounding there to up to lr (ROADMAP §C lists
    this bar). From the
    second step on, the gradients are those of parameters that already
    differ there: each leaf's gradient is held within G_SPREAD in norm,
    and AdamW scales that departure up where an element's gradients are
    small, so an element can leave the bar by ~1e-6 there too."""
    out, want = ranks
    port = [_json(out, r)["llama"] for r in range(N)]
    for s, (loss, grads, params) in enumerate(want["llama"]):
        # the mean of the ranks' half-batch losses is the global mean
        np.testing.assert_allclose(
            np.mean([p["losses"][s] for p in port]), loss, rtol=RTOL)
        for r in range(N):
            got = np.load(out / f"llama_r{r}_s{s}.npz")
            off_bar = 0
            for name, w in params.items():
                d = got[name].astype(np.float64) - w
                assert np.linalg.norm(d) <= RTOL * np.linalg.norm(w), name
                bad = ~np.isclose(got[name], w, rtol=RTOL, atol=ATOL)
                assert np.all(np.abs(d[bad]) <= 2 * R.LLAMA_LR * (s + 1))
                g, dg = grads[name], got[f"grad.{name}"] - grads[name]
                if s == 0:   # the origin: halves that cancel
                    _close(got[f"grad.{name}"], g)
                    rms = np.sqrt(np.mean(g * g))
                    assert np.all(np.abs(g[bad]) < G_CANCEL * rms), name
                else:        # spread by the parameters already off
                    assert np.linalg.norm(dg) <= G_SPREAD * \
                        np.linalg.norm(g), name
                off_bar += bad.sum()
            assert off_bar <= OFF_BAR, (s, off_bar)
    n_params = len(want["llama"][0][2])
    for p in port:
        assert p["params"] == p["reduced"] == n_params
        assert p["all_reduces"] == R.LLAMA_STEPS * p["buckets"]
