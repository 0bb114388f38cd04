"""The port's `quantization` (`paddle_tpu_torch/quantization`) and
`jit.save(quantize="weight_only_int8")` against the JAX package's on the
CPU, inputs from a numpy seed:

  - every function of the module (fake quantizers with their
    straight-through gradients, linear quant/dequant, weight quant/dequant,
    `weight_only_linear` on B8's custom operator, `apply_per_channel_scale`,
    `llm_int8_linear` with outlier columns) and the 10 `_C_ops` targets
    under `paddle.quantization.`, called with the kernels' argument lists;
  - `weight_only_int8_patched` on a model with two Linears tied to one
    weight, a sublayer aliased under two names and a weight tied into an
    Embedding (which stays float): the same keys, outputs and restore as
    the JAX patch; `fused=` has no effect; QAT and PTQ;
  - `jit.save(quantize="weight_only_int8")` of a 2-layer layer Llama at
    hidden 64 (one head of 64, B1's gate) behind bench.py's next-token
    head, with dynamic batch and sequence, and of the JAX test's
    Sequential (`tests/test_subsystems.py:592`): the port's CPU Predictor
    against the JAX Predictor (f32, 1e-5) and against the float model
    under the JAX test's weight-only bar (0.05), batches 1-3 from one
    save, the program's B8 nodes, and the `.pdiparams` files read across
    both ways (int8 codes, f32 `__scale__` entries, equal codes).
"""

import pickle

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu import _C_ops as JC
from paddle_tpu import inference as jinfer
from paddle_tpu import quantization as jq
from paddle_tpu.models import llama as jllama
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import _C_ops as PC
from paddle_tpu_torch import inference
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.hapi.model import InputSpec
from paddle_tpu_torch.jit import _read_params
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.weights import layer_from_numpy

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BAR = 1e-5
WEIGHT_ONLY_BAR = 0.05   # tests/test_subsystems.py:630


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1.0)


def _pair(*arrays):
    return ([J.to_tensor(a) for a in arrays], [P.to_tensor(a) for a in arrays])


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- the functions ------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantizers_and_their_gradients(bits):
    x = _rng(1).normal(size=(6, 5)).astype("float32")
    (jx,), (px,) = _pair(x)
    for fn in ("fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max"):
        (jqv, js), (pqv, ps) = getattr(jq, fn)(jx, bits), \
            getattr(pq, fn)(px, bits)
        assert _np(pqv).dtype == np.int8
        np.testing.assert_array_equal(_np(pqv), _np(jqv))
        _close(_np(ps), _np(js))
    for fn in ("fake_quantize_dequantize_abs_max",
               "fake_channel_wise_quantize_dequantize_abs_max"):
        jx.stop_gradient = px.stop_gradient = False
        jy, py = getattr(jq, fn)(jx, bits), getattr(pq, fn)(px, bits)
        _close(_np(py), _np(jy))
        (jy * jy).sum().backward()
        (py * py).sum().backward()
        _close(_np(px.grad), _np(jx.grad))   # the straight-through estimator
        jx.clear_grad()
        px.clear_grad()
    state = np.float32(0.5)
    jy, jst = jq.fake_quantize_moving_average_abs_max(jx, state, bits)
    py, pst = pq.fake_quantize_moving_average_abs_max(px, state, bits)
    _close(_np(py), _np(jy))
    _close(_np(pst), _np(jst))


def test_linear_quant_and_weight_quant():
    x = _rng(2).normal(size=(4, 6)).astype("float32") * 3
    s = np.abs(x).max(axis=0).astype("float32") / 127
    (jx, js), (px, ps) = _pair(x, s)
    for axis, (jsc, psc) in ((1, (js, ps)), (-1, (0.05, 0.05))):
        jqv = jq.quantize_linear(jx, jsc, quant_axis=axis)
        pqv = pq.quantize_linear(px, psc, quant_axis=axis)
        np.testing.assert_array_equal(_np(pqv), _np(jqv))
        _close(_np(pq.dequantize_linear(pqv, psc, quant_axis=axis)),
               _np(jq.dequantize_linear(jqv, jsc, quant_axis=axis)))
    w = _rng(3).normal(size=(32, 24)).astype("float32")
    (jw,), (pw,) = _pair(w)
    (jqw, jsw), (pqw, psw) = jq.weight_quantize(jw), pq.weight_quantize(pw)
    np.testing.assert_array_equal(_np(pqw), _np(jqw))
    _close(_np(psw), _np(jsw))
    for dt in ("float32", "bfloat16"):
        got = pq.weight_dequantize(pqw, psw, out_dtype=dt)
        want = jq.weight_dequantize(jqw, jsw, out_dtype=dt)
        assert str(got.dtype).endswith(dt)
        _close(_np(got.astype("float32")), _np(want.astype("float32")))
    with pytest.raises(NotImplementedError, match="group"):
        pq.weight_quantize(pw, group_size=64)


def test_weight_only_linear_per_channel_scale_and_llm_int8():
    rng = _rng(4)
    x = rng.normal(size=(2, 3, 32)).astype("float32")
    x[..., 5] *= 40.0                       # an outlier column for LLM.int8
    w = rng.normal(size=(32, 24)).astype("float32")
    b = rng.normal(size=(24,)).astype("float32")
    (jx, jw, jb), (px, pw, pb) = _pair(x, w, b)
    (jqw, jsw), (pqw, psw) = jq.weight_quantize(jw), pq.weight_quantize(pw)
    px.stop_gradient = jx.stop_gradient = False
    jy = jq.weight_only_linear(jx, jqw, jb, jsw)
    py = pq.weight_only_linear(px, pqw, pb, psw)
    _close(_np(py), _np(jy))
    jy.sum().backward()
    py.sum().backward()
    _close(_np(px.grad), _np(jx.grad))
    _close(_np(pq.llm_int8_linear(px, pqw, pb, psw)),
           _np(jq.llm_int8_linear(jx, jqw, jb, jsw)))
    s = rng.uniform(0.5, 2.0, size=(32,)).astype("float32")
    _close(_np(pq.apply_per_channel_scale(px, P.to_tensor(s))),
           _np(jq.apply_per_channel_scale(jx, J.to_tensor(s))))


def test_weight_only_operator_is_one_node_with_a_fake_and_a_backward():
    """B8's custom operator: its fake gives [..., N] for a [..., K] input,
    its CPU body is B8's plain version, its backward reaches x and the
    scale (the codes take none)."""
    rng = _rng(5)
    x = torch.tensor(rng.normal(size=(2, 3, 32)), dtype=torch.float32,
                     requires_grad=True)
    q, s = qm.quantize_absmax(torch.tensor(rng.normal(size=(32, 16)),
                                           dtype=torch.float32))
    s.requires_grad_(True)
    y = qm.weight_only_matmul_op(x, q, s)
    assert y.shape == (2, 3, 16)
    torch.testing.assert_close(y, qm.dequant_matmul_plain(x, q, s))
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    fakes = [mode.from_tensor(t) for t in (x.detach(), q, s.detach())]
    with mode:
        out = qm.WEIGHT_ONLY_MATMUL_OP(*fakes)
    assert tuple(out.shape) == (2, 3, 16) and out.dtype == torch.float32
    y.square().sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    sr = s.detach().clone().requires_grad_(True)
    (xr @ (q.float() * sr / 127.0)).square().sum().backward()
    _close(x.grad.numpy(), xr.grad.numpy())
    _close(s.grad.numpy(), sr.grad.numpy())


def test_the_ten_c_ops_targets_call_the_ported_functions():
    rng = _rng(6)
    x = rng.normal(size=(4, 32)).astype("float32")
    w = rng.normal(size=(32, 16)).astype("float32")
    b = rng.normal(size=(16,)).astype("float32")
    (jx, jw, jb), (px, pw, pb) = _pair(x, w, b)
    names = [n for n, t in PC._TARGETS.items()
             if t.startswith("paddle.quantization.")]
    assert len(names) == 10
    for n in names:
        assert PC._t(n) is getattr(pq, PC._TARGETS[n].rsplit(".", 1)[1])
    jqw, jsw = JC.weight_quantize(jw)
    pqw, psw = PC.weight_quantize(pw)
    np.testing.assert_array_equal(_np(pqw), _np(jqw))
    calls = {
        "weight_dequantize": lambda M, a: M.weight_dequantize(
            a["q"], a["s"], out_dtype="float32"),
        "weight_only_linear": lambda M, a: M.weight_only_linear(
            a["x"], a["q"], a["b"], a["s"], "int8"),
        "llm_int8_linear": lambda M, a: M.llm_int8_linear(
            a["x"], a["q"], a["b"], a["s"]),
        "apply_per_channel_scale": lambda M, a: M.apply_per_channel_scale(
            a["x"], a["x"]),
        "fake_quantize_abs_max": lambda M, a: M.fake_quantize_abs_max(
            a["x"])[0],
        "fake_quantize_dequantize_abs_max":
            lambda M, a: M.fake_quantize_dequantize_abs_max(a["x"]),
        "fake_channel_wise_quantize_abs_max":
            lambda M, a: M.fake_channel_wise_quantize_abs_max(a["w"])[1],
        # the kernel's positional round_type lands on quant_axis in both
        "fake_channel_wise_quantize_dequantize_abs_max":
            lambda M, a: M.fake_channel_wise_quantize_dequantize_abs_max(
                a["w"]),
    }
    ja = {"x": jx, "w": jw, "b": jb, "q": jqw, "s": jsw}
    pa = {"x": px, "w": pw, "b": pb, "q": pqw, "s": psw}
    for n, call in calls.items():
        _close(_np(call(PC, pa)), _np(call(JC, ja)))
    # the moving-average target drops its state in both packages' bodies
    with pytest.raises(TypeError):
        JC.fake_quantize_moving_average_abs_max(jx, None, None, None)
    with pytest.raises(TypeError):
        PC.fake_quantize_moving_average_abs_max(px, None, None, None)


# -- the patch, QAT and PTQ ---------------------------------------------------


def _tied_model(M, state=None):
    class Tied(M.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = M.nn.Embedding(32, 32)
            self.fc1 = M.nn.Linear(32, 32)
            self.fc2 = M.nn.Linear(32, 32)
            self.fc2.weight = self.fc1.weight      # two Linears, one weight
            self.alias = self.fc1                  # one sublayer, two names
            self.head = M.nn.Linear(32, 32)
            self.head.weight = self.emb.weight     # tied into an Embedding
            self.out = M.nn.Linear(32, 16)

        def forward(self, ids):
            h = self.emb(ids)
            h = self.fc2(M.nn.functional.relu(self.alias(h)))
            return self.out(self.head(h))

    M.seed(0)
    m = Tied()
    if state is not None:
        m.set_state_dict(state)
    return m


def test_patch_keeps_every_guard_of_the_jax_patch():
    ref = _tied_model(J)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    port = _tied_model(P, state)
    ids = _rng(7).integers(0, 32, (2, 5)).astype("int64")
    float_out = _np(port(P.to_tensor(ids)))
    with jq.weight_only_int8_patched(ref) as jkeys, \
            pq.weight_only_int8_patched(port) as pkeys:
        assert pkeys == jkeys == ["fc1.weight", "out.weight"]
        assert port.emb.weight._data.dtype == torch.float32
        assert port.fc2.weight._data.dtype == torch.int8
        sd = port.state_dict()
        assert sorted(k for k in sd if k.endswith("__scale__")) == \
            ["fc1.weight.__scale__", "out.weight.__scale__"]
        assert sorted(sd) == sorted(ref.state_dict())
        _close(_np(port(P.to_tensor(ids))), _np(ref(J.to_tensor(ids))))
    # restored: float weights, no scale, the class forwards
    assert port.fc1.weight._data.dtype == torch.float32
    assert "forward" not in port.fc2.__dict__
    assert not any("__scale__" in k for k in port.state_dict())
    np.testing.assert_array_equal(_np(port(P.to_tensor(ids))), float_out)


def test_fused_has_no_effect_and_an_empty_model_warns():
    port = _tied_model(P)
    ids = P.to_tensor(_rng(8).integers(0, 32, (2, 5)).astype("int64"))
    outs = []
    for fused in (None, True, False):
        with pq.weight_only_int8_patched(port, fused=fused):
            outs.append(_np(port(ids)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    with pytest.warns(UserWarning, match="no quantizable"):
        with pq.weight_only_int8_patched(P.nn.Sequential(P.nn.Linear(4, 4))):
            pass


def test_qat_and_ptq_match_the_jax_package():
    x = _rng(9).normal(size=(4, 16)).astype("float32")
    outs = {}
    for M, Q in ((J, jq), (P, pq)):
        M.seed(0)
        net = M.nn.Sequential(M.nn.Linear(16, 32), M.nn.ReLU(),
                              M.nn.Linear(32, 8))
        state = state if M is P else {k: v.numpy() for k, v in
                                      net.state_dict().items()}
        net.set_state_dict(state)
        ptq_net = M.nn.Sequential(M.nn.Linear(16, 32), M.nn.ReLU(),
                                  M.nn.Linear(32, 8))
        ptq_net.set_state_dict(state)
        Q.QAT(Q.QuantConfig()).quantize(net)
        xt = M.to_tensor(x)
        y1, y2 = net(xt), net(xt)     # the moving scale moves
        ptq = Q.PTQ()
        ptq.convert(ptq.quantize(ptq_net))
        outs[M.__name__] = [_np(y1), _np(y2), _np(ptq_net(xt))]
    for got, want in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"]):
        _close(got, want)


# -- jit.save(quantize="weight_only_int8") -------------------------------------


def _llama_cfg(mod):
    return mod.LlamaConfig.tiny(num_hidden_layers=2, hidden_size=64,
                                num_attention_heads=1, intermediate_size=176)


def _next_token(M, mod, state=None):
    class NextToken(M.nn.Layer):
        """bench.py's `_NextToken` (:285): the last position's logits."""

        def __init__(self):
            super().__init__()
            self.lm = mod.LlamaForCausalLM(_llama_cfg(mod))

        def forward(self, ids):
            return self.lm(ids)[:, -1, :]

    M.seed(0)
    m = NextToken()
    if state is not None:
        layer_from_numpy(m, state)
    return m


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def saved_llama(tmp_path_factory):
    ref = _next_token(J, jllama)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = _next_token(P, tllama, state)
    d = tmp_path_factory.mktemp("q8llama")
    P.jit.save(port, str(d / "port"), input_spec=[
        InputSpec([None, None], "int64", "ids")], quantize="weight_only_int8")
    J.jit.save(ref, str(d / "jax"), input_spec=[
        JSpec([None, None], "int64", "ids")], quantize="weight_only_int8")
    return {"ref": ref, "port": port, "port_prefix": str(d / "port"),
            "jax_prefix": str(d / "jax")}


def _cpu_predictor(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def test_quantized_llama_meta_params_and_program(saved_llama):
    with open(saved_llama["port_prefix"] + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    with open(saved_llama["jax_prefix"] + ".pdmodel", "rb") as f:
        jmeta = pickle.load(f)
    assert meta["quantize"] == jmeta["quantize"] == "weight_only_int8"
    assert meta["quantized_keys"] == jmeta["quantized_keys"]
    assert len(meta["quantized_keys"]) == 7 * 2 + 1
    assert sorted(meta["param_keys"]) == sorted(jmeta["param_keys"])
    ep = torch.export.load(__import__("io").BytesIO(meta["torch_export"]))
    b8 = [n for n in ep.graph.nodes if n.op == "call_function"
          and n.target is qm.WEIGHT_ONLY_MATMUL_OP]
    assert len(b8) == 15
    # traced on the CPU, the norms are B9's operator all the same, so a
    # program moved to the card launches B9 there
    norms = [n for n in ep.graph.nodes if n.op == "call_function"
             and n.target is torch.ops.paddle_tpu_torch.rms_norm.default]
    assert len(norms) == 2 * 2 + 1
    assert "weight_only_matmul_op" in \
        inference.Config(saved_llama["port_prefix"]).pass_builder(
        ).all_passes()


def test_pdiparams_cross_both_ways_with_equal_codes(saved_llama):
    pstate = _read(saved_llama["port_prefix"] + ".pdiparams")
    jstate = _read(saved_llama["jax_prefix"] + ".pdiparams")
    assert set(pstate) == set(jstate)
    with open(saved_llama["port_prefix"] + ".pdmodel", "rb") as f:
        qkeys = pickle.load(f)["quantized_keys"]
    for k in qkeys:
        assert pstate[k].dtype == jstate[k].dtype == np.int8
        np.testing.assert_array_equal(pstate[k], jstate[k])
        assert pstate[k + ".__scale__"].dtype == np.float32
        _close(pstate[k + ".__scale__"], jstate[k + ".__scale__"])
    # the port reads the JAX package's file
    pread = _read_params(saved_llama["jax_prefix"] + ".pdiparams")
    for k in qkeys:
        assert pread[k].dtype == torch.int8
        np.testing.assert_array_equal(pread[k].numpy(), jstate[k])


def test_port_predictor_equals_the_jax_predictor_at_batches_1_to_3(
        saved_llama):
    pred = _cpu_predictor(saved_llama["port_prefix"])
    jcfg = jinfer.Config(saved_llama["jax_prefix"])
    jcfg.disable_gpu()
    jpred = jinfer.create_predictor(jcfg)
    vocab = _llama_cfg(jllama).vocab_size
    for b, s in ((1, 9), (2, 16), (3, 5)):
        ids = _rng(10 + b).integers(0, vocab, (b, s)).astype("int64")
        got = _np(pred.run([ids])[0])
        want = np.asarray(jpred.run([ids])[0])
        assert got.shape == (b, vocab)
        _close(got, want)
        ref = _np(saved_llama["port"](P.to_tensor(ids)))
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert 0 < err < WEIGHT_ONLY_BAR, err


def test_sequential_weight_only_int8_predictor(tmp_path):
    """`tests/test_subsystems.py:592` on the port, with the JAX Predictor on
    the same weights beside it."""
    nets = {}
    for M in (J, P):
        M.seed(0)
        nets[M] = M.nn.Sequential(M.nn.Linear(64, 128), M.nn.GELU(),
                                  M.nn.Linear(128, 128), M.nn.GELU(),
                                  M.nn.Linear(128, 32))
    nets[P].set_state_dict({k: v.numpy() for k, v in
                            nets[J].state_dict().items()})
    x = _rng(0).normal(size=(4, 64)).astype("float32")
    ref = _np(nets[P](P.to_tensor(x)))
    fp, q8, jq8 = (str(tmp_path / n) for n in ("fp32", "int8", "jint8"))
    spec = [InputSpec([None, 64], "float32", "x")]
    P.jit.save(nets[P], fp, input_spec=spec)
    P.jit.save(nets[P], q8, input_spec=spec, quantize="weight_only_int8")
    J.jit.save(nets[J], jq8, input_spec=[JSpec([None, 64], "float32", "x")],
               quantize="weight_only_int8")
    meta = _read(q8 + ".pdmodel")
    assert meta["quantize"] == "weight_only_int8"
    assert len(meta["quantized_keys"]) == 3
    qstate = _read(q8 + ".pdiparams")
    for k in meta["quantized_keys"]:
        assert qstate[k].dtype == np.int8
        assert qstate[k + ".__scale__"].dtype == np.float32
    import os

    assert os.path.getsize(q8 + ".pdiparams") < \
        0.5 * os.path.getsize(fp + ".pdiparams")
    np.testing.assert_allclose(_np(_cpu_predictor(fp).run([x])[0]), ref,
                               atol=1e-5)
    got = _np(_cpu_predictor(q8).run([x])[0])
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < \
        WEIGHT_ONLY_BAR
    jcfg = jinfer.Config(jq8)
    jcfg.disable_gpu()
    _close(got, np.asarray(jinfer.create_predictor(jcfg).run([x])[0]))
    # the JAX Predictor serves the port's params file in its own program
    jstate = _read(jq8 + ".pdiparams")
    for k in meta["quantized_keys"]:
        np.testing.assert_array_equal(qstate[k], jstate[k])


def test_quantize_argument_checks(tmp_path):
    m = P.nn.Linear(32, 32)
    spec = [InputSpec([1, 32], "float32")]
    with pytest.raises(ValueError, match="unsupported quantize"):
        P.jit.save(m, str(tmp_path / "q"), input_spec=spec, quantize="fp4")
    with pytest.raises(ValueError, match="requires input_spec"):
        P.jit.save(m, str(tmp_path / "q"), quantize="weight_only_int8")
    with pytest.raises(ValueError, match="calib_reader"):
        P.jit.save(m, str(tmp_path / "q"), input_spec=spec,
                   quantize="int8_ptq")
    assert m.weight._data.dtype == torch.float32
