"""The port's activation-int8 PTQ (`paddle_tpu_torch/quantization/
ptq_int8.py`, `jit.save(quantize="int8_ptq", calib_reader=...)`) against
the JAX package's on the CPU:

  - the JAX test's Conv2D + Linear model (`tests/test_subsystems.py:724`)
    saved by both packages from the same weights and calibration batches:
    the same quantized keys and int8 codes, the port's CPU Predictor
    against the JAX Predictor (f32, 1e-5) and against the float model
    under the JAX test's bar (0.1), the live model restored after the
    save, `calib_reader` required;
  - the int8 x int8 -> int32 products past K = 1040, where an f32 sum of
    the codes stops being exact: a Linear at K 4096 and 11008 and a 3x3
    convolution over 512 channels (K 4608), each held to the JAX
    package's int32 result exactly, with the f32 route shown to miss it;
  - a K-4096 Linear saved by both packages: the Predictors agree.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu import inference as jinfer
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import inference
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.hapi.model import InputSpec
from paddle_tpu_torch.quantization import ptq_int8

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BAR = 1e-5
PTQ_BAR = 0.1   # tests/test_subsystems.py:769


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _conv_lin(M):
    class ConvLin(M.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = M.nn.Conv2D(3, 8, 3, stride=1, padding=1)
            self.act = M.nn.ReLU()
            self.fc = M.nn.Linear(8 * 8 * 8, 32)

        def forward(self, x):
            h = self.act(self.conv(x))
            return self.fc(M.reshape(h, [h.shape[0], -1]))

    return ConvLin()


def _jax_predictor(prefix):
    cfg = jinfer.Config(prefix)
    cfg.disable_gpu()
    return jinfer.create_predictor(cfg)


def _port_predictor(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def test_int8_ptq_predictor_matches_the_jax_predictor(tmp_path):
    J.seed(0)
    ref = _conv_lin(J)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    port = _conv_lin(P)
    port.set_state_dict(state)
    rng = np.random.default_rng(0)
    calib = [rng.normal(size=(4, 3, 8, 8)).astype("float32")
             for _ in range(4)]
    x = rng.normal(size=(4, 3, 8, 8)).astype("float32")
    want_fp = port(P.to_tensor(x)).numpy()
    pq8, jq8 = str(tmp_path / "port"), str(tmp_path / "jax")
    P.jit.save(port, pq8, input_spec=[InputSpec([None, 3, 8, 8], "float32",
                                                "x")],
               quantize="int8_ptq", calib_reader=calib)
    J.jit.save(ref, jq8, input_spec=[JSpec([None, 3, 8, 8], "float32", "x")],
               quantize="int8_ptq", calib_reader=calib)
    # the patch restored the model: the eager forward is unchanged
    np.testing.assert_array_equal(port(P.to_tensor(x)).numpy(), want_fp)
    metas = [pickle.load(open(p + ".pdmodel", "rb")) for p in (pq8, jq8)]
    assert metas[0]["quantize"] == metas[1]["quantize"] == "int8_ptq"
    assert set(metas[0]["quantized_keys"]) == \
        set(metas[1]["quantized_keys"]) == {"conv.weight", "fc.weight"}
    pstate, jstate = (pickle.load(open(p + ".pdiparams", "rb"))
                      for p in (pq8, jq8))
    for k in metas[0]["quantized_keys"]:
        assert pstate[k].dtype == np.int8
        np.testing.assert_array_equal(pstate[k], jstate[k])
    got = _port_predictor(pq8).run([x])[0].numpy()
    assert _rel(got, np.asarray(_jax_predictor(jq8).run([x])[0])) <= BAR
    err = _rel(got, want_fp)
    assert 0 < err < PTQ_BAR, err
    with pytest.raises(ValueError, match="calib_reader"):
        P.jit.save(port, str(tmp_path / "bad"), input_spec=[
            InputSpec([None, 3, 8, 8], "float32", "x")], quantize="int8_ptq")


def _codes(rng, shape, lo=-127):
    return rng.integers(lo, 128, shape).astype(np.int8)


@pytest.mark.parametrize("k", [4096, 11008])
def test_linear_int32_accumulation_is_exact_past_k_1040(k):
    """Codes near +127 drive the sums past 2^24, where f32 rounds."""
    rng = np.random.default_rng(k)
    x, w = _codes(rng, (3, 5, k), 90), _codes(rng, (k, 24), 90)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    got = ptq_int8._int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 2 ** 24
    f32 = torch.from_numpy(x).float() @ torch.from_numpy(w).float()
    assert not np.array_equal(f32.numpy().astype(np.int64), want)


def test_conv_int32_accumulation_is_exact_over_512_channels():
    rng = np.random.default_rng(1)
    x = _codes(rng, (1, 512, 5, 5), 90)
    w = _codes(rng, (8, 512, 3, 3), 90)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(1, 1),
        padding=[(1, 1), (1, 1)], dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32))
    assert np.abs(want).max() > 2 ** 24

    class Conv:   # the attributes `_q_conv2d_forward` reads
        _stride, _padding, _dilation, _groups = (1, 1), 1, (1, 1), 1
        bias = None

        class weight:
            _data = torch.from_numpy(w)

    fwd = ptq_int8._q_conv2d_forward(Conv, 1.0, torch.ones(8))
    got = fwd(P.to_tensor(x.astype("float32")))._data
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_k4096_linear_predictors_agree(tmp_path):
    J.seed(0)
    ref = J.nn.Linear(4096, 64)
    port = P.nn.Linear(4096, 64)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    rng = np.random.default_rng(2)
    calib = [rng.normal(size=(4, 4096)).astype("float32") for _ in range(2)]
    x = rng.normal(size=(3, 4096)).astype("float32")
    P.jit.save(port, str(tmp_path / "p"), input_spec=[
        InputSpec([None, 4096], "float32", "x")], quantize="int8_ptq",
        calib_reader=calib)
    J.jit.save(ref, str(tmp_path / "j"), input_spec=[
        JSpec([None, 4096], "float32", "x")], quantize="int8_ptq",
        calib_reader=calib)
    got = _port_predictor(str(tmp_path / "p")).run([x])[0].numpy()
    want = np.asarray(_jax_predictor(str(tmp_path / "j")).run([x])[0])
    assert _rel(got, want) <= BAR
