"""The port's `jit.save`/`jit.load` and `inference` Predictor
(`paddle_tpu_torch/jit`, `paddle_tpu_torch/inference`) against the JAX
package's on the CPU.

  - the gate variant of `unet_tiny` (`torch_unet_parity`, head_dim 64:
    B1's custom op) saved with a dynamic batch: its program holds a
    `paddle_tpu_torch.flash_fwd` node (the op the card's program launches
    B1 from), takes every parameter as an input (`param_keys` lists all
    128 leaves, no constant is a weight, the program file holds none);
    the CPU Predictor's output equals the eager layer's and the JAX
    Predictor's on the same weights (f32 1e-5), at batches 1, 2 and 3 from
    one save;
  - the port's counterparts of `tests/test_subsystems.py`: the
    Sequential and two-head round trips (:16-57), the passes on tied
    weights (:1455-1510) and their composition;
  - the `.pdiparams` file both ways (the JAX package unpickles the port's,
    bf16 included, to the same arrays; the port reads the JAX package's),
    a StableHLO-only `.pdmodel` refused with the port's ValueError,
    `Model.save(training=False)` in the JAX layout,
    `convert_to_mixed_precision` in bf16, and no card: a Config that asks
    for one raises.
"""

import pickle
import warnings

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
import torch_unet_parity as U
from paddle_tpu import inference as jinfer
from paddle_tpu import jit as jjit
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import inference
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.hapi.model import InputSpec

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BAR = 1e-5
SPEC = [("batch", 4, U.SIZE, U.SIZE), ("batch",)]


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _cpu_predictor(prefix, *passes):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    for p in passes:
        cfg.pass_builder().append_pass(p)
    return inference.create_predictor(cfg)


def _near(got, want, bar=BAR):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * np.abs(want).max()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The gate variant in both packages from the same weights, each saved
    by its own jit.save with a dynamic batch."""
    ref, port, state = U.build(**U.CONFIGS["gate"])
    d = tmp_path_factory.mktemp("unet")
    P.jit.save(port, str(d / "port"), input_spec=[
        InputSpec(list(SPEC[0]), "float32", "latents"),
        InputSpec(list(SPEC[1]), "float32", "timestep")])
    jjit.save(ref, str(d / "jax"), input_spec=[
        JSpec(list(SPEC[0]), "float32", "latents"),
        JSpec(list(SPEC[1]), "float32", "timestep")])
    return {"ref": ref, "port": port, "state": state,
            "port_prefix": str(d / "port"), "jax_prefix": str(d / "jax")}


def _meta(prefix):
    with open(prefix + ".pdmodel", "rb") as f:
        return pickle.load(f)


def test_the_program_holds_b1s_op_and_no_weight(saved):
    from paddle_tpu_torch.inference import _load_program

    meta = _meta(saved["port_prefix"])
    ep = _load_program(meta, "")
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    # level 1: one attention down, two up, one in the middle
    assert ops.count("paddle_tpu_torch.flash_fwd.default") == 4
    names = [n for n, _ in saved["port"].named_parameters()]
    assert meta["param_keys"] == names and len(names) == 128
    assert meta["input_names"] == ["latents", "timestep"]
    assert meta["output_names"] == ["output_0"]
    assert meta["input_dtypes"] == ["float32", "float32"]
    # the constants are two interpolation scales, none a weight
    assert all(c.numel() == 1 for c in ep.constants.values())
    assert not list(ep.state_dict)
    weight_bytes = sum(v.nbytes for v in saved["state"].values())
    assert len(meta["torch_export"]) < weight_bytes


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_cpu_predictor_equals_the_eager_layer_and_the_jax_predictor(
        saved, batch):
    pred = _cpu_predictor(saved["port_prefix"])
    jcfg = jinfer.Config(saved["jax_prefix"])
    jcfg.disable_gpu()
    jpred = jinfer.create_predictor(jcfg)
    x, t = U.inputs(batch, seed=10 + batch)
    out = pred.run([x, t])
    assert len(out) == 1 and out[0].device.type == "cpu"
    with P.no_grad():
        eager = saved["port"](P.to_tensor(x), P.to_tensor(t)).numpy()
    _near(out[0].numpy(), eager)
    _near(out[0].numpy(), np.asarray(jpred.run([x, t])[0]))
    h = pred.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_array_equal(h, out[0].numpy())


def test_the_jax_package_reads_the_ports_params_and_the_port_the_jaxs(
        saved, tmp_path):
    with open(saved["port_prefix"] + ".pdiparams", "rb") as f:
        port_file = pickle.load(f)    # plain pickle: the JAX package's read
    jax_file = P.jit.load(saved["jax_prefix"]).state_dict()
    assert list(port_file) == list(jax_file) == list(saved["state"])
    for k, v in saved["state"].items():
        np.testing.assert_array_equal(port_file[k], v)
        np.testing.assert_array_equal(jax_file[k].numpy(), v)
    # bf16 both ways, bit for bit
    port16 = U.build()[1].astype("bfloat16")
    P.jit.save(port16, str(tmp_path / "p16"))
    with open(str(tmp_path / "p16.pdiparams"), "rb") as f:
        got = pickle.load(f)
    for k, v in port16.state_dict().items():
        assert got[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(got[k].view(np.uint16), v.numpy())
    ref16 = U.build()[0]
    for _, p in ref16.named_parameters():
        p._data = p._data.astype(jnp.bfloat16)
    jjit.save(ref16, str(tmp_path / "j16"))
    loaded = P.jit.load(str(tmp_path / "j16")).state_dict()
    for k, v in ref16.state_dict().items():
        assert loaded[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(loaded[k].numpy(),
                                      np.asarray(v._data).view(np.uint16))
    with pytest.raises(NotImplementedError, match="jit.load restores"):
        P.jit.load(str(tmp_path / "j16"))(None)


def test_a_stablehlo_only_program_is_refused_naming_the_ports_save(saved):
    with pytest.raises(ValueError, match=r"StableHLO.*paddle_tpu_torch\.jit"
                       r"\.save"):
        _cpu_predictor(saved["jax_prefix"])


def test_a_weights_only_save_has_no_program(tmp_path):
    m = P.nn.Linear(3, 2)
    P.jit.save(m, str(tmp_path / "w"))
    assert _meta(str(tmp_path / "w")) == {"class": "Linear"}
    with pytest.raises(ValueError, match="no program"):
        _cpu_predictor(str(tmp_path / "w"))


def test_sequential_round_trip(tmp_path):
    """tests/test_subsystems.py:16 on the port."""
    P.seed(0)
    m = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(), P.nn.Linear(16, 4))
    prefix = str(tmp_path / "model")
    # platforms is accepted and unused: the Predictor places the program
    P.jit.save(m, prefix, input_spec=[InputSpec([2, 8], "float32", "x")],
               platforms=("tpu",))
    pred = _cpu_predictor(prefix)
    assert pred.get_input_names() == ["x"]
    x = np.random.default_rng(0).normal(size=(2, 8)).astype("float32")
    out = pred.run([x])[0]
    np.testing.assert_allclose(out.numpy(), m(P.to_tensor(x)).numpy(),
                               atol=1e-5)
    with pytest.raises(Exception):   # the batch was saved static
        pred.run([np.zeros((3, 8), "float32")])


def test_dynamic_batch_and_multi_output(tmp_path):
    """tests/test_subsystems.py:33 on the port."""
    class TwoHead(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = P.nn.Linear(8, 4)
            self.b = P.nn.Linear(8, 2)

        def forward(self, x):
            return self.a(x), self.b(x)

    P.seed(0)
    m = TwoHead()
    prefix = str(tmp_path / "twohead")
    P.jit.save(m, prefix, input_spec=[InputSpec([None, 8], "float32", "x")])
    pred = _cpu_predictor(prefix)
    assert pred.get_output_names() == ["output_0", "output_1"]
    for bs in (1, 3, 7):
        x = np.random.default_rng(bs).normal(size=(bs, 8)).astype("float32")
        outs = pred.run([x])
        assert tuple(outs[0].shape) == (bs, 4)
        assert tuple(outs[1].shape) == (bs, 2)
        np.testing.assert_allclose(outs[0].numpy(),
                                   m(P.to_tensor(x))[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(
            pred.get_output_handle("output_1").copy_to_cpu(),
            m(P.to_tensor(x))[1].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="_autodim"):
        P.jit.save(m, prefix, input_spec=[InputSpec(["_autodim0", 8])])


class Tied(P.nn.Layer):
    def __init__(self):
        super().__init__()
        self.a = P.nn.Linear(8, 8, bias_attr=False)
        self.b = P.nn.Linear(8, 8, bias_attr=False)
        self.b.weight.set_value(self.a.weight)   # byte-identical

    def forward(self, x):
        return self.b(self.a(x))


@pytest.fixture
def tied(tmp_path):
    P.seed(0)
    prefix = str(tmp_path / "tied")
    P.jit.save(Tied(), prefix, input_spec=[InputSpec([2, 8], "float32",
                                                     "x")])
    return prefix


def test_passes_on_tied_weights(tied):
    """tests/test_subsystems.py:1455 on the port."""
    cfg = inference.Config(tied)
    assert "weight_dedup_pass" in cfg.pass_builder().all_passes()
    assert "flash_attention_op" in cfg.pass_builder().all_passes()
    pred = _cpu_predictor(tied)
    assert len({id(p) for p in pred._params}) < len(pred._params)
    x = np.ones((2, 8), np.float32)
    base = pred.run([x])[0].numpy()

    cfg2 = inference.Config(tied)
    cfg2.disable_gpu()
    cfg2.delete_pass("weight_dedup_pass")
    pred2 = inference.create_predictor(cfg2)
    assert len({id(p) for p in pred2._params}) == len(pred2._params)
    np.testing.assert_allclose(pred2.run([x])[0].numpy(), base, rtol=1e-6)

    pred3 = _cpu_predictor(tied, "bf16_weights_pass")
    assert all(p.dtype == torch.bfloat16 for p in pred3._params)
    np.testing.assert_allclose(pred3.run([x])[0].numpy(), base, rtol=3e-2,
                               atol=3e-2)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg2.delete_pass("flash_attention_op")
    assert any("cannot be deleted" in str(m.message) for m in w)
    with pytest.raises(ValueError):
        cfg2.pass_builder().append_pass("nonexistent_pass")


def test_bf16_and_dedup_passes_compose(tied):
    """Tied weights keep one device buffer after both passes (the
    id()-keyed cast), tests/test_subsystems.py:1513 on the port."""
    pred = _cpu_predictor(tied, "bf16_weights_pass")
    assert len(pred._params) == 2
    assert pred._params[0] is pred._params[1]
    assert pred._params[0].dtype == torch.bfloat16


def test_noop_knobs_warn_and_profiling_counts_runs(tied):
    cfg = inference.Config(tied)
    cfg.disable_gpu()
    for knob in (cfg.enable_memory_optim, cfg.enable_mkldnn,
                 lambda: cfg.switch_ir_optim(False),
                 lambda: cfg.set_cpu_math_library_num_threads(2),
                 cfg.enable_tensorrt_engine):
        with pytest.warns(UserWarning, match="no-op on this backend"):
            knob()
    cfg.enable_profile()
    pred = inference.create_predictor(cfg)
    for _ in range(3):
        pred.run([np.ones((2, 8), np.float32)])
    summary = pred.summary()
    assert summary["counters"]["run_calls"] == 3
    assert _cpu_predictor(tied).summary() is None


def test_model_save_for_inference_writes_the_jax_layout(tmp_path):
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.BatchNorm1D(3))
    P.Model(net).save(str(tmp_path / "inf"), training=False)
    assert _meta(str(tmp_path / "inf")) == {"class": "Sequential"}
    with open(str(tmp_path / "inf.pdiparams"), "rb") as f:
        state = pickle.load(f)
    assert list(state) == list(net.state_dict())
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy())
    # the JAX package's Model writes the same keys for the same layers
    paddle_tpu.seed(0)
    jnet = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(4, 3),
                                    paddle_tpu.nn.BatchNorm1D(3))
    paddle_tpu.Model(jnet).save(str(tmp_path / "jinf"), training=False)
    assert _meta(str(tmp_path / "jinf")) == {"class": "Sequential"}
    with open(str(tmp_path / "jinf.pdiparams"), "rb") as f:
        assert list(pickle.load(f)) == list(state)


def test_convert_to_mixed_precision_bf16(tied, tmp_path):
    out = str(tmp_path / "mixed")
    inference.convert_to_mixed_precision(
        tied + ".pdmodel", tied + ".pdiparams", out + ".pdmodel",
        out + ".pdiparams", inference.PrecisionType.Bfloat16)
    with open(out + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    with open(tied + ".pdiparams", "rb") as f:
        f32 = pickle.load(f)
    for k, v in state.items():
        assert v.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            v, np.asarray(jnp.asarray(f32[k]).astype(jnp.bfloat16)))
    x = np.ones((2, 8), np.float32)
    got = _cpu_predictor(out).run([x])[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               _cpu_predictor(tied).run([x])[0].numpy(),
                               rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError, match="unsupported"):
        inference.convert_to_mixed_precision(
            tied + ".pdmodel", tied + ".pdiparams", out + ".pdmodel",
            out + ".pdiparams", inference.PrecisionType.Int8)


def test_a_config_that_asks_for_the_card_raises_without_one(tied,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.create_predictor(inference.Config(tied))
    cfg = inference.Config(tied)
    cfg.enable_use_gpu(device_id=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.create_predictor(cfg)


def test_quantize_waits_for_the_quantization_module(tmp_path):
    """The quantization module came with A10f part 1: `quantize=` saves an
    int8 program the Predictor serves (`test_torch_quantization.py` holds
    it to the JAX package's)."""
    P.seed(0)
    m = P.nn.Linear(32, 16)
    spec = [InputSpec([1, 32], "float32")]
    P.jit.save(m, str(tmp_path / "q"), input_spec=spec,
               quantize="weight_only_int8")
    with open(str(tmp_path / "q") + ".pdiparams", "rb") as f:
        assert pickle.load(f)["weight"].dtype == np.int8
    x = np.random.default_rng(0).normal(size=(1, 32)).astype("float32")
    got = _cpu_predictor(str(tmp_path / "q")).run([x])[0].numpy()
    want = m(P.to_tensor(x)).numpy()
    assert np.abs(got - want).max() < 0.05 * np.abs(want).max()
    with pytest.raises(ValueError, match="unsupported quantize"):
        P.jit.save(m, str(tmp_path / "q"), input_spec=spec, quantize="fp4")


def test_buffers_are_program_inputs_and_bf16_outputs_copy_as_bits(tmp_path):
    """Departures from the JAX package (ROADMAP §C): a buffer is a program
    input listed in `param_keys` after the parameters (the JAX save bakes
    buffers into the program), and a bf16 output's `copy_to_cpu` gives its
    uint16 bits, as `Tensor.numpy()` does (the JAX one gives ml_dtypes
    bfloat16)."""
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(4, 6), P.nn.BatchNorm1D(6))
    net.train()
    net(P.to_tensor(np.random.default_rng(0).normal(
        size=(8, 4)).astype("float32")))     # running statistics move
    net.astype("bfloat16")
    prefix = str(tmp_path / "bn")
    P.jit.save(net, prefix, input_spec=[InputSpec([None, 4], "bfloat16",
                                                  "x")])
    assert net.training   # the save traced in eval() and restored train()
    meta = _meta(prefix)
    params = [n for n, _ in net.named_parameters()]
    buffers = [n for n, _ in net.named_buffers()]
    assert meta["param_keys"] == params + buffers
    assert buffers == ["1._mean", "1._variance"]
    pred = _cpu_predictor(prefix)
    x = np.random.default_rng(1).normal(size=(3, 4)).astype("float32")
    pred.run([x])
    got = pred.get_output_handle("output_0").copy_to_cpu()
    net.eval()
    with P.no_grad():
        want = net(P.to_tensor(x).astype("bfloat16")).numpy()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
