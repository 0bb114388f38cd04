"""The layer-built Llama through the port's traced paths against the JAX
package's, on the CPU (a tiny config: hidden 128, 2 layers, 2 heads, 1 kv
head, so attention takes B1-B3's operators; vocab 64; b 2, s 16):

  - `jit.to_static(LlamaForCausalLM)` against the JAX package's
    `to_static` on the same numpy weights (f32, atol 1e-5), with no
    fallback, its program holding `flash_fwd` and `rms_norm` nodes;
  - 2 SOT training steps (`to_static(model, full_graph=False)`, loss and
    `backward()`) against the JAX package's SOT on fixed ids: the losses
    and every gradient;
  - a `make_fx` trace of a training step on fake CPU tensors holds one
    `flash_bwd` node for each attention and one `rms_norm_bwd` for each
    norm, and reads no data pointer: B2/B3 and B10 are operators whose
    bodies read the pointers at run time.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.weights import layer_from_numpy

torch.set_num_threads(1)

CFG = dict(vocab_size=64, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    T.set_device("cpu")
    yield
    port_device._current = prev


def _models():
    J.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**CFG))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**CFG))
    layer_from_numpy(tm, {k: np.asarray(v._data)
                          for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int64)


def test_to_static_llama_against_the_jax_to_static():
    jm, tm = _models()
    jm.eval()
    tm.eval()
    ids = _ids(1)
    base = T.jit.fallback_count()
    sf = T.jit.to_static(tm)
    got = sf(T.to_tensor(ids))
    ref = J.jit.to_static(jm)(J.to_tensor(ids))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    with T.no_grad():
        eager = tm(T.to_tensor(ids))
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=1e-6,
                               rtol=0)
    assert got.stop_gradient  # a to_static output carries no gradient
    assert T.jit.fallback_count() == base
    (prog,) = sf.programs()
    targets = prog.graph_targets()
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    assert targets.count("paddle_tpu_torch.rms_norm.default") == 5
    # another shape is another program; the same shape reuses it
    sf(T.to_tensor(_ids(2, s=8)))
    sf(T.to_tensor(_ids(3)))
    assert len(sf.programs()) == 2


def test_sot_training_steps_against_the_jax_sot():
    jm, tm = _models()
    ids, labels = _ids(4), _ids(5)
    jsot = J.jit.to_static(jm, full_graph=False)
    tsot = T.jit.to_static(tm, full_graph=False)
    for step in range(2):
        jl = jsot(J.to_tensor(ids), labels=J.to_tensor(labels))
        jl.backward()
        tl = tsot(T.to_tensor(ids), labels=T.to_tensor(labels))
        tl.backward()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        jg = {k: p.grad.numpy() for k, p in jm.named_parameters()}
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), jg[k], atol=1e-5,
                                       rtol=0, err_msg=k)
        jm.clear_gradients()
        tm.clear_gradients()
    rep = tsot.report()
    assert (rep["captures"], rep["hits"], rep["eager_calls"]) == (1, 1, 0)


def test_traced_training_step_holds_the_backward_operators(monkeypatch):
    _, tm = _models()
    names = [k for k, _ in tm.named_parameters()]
    params = [p._data.detach() for _, p in tm.named_parameters()]
    swapped = T.jit._SwappedState(tm)

    def step(ps, ids, labels):
        ps = [p.requires_grad_(True) for p in ps]
        with torch.enable_grad():
            saved = {k: p._data for k, p in swapped.params.items()}
            try:
                for (k, p), d in zip(swapped.params.items(), ps):
                    p._data = d
                loss = tm(T.Tensor(ids), labels=T.Tensor(labels))._data
            finally:
                for k, p in swapped.params.items():
                    p._data = saved[k]
            return torch.autograd.grad(loss, ps)

    reads = []
    real = torch.Tensor.data_ptr
    monkeypatch.setattr(torch.Tensor, "data_ptr",
                        lambda self: reads.append(1) or real(self))
    gm = make_fx(step, tracing_mode="fake")(
        params, torch.as_tensor(_ids(6)), torch.as_tensor(_ids(7)))
    assert not reads
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_bwd.default") == 2
    assert targets.count("paddle_tpu_torch.rms_norm_bwd.default") == 5
    # the traced step gives the eager gradients
    monkeypatch.undo()
    got = gm(params, torch.as_tensor(_ids(6)), torch.as_tensor(_ids(7)))
    loss = tm(T.to_tensor(_ids(6)), labels=T.to_tensor(_ids(7)))
    loss.backward()
    for g, (k, p) in zip(got, tm.named_parameters()):
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
