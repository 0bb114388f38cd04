"""The port's layer-built Llama (`models.llama.LlamaForCausalLM` over the
port's nn.Layers) against the JAX package's on the CPU, at
`LlamaConfig.tiny(num_hidden_layers=2)` with the JAX model's weights
carried across (`models.weights.layer_from_numpy`): the loss and every
parameter's gradient (f32, 1e-5: the loss relative, each gradient's
||d|| / ||ref||), 5 AdamW steps (each loss and the parameters after),
`params_from_layer` leaf by leaf, greedy `generate` eager and
`compiled=True` (the JAX tokens), and `LlamaRMSNorm` in f32 and bf16."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import params_from_layer
from paddle_tpu_torch.models.weights import layer_from_numpy

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BAR = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _cfg(M, **kw):
    mod = jllama if M is paddle_tpu else tllama
    return mod.LlamaConfig.tiny(num_hidden_layers=2, **kw)


@pytest.fixture(scope="module")
def pair():
    """(the JAX model, the port's with its weights, ids, labels)."""
    prev = port_device._current
    P.set_device("cpu")
    paddle_tpu.seed(0)
    ref = jllama.LlamaForCausalLM(_cfg(paddle_tpu))
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = layer_from_numpy(tllama.LlamaForCausalLM(_cfg(P)), state)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 16)).astype(np.int64)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int64)
    port_device._current = prev
    return ref, port, state, ids, labels


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def test_names_shapes_and_order_equal_the_jax_models(pair):
    ref, port, state, _, _ = pair
    assert [(k, list(v.shape)) for k, v in port.state_dict().items()] == \
        [(k, list(v.shape)) for k, v in ref.state_dict().items()]
    assert len(state) == 2 * 9 + 3
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]


def test_loss_and_every_gradient_match_the_jax_model(pair):
    ref, port, _, ids, labels = pair
    rl = ref(paddle_tpu.to_tensor(ids), labels=paddle_tpu.to_tensor(labels))
    rl.backward()
    pl = port(P.to_tensor(ids), labels=P.to_tensor(labels))
    pl.backward()
    assert abs(float(pl) - float(rl)) <= BAR * abs(float(rl))
    worst = max((_rel(p.grad.numpy(), r.grad.numpy()), n) for (n, p), (_, r)
                in zip(port.named_parameters(), ref.named_parameters()))
    assert worst[0] <= BAR, worst
    ref.clear_gradients()
    port.clear_gradients()


def test_five_adamw_steps_match_the_jax_model(pair):
    _, _, state, ids, labels = pair
    paddle_tpu.seed(0)
    models = {"jax": jllama.LlamaForCausalLM(_cfg(paddle_tpu)),
              "port": tllama.LlamaForCausalLM(_cfg(P))}
    for m in models.values():
        m.set_state_dict(state)
    losses = {}
    for name, m in models.items():
        M = paddle_tpu if name == "jax" else P
        opt = M.optimizer.AdamW(1e-3, parameters=m.parameters(),
                                weight_decay=0.01)
        losses[name] = []
        for _ in range(5):
            loss = m(M.to_tensor(ids), labels=M.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[name].append(float(loss))
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=BAR)
    assert losses["port"][-1] < losses["port"][0]
    for (n, p), (_, r) in zip(models["port"].named_parameters(),
                              models["jax"].named_parameters()):
        assert _rel(p.numpy(), r.numpy()) <= BAR, n


def test_params_from_layer_equals_the_jax_packages(pair):
    ref, port, _, _, _ = pair
    want = jgen.params_from_layer(ref)
    got = params_from_layer(port)
    assert set(got) == set(want) and set(got["layers"]) == \
        set(want["layers"])
    for k in ("embedding", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert not any(t.requires_grad for t in (got["embedding"],
                                             *got["layers"].values()))


@pytest.mark.parametrize("compiled", [False, True])
def test_greedy_generate_gives_the_jax_tokens(pair, compiled):
    ref, port, _, ids, _ = pair
    prompt = ids[:, :5]
    want = ref.generate(paddle_tpu.to_tensor(prompt), max_new_tokens=4,
                        compiled=compiled).numpy()
    got = port.generate(P.to_tensor(prompt), max_new_tokens=4,
                        compiled=compiled)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.place.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_rms_norm_matches_the_jax_one(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    out = {}
    for M, mod in ((paddle_tpu, jllama), (P, tllama)):
        norm = mod.LlamaRMSNorm(64, eps=1e-6)
        norm.set_state_dict({"weight": w})
        norm.to(dtype=dtype)
        xt = M.to_tensor(x).astype(dtype)
        xt.stop_gradient = False
        y = norm(xt)
        y.astype("float32").sum().backward()
        out[M.__name__] = [t.astype("float32").numpy() for t in
                           (y, xt.grad, norm.weight.grad)]
    tol = BAR if dtype == "float32" else 2.0 ** -7
    (ry, rdx, rdw), (gy, gdx, gdw) = out["paddle_tpu"], out["paddle_tpu_torch"]
    np.testing.assert_allclose(gy, ry, rtol=tol, atol=tol)
    np.testing.assert_allclose(gdx, rdx, rtol=tol, atol=tol)
    # dw sums 15 rows: in bf16 the two packages round the partial sums in
    # other orders, so dw is held by its norm, as B10's bar holds it
    assert _rel(gdw, rdw) <= tol


def test_recompute_waits_for_its_slice(pair):
    """`recompute` came with fleet.recompute (A10f part 1): the same loss
    and gradients as without it (`test_torch_recompute.py` holds it to the
    JAX model)."""
    _, _, state, ids, labels = pair
    grads = []
    for rc in (True, False):
        m = layer_from_numpy(tllama.LlamaForCausalLM(_cfg(P, recompute=rc)),
                             state)
        loss = m(P.to_tensor(ids), labels=P.to_tensor(labels))
        loss.backward()
        grads.append((float(loss.numpy()),
                      [p.grad.numpy() for p in m.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_array_equal(a, b)


def test_llama2_7b_takes_a_depth_where_the_jax_package_raises():
    """`LlamaConfig.llama2_7b(num_hidden_layers=2)` is the 7B widths at
    depth 2 in the port; the JAX package's passes the depth twice and
    raises TypeError (ROADMAP §C)."""
    cfg = tllama.LlamaConfig.llama2_7b(num_hidden_layers=2)
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.vocab_size) == \
        (4096, 11008, 2, 32, 32000)
    assert tllama.LlamaConfig.llama2_7b().num_hidden_layers == 32
    with pytest.raises(TypeError, match="num_hidden_layers"):
        jllama.LlamaConfig.llama2_7b(num_hidden_layers=2)
