"""The port's layer-built GPT and BERT (`models/gpt.py`, `models/bert.py`
over the port's nn.Layers) against the JAX package's on the CPU, at
`gpt_tiny()` and `bert_tiny()` with the JAX models' weights carried across
(`models.weights.layer_from_numpy`): state-dict names, shapes and order;
the forward, the loss and every parameter's gradient (f32 rtol 1e-5 /
atol 1e-6), BERT with and without `attention_mask` and `token_type_ids`
and its MLM-only loss, GPT's tied head (one gradient for the embedding,
both uses summed); `gpt_params_from_layer` leaf by leaf; greedy
`gpt_generate` from a layer model; the merged configs; the pipeline
descriptors that wait for A9."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.weights import layer_from_numpy

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B, S = 2, 16


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(family):
    """(JAX model, port model with its weights, the state)."""
    prev = port_device._current
    P.set_device("cpu")
    paddle_tpu.seed(0)
    if family == "gpt":
        ref, port = jgpt.gpt_tiny(), tgpt.gpt_tiny()
    else:
        ref, port = jbert.bert_tiny(), tbert.bert_tiny()
    state = _state(ref)
    layer_from_numpy(port, state)
    port_device._current = prev
    return ref, port, state


@pytest.fixture(scope="module")
def gpt():
    return _pair("gpt")


@pytest.fixture(scope="module")
def bert():
    return _pair("bert")


def _inputs(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int64)
    tt = rng.integers(0, 2, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 11:] = 0
    mlm = np.where(rng.random((B, S)) < 0.3, ids, -100).astype(np.int64)
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, tt, mask, mlm, nsp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _grads_match(port, ref):
    for (n, p), (m, r) in zip(port.named_parameters(),
                              ref.named_parameters()):
        assert n == m
        if r.grad is None:
            assert p.grad is None, n
            continue
        np.testing.assert_allclose(p.grad.numpy(), r.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    port.clear_gradients()
    ref.clear_gradients()


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_names_shapes_and_order_equal_the_jax_models(family, gpt, bert):
    ref, port, state = gpt if family == "gpt" else bert
    assert [(k, list(v.shape)) for k, v in port.state_dict().items()] == \
        [(k, list(v.shape)) for k, v in ref.state_dict().items()]
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert len(state) == (4 * 16 + 4 if family == "gpt" else
                          2 * 16 + 5 + 2 + 6 + 2)


def test_gpt_logits_loss_and_every_gradient(gpt):
    ref, port, _ = gpt
    ids = _inputs(512)[0]
    _close(port(P.to_tensor(ids)).numpy(),
           ref(paddle_tpu.to_tensor(ids)).numpy())
    rl = ref(paddle_tpu.to_tensor(ids), labels=paddle_tpu.to_tensor(ids))
    pl = port(P.to_tensor(ids), labels=P.to_tensor(ids))
    _close(float(pl), float(rl))
    rl.backward()
    pl.backward()
    _grads_match(port, ref)


def test_gpt_tied_head_has_one_gradient_summing_both_uses(gpt):
    """The embedding is one parameter: its gradient is the lookup's plus
    the head's, which the two parts of the graph give on their own."""
    _, port, _ = gpt
    ids = _inputs(512, seed=1)[0]
    emb = port.gpt.embeddings.word_embeddings.weight
    names = [n for n, p in port.named_parameters() if p is emb]
    assert names == ["gpt.embeddings.word_embeddings.weight"]
    port(P.to_tensor(ids), labels=P.to_tensor(ids)).backward()
    total = emb.grad.numpy().copy()
    port.clear_gradients()
    # the head's share alone: the hidden states detached from the lookup
    h = port.gpt(P.to_tensor(ids)).detach()
    logits = P.matmul(h, emb, transpose_y=True)
    tgpt.GPTPretrainingLoss()(logits, P.to_tensor(ids)).backward()
    head = emb.grad.numpy().copy()
    port.clear_gradients()
    lookup = total - head
    assert np.abs(head).max() > 0 and np.abs(lookup).max() > 0
    # the lookup's share touches only the rows of the ids
    untouched = np.setdiff1d(np.arange(512), ids)
    np.testing.assert_allclose(lookup[untouched], 0.0, atol=1e-7)


@pytest.mark.parametrize("with_mask,with_types", [
    (False, False), (True, False), (False, True), (True, True)])
def test_bert_outputs_loss_and_every_gradient(bert, with_mask, with_types):
    ref, port, _ = bert
    ids, tt, mask, mlm, nsp = _inputs(1024)
    outs = {}
    for name, M, mod, model in (("port", P, tbert, port),
                                ("jax", paddle_tpu, jbert, ref)):
        args = [M.to_tensor(ids), M.to_tensor(tt) if with_types else None,
                M.to_tensor(mask) if with_mask else None]
        h, pooled = model.bert(*args)
        out = model(*args)
        loss = mod.BertPretrainingLoss()(out, M.to_tensor(mlm),
                                         M.to_tensor(nsp))
        loss.backward()
        outs[name] = (h.numpy(), pooled.numpy(), out[0].numpy(),
                      out[1].numpy(), float(loss))
    for got, want in zip(outs["port"], outs["jax"]):
        _close(got, want)
    _grads_match(port, ref)


def test_bert_mlm_only_loss_and_its_gradient(bert):
    ref, port, _ = bert
    ids, _, _, mlm, _ = _inputs(1024, seed=2)
    losses = []
    for M, mod, model in ((P, tbert, port), (paddle_tpu, jbert, ref)):
        mlm_logits, _ = model(M.to_tensor(ids))
        loss = mod.BertMLMLoss()(mlm_logits, M.to_tensor(mlm))
        loss.backward()
        losses.append(float(loss))
        # without nsp labels the pretraining loss is the MLM loss alone
        assert float(mod.BertPretrainingLoss()(
            model(M.to_tensor(ids)), M.to_tensor(mlm))) == pytest.approx(
                losses[-1], rel=1e-6)
    _close(*losses)
    _grads_match(port, ref)


def test_gpt_params_from_layer_equals_the_jax_packages(gpt):
    ref, port, _ = gpt
    want = jgen.gpt_params_from_layer(ref)
    got = tgpt.gpt_params_from_layer(port)
    assert set(got) == set(want) and set(got["layers"]) == \
        set(want["layers"]) == set(tgpt.GPT_LAYER_KEYS)
    for k in ("word_emb", "pos_emb", "lnf_w", "lnf_b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert not any(t.requires_grad for t in got["layers"].values())
    # the model itself works as the argument too
    assert tgpt.gpt_params_from_layer(port.gpt)["word_emb"] is not None


def test_greedy_gpt_generate_from_a_layer_model_gives_the_jax_tokens(gpt):
    ref, port, _ = gpt
    prompt = _inputs(512, seed=3)[0][:, :6].astype(np.int32)
    jcfg = ref.gpt.cfg
    want = np.asarray(jgen.gpt_generate(
        jgen.gpt_params_from_layer(ref), jgen.GPTGenArgs.from_config(jcfg),
        prompt, max_new_tokens=6))
    args = tgpt.GPTGenArgs.from_config(port.gpt.cfg)
    model = tgpt.Gpt(args, tgpt.gpt_params_from_layer(port), device="cpu")
    got = tgpt.gpt_generate(model, prompt, max_new_tokens=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # and the layer model's own argmax continues the prompt the same way
    with P.no_grad():
        port.eval()
        logits = port(P.to_tensor(want[:, :-1].astype(np.int64)))
        port.train()
    np.testing.assert_array_equal(
        logits.numpy()[:, 5:].argmax(-1), want[:, 6:])


def test_the_merged_configs_take_every_callers_keywords():
    """One config class a family, with the JAX package's fields, defaults
    and keywords; the functional models' callers still build them."""
    for tmod, jmod, cls in ((tgpt, jgpt, "GPTConfig"),
                            (tbert, jbert, "BertConfig")):
        port_cfg, ref_cfg = getattr(tmod, cls)(), getattr(jmod, cls)()
        assert vars(port_cfg) == vars(ref_cfg)
    g = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=1024, layer_norm_eps=1e-5)
    assert tgpt.GPTGenArgs.from_config(g) == tgpt.GPTGenArgs(
        64, 32, 2, 4, 1024, 1e-5, 128)
    b = tbert.BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=16, type_vocab_size=2,
                         layer_norm_eps=1e-12)
    model = tbert.Bert(b, device="cpu")
    h, pooled = model(torch.zeros(1, 4, dtype=torch.long))
    assert tuple(h.shape) == (1, 4, 16) and tuple(pooled.shape) == (1, 16)


@pytest.mark.parametrize("fn,cfg", [("gpt", "GPTConfig"),
                                    ("bert", "BertConfig")])
def test_pipeline_descs_wait_for_a9(fn, cfg):
    mod = tgpt if fn == "gpt" else tbert
    with pytest.raises(NotImplementedError, match="A9"):
        getattr(mod, f"{fn}_pipeline_descs")(getattr(mod, cfg)())
