"""The eager slice as a whole on the CPU: `nn.functional.flash_attention`
of the port against the JAX package's, its route by shape, and one eager
2-layer Llama loss (`chip_smoke.eager_llama_loss`, written against a module
argument P) run with P = paddle_tpu and P = paddle_tpu_torch on the same
numpy weights, and on the port's side against
`llama_functional.forward_and_loss`.

Bars, all f32: outputs and every gradient to 1e-5 relative to the
reference's largest magnitude (flash), the loss relative 1e-5 and each
grad leaf ||d|| / ||ref|| <= 1e-5 (Llama)."""

import importlib

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import chip_smoke
import paddle_tpu
import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import LlamaArgs
from paddle_tpu_torch.models import llama_functional as lf

# the module (the package's `flash_attention` attribute is the function)
port_fa = importlib.import_module(
    "paddle_tpu_torch.nn.functional.flash_attention")

BAR = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    paddle.set_device("cpu")
    yield
    port_device._current = prev


@pytest.fixture
def routes(monkeypatch):
    """Counts of calls into B1's wrapper (its plain version on the CPU)
    and into the plain SDPA."""
    seen = {"kernel": 0, "plain": 0}
    fwd, sdpa = fa.flash_fwd_plain, port_fa._sdpa_reference

    def count_fwd(*a, **k):
        seen["kernel"] += 1
        return fwd(*a, **k)

    def count_sdpa(*a, **k):
        seen["plain"] += 1
        return sdpa(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd_plain", count_fwd)
    monkeypatch.setattr(port_fa, "_sdpa_reference", count_sdpa)
    return seen


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= BAR * max(1.0, np.abs(ref).max()), (what, err)


def _attend(P, q, k, v, fn):
    ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out = fn(P, *ts)
    w = np.random.default_rng(3).uniform(-1, 1, out.shape).astype(np.float32)
    (out * P.to_tensor(w)).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in ts]


# (b, s, h, hk, d, causal, route)
FLASH = {
    "kernel_causal": (1, 96, 2, 2, 64, True, "kernel"),
    "kernel_gqa": (2, 64, 4, 2, 128, False, "kernel"),
    "plain_head_dim_16": (1, 32, 2, 1, 16, True, "plain"),
}


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_matches_the_jax_package_and_routes_by_shape(
        case, routes):
    b, s, h, hk, d, causal, route = FLASH[case]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))

    def fn(P, q, k, v):
        return P.nn.functional.flash_attention(q, k, v, causal=causal)[0]

    ref = _attend(paddle_tpu, q, k, v, fn)
    got = _attend(paddle, q, k, v, fn)
    for name, r, g in zip(("out", "dq", "dk", "dv"), ref, got):
        _close(g, r, f"{case} {name}")
    assert routes[route] == 1 and routes[{"kernel": "plain",
                                          "plain": "kernel"}[route]] == 0


def test_mask_and_dropout_take_the_plain_path_and_a_view_the_kernel(
        routes):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 16, 2, 64)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(1, 1, 16, 16)) > 0.3

    def sdpa(P, q, k, v):
        return P.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=P.to_tensor(mask), is_causal=True)

    for r, g in zip(_attend(paddle_tpu, q, k, v, sdpa),
                    _attend(paddle, q, k, v, sdpa)):
        _close(g, r, "masked sdpa")
    assert routes == {"kernel": 0, "plain": 1}
    # a transposed (non-contiguous) query is on B1's gate: the route is by
    # shape and dtype, and the kernel gets a dense copy
    q_hm = paddle.to_tensor(q.transpose(0, 2, 1, 3), stop_gradient=False)
    qt = paddle.transpose(q_hm, [0, 2, 1, 3])
    assert not qt._data.is_contiguous()
    kt, vt = paddle.to_tensor(k), paddle.to_tensor(v)
    out = paddle.nn.functional.flash_attention(qt, kt, vt, causal=True)[0]
    assert routes == {"kernel": 1, "plain": 1}
    ref_q = paddle_tpu.to_tensor(q, stop_gradient=False)
    ref = paddle_tpu.nn.functional.flash_attention(
        ref_q, paddle_tpu.to_tensor(k), paddle_tpu.to_tensor(v),
        causal=True)[0]
    _close(out.numpy(), ref.numpy(), "transposed q")
    out.sum().backward()
    ref.sum().backward()
    _close(q_hm.grad.numpy(), ref_q.grad.numpy().transpose(0, 2, 1, 3),
           "transposed q grad")
    # dropout in training: the plain path, drawn from the framework
    # generator (reproducible from the seed); no dropout outside training
    paddle.seed(11)
    d1 = paddle.nn.functional.flash_attention(kt, kt, vt, dropout=0.5)[0]
    paddle.seed(11)
    d2 = paddle.nn.functional.flash_attention(kt, kt, vt, dropout=0.5)[0]
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    assert routes == {"kernel": 1, "plain": 3}
    ev = paddle.nn.functional.flash_attention(kt, kt, vt, dropout=0.5,
                                              training=False)[0]
    assert routes["kernel"] == 2
    assert not np.allclose(d1.numpy(), ev.numpy())


def test_qkvpacked_matches_the_jax_package(routes):
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 32, 3, 2, 64)).astype(np.float32)
    outs = []
    for P in (paddle_tpu, paddle):
        t = P.to_tensor(qkv, stop_gradient=False)
        out = P.nn.functional.flash_attn_qkvpacked(t, causal=True)[0]
        (out * out).sum().backward()
        outs.append((out.numpy(), t.grad.numpy()))
    for r, g in zip(*outs):
        _close(g, r, "qkvpacked")
    assert routes == {"kernel": 1, "plain": 0}


# --------------------------------------------------------------------------
# the slice as a whole: one eager Llama loss through both packages
# --------------------------------------------------------------------------

TINY = {  # h 64, 4 heads, s 16 (head_dim 16: the plain attention path)
    "h64": LlamaArgs(vocab_size=96, hidden_size=64, intermediate_size=96,
                     num_layers=2, num_heads=4, num_kv_heads=4,
                     rope_theta=10000.0, rms_eps=1e-6),
    # head_dim 64 with GQA: the kernel route on the port's side
    "h128_gqa": LlamaArgs(vocab_size=96, hidden_size=128,
                          intermediate_size=160, num_layers=2, num_heads=2,
                          num_kv_heads=1, rope_theta=10000.0, rms_eps=1e-6),
}


def _weights(args, seed=0):
    rng = np.random.default_rng(seed)
    h, i, L, hd = (args.hidden_size, args.intermediate_size,
                   args.num_layers, args.head_dim)

    def n(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    layers = {"wq": n(L, h, args.num_heads * hd),
              "wk": n(L, h, args.num_kv_heads * hd),
              "wv": n(L, h, args.num_kv_heads * hd),
              "wo": n(L, args.num_heads * hd, h), "w_gate": n(L, h, i),
              "w_up": n(L, h, i), "w_down": n(L, i, h),
              "ln1": 1.0 + n(L, h), "ln2": 1.0 + n(L, h)}
    return {"embedding": n(args.vocab_size, h), "layers": layers,
            "final_norm": 1.0 + n(h), "lm_head": n(h, args.vocab_size)}


def _eager(P, args, weights, ids, labels):
    tree = chip_smoke._tree_map(
        lambda a: P.to_tensor(a, stop_gradient=False), weights)
    loss = chip_smoke.eager_llama_loss(P, tree, P.to_tensor(ids),
                                       P.to_tensor(labels), args)
    loss.backward()
    return float(loss), {p: t.grad.numpy()
                         for p, t in chip_smoke._leaves(tree)}


def _worst(got, ref):
    return max(np.linalg.norm(got[p] - ref[p]) / np.linalg.norm(ref[p])
               for p in ref)


@pytest.mark.parametrize("name", sorted(TINY))
def test_eager_llama_matches_the_jax_package_and_the_functional_path(
        name, routes):
    args = TINY[name]
    weights = _weights(args)
    rng = np.random.default_rng(1)
    ids, labels = (rng.integers(0, args.vocab_size, (2, 16)).astype(np.int64)
                   for _ in range(2))
    ref_loss, ref_grads = _eager(paddle_tpu, args, weights, ids, labels)
    loss, grads = _eager(paddle, args, weights, ids, labels)
    assert abs(loss - ref_loss) / abs(ref_loss) <= BAR, (loss, ref_loss)
    assert _worst(grads, ref_grads) <= BAR
    kernel = args.head_dim in fa.KERNEL_HEAD_DIMS
    assert routes == {"kernel": args.num_layers * kernel,
                      "plain": args.num_layers * (not kernel)}
    # the port's functional path on the same weights
    import torch

    tree = chip_smoke._tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), weights)
    fl = lf.forward_and_loss(tree, torch.from_numpy(ids),
                             torch.from_numpy(labels), args, remat=False)
    fl.backward()
    assert abs(loss - fl.item()) / abs(fl.item()) <= BAR
    assert _worst(grads, {p: t.grad.numpy() for p, t in
                          chip_smoke._leaves(tree)}) <= BAR
