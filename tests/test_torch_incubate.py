"""The port's `incubate.nn` (`paddle_tpu_torch/incubate/nn`) against the JAX
package's on the CPU, f32, inputs and weights from a numpy seed: every
fused function and the three fused layers, forward and the gradients of
every input (sum of squares of the outputs), each held to 1e-5 of the
largest value. The attention layers run at head_dim 64 and without mask
or dropout, B1's gate (its plain versions on the CPU), and with a mask,
the plain path; `fused_rms_norm` also in bf16."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.incubate import nn as jinc
from paddle_tpu_torch import incubate
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.incubate import nn as pinc

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


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1.0)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _leaves(x)]
    return [] if out is None else [out]


def _run(M, fn, arrays, grads=True, constants=()):
    ts = [M.to_tensor(a) for a in arrays]
    if grads:
        for i, t in enumerate(ts):
            if t.dtype in (M.float32,) and i not in constants:
                t.stop_gradient = False
    out = _leaves(fn(M, *ts))
    vals = [o.astype("float32").numpy() for o in out]
    if grads:
        loss = None
        for o in out:
            if not o.stop_gradient:
                term = (o.astype("float32") * o.astype("float32")).sum()
                loss = term if loss is None else loss + term
        loss.backward()
    gs = [t.grad.numpy() if (grads and t.grad is not None) else None
          for t in ts]
    return vals, gs


def _check(fn, arrays, grads=True, bar=BAR, constants=()):
    """fn on both packages; `constants` index inputs that take no gradient
    (a mask, given to the op as data)."""
    (jv, jg), (pv, pg) = (_run(M, fn, arrays, grads, constants)
                          for M in (J, P))
    assert len(pv) == len(jv)
    for a, b in zip(pv, jv):
        _close(a, b, bar)
    for a, b in zip(pg, jg):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, bar)


def _F(M):
    return (jinc if M is J else pinc).functional


def _rng(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype("float32")


def test_the_namespace():
    assert P.incubate is incubate and incubate.nn is pinc
    assert sorted(pinc.__all__) == sorted(jinc.__all__)
    assert sorted(pinc.functional.__all__) == sorted(jinc.functional.__all__)


def test_swiglu_and_fused_linear():
    r = _rng(0)
    _check(lambda M, a: _F(M).swiglu(a), [_n(r, 3, 8)])
    _check(lambda M, a, b: _F(M).swiglu(a, b), [_n(r, 3, 4), _n(r, 3, 4)])
    _check(lambda M, a, w, b: _F(M).fused_linear(a, w, b),
           [_n(r, 2, 3, 8), _n(r, 8, 5), _n(r, 5)])
    _check(lambda M, a, w: _F(M).fused_linear(a, w, transpose_weight=True),
           [_n(r, 4, 8), _n(r, 5, 8)])


def test_fused_rms_norm_f32_and_bf16():
    r = _rng(1)
    x, w, b = _n(r, 2, 5, 64), _n(r, 64, scale=0.5) + 1, _n(r, 64)
    _check(lambda M, a, ww: _F(M).fused_rms_norm(a, ww, epsilon=1e-5),
           [x, w])
    _check(lambda M, a, ww, bb: _F(M).fused_rms_norm(a, ww, bb), [x, w, b])
    _check(lambda M, a, ww: _F(M).fused_rms_norm(a.astype("bfloat16"),
                                                 ww.astype("bfloat16")),
           [x, w], grads=False, bar=2.0 ** -7)


def test_rotary_dropout_add_and_the_layer_norms():
    r = _rng(2)
    q, k, v = _n(r, 2, 6, 2, 8), _n(r, 2, 6, 2, 8), _n(r, 2, 6, 2, 8)
    _check(lambda M, a, b, c: _F(M).fused_rotary_position_embedding(
        a, b, c)[:2], [q, k, v])
    _check(lambda M, a: _F(M).fused_rotary_position_embedding(a)[0], [q])
    ang = _n(r, 6, 8)
    _check(lambda M, a, b, s, c: _F(M).fused_rotary_position_embedding(
        a, b, sin=s, cos=c)[:2], [q, k, np.sin(ang), np.cos(ang)])
    x, y = _n(r, 3, 4, 16), _n(r, 3, 4, 16)
    _check(lambda M, a, b: _F(M).fused_dropout_add(a, b, p=0.0), [x, y])
    _check(lambda M, a, b: _F(M).fused_dropout_add(a, b, training=False,
                                                   mode="downscale_in_infer"),
           [x, y])
    g, bb, bias = _n(r, 16) + 1, _n(r, 16), _n(r, 16)
    _check(lambda M, a, res, b0, s, sh:
           _F(M).fused_bias_dropout_residual_layer_norm(
               a, res, b0, s, sh, dropout_rate=0.0), [x, y, bias, g, bb])
    _check(lambda M, a, s, sh, b0, res: _F(M).fused_layer_norm(
        a, s, sh, begin_norm_axis=2, bias=b0, residual=res),
        [x, g, bb, bias, y])
    _check(lambda M, a, s, sh: _F(M).fused_layer_norm(a, s, sh,
                                                     begin_norm_axis=1),
           [x, _n(r, 64) + 1, _n(r, 64)])


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_multi_head_attention_on_and_off_the_gate(pre_ln):
    r = _rng(3)
    b, s, nh, hd = 2, 8, 2, 64
    h = nh * hd
    args = [_n(r, b, s, h), _n(r, 3, nh, hd, h, scale=0.05),
            _n(r, h, h, scale=0.05), _n(r, h) + 1, _n(r, h), _n(r, h) + 1,
            _n(r, h), _n(r, 3 * h, scale=0.1), _n(r, h, scale=0.1)]

    def fn(M, x, qkv, lw, pls, plb, ls, lb, qb, lbias, mask=None):
        return _F(M).fused_multi_head_attention(
            x, qkv, lw, pre_layer_norm=pre_ln, pre_ln_scale=pls,
            pre_ln_bias=plb, ln_scale=ls, ln_bias=lb, qkv_bias=qb,
            linear_bias=lbias, attn_mask=mask, dropout_rate=0.0,
            attn_dropout_rate=0.0)

    _check(fn, args)
    mask = np.where(np.tril(np.ones((s, s))) > 0, 0.0, -1e9).astype(
        "float32")[None, None]
    _check(lambda M, *a: fn(M, *a[:-1], mask=a[-1]), args + [mask],
           constants=(len(args),))


@pytest.mark.parametrize("act,pre_ln", [("relu", False), ("gelu", True)])
def test_fused_feedforward(act, pre_ln):
    r = _rng(4)
    args = [_n(r, 2, 5, 16), _n(r, 16, 32, scale=0.2), _n(r, 32, 16,
                                                          scale=0.2),
            _n(r, 32), _n(r, 16), _n(r, 16) + 1, _n(r, 16), _n(r, 16) + 1,
            _n(r, 16)]
    _check(lambda M, x, w1, w2, b1, b2, s1, c1, s2, c2:
           _F(M).fused_feedforward(
               x, w1, w2, b1, b2, s1, c1, s2, c2, dropout1_rate=0.0,
               dropout2_rate=0.0, activation=act, pre_layer_norm=pre_ln),
           args)


def test_masked_multihead_attention_with_rotary_and_mask():
    r = _rng(5)
    b, h, d, L = 2, 2, 8, 6
    cache = _n(r, 2, b, h, L, d)
    x = _n(r, b, 3 * h * d)
    ang = _n(r, L, d)
    mask = np.where(r.random((b, L)) > 0.3, 0.0, -1e4).astype("float32")
    for t in (0, 3):
        _check(lambda M, xx, c: _F(M).masked_multihead_attention(
            xx, c, seq_len=t), [x, cache], grads=False)
        _check(lambda M, xx, c, cs, sn, m: _F(M).masked_multihead_attention(
            xx, c, src_mask=m, seq_len=t, rotary_embs=(cs, sn)),
            [x, cache, np.cos(ang), np.sin(ang), mask], grads=False)
    with pytest.raises(NotImplementedError, match="beam"):
        pinc.functional.masked_multihead_attention(
            P.to_tensor(x), P.to_tensor(cache), beam_width=2)


def test_fused_moe():
    r = _rng(6)
    _check(lambda M, x, g, w1, w2: _F(M).fused_moe(x, g, w1, w2, k=2),
           [_n(r, 2, 3, 8), _n(r, 8, 4), _n(r, 4, 8, 16, scale=0.3),
            _n(r, 4, 16, 8, scale=0.3)])


def _layer_pair(make):
    J.seed(0)
    ref = make(J, jinc)
    port = make(P, pinc)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    assert list(port.state_dict()) == list(ref.state_dict())
    return ref, port


@pytest.mark.parametrize("layer,normalize_before", [
    ("mha", False), ("mha", True), ("ffn", False), ("encoder", False),
    ("encoder", True)])
def test_the_fused_layers_forward_and_backward(layer, normalize_before):
    makers = {
        "mha": lambda M, I: I.FusedMultiHeadAttention(
            128, 2, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=normalize_before),
        "ffn": lambda M, I: I.FusedFeedForward(
            128, 256, dropout_rate=0.0, activation="gelu",
            normalize_before=normalize_before),
        "encoder": lambda M, I: I.FusedTransformerEncoderLayer(
            128, 2, 256, dropout_rate=0.0, normalize_before=normalize_before),
    }
    ref, port = _layer_pair(makers[layer])
    x = _n(_rng(7), 2, 8, 128)
    outs = {}
    for M, m in ((J, ref), (P, port)):
        xt = M.to_tensor(x)
        xt.stop_gradient = False
        y = m(xt)
        (y * y).sum().backward()
        outs[M] = (y.numpy(), xt.grad.numpy(),
                   {k: p.grad.numpy() for k, p in m.named_parameters()
                    if p.grad is not None})
    (jy, jgx, jgp), (py, pgx, pgp) = outs[J], outs[P]
    _close(py, jy)
    _close(pgx, jgx)
    assert set(pgp) == set(jgp)
    for k in jgp:
        _close(pgp[k], jgp[k])
