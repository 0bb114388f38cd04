"""Kernel B1 in fp16 and at head_dim 32 (its plain version on the CPU)
against the reference's Pallas forward in interpret mode, the split gate
(B1 takes bf16/fp16/f32 at head_dim 32/64/128; B2/B3 bf16/f32 at 64/128)
and its routes, and a tiny fp16 UNet against the JAX UNet.

  - B1: `flash_fwd` on the same numpy inputs (rounded to the dtype) as
    `_flash_fwd(..., interpret=True)` with 128-row blocks, causal and full,
    GQA. Bars: out per head_dim vector within 2^-6 of that vector's max
    |reference| in fp16 and bf16 (the card's bar for B1; the two round P
    to v's dtype at other running maxima), 1e-5 of max |reference| in f32;
    lse within 1e-5 of max(1, |lse|) (f32 on both sides, from the same
    rounded inputs);
  - the gate: `supports` takes fp16 and head_dim 32, `supports_backward`
    does not; `nn.functional.flash_attention` routes a call that needs a
    gradient on B2/B3's gate (the plain attention for fp16 or head_dim
    32), its output and gradients against `jax.vjp` of the reference's
    attention (f32 at head_dim 32: 1e-5 / 1e-4 of the largest value; fp16:
    2^-6), and a call without one on B1's;
  - `unet_tiny(base_channels=32, num_heads=2)` (level-1 attention at
    head_dim 32) with fp16 parameters and latents: every attention block
    through B1's op in fp16, the output within 2^-6 of max |JAX fp16
    output| of the JAX UNet run in fp16 on the same weights.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
import torch_unet_parity as U
from paddle_tpu import jit as pjit
from paddle_tpu.kernels import flash_attention as ref_fa
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.kernels import flash_attention as fa

fmod = importlib.import_module(
    "paddle_tpu_torch.nn.functional.flash_attention")

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ROW_BAR = {"float16": 2.0 ** -6, "bfloat16": 2.0 ** -6}
F32_BAR, LSE_BAR, GRAD_BAR = 1e-5, 1e-5, 1e-4
SCALE = 0.125

# (b, s, h, hk, d, causal, dtype)
CASES = {
    "fp16_d64_causal_gqa": (1, 256, 4, 2, 64, True, "float16"),
    "fp16_d128_full": (1, 256, 2, 2, 128, False, "float16"),
    "fp16_d32_causal": (1, 256, 4, 4, 32, True, "float16"),
    "bf16_d32_full_gqa": (1, 256, 4, 1, 32, False, "bfloat16"),
    "f32_d32_causal_gqa": (2, 256, 4, 2, 32, True, "float32"),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _inputs(b, s, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return r(b, s, h, d), r(b, s, hk, d), r(b, s, hk, d)


def _round(x, dtype):
    """x rounded to `dtype` (numpy f32 holding the rounded values)."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _bhsd(x, dtype):
    jdt = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32}[dtype]
    return jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)


def _row_ratio(got, ref, bar):
    """Worst head_dim vector's max |got - ref| over bar * its max |ref|
    (floored at 1e-5 of the tensor's max |ref|)."""
    d = np.abs(got - ref).max(-1)
    top = np.abs(ref).max(-1)
    return float((d / np.maximum(bar * top, 1e-5 * np.abs(ref).max())).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_b1_plain_matches_pallas_interpret(case):
    b, s, h, hk, d, causal, dtype = CASES[case]
    q, k, v = (_round(x, dtype) for x in _inputs(b, s, h, hk, d))
    o_ref, lse_ref = ref_fa._flash_fwd(
        _bhsd(q, dtype), _bhsd(k, dtype), _bhsd(v, dtype), causal, SCALE,
        128, 128, interpret=True)
    o_ref = np.swapaxes(np.asarray(o_ref.astype(jnp.float32)), 1, 2)
    lse_ref = np.asarray(lse_ref)[..., 0]
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    assert fa.supports(tq, tk, tv)
    out, lse = fa.flash_fwd(tq, tk, tv, causal, SCALE)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    got = out.float().numpy()
    if dtype == "float32":
        assert np.abs(got - o_ref).max() <= F32_BAR * np.abs(o_ref).max()
    else:
        assert _row_ratio(got, o_ref, ROW_BAR[dtype]) <= 1.0
    assert (np.abs(lse.numpy() - lse_ref)
            <= LSE_BAR * np.maximum(1.0, np.abs(lse_ref))).all()


def test_the_split_gate():
    x16 = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    x32 = torch.zeros(1, 8, 2, 32)
    bf = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    for x in (x16, x32, x32.bfloat16(), x32.half(), bf):
        assert fa.supports(x, x, x)
    assert fa.supports_backward(bf, bf, bf)
    for x in (x16, x32, x32.bfloat16()):
        assert not fa.supports_backward(x, x, x)
    for bad in (torch.zeros(1, 8, 2, 48), torch.zeros(1, 8, 2, 64,
                                                      dtype=torch.float64)):
        assert not fa.supports(bad, bad, bad)
    with pytest.raises(TypeError, match="B2/B3 takes bfloat16 or float32"):
        fa._check_kernel(x16, x16, x16, backward=True)
    with pytest.raises(ValueError, match=r"B2/B3 takes head_dim in \(64, "):
        fa._check_kernel(x32, x32, x32, backward=True)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        x = torch.zeros(1, 8, 2, 64, dtype=torch.float64)
        fa._check_kernel(x, x, x)
    fa._check_kernel(x16, x16, x16)
    fa._check_kernel(x32, x32, x32)


@pytest.fixture
def routes(monkeypatch):
    seen = {"kernel": 0, "plain": 0}
    kernel, plain = fa.flash_attention_fwd, fmod._sdpa_reference

    def k(*a, **kw):
        seen["kernel"] += 1
        return kernel(*a, **kw)

    def p(*a, **kw):
        seen["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", k)
    monkeypatch.setattr(fmod, "_sdpa_reference", p)
    return seen


@pytest.mark.parametrize("dtype,d", [("float32", 32), ("float16", 64),
                                     ("float16", 32)])
def test_grad_calls_route_plain_and_match_the_jax_vjp(dtype, d, routes):
    b, s, h, hk = 1, 128, 2, 1
    q, k, v = (_round(x, dtype) for x in _inputs(b, s, h, hk, d, seed=1))
    g = _round(np.random.default_rng(2).standard_normal(
        (b, s, h, d)).astype(np.float32), dtype)
    jdt = jnp.float16 if dtype == "float16" else jnp.float32
    out_r, vjp = jax.vjp(
        lambda q, k, v: ref_fa._flash_attention(q, k, v, True, 1 / np.sqrt(d),
                                                True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_r = vjp(jnp.asarray(g, jdt))
    ts = [P.to_tensor(x).astype(dtype) for x in (q, k, v)]
    for t in ts:
        t.stop_gradient = False
    out, _ = P.nn.functional.flash_attention(*ts, causal=True)
    assert routes == {"kernel": 0, "plain": 1}
    (out * P.to_tensor(g).astype(dtype)).sum().backward()
    pairs = [(out, out_r)] + list(zip((t.grad for t in ts), grads_r))
    for i, (got, want) in enumerate(pairs):
        got = got.astype("float32").numpy()
        want = np.asarray(want.astype(jnp.float32))
        bar = (2.0 ** -6 if dtype == "float16"
               else F32_BAR if i == 0 else GRAD_BAR)
        assert np.abs(got - want).max() <= bar * np.abs(want).max(), i
    # without a gradient the same call takes B1 (its plain version here)
    with P.no_grad():
        P.nn.functional.flash_attention(*ts, causal=True)
    assert routes == {"kernel": 1, "plain": 1}


def test_fp16_unet_tiny_at_head_dim_32_matches_the_jax_unet():
    kw = {"base_channels": 32, "num_heads": 2}
    ref, port, _ = U.build(**kw)
    x, t = U.inputs(2)
    pure_fn, params, buffers = pjit.functionalize(ref)

    def fwd(params, x, t):
        return pure_fn(params, buffers, jax.random.key(0), x, t)[0]

    p16 = {n: a.astype(jnp.float16) for n, a in params.items()}
    want = np.asarray(jax.jit(fwd)(p16, jnp.asarray(x, jnp.float16),
                                   jnp.asarray(t)).astype(jnp.float32))
    for p in port.parameters():
        p._data = p._data.to(torch.float16)
    calls = []
    op = fa._flash_fwd_op
    fa._flash_fwd_op = lambda *a: calls.append(
        (a[0].dtype, a[0].shape[-1])) or op(*a)
    try:
        with P.no_grad():
            out = port(P.to_tensor(x).astype("float16"), P.to_tensor(t))
    finally:
        fa._flash_fwd_op = op
    # level 1: one attention block down, two up, one in the middle
    assert calls == [(torch.float16, 32)] * 4
    assert out.dtype == torch.float16
    got = out.astype("float32").numpy()
    assert got.shape == want.shape == (2, 4, U.SIZE, U.SIZE)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
