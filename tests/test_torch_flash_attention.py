"""Kernels B1-B3 of the PyTorch port, their plain versions on the CPU,
against the reference's Pallas flash attention run in interpret mode.

Inputs come from numpy seeds. The kernel-level cases call the reference's
`_flash_fwd` / `_flash_bwd` with 128-row blocks (the blocks its causal
skipping is defined over) in [B, H, S, D], and the port's `flash_fwd` /
`flash_bwd` in the public [B, S, H, D] layout; the backward of both is fed
the reference forward's out and lse. The public level compares
`flash_attention_fwd` and `flash_attention_with_lse` (with a nonzero lse
cotangent) under autograd against the reference's `jax.vjp`.

Bars, all f32 and relative to max |reference|: out and lse 1e-5, grads
1e-4 (the two sum in different orders; the grads sum over two products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as ref_fa
from paddle_tpu_torch.kernels import flash_attention as fa

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

FWD_BAR, GRAD_BAR = 1e-5, 1e-4
SCALE = 0.125

# (b, sq, sk, h, hk, d, causal)
CASES = {
    "causal": (1, 256, 256, 2, 2, 64, True),
    "full": (2, 256, 256, 2, 2, 32, False),
    "gqa": (1, 256, 256, 4, 2, 64, True),
    "cross_length": (1, 128, 256, 2, 2, 32, True),
    "sq_gt_sk": (1, 256, 128, 2, 1, 64, True),
}


def _inputs(b, sq, sk, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return r(b, sq, h, d), r(b, sk, hk, d), r(b, sk, hk, d), r(b, sq, h, d)


def _bhsd(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


def _close(got, ref, bar, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= bar * max(1.0, np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_pallas(case):
    b, sq, sk, h, hk, d, causal = CASES[case]
    q, k, v, do = _inputs(b, sq, sk, h, hk, d)
    o_ref, lse_ref = ref_fa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal,
                                       SCALE, 128, 128, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_fwd(tq, tk, tv, causal, SCALE)
    _close(out, np.swapaxes(np.asarray(o_ref), 1, 2), FWD_BAR, "out")
    lse_ref = np.array(lse_ref)[..., 0]
    masked = lse_ref <= -1e29
    assert ((lse.numpy() <= -1e29) == masked).all()
    assert masked.any() == (case == "sq_gt_sk")
    _close(np.where(masked, 0, lse.numpy()), np.where(masked, 0, lse_ref),
           FWD_BAR, "lse")
    if masked.any():                 # rows that see no key: out 0
        rows = masked[0, 0]
        assert (out.numpy()[:, rows] == 0).all()

    # the backward of both from the reference forward's out and lse
    dq_r, dk_r, dv_r = ref_fa._flash_bwd(
        _bhsd(q), _bhsd(k), _bhsd(v), o_ref, jnp.asarray(lse_ref)[..., None],
        _bhsd(do), causal, SCALE, 128, 128, interpret=True)
    o_t = torch.from_numpy(np.swapaxes(np.asarray(o_ref), 1, 2).copy())
    dq, dk, dv = fa.flash_bwd(tq, tk, tv, o_t, torch.from_numpy(lse_ref),
                              tdo, causal, SCALE)
    assert dk.dtype == dv.dtype == torch.float32
    for name, got, ref in (("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
        _close(got, np.swapaxes(np.asarray(ref), 1, 2), GRAD_BAR, name)


@pytest.mark.parametrize("case", ["causal", "gqa", "full"])
def test_autograd_matches_reference_vjp(case):
    b, sq, sk, h, hk, d, causal = CASES[case]
    q, k, v, do = _inputs(b, sq, sk, h, hk, d, seed=1)
    out_r, vjp = jax.vjp(
        lambda q, k, v: ref_fa._flash_attention(q, k, v, causal, SCALE, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_r = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_fwd(tq, tk, tv, causal=causal, scale=SCALE)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), out_r, FWD_BAR, "out")
    for name, t, ref in zip("qkv", (tq, tk, tv), grads_r):
        _close(t.grad, ref, GRAD_BAR, f"d{name}")


def test_with_lse_folds_the_lse_cotangent():
    b, sq, sk, h, hk, d, causal = CASES["gqa"]
    q, k, v, do = _inputs(b, sq, sk, h, hk, d, seed=2)
    g_lse = np.random.default_rng(3).standard_normal(
        (b, h, sq)).astype(np.float32)
    (out_r, lse_r), vjp = jax.vjp(
        lambda q, k, v: ref_fa.flash_attention_with_lse(q, k, v, causal,
                                                        SCALE, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_r = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                           scale=SCALE)
    torch.autograd.backward((out, lse), (torch.from_numpy(do),
                                         torch.from_numpy(g_lse)))
    _close(out.detach(), out_r, FWD_BAR, "out")
    _close(lse.detach(), lse_r, FWD_BAR, "lse")
    for name, t, ref in zip("qkv", (tq, tk, tv), grads_r):
        _close(t.grad, ref, GRAD_BAR, f"d{name}")
    # the lse cotangent moves the grads: it is not dropped
    tq2 = tq.detach().clone().requires_grad_()
    fa.flash_attention_fwd(tq2, tk.detach(), tv.detach(), causal=causal,
                           scale=SCALE).backward(torch.from_numpy(do))
    assert not torch.allclose(tq2.grad, tq.grad)


def test_wrappers_count_no_launch_on_cpu_and_check_shapes():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 4, 2, 8))
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, True)
    fa.flash_bwd(q, k, v, out, lse, do, True)
    assert fa.launches == before
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, k[:, :, :1].expand(1, 16, 3, 8), v[:, :, :1]
                     .expand(1, 16, 3, 8))
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_fwd(q, k[..., :4], v[..., :4])


@pytest.mark.parametrize("shape", [(1, 256, 256, 4, 2, 64),
                                   (2, 200, 200, 8, 2, 128)])
def test_card_bar_rejects_planted_faults(shape):
    """chip_smoke.py's B1-B3 bar (each head_dim vector within 2^-6 of its
    own max |plain|) passes a one-ulp bf16 change and fails each planted
    fault: a 1% scale error, the last key tile's V read as zeros, dS
    without delta, dk without its GQA sum."""
    import chip_smoke as cs

    b, sq, sk, h, hk, d = shape
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(b, sq, sk, h, hk, d, seed=3))
    out, _ = fa.flash_fwd_plain(q, k, v, True)
    nudged = (out.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    assert cs.flash_row_ratio(torch, nudged, out, cs.TOL["bfloat16"]) <= 1.0
    faults = cs.planted_flash_faults(torch, fa, q, k, v, do, True)
    assert [name for _, name, _, _ in faults] == ["out", "out", "dq", "dk"]
    for fault, _, wrong, right in faults:
        ratio = cs.flash_row_ratio(torch, wrong, right, cs.TOL["bfloat16"])
        assert ratio > 1.0, fault
