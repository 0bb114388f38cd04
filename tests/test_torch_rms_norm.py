"""Fused RMSNorm in the port (kernels B9/B10, `kernels/rms_norm.py`) against
the JAX package, on the CPU.

  - B9's plain version against the Pallas `_fwd_call` in interpret mode
    (as tests/test_rms_norm_kernel.py runs it): f32 at 1e-6; bf16 within
    one bf16 unit in the last place of |y|, the one rounding by design (the
    port rounds twice, as the composite it replaces, rnd(rnd(x r) w); the
    Pallas kernel once, rnd(x r w)); r at 1e-6;
  - B10's plain version against `_bwd_call` in interpret mode, f32 at
    1e-5, over rows that cross several of its 256-row blocks (dw
    accumulated across grid steps);
  - the custom operator's gradients: an f64 gradcheck on the plain route,
    and f32 against autograd of the composite at 1e-6;
  - B9/B10 calls per remat mode in a tiny train step (B9: 2L + 1 in the
    forward, and again in backward for each norm of a recomputed layer;
    B10: 2L + 1);
  - the kernels' gate (what a CUDA tensor must be) and the wrapper's
    shape checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import rms_norm as jrn
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.models.llama import LlamaConfig
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.models import LlamaArgs, tree_from_numpy
from paddle_tpu_torch.models import llama_functional as lf

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

EPS = 1e-6
# (rows, H): tests/test_rms_norm_kernel.py's shapes flattened, and row
# counts past the Pallas kernel's 256-row block
SHAPES = [(8 * 16, 256), (32, 128), (2 * 8, 384), (512, 128), (768, 256)]


def _inputs(rows, h, seed=0):
    rng = np.random.default_rng(seed)
    # rows of different scales, some small enough for eps to matter
    scale = 10.0 ** rng.uniform(-3, 1, size=(rows, 1))
    x = (rng.standard_normal((rows, h)) * scale).astype(np.float32)
    w = (rng.standard_normal(h) * 0.5 + 1.0).astype(np.float32)
    g = rng.standard_normal((rows, h)).astype(np.float32)
    return x, w, g


def _bf16_ulp(y):
    """The bf16 unit in the last place of each |y| (y f32 holding bf16
    values): 2^(floor(log2 |y|) - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(y), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("rows,h", SHAPES)
def test_plain_forward_matches_pallas_f32(rows, h):
    x, w, _ = _inputs(rows, h)
    y_ref, r_ref = jrn._fwd_call(jnp.asarray(x), jnp.asarray(w), EPS, True)
    y, r = rn.rms_norm_fwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-6,
                               atol=1e-6 * np.abs(y_ref).max())
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref)[:, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("rows,h", SHAPES)
def test_plain_forward_matches_pallas_bf16(rows, h):
    x, w, _ = _inputs(rows, h, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    y_ref, _ = jrn._fwd_call(xb, wb, EPS, True)
    y_ref = np.asarray(y_ref, np.float32)
    y, _ = rn.rms_norm_fwd_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(),
        torch.from_numpy(np.asarray(wb, np.float32)).bfloat16(), EPS)
    assert y.dtype == torch.bfloat16
    diff = np.abs(y.float().numpy() - y_ref)
    assert (diff <= _bf16_ulp(y_ref)).all(), diff.max()
    # the two roundings differ somewhere: the difference is the rounding
    assert (diff > 0).any()


@pytest.mark.parametrize("rows,h", [(1024, 128), (768, 256), (300 * 8, 64)])
def test_plain_backward_matches_pallas(rows, h):
    x, w, g = _inputs(rows, h, seed=2)
    _, r_ref = jrn._fwd_call(jnp.asarray(x), jnp.asarray(w), EPS, True)
    dx_ref, dw_ref = jrn._bwd_call(jnp.asarray(x), jnp.asarray(w), r_ref,
                                   jnp.asarray(g), True)
    dx, dw = rn.rms_norm_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(np.array(r_ref)[:, 0]), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-5,
                               atol=1e-5 * np.abs(dx_ref).max())
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), rtol=1e-5,
                               atol=1e-5 * np.abs(dw_ref).max())


def test_operator_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 3, 16, generator=gen, dtype=torch.float64)
         * torch.tensor([[[0.01]], [[3.0]]], dtype=torch.float64)
         ).requires_grad_()
    w = (torch.randn(16, generator=gen, dtype=torch.float64) + 1
         ).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: rn.rms_norm(a, b, EPS),
                                    (x, w))


def _composite(x, w):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + EPS)).to(x.dtype) * w


def test_operator_grads_match_composite_f32():
    x, w, g = (torch.from_numpy(a) for a in _inputs(48, 64, seed=3))
    x = x.reshape(4, 12, 64)
    g = g.reshape(4, 12, 64)
    grads = []
    for fn in (lambda a, b: rn.rms_norm(a, b, EPS), _composite):
        a = x.clone().requires_grad_()
        b = w.clone().requires_grad_()
        y = fn(a, b)
        (y * g).sum().backward()
        grads.append((y.detach(), a.grad, b.grad))
    (y, dx, dw), (y_r, dx_r, dw_r) = grads
    assert torch.equal(y, y_r)
    torch.testing.assert_close(dx, dx_r, rtol=1e-6,
                               atol=1e-6 * dx_r.abs().max())
    torch.testing.assert_close(dw, dw_r, rtol=1e-6,
                               atol=1e-6 * dw_r.abs().max())


def test_without_grad_the_wrapper_runs_alone():
    x, w, _ = (torch.from_numpy(a) for a in _inputs(6, 32))
    with torch.no_grad():
        y = rn.rms_norm(x.reshape(2, 3, 32), w, EPS)
    y_op = rn.rms_norm(x.reshape(2, 3, 32).requires_grad_(), w, EPS)
    assert torch.equal(y, y_op.detach())
    _, r = rn.rms_norm_fwd_plain(x, w, EPS, save_r=False)
    assert r is None
    assert rn.launches == {"rms_norm_fwd": 0, "rms_norm_bwd": 0}


@pytest.fixture
def norm_calls(monkeypatch):
    """Calls of the plain versions (on the CPU the wrappers launch no
    kernel and count nothing)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = rn.rms_norm_fwd_plain, rn.rms_norm_bwd_plain

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(rn, "rms_norm_fwd_plain", counted_fwd)
    monkeypatch.setattr(rn, "rms_norm_bwd_plain", counted_bwd)
    return calls


LAYERS = 2
# B9 calls in backward: each norm of a recomputed layer runs again; no
# remat mode saves a norm (the reference's policies name none)
RECOMPUTED_NORMS = {False: 0, True: 2 * LAYERS, "half": LAYERS,
                    "dots": 2 * LAYERS, "lean": 2 * LAYERS}


@pytest.mark.parametrize("remat", [False, True, "half", "dots", "lean"])
def test_norm_calls_per_remat_mode(remat, norm_calls):
    cfg = LlamaConfig.tiny(num_hidden_layers=LAYERS, hidden_size=64,
                           intermediate_size=128, num_attention_heads=2,
                           vocab_size=256, max_position_embeddings=64)
    args = LlamaArgs.from_config(cfg)
    jparams = jlf.init_params(jlf.LlamaArgs.from_config(cfg),
                              jax.random.key(0))
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                             requires_grad=True)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, 256, (2, 16))).long()
                   for _ in range(2))
    loss = lf.forward_and_loss(params, ids, labels, args, remat=remat,
                               loss_chunk=8)
    assert norm_calls == {"fwd": 2 * LAYERS + 1, "bwd": 0}
    loss.backward()
    assert norm_calls == {"fwd": 2 * LAYERS + 1 + RECOMPUTED_NORMS[remat],
                          "bwd": 2 * LAYERS + 1}
    assert params["final_norm"].grad is not None
    assert params["layers"]["ln1"].grad.abs().sum() > 0


def test_kernel_gate():
    """What the kernels take, checked before a CUDA launch (the checks are
    plain Python; here on CPU tensors)."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    rn._check_kernel(w, x)
    rn._check_kernel(w, torch.zeros(4, 128, dtype=torch.bfloat16)[:, :64])
    rn._check_kernel(w.half(), x.half())
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        rn._check_kernel(w.double(), x.double())
    with pytest.raises(TypeError, match="dtype mismatch"):
        rn._check_kernel(w, x.float())
    with pytest.raises(ValueError, match="H % 8"):
        rn._check_kernel(torch.ones(60, dtype=torch.bfloat16),
                         torch.zeros(4, 60, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="H % 8"):
        rn._check_kernel(torch.ones(16392), torch.zeros(2, 16392))
    with pytest.raises(ValueError, match="unit last stride"):
        rn._check_kernel(w, torch.zeros(64, 4, dtype=torch.bfloat16).T)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rn._check_kernel(w, torch.zeros(4, 72, dtype=torch.bfloat16)[:, 1:65])
    with pytest.raises(ValueError, match="not \\[rows, H\\]"):
        rn.rms_norm_fwd(x, torch.ones(32, dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError, match="does not fit"):
        rn.rms_norm_bwd(x, w, torch.ones(4), x[:2])


# B10's grid and its fixed-order dw sum (`bwd_plan`, `bwd_grid`,
# `bwd_rows`), which rms_norm_bwd_kernel follows on the card
_SMEM_MAX = 227 * 1024


@pytest.mark.parametrize("rows,h,itemsize,plan,grid", [
    (8, 4096, 2, (256, 2, 2, 2), (4, 4)),          # the decode rows
    (4096, 4096, 2, (256, 2, 2, 2), (132, 4)),     # the 7B leg's micro-batch
    (4096, 2048, 2, (128, 2, 4, 2), (132, 4)),     # the h2048 leg's
    (300, 16384, 2, (512, 4, 1, 2), (132, 4)),     # the widest H in bf16
    (300, 16384, 4, (512, 8, 1, 1), (132, 4)),     # ... in f32: one stage
    (8, 16384, 4, (512, 8, 1, 1), (8, 4)),
    (33, 8, 2, (32, 1, 8, 2), (4, 4)),             # the narrowest H
    (1, 128, 2, (32, 1, 8, 2), (1, 1)),
])
def test_bwd_grid_rule(rows, h, itemsize, plan, grid):
    """B10's plan and grid: row groups of R threads with NV vectors each
    that cover the row (NV <= 4 in bf16, 8 in f32), G R <= 512 threads and
    G <= 8 named barriers a block, the ring and the row sums within the
    card's shared memory and the dw slab within the ring, one block an SM
    at most, clusters of 1, 2 or 4 dividing the grid and H into even
    column shares, and every row in exactly one row group, in order."""
    r, nv, g, s = rn.bwd_plan(h, itemsize)
    assert (r, nv, g, s) == plan
    vec = 16 // itemsize
    assert r % 32 == 0 and nv * r * vec >= h and nv <= (4 if itemsize == 2
                                                         else 8)
    assert g * r <= rn.BWD_MAX_THREADS and g <= 8
    ring = g * s * 2 * h * itemsize
    assert ring + 2 * g * 16 * 4 + 16 <= _SMEM_MAX
    assert g * h * 4 <= ring
    blocks, cluster = rn.bwd_grid(rows, h, itemsize, 132)
    assert (blocks, cluster) == grid
    assert blocks <= 132 and cluster in (1, 2, 4) and blocks % cluster == 0
    assert (h // cluster) % 2 == 0
    spans = rn.bwd_rows(rows, blocks, g)
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a <= e for a, e in spans)
    assert all(e == a2 for (_, e), (a2, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("rows,h,sms", [(512, 256, 16), (1000, 128, 132),
                                        (8, 4096, 132), (37, 64, 6)])
def test_bwd_dw_split_equals_the_plain_version(rows, h, sms):
    """chip_smoke's model of B10's dw sum (row groups in row order, the
    groups and blocks of a cluster in order, the clusters in index order)
    is the plain version's dw: in f32 within f32 rounding of the sum."""
    import chip_smoke as cs

    x, w, g = (torch.from_numpy(a) for a in _inputs(rows, h, seed=3))
    _, r = rn.rms_norm_fwd_plain(x, w, EPS)
    _, dw = rn.rms_norm_bwd_plain(x, w, r, g)
    split = cs.rms_dw_split(torch, rn, x, r, g, sms)
    torch.testing.assert_close(split, dw, rtol=0,
                               atol=1e-5 * dw.abs().max().item())


def test_bwd_bars_reject_planted_faults():
    """chip_smoke.py's B9/B10 bars pass B10's dw split in bf16 and reject
    each planted fault: eps dropped, the mean over H - 1, r from another
    row, and in the dw sum a row group left out, a cluster's partial
    counted twice or left out (16 SMs: several clusters)."""
    import chip_smoke as cs

    x, w, g = cs.rms_case(torch, torch.device("cpu"), 1024, 512,
                          torch.bfloat16)
    _, r = rn.rms_norm_fwd_plain(x, w, cs.RMS_EPS)
    _, dw = rn.rms_norm_bwd_plain(x, w, r, g)
    split = cs.rms_dw_split(torch, rn, x, r, g, 16).to(w.dtype)
    assert cs.rms_ratios(torch, {"dw": split}, {"dw": dw},
                         "bfloat16")["dw"] <= 1.0
    faults = cs.planted_rms_faults(torch, rn, x, w, g, 16)
    assert [f for f, _, _ in faults][-3:] == list(cs.RMS_DW_FAULTS)
    for fault, wrong, right in faults:
        bad = cs.rms_ratios(torch, wrong, right, "bfloat16")
        assert max(bad.values()) > 1.0, fault


def test_b10_scratch_is_kept_per_stream(monkeypatch):
    """Fault C3: B10's arrival counter and partial sums are kept per
    (device, current stream): two streams get two, a stream gets its own
    back on every call (the partials grown when a call needs more)."""
    from types import SimpleNamespace

    from paddle_tpu_torch.kernels import rms_norm as rn

    now = {"stream": 1}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(
                            cuda_stream=now["stream"]))
    monkeypatch.setattr(rn, "_scratch", {})
    cpu = torch.device("cpu")
    a = rn._bwd_scratch(cpu, 2, 64)
    now["stream"] = 2
    b = rn._bwd_scratch(cpu, 2, 64)
    assert a[0] is not b[0] and a[1] is not b[1]
    now["stream"] = 1
    again = rn._bwd_scratch(cpu, 2, 64)
    assert again[0] is a[0] and again[1] is a[1]
    grown = rn._bwd_scratch(cpu, 4, 64)
    assert grown[0] is a[0] and grown[1].numel() == 256
    assert set(rn._scratch) == {(cpu, 1), (cpu, 2)}


# --------------------------------------------------------------------------
# `nn.functional.rms_norm`'s route: B9/B10 on the card when on the gate,
# else the plain composite
# --------------------------------------------------------------------------


def test_gate_predicate_decides_by_shape_and_dtype_alone():
    bf = torch.bfloat16
    x, w = torch.zeros(4, 64, dtype=bf), torch.ones(64, dtype=bf)
    assert rn.supports(x, w) and rn.supports(x.float(), w.float())
    assert rn.supports(torch.zeros(2, 3, 64, dtype=bf), w)
    # layout is not part of the gate: the route hands B9 a dense copy
    assert rn.supports(torch.zeros(64, 4, dtype=bf).T, w)
    assert rn.supports(torch.zeros(4, 72, dtype=bf)[:, 1:65], w)
    assert not rn.supports(x.float(), w)              # mixed dtypes
    assert rn.supports(x.half(), w.half())
    assert not rn.supports(x.double(), w.double())    # none of bf16/fp16/f32
    assert not rn.supports(torch.zeros(4, 60, dtype=bf),
                           torch.ones(60, dtype=bf))  # H % 8
    h = rn.MAX_HIDDEN + 8
    assert not rn.supports(torch.zeros(1, h), torch.ones(h))
    assert not rn.supports(x, torch.ones(32, dtype=bf))   # w does not fit


@pytest.fixture
def kernel_route(monkeypatch):
    """The functional's view of a card (`_on_card` true for these CPU
    tensors) and a stand-in for the kernel wrapper that records its
    inputs and computes the plain version."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.nn.functional import norm

    calls = []

    def kernel(x, w, eps):
        calls.append((x.shape, x.is_contiguous(), w.is_contiguous(), eps))
        y, _ = rn.rms_norm_fwd_plain(x.reshape(-1, x.shape[-1]), w, eps)
        return y.reshape(x.shape)

    monkeypatch.setattr(norm, "_on_card", lambda *ts: True)
    monkeypatch.setattr(rn, "rms_norm", kernel)
    prev = port_device._current
    paddle.set_device("cpu")
    yield paddle, calls
    port_device._current = prev


def test_a_gated_call_reaches_the_kernel_and_an_off_gate_call_never(
        kernel_route):
    paddle, calls = kernel_route
    F = paddle.nn.functional
    rng = np.random.default_rng(4)
    x = paddle.to_tensor(rng.standard_normal((2, 3, 64)).astype(np.float32))
    w = paddle.to_tensor(rng.standard_normal(64).astype(np.float32))
    F.rms_norm(x, w, 1e-5)
    F.rms_norm(x.astype("bfloat16"), w.astype("bfloat16"))
    assert calls == [((2, 3, 64), True, True, 1e-5),
                     ((2, 3, 64), True, True, 1e-6)]
    # a strided view on the gate is handed over as a dense copy
    wide = paddle.to_tensor(rng.standard_normal((6, 72)).astype(np.float32))
    F.rms_norm(wide[:, 1:65], w)
    assert calls[-1] == ((6, 64), True, True, 1e-6)
    n = len(calls)
    odd = paddle.to_tensor(rng.standard_normal((2, 60)).astype(np.float32))
    F.rms_norm(odd, paddle.ones([60]))                  # H % 8
    F.rms_norm(x, w.astype("bfloat16"))                 # mixed dtypes
    F.rms_norm(x)                                       # weight=None
    F.rms_norm(x.astype("float64"), w.astype("float64"))
    assert len(calls) == n
    F.rms_norm(x.astype("float16"), w.astype("float16"))
    assert calls[-1] == ((2, 3, 64), True, True, 1e-6)


def test_x_and_weight_on_different_devices_raise():
    """The functional routes on the kernel wrappers' device check, which
    raises on a mix (here the CPU and the meta device) rather than
    sending the call to the plain path."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device

    prev = port_device._current
    paddle.set_device("cpu")
    try:
        x = paddle.to_tensor(np.ones((2, 64), np.float32))
        w = paddle.Tensor(torch.ones(64, device="meta"))
        with pytest.raises(ValueError, match="different devices"):
            paddle.nn.functional.rms_norm(x, w)
    finally:
        port_device._current = prev


def test_the_kernel_route_is_differentiable_through_the_wrapper(
        kernel_route, monkeypatch):
    """On the gate the functional calls the wrapper inside `apply`, so its
    custom operator (B10 on the card) takes the gradient: here the real
    wrapper on CPU tensors, against the plain composite's gradient."""
    paddle, _ = kernel_route
    monkeypatch.undo()
    from paddle_tpu_torch.nn.functional import norm

    seen = []
    real = rn.rms_norm

    def wrapper(x, w, eps):
        seen.append(1)
        return real(x, w, eps)

    monkeypatch.setattr(norm, "_on_card", lambda *ts: True)
    monkeypatch.setattr(rn, "rms_norm", wrapper)
    rng = np.random.default_rng(5)
    xa = rng.standard_normal((3, 16)).astype(np.float32)
    wa = rng.standard_normal(16).astype(np.float32)
    grads = []
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(norm, "_on_card", lambda *ts: False)
        x = paddle.to_tensor(xa, stop_gradient=False)
        w = paddle.to_tensor(wa, stop_gradient=False)
        (paddle.nn.functional.rms_norm(x, w) ** 2).sum().backward()
        grads.append((x.grad.numpy(), w.grad.numpy()))
    assert seen == [1]
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_route_matches_the_jax_functional(dtype):
    """The plain composite against the JAX package's `F.rms_norm` on the
    same inputs: f32 to 1e-6, bf16 within one bf16 unit in the last place
    of |y|."""
    import paddle_tpu
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device

    x, w, _ = _inputs(48, 128, seed=7)
    prev = port_device._current
    paddle.set_device("cpu")
    try:
        got = paddle.nn.functional.rms_norm(
            paddle.to_tensor(x).astype(dtype),
            paddle.to_tensor(w).astype(dtype), 1e-6)
        got = got.astype("float32").numpy()
    finally:
        port_device._current = prev
    ref = paddle_tpu.nn.functional.rms_norm(
        paddle_tpu.to_tensor(x).astype(dtype),
        paddle_tpu.to_tensor(w).astype(dtype), 1e-6)
    ref = np.asarray(ref.astype("float32").numpy())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), \
            np.max(np.abs(got - ref) / _bf16_ulp(ref))


def test_backward_hands_b10_a_dense_cotangent(monkeypatch):
    """The gradient of y.sum() reaches the custom operator expanded
    (stride 0): B10 takes dense, 16-byte aligned rows, so the operator
    makes them so before the call (found by the card test
    `test_rms_norm_launches_b9_and_b10_on_the_gate_only`)."""
    seen = []
    real = rn.rms_norm_bwd

    def record(x2d, w, r, g2d):
        seen.append((g2d.is_contiguous(), g2d.stride()))
        rn._check_kernel(w, x2d, g2d)
        return real(x2d, w, r, g2d)

    monkeypatch.setattr(rn, "rms_norm_bwd", record)
    x = torch.randn(4, 3, 64, requires_grad=True)
    w = torch.randn(64, requires_grad=True)
    rn.rms_norm(x, w, EPS).sum().backward()
    assert seen == [(True, (64, 1))]
    xr = x.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    y, _ = rn.rms_norm_fwd_plain(xr.reshape(-1, 64), wr, EPS)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), xr.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), wr.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
