"""Fused RMSNorm: the wrappers of kernels B9 and B10, their plain PyTorch
versions, and the autograd operator every norm of the port goes through.

  B9   `rms_norm_fwd`  replaces `_fwd_kernel` (:34, launched by `_fwd_call`)
  B10  `rms_norm_bwd`  replaces `_bwd_kernel` (:42, launched by `_bwd_call`)

(in paddle_tpu/kernels/rms_norm.py)

The reference dispatches neither: on the TPU a `pallas_call` is an XLA
fusion barrier and the compiled composite won. The port runs eagerly, where
the composite costs eight launches and ~36 bytes an element per norm, so
every norm of the port (`llama_functional.rms_norm`) runs B9, and every
norm's backward B10 (the counterpart of the reference Paddle's CUDA
`fused_rms_norm`).

Routing is by the tensors' device, as for the other kernels: CPU tensors
go to the plain versions, CUDA tensors to the hand-written kernels in
`csrc/rms_norm.cu` or to an error. The kernels take x, w (and g) of one
dtype, bf16, fp16 or f32, a contiguous last dim H with H % 8 == 0 and
H <= 16384, rows 16-byte aligned, any row count. Nothing falls back.

Rounding: B9 and its plain version round as the composite does,
y = rnd(rnd(x * r) * w) in x's dtype (the Pallas kernel rounds once,
rnd(x * r * w); ROADMAP C). B10 and its plain version compute in f32,
dx = r * (gw - x * r^2 * mean(gw * x)) with gw = g * w, dw = sum_rows(g *
x * r), dx rounded to x's dtype and dw to w's.

`launches["rms_norm_fwd"]` / `["rms_norm_bwd"]` count the wrappers' calls
that launched a kernel (a plain call counts nothing);
`variant_launches["rms_norm_fwd_f16"]` / `["rms_norm_bwd_f16"]` count those
in fp16 beside them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.attention import _on_card, _raise_on, _tracing

__all__ = ["rms_norm_fwd", "rms_norm_bwd", "rms_norm_fwd_plain",
           "rms_norm_bwd_plain", "rms_norm", "supports", "launches",
           "variant_launches", "reset_launches",
           "MAX_HIDDEN", "bwd_plan", "bwd_grid", "bwd_rows"]

MAX_HIDDEN = 16384
# the dtype codes of the C entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# B10 (csrc/rms_norm.cu, mirrored there): threads a block, shared memory
# the ring of x and g may take, blocks a cluster
BWD_MAX_THREADS = 512
BWD_RING_BYTES = 192 * 1024
BWD_CLUSTER = 4

launches = {"rms_norm_fwd": 0, "rms_norm_bwd": 0}
# the launches in fp16, counted beside the totals
variant_launches = {"rms_norm_fwd_f16": 0, "rms_norm_bwd_f16": 0}
_sm_count = {}
# B10's arrival counter (int32 [1], left at 0 by every call) and its f32
# scratch for the clusters' dw partials, one pair a (device, stream)
_scratch = {}


def reset_launches():
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


def _count(name, dtype):
    launches[name] += 1
    variant_launches[f"{name}_f16"] += dtype == torch.float16


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _wide(t):
    """t in f32, or in f64 when it is f64 (the gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm_fwd_plain(x2d, w, eps, save_r=True):
    """B9's plain version, the composite the port ran before B9:
    normalise in f32, cast to x's dtype, then multiply by w in the working
    dtype. Returns (y [rows, H], r [rows] f32 or None); f64 inputs
    compute in f64."""
    x32 = _wide(x2d)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    y = (x32 * r).to(x2d.dtype) * w
    return y, (r[:, 0] if save_r else None)


def rms_norm_bwd_plain(x2d, w, r, g2d):
    """B10's plain version (the formula of `_bwd_kernel`, :42-60) in f32
    (f64 for f64 inputs): (dx [rows, H] in x's dtype, dw [H] in w's
    dtype)."""
    x = _wide(x2d)
    g = _wide(g2d)
    rr = _wide(r)[:, None]
    gw = g * _wide(w)
    m = (gw * x).mean(dim=-1, keepdim=True)
    dx = rr * (gw - x * (rr * rr) * m)
    dw = (g * x * rr).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(w.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_shapes(x2d, w, *others):
    if x2d.dim() != 2 or w.shape != (x2d.shape[1],):
        raise ValueError(f"x {tuple(x2d.shape)} and w {tuple(w.shape)} are "
                         "not [rows, H] and [H]")
    for t in others:
        if t.shape != x2d.shape:
            raise ValueError(f"{tuple(t.shape)} does not fit x "
                             f"{tuple(x2d.shape)}")


def _off_gate(w, *rows):
    """Why B9/B10 do not take w and the rows, by shape and dtype only, as
    the error to raise, or None: one dtype, bf16, fp16 or f32; H % 8 == 0
    and H <= MAX_HIDDEN."""
    h = w.shape[-1]
    if w.dtype not in _DTYPES:
        return TypeError(f"kernel takes bfloat16, float16 or float32, got "
                         f"{w.dtype}")
    if h % 8 or h > MAX_HIDDEN:
        return ValueError(f"kernel takes H % 8 == 0 and H <= {MAX_HIDDEN}, "
                          f"got {h}")
    for t in rows:
        if t.dtype != w.dtype:
            return TypeError(f"dtype mismatch: {t.dtype} vs w {w.dtype}")
    return None


def supports(x, w):
    """B9's gate for x [..., H] and w [H], by shape and dtype only
    (`_off_gate`). A caller routes on it before the launch
    (`nn.functional.rms_norm`) and hands the kernel dense rows."""
    return w.dim() == 1 and x.shape[-1:] == w.shape and \
        _off_gate(w, x) is None


def _check_kernel(w, *rows):
    """What the kernels take: B9's gate (`_off_gate`), w contiguous and
    rows with a unit last stride, all 16-byte aligned."""
    err = _off_gate(w, *rows)
    if err is not None:
        raise err
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("w must be contiguous and 16-byte aligned")
    for t in rows:
        if t.stride(1) != 1 or (t.shape[0] > 1 and t.stride(0) % 8) or \
                t.data_ptr() % 16:
            raise ValueError("kernel rows must have a unit last stride and "
                             "start 16-byte aligned")


def _ld(t):
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def rms_norm_fwd(x2d, w, eps, save_r=True):
    """B9: y = rnd(rnd(x * r) * w) over x [rows, H], r = rsqrt(mean(x^2) +
    eps) in f32. Returns (y [rows, H] in x's dtype, r [rows] f32 when
    save_r, else None)."""
    _check_shapes(x2d, w)
    if not _on_card(x2d, w):
        return rms_norm_fwd_plain(x2d, w, eps, save_r)
    _check_kernel(w, x2d)
    rows, h = x2d.shape
    y = torch.empty((rows, h), dtype=x2d.dtype, device=x2d.device)
    r = (torch.empty(rows, dtype=torch.float32, device=x2d.device)
         if save_r else None)
    rc = _build.launch(
        "rms_norm", "pt_rms_norm_fwd", x2d.device, x2d.data_ptr(),
        w.data_ptr(), y.data_ptr(), 0 if r is None else r.data_ptr(), rows,
        h, _ld(x2d), _DTYPES[w.dtype], float(eps))
    _raise_on(rc, "rms_norm_fwd")
    _count("rms_norm_fwd", w.dtype)
    return y, r


def bwd_plan(h, itemsize):
    """B10's work for a row of H elements of `itemsize` bytes, as
    `rms_norm_bwd_kernel` takes it: (R threads a row group, NV 16-byte
    vectors a thread, G row groups a block, S stages of its ring). About 2
    vectors a thread (NV a power of two), R <= BWD_MAX_THREADS, G R <=
    BWD_MAX_THREADS and G <= 8 (a named barrier each), two stages of x and
    g when the ring fits BWD_RING_BYTES, else one."""
    nvec = h // (16 // itemsize)
    half = -(-nvec // 2)
    r = min(BWD_MAX_THREADS, 32 * -(-half // 32))
    nv = 1
    while nv * r < nvec:
        nv *= 2
    g = min(8, BWD_MAX_THREADS // r)
    s = 2 if g * 2 * (2 * h * itemsize) <= BWD_RING_BYTES else 1
    return r, nv, g, s


def bwd_grid(rows, h, itemsize, sms):
    """B10's grid: (blocks, blocks a cluster). One block an SM, fewer when
    the rows do not fill them (a row group at least a row), in clusters of
    BWD_CLUSTER (2 or 1 for grids of fewer blocks). The kernel takes fewer
    blocks when the card cannot hold that many clusters at once."""
    g = bwd_plan(h, itemsize)[2]
    want = max(1, min(sms, -(-rows // g)))
    c = BWD_CLUSTER if want >= BWD_CLUSTER else (2 if want >= 2 else 1)
    return c * (want // c), c


def bwd_rows(rows, blocks, groups):
    """The rows [first, end) of each of B10's blocks * groups row groups, in
    order (row group u of U: [u rows / U, (u + 1) rows / U))."""
    n = blocks * groups
    return [(u * rows // n, (u + 1) * rows // n) for u in range(n)]


def _bwd_scratch(device, clusters, h):
    """(counter, part) for B10 on `device` and its current stream: the
    arrival counter, zeroed once, and a partial buffer of at least clusters
    * h f32, grown when a call needs more. Kept per (device, stream): calls
    on one stream run one after another, calls on two streams may overlap
    and so each stream has its own. Both are made on that stream, so the
    caching allocator hands their memory to no other stream."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counter, part = _scratch.get(key, (None, None))
    if counter is None:
        counter = torch.empty(1, dtype=torch.int32, device=device).zero_()
    if part is None or part.numel() < clusters * h:
        part = torch.empty(clusters * h, dtype=torch.float32, device=device)
    _scratch[key] = (counter, part)
    return counter, part


def rms_norm_bwd(x2d, w, r, g2d):
    """B10: (dx [rows, H] in x's dtype, dw [H] in w's dtype) of y =
    rms_norm(x, w) under the cotangent g [rows, H], from the r [rows] f32
    that B9 stored. One launch over `bwd_grid`'s blocks: dx row by row, dw
    summed on the card in a fixed order (two calls give the same bits).
    The arrival counter and partial sums are the current stream's
    (`_bwd_scratch`), so calls on different streams of one card may run at
    once."""
    _check_shapes(x2d, w, g2d)
    if r.shape != (x2d.shape[0],):
        raise ValueError(f"r {tuple(r.shape)} is not [{x2d.shape[0]}]")
    if not _on_card(x2d, w, r, g2d):
        return rms_norm_bwd_plain(x2d, w, r, g2d)
    _check_kernel(w, x2d, g2d)
    if r.dtype != torch.float32 or not r.is_contiguous():
        raise TypeError("r must be contiguous float32")
    rows, h = x2d.shape
    dev = x2d.device
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    blocks, cluster = bwd_grid(rows, h, x2d.element_size(), _sm_count[dev])
    counter, part = _bwd_scratch(dev, blocks // cluster, h)
    dx = torch.empty((rows, h), dtype=x2d.dtype, device=dev)
    dw = torch.empty(h, dtype=w.dtype, device=dev)
    rc = _build.launch(
        "rms_norm", "pt_rms_norm_bwd", dev, x2d.data_ptr(), w.data_ptr(),
        r.data_ptr(), g2d.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        part.data_ptr(), counter.data_ptr(), rows, h, _ld(x2d), _ld(g2d),
        blocks, cluster, _DTYPES[w.dtype])
    _raise_on(rc, "rms_norm_bwd")
    _count("rms_norm_bwd", w.dtype)
    return dx, dw


# ---------------------------------------------------------------------------
# autograd: one custom operator, visible to selective checkpointing
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu_torch::rms_norm", mutates_args=())
def _rms_norm_op(x: torch.Tensor, w: torch.Tensor, eps: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    y, r = rms_norm_fwd(x.reshape(-1, x.shape[-1]), w, eps, save_r=True)
    return y.reshape(x.shape), r


@_rms_norm_op.register_fake
def _(x, w, eps):
    rows = x.numel() // x.shape[-1]
    return (x.new_empty(x.shape, dtype=torch.promote_types(x.dtype, w.dtype)),
            x.new_empty((rows,), dtype=torch.promote_types(x.dtype,
                                                           torch.float32)))


def _setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w, output[1])
    ctx.set_materialize_grads(False)


@torch.library.custom_op("paddle_tpu_torch::rms_norm_bwd", mutates_args=())
def _rms_norm_bwd_op(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[-1]
    g2d = g.reshape(-1, h)
    # autograd may hand over an expanded or strided cotangent (the
    # gradient of a sum has stride 0): B10 reads dense, aligned rows
    if not g2d.is_contiguous() or g2d.data_ptr() % 16:
        g2d = g2d.clone(memory_format=torch.contiguous_format)
    dx, dw = rms_norm_bwd(x.reshape(-1, h), w, r, g2d)
    return dx.reshape(x.shape), dw


@_rms_norm_bwd_op.register_fake
def _(x, w, r, g):
    return x.new_empty(x.shape), w.new_empty(w.shape)


def _backward(ctx, g_y, _g_r):
    """B10 through its operator: a traced backward holds one
    `paddle_tpu_torch::rms_norm_bwd` node, whose body makes the cotangent
    dense and launches B10 at its every call."""
    x, w, r = ctx.saved_tensors
    if g_y is None:
        return None, None, None
    dx, dw = _rms_norm_bwd_op(x, w, r, g_y)
    return dx, dw, None


_rms_norm_op.register_autograd(_backward, setup_context=_setup)


def rms_norm(x, w, eps):
    """RMSNorm over the last dim of x [..., H] with weight w [H]: B9 on a
    CUDA tensor (its plain version on a CPU one). Differentiable through
    the custom operator, whose backward is B10; without a gradient to
    take, the wrapper runs alone and stores no r. While a trace runs
    (`_tracing`), the operator is the one node of the program, launched at
    its every call, and its backward the one `rms_norm_bwd` node."""
    if _tracing(x, w) or (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return _rms_norm_op(x, w, float(eps))[0]
    y, _ = rms_norm_fwd(x.reshape(-1, x.shape[-1]), w, eps, save_r=False)
    return y.reshape(x.shape)
