"""Flash attention forward and backward: the wrappers of kernels B1, B2, B3,
their plain PyTorch versions, and the differentiable entry points.

  B1  `flash_fwd`             replaces `_fwd_kernel` (:112, `_flash_fwd` :169)
  B2  `flash_bwd` (dq)        replaces `_bwd_dq_kernel` (:215)
  B3  `flash_bwd` (dk, dv)    replaces `_bwd_dkv_kernel` (:260, `_flash_bwd`
                              :325)

(in paddle_tpu/kernels/flash_attention.py)

Layout is the public one throughout: q [B, Sq, H, D], k/v [B, Sk, Hk, D],
lse [B, H, Sq] f32. The kernels read it through strides, so nothing is
transposed or copied around a call. GQA is native: query head h reads kv
head h // (H // Hk). Causal attention uses the offset diagonal: query i
sees keys j <= i + (Sk - Sq). A row that sees no key (Sq > Sk) gives out 0
and lse -1e30, and no gradient.

Routing is by the tensors' device, as the other wrappers route: a CPU
tensor goes to the plain version beside the kernel, a CUDA tensor to the
hand-written kernel in `csrc/flash_attention.cu`, checked first, then
contiguous and 16-byte aligned. The gates, by shape and dtype only, with
H a multiple of Hk and any Sq and Sk:
  B1      (`supports`)           bf16, fp16 or f32 at head_dim 32, 64, 128;
  B2, B3  (`supports_backward`)  bf16 or f32 at head_dim 64 or 128.
A call that will need a gradient routes on the second
(`nn.functional.flash_attention._use_kernel`), so B1's wider gate never
leads to a backward the kernels do not take. Nothing falls back.
`launches` counts kernel launches only (`flash_fwd`, `flash_bwd_dq`,
`flash_bwd_dkv`).

The plain versions compute the same function over a materialized [Sq, Sk]
score matrix, in f32, and round where the Pallas kernels round: p to v's
dtype before P·V, ds to k's dtype before dS·K and dSᵀ·Q, p to dO's dtype
before Pᵀ·dO; dk and dv come back in f32, dq in q's dtype after
`* sm_scale` in f32.

`flash_attention_fwd` and `flash_attention_with_lse` are differentiable
through the operator `paddle_tpu_torch::flash_fwd` (a `torch.library`
custom op with a registered backward), so a selective-checkpoint policy can
name the forward and keep its outputs (`llama_functional` remat='lean').
The backward is the operator `paddle_tpu_torch::flash_bwd` (B2 + B3): the
pointer checks live in the operators' bodies, so a trace of a training
step (`make_fx`, `torch.export`, `jit.to_static`, SOT, a static Program)
holds one node for each, launched at its every call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.attention import _on_card

__all__ = ["flash_fwd", "flash_bwd", "flash_fwd_plain", "flash_bwd_plain",
           "flash_bwd_dq_plain", "flash_bwd_dkv_plain", "flash_attention_fwd",
           "flash_attention_with_lse", "FLASH_FWD_OP", "FLASH_BWD_OP",
           "launches", "variant_launches",
           "reset_launches", "KERNEL_HEAD_DIMS", "BWD_HEAD_DIMS", "supports",
           "supports_backward"]

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128)      # B1
BWD_HEAD_DIMS = (64, 128)             # B2, B3
# the dtype codes of the C entry points; B2/B3 take the first two
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BWD_DTYPES = (torch.float32, torch.bfloat16)

launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# B1's launches in fp16 and at head_dim 32, counted beside its total
variant_launches = {"flash_fwd_f16": 0, "flash_fwd_hd32": 0}


def reset_launches():
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# checks and routing
# ---------------------------------------------------------------------------


def _shape_error(q, k, v):
    """Why q/k/v are not q [B, Sq, H, D], k/v [B, Sk, Hk, D] with H a
    multiple of Hk, or None."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return (f"want q [B, Sq, H, D], k/v [B, Sk, Hk, D]; got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        return f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        return (f"query heads {q.shape[2]} not a multiple of kv heads "
                f"{k.shape[2]}")
    return None


def _shapes(q, k, v):
    """(B, Sq, Sk, H, Hk, D); raises on shapes no path takes."""
    err = _shape_error(q, k, v)
    if err is not None:
        raise ValueError(err)
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def _off_gate(q, k, v, backward=False):
    """Why B1 (or with `backward`, B2 and B3) do not take q/k/v, by shape
    and dtype only, as the error to raise, or None: the shapes of
    `_shape_error`, one dtype of bf16/fp16/f32 (B2, B3: bf16/f32), head_dim
    in KERNEL_HEAD_DIMS (B2, B3: BWD_HEAD_DIMS)."""
    err = _shape_error(q, k, v)
    if err is not None:
        return ValueError(err)
    who, dtypes, dims = (("B2/B3", _BWD_DTYPES, BWD_HEAD_DIMS) if backward
                         else ("B1", tuple(_DTYPES), KERNEL_HEAD_DIMS))
    if q.dtype not in dtypes:
        names = sorted(str(d).split(".")[-1] for d in dtypes)
        return TypeError(f"{who} takes {', '.join(names[:-1])} or "
                         f"{names[-1]}, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype:
            return TypeError(f"dtype mismatch: {t.dtype} vs {q.dtype}")
    if q.shape[-1] not in dims:
        return ValueError(f"{who} takes head_dim in {dims}, got "
                          f"{q.shape[-1]}")
    return None


def supports(q, k, v=None):
    """B1's gate, by shape and dtype only (`_off_gate`). A caller routes on
    it before the launch (`nn.functional.flash_attention`) and hands the
    kernel dense tensors; on a CPU tensor the wrappers then run their plain
    versions."""
    return _off_gate(q, k, k if v is None else v) is None


def supports_backward(q, k, v=None):
    """B2 and B3's gate (bf16/f32, head_dim 64/128): what a call that will
    need a gradient routes on, before B1 launches."""
    return _off_gate(q, k, k if v is None else v, backward=True) is None


def _check_kernel(q, k, v, others=(), floats=(), backward=False):
    """What the kernels take: B1's gate, or B2/B3's with `backward`
    (`_off_gate`), `others` (do) in q's dtype, f32 lse/delta, and every
    input contiguous and 16-byte aligned."""
    err = _off_gate(q, k, v, backward)
    if err is not None:
        raise err
    for t in others:
        if t.dtype != q.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {q.dtype}")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"lse/delta must be float32, got {t.dtype}")
    for t in (q, k, v, *others, *floats):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _heads_major(x, g=1):
    """[B, S, h, D] -> [B, h * g, S, D] (kv heads repeated for GQA)."""
    x = x.transpose(1, 2)
    return x if g == 1 else x.repeat_interleave(g, dim=1)


def _visible(sq, sk, causal, device):
    """[Sq, Sk] bool of the keys each query sees, or None when all."""
    if not causal:
        return None
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return j <= i + (sk - sq)


def _probs(q, k, lse, causal, sm_scale):
    """P [B, H, Sq, Sk] f32 rebuilt from lse [B, H, Sq]: exp(s - lse) where
    visible, 0 elsewhere (a select after the exp, as :240/:290)."""
    g = q.shape[2] // k.shape[2]
    s = (_heads_major(q).float()
         @ _heads_major(k, g).float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse[..., None])
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    return p


def flash_fwd_plain(q, k, v, causal=False, sm_scale=None):
    """B1's plain version: (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32). A row with no visible key gives out 0 and lse -1e30."""
    _shapes(q, k, v)
    sm_scale = _scale(sm_scale, q.shape[-1])
    g = q.shape[2] // k.shape[2]
    s = (_heads_major(q).float()
         @ _heads_major(k, g).float().transpose(-1, -2)) * sm_scale
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    safe = torch.where(live, l, 1.0)
    vh = _heads_major(v, g)
    o = (p.to(v.dtype).float() @ vh.float()) / safe
    o = torch.where(live, o, 0.0)
    lse = torch.where(live, m + torch.log(safe), NEG_INF)[..., 0]
    return o.to(q.dtype).transpose(1, 2).contiguous(), lse


def _delta(o, do, g_lse=None):
    """rowsum(dO·O) in f32, [B, H, Sq], minus g_lse when given (:349-352)."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                       sm_scale=None):
    """B2's plain version: dq [B, Sq, H, D] in q's dtype."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    g = q.shape[2] // k.shape[2]
    p = _probs(q, k, lse, causal, sm_scale)
    dp = _heads_major(do).float() @ _heads_major(v, g).float().transpose(
        -1, -2)
    ds = p * (dp - delta[..., None])
    dq = (ds.to(k.dtype).float() @ _heads_major(k, g).float()) * sm_scale
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None):
    """B3's plain version: (dk, dv) [B, Sk, Hk, D] f32, summed over the
    query heads of each kv head's group."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    B, Sk, Hk, D = k.shape
    g = q.shape[2] // Hk
    p = _probs(q, k, lse, causal, sm_scale)
    dof = _heads_major(do).float()
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ _heads_major(v, g).float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dk = (ds.to(q.dtype).float().transpose(-1, -2)
          @ _heads_major(q).float()) * sm_scale

    def group(x):   # [B, H, Sk, D] -> [B, Sk, Hk, D]
        return x.reshape(B, Hk, g, Sk, D).sum(dim=2).transpose(1, 2) \
            .contiguous()

    return group(dk), group(dv)


def flash_bwd_plain(q, k, v, o, lse, do, causal=False, sm_scale=None,
                    g_lse=None):
    """B2 + B3's plain version: (dq in q's dtype, dk f32, dv f32)."""
    delta = _delta(o, do, g_lse)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _dims(q, k, causal, sm_scale):
    B, Sq, H, D = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], D, _DTYPES[q.dtype],
            int(bool(causal)), sm_scale)


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """B1: (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)."""
    B, Sq, Sk, H, Hk, D = _shapes(q, k, v)
    sm_scale = _scale(sm_scale, D)
    if not _on_card(q, k, v):
        return flash_fwd_plain(q, k, v, causal, sm_scale)
    _check_kernel(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _build.launch(
        "flash_attention", "pt_flash_fwd", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_dims(q, k, causal, sm_scale))
    _raise_on(rc, "flash_fwd")
    launches["flash_fwd"] += 1
    variant_launches["flash_fwd_f16"] += q.dtype == torch.float16
    variant_launches["flash_fwd_hd32"] += D == 32
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """B2 on the card: dq in q's dtype."""
    dq = torch.empty_like(q)
    rc = _build.launch(
        "flash_attention", "pt_flash_bwd_dq", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_dims(q, k, causal, sm_scale))
    _raise_on(rc, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """B3 on the card: dk, dv in f32."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    rc = _build.launch(
        "flash_attention", "pt_flash_bwd_dkv", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal, sm_scale))
    _raise_on(rc, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None, g_lse=None):
    """B2 + B3: (dq in q's dtype, dk f32, dv f32). delta = rowsum(dO·O)
    in f32 (minus g_lse [B, H, Sq] when given) is plain torch, as at
    :349-352."""
    B, Sq, Sk, H, Hk, D = _shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} / lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    sm_scale = _scale(sm_scale, D)
    extra = (g_lse,) if g_lse is not None else ()
    if not _on_card(q, k, v, o, lse, do, *extra):
        return flash_bwd_plain(q, k, v, o, lse, do, causal, sm_scale, g_lse)
    do = do.contiguous()
    delta = _delta(o, do, g_lse)
    _check_kernel(q, k, v, (do,), (lse, delta), backward=True)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd: one custom operator, visible to selective checkpointing
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal, sm_scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, sm_scale):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32)


def _setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.set_materialize_grads(False)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, sm_scale: float,
                  g_lse: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_bwd(q, k, v, o, lse, do, causal, sm_scale, g_lse)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, sm_scale, g_lse):
    return (torch.empty_like(q), k.new_empty(k.shape, dtype=torch.float32),
            k.new_empty(k.shape, dtype=torch.float32))


def _backward(ctx, g_out, g_lse):
    """B2 and B3 through their operator: a traced backward holds one
    `paddle_tpu_torch::flash_bwd` node, whose body checks the pointers and
    launches both kernels at its every call."""
    q, k, v, out, lse = ctx.saved_tensors
    if g_out is None:
        g_out = torch.zeros_like(out)
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, g_out, ctx.causal,
                               ctx.sm_scale, g_lse)
    return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup)

# the operator a checkpoint policy names to keep the forward's outputs
FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_fwd.default
FLASH_BWD_OP = torch.ops.paddle_tpu_torch.flash_bwd.default


def needs_grad(q, k, v):
    """Whether a call on q/k/v will need a gradient: grad enabled and an
    input that requires one."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))


def _grad_gate(q, k, v):
    """A call on the card that will need a gradient raises here, before B1
    launches, when B2/B3 do not take its tensors (`supports_backward`):
    B1's gate is the wider, and a backward it cannot run is refused up
    front, not after the forward."""
    if needs_grad(q, k, v) and _on_card(q, k, v):
        err = _off_gate(q, k, v, backward=True)
        if err is not None:
            raise err


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q [B, S, H, D]; k/v may carry fewer (kv) heads (GQA). Differentiable:
    backward runs B2 and B3 (the plain versions on the CPU)."""
    _grad_gate(q, k, v)
    return _flash_fwd_op(q, k, v, bool(causal), _scale(scale, q.shape[-1]))[0]


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """Differentiable (out, lse [B, H, Sq] f32); the lse cotangent folds
    into delta (the building block ring attention merges)."""
    _grad_gate(q, k, v)
    return _flash_fwd_op(q, k, v, bool(causal), _scale(scale, q.shape[-1]))
