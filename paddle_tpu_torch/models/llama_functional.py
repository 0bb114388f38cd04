"""Functional Llama building blocks (port of
`paddle_tpu/models/llama_functional.py`).

The parameter tree keeps the reference layout so that no transpose can
hide a bug: every weight is [in, out] (`x @ W`), and the decoder-layer
leaves are stacked on a leading [num_layers] dim:

    {"embedding": [V, H],
     "layers": {"wq": [L, H, nh*hd], "wk": [L, H, nkv*hd], "wv": ...,
                "wo": [L, nh*hd, H], "w_gate": [L, H, I], "w_up": [L, H, I],
                "w_down": [L, I, H], "ln1": [L, H], "ln2": [L, H]},
     "final_norm": [H], "lm_head": [H, V]}

`models.llama.Llama` is the nn.Module that owns such a tree.

The training path is the reference's single-device branch (`mp_axis=None`):
`forward_and_loss` = embedding -> `run_layers` (a Python loop over the
stacked leaves, with the reference's remat modes on
`torch.utils.checkpoint`) -> final norm -> `fused_linear_cross_entropy`
(or the unfused `parallel_cross_entropy`). Attention is flash attention
(kernels B1-B3 on the card) when `args.use_flash`, else `sdpa_reference`.
Every norm is `rms_norm`: kernel B9 forward and B10 backward on the card.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels import attention as attn_k
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import rms_norm as rn

__all__ = ["LlamaArgs", "LLAMA2_7B", "init_params", "rms_norm",
           "rope_tables", "apply_rope_bcast", "apply_rope", "LAYER_KEYS",
           "sdpa_reference", "decoder_layer", "run_layers",
           "stack_leading_dim", "embed_lookup", "parallel_cross_entropy",
           "fused_linear_cross_entropy", "forward_hidden", "forward",
           "forward_and_loss", "REMAT_MODES"]

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1",
              "ln2")


class LlamaArgs(NamedTuple):
    """Static model config (`llama_functional.LlamaArgs`)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    rope_theta: float
    rms_eps: float
    use_flash: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_config(cfg):
        """From an object with the reference `LlamaConfig`'s attribute
        names; the optional ones take that class's defaults (kv heads =
        heads, rope theta 10000, rms eps 1e-6, flash attention on)."""
        return LlamaArgs(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            num_kv_heads=(getattr(cfg, "num_key_value_heads", None)
                          or cfg.num_attention_heads),
            rope_theta=getattr(cfg, "rope_theta", 10000.0),
            rms_eps=getattr(cfg, "rms_norm_eps", 1e-6),
            use_flash=getattr(cfg, "use_flash_attention", True))


# `LlamaConfig.llama2_7b` (paddle_tpu/models/llama.py:88) with its defaults:
# 32 kv heads (no GQA), rope theta 10000, rms eps 1e-6
LLAMA2_7B = LlamaArgs(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_layers=32, num_heads=32,
                      num_kv_heads=32, rope_theta=10000.0, rms_eps=1e-6)


def init_params(args: LlamaArgs, generator=None, *, device=None,
                dtype=torch.float32):
    """A random parameter tree (`llama_functional.init_params`): matmul
    weights and the embedding ~ N(0, 0.02), norms ones. Drawn on `device`
    (CUDA unless device="cpu") from `generator`, a torch.Generator on that
    device (default: seeded 0). JAX's threefry and torch's generators give
    different numbers from one seed: to compare with the reference, build
    the JAX tree and carry it over with `weights.params_from_numpy`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    h, i, L = args.hidden_size, args.intermediate_size, args.num_layers
    hd = args.head_dim

    def normal(*shape):
        w = torch.empty(shape, device=dev, dtype=dtype)
        return w.normal_(0.0, 0.02, generator=generator)

    layers = {
        "wq": normal(L, h, args.num_heads * hd),
        "wk": normal(L, h, args.num_kv_heads * hd),
        "wv": normal(L, h, args.num_kv_heads * hd),
        "wo": normal(L, args.num_heads * hd, h),
        "w_gate": normal(L, h, i),
        "w_up": normal(L, h, i),
        "w_down": normal(L, i, h),
        "ln1": torch.ones(L, h, device=dev, dtype=dtype),
        "ln2": torch.ones(L, h, device=dev, dtype=dtype),
    }
    return {"embedding": normal(args.vocab_size, h), "layers": layers,
            "final_norm": torch.ones(h, device=dev, dtype=dtype),
            "lm_head": normal(h, args.vocab_size)}


def rms_norm(x, w, eps):
    """RMSNorm over the last dim in the reference's rounding order:
    normalise in f32, cast to x's dtype, then scale by w in the working
    dtype. Kernel B9 on a CUDA tensor, its backward B10
    (`kernels/rms_norm.py`); their plain versions on a CPU one."""
    return rn.rms_norm(x, w, eps)


def rope_tables(seq_len, head_dim, theta, device=None):
    """cos/sin tables [seq_len, head_dim] in f32 (rotate-half layout)."""
    dev = torch.device("cpu") if device is None else device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=dev,
                                             dtype=torch.float32) / head_dim))
    t = torch.arange(seq_len, device=dev, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope_bcast(q, k, c, s):
    """RoPE with cos/sin already broadcast to q/k's rank: rotate-half in
    f32, then cast back to q's dtype."""
    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    dt = q.dtype
    q32, k32 = q.float(), k.float()
    return ((q32 * c + rot(q32) * s).to(dt),
            (k32 * c + rot(k32) * s).to(dt))


def apply_rope(q, k, cos, sin):
    """q/k [b, s, heads, hd], cos/sin [s, hd] (positions of the s rows)."""
    return apply_rope_bcast(q, k, cos[None, :, None, :], sin[None, :, None, :])


# --------------------------------------------------------------------------
# training path: the reference's single-device branch (mp_axis=None)
# --------------------------------------------------------------------------


def sdpa_reference(q, k, v, causal=False, scale=None):
    """`nn.functional.flash_attention._sdpa_reference` (:22) without dropout
    and mask: q [B, L, H, D], k/v [B, Lk, Hk, D] (kv heads repeated for
    GQA). Scores in the inputs' dtype, softmax in f32, probabilities cast
    back before P·V; causal is tril(k=Lk-Lq), masked scores at -1e30
    (-inf in fp16: `attention.neg_inf`)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = (qh @ kh.transpose(-1, -2)) * s
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        logits = torch.where(keep, logits, attn_k.neg_inf(logits.dtype))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return (probs @ vh).transpose(1, 2)


def _attention(q, k, v, use_flash):
    """q [b, s, h, d]; k/v [b, s, hk, d]; causal. `use_flash`: kernels B1-B3
    on a CUDA tensor (or an error), their plain versions on a CPU one."""
    if use_flash:
        return fa.flash_attention_fwd(q, k, v, causal=True)
    return sdpa_reference(q, k, v, causal=True)


def decoder_layer(p, h, cos, sin, args: LlamaArgs):
    """One decoder block (`llama_functional.decoder_layer` :157, one
    device): p holds one layer's leaves, h is [b, s, hidden]."""
    nh, nkv, hd = args.num_heads, args.num_kv_heads, args.head_dim
    hin = rms_norm(h, p["ln1"], args.rms_eps)
    b, s = hin.shape[0], hin.shape[1]
    q = (hin @ p["wq"]).view(b, s, nh, hd)
    k = (hin @ p["wk"]).view(b, s, nkv, hd)
    v = (hin @ p["wv"]).view(b, s, nkv, hd)
    q, k = apply_rope(q, k, cos[:s], sin[:s])
    attn = _attention(q, k, v, args.use_flash).reshape(b, s, nh * hd)
    h = h + attn @ p["wo"]
    hin = rms_norm(h, p["ln2"], args.rms_eps)
    act = F.silu(hin @ p["w_gate"]) * (hin @ p["w_up"])
    return h + act @ p["w_down"]


# matrix products without batch dims: what JAX's
# `dots_with_no_batch_dims_saveable` keeps (x @ W lowers to aten.mm; the
# attention products of `sdpa_reference` are batched, aten.bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _policy(saved):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


# remat mode -> checkpoint context (None: plain checkpoint). 'lean' also
# keeps the flash forward's out and lse, so backward runs no B1 (the
# reference names them "attn"/"attn_lse" inside its custom vjp).
_CONTEXTS = {True: None, "full": None, "dots": _policy(_DOTS),
             "lean": _policy(_DOTS + (fa.FLASH_FWD_OP,))}
REMAT_MODES = (False, True, "full", "half", "dots", "lean")


def stack_leading_dim(stack):
    return next(iter(stack.values())).shape[0]


def run_layers(stack, h, cos, sin, args: LlamaArgs, remat=True):
    """The decoder stack (`run_layers` :226, one device): a Python loop over
    the [L]-stacked leaves. remat: False (save everything), True/'full'
    (recompute each layer in backward), 'half' (every other layer; an odd
    count warns and goes full), 'dots' (save matmul outputs, recompute the
    rest), 'lean' ('dots' plus the flash out and lse)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    n = stack_leading_dim(stack)
    if remat == "half" and n % 2 != 0:
        warnings.warn("remat='half' needs an even layer count; falling back "
                      "to full remat")
        remat = True
    # unbind: one backward node per leaf stacks the L slices' grads once
    keys = sorted(stack)
    layers = [dict(zip(keys, vals))
              for vals in zip(*(torch.unbind(stack[k]) for k in keys))]
    for i, lp in enumerate(layers):
        mode = (i % 2 == 1) if remat == "half" else remat
        if not mode:
            h = decoder_layer(lp, h, cos, sin, args)
            continue
        ctx = _CONTEXTS[mode]
        kw = {} if ctx is None else {"context_fn": ctx}
        h = checkpoint(decoder_layer, lp, h, cos, sin, args,
                       use_reentrant=False, **kw)
    return h


def embed_lookup(table, ids):
    """`embed_lookup` :328, one device: rows of `table` [V, H] at ids."""
    return F.embedding(ids, table)


def parallel_cross_entropy(logits, labels):
    """Mean softmax cross entropy over [..., V] logits in f32
    (`parallel_cross_entropy` :345, one device)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    true_logit = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - true_logit).mean()


def _mm_f32(a, b):
    """a @ b summed and returned in f32 (`preferred_element_type=f32`): a
    bf16 product on the card keeps bf16 operands and an f32 output."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _ce_chunk_stats(h_c, head, labels_c, inv_n):
    """One chunk's CE loss sum and its input grads in one pass
    (`_ce_chunk_stats` :376): the logits' grad is (softmax - onehot) / n,
    known in forward. Returns (loss_sum f32, d_h_c [b, c, H] in h's dtype,
    d_head_c [H, V] f32)."""
    b, c, hidden = h_c.shape
    logits = (h_c @ head).float()                      # [b, c, V]
    labels_c = labels_c[..., None].long()
    m = logits.amax(dim=-1, keepdim=True)
    true_logit = logits.gather(-1, labels_c)[..., 0]
    e = logits.sub_(m).exp_()
    denom = e.sum(dim=-1, keepdim=True)
    lse = torch.log(denom[..., 0]) + m[..., 0]
    d_logits = e.div_(denom).scatter_add_(
        -1, labels_c, torch.full_like(true_logit[..., None], -1.0))
    dl = d_logits.mul_(inv_n).to(h_c.dtype)
    loss_sum = (lse - true_logit).sum()
    d_h = dl @ head.T
    d_head = _mm_f32(h_c.reshape(b * c, hidden).T, dl.reshape(b * c, -1))
    return loss_sum, d_h, d_head


def _fused_ce_loss_only(h, head, labels, chunk):
    """The loss alone, chunk by chunk (`_fused_ce_loss_only` :429): the
    path when nothing is differentiated."""
    b, s, _ = h.shape
    chunk = max(1, min(int(chunk), s))
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        per_tok = parallel_cross_entropy(h[:, c0:c1] @ head, labels[:, c0:c1])
        loss_sum = loss_sum + per_tok * (b * (c1 - c0))
    return loss_sum / (b * s)


class _FusedLinearCE(torch.autograd.Function):
    """Forward streams [b, chunk, V] logit tiles (the last chunk may be
    short) and computes the loss with d_h and d_head; backward scales them
    by the cotangent (`_fused_ce_fwd` :474, `_fused_ce_bwd` :507). Only
    d_h [b, s, H] and d_head [H, V] are saved."""

    @staticmethod
    def forward(ctx, h, head, labels, chunk):
        b, s, hidden = h.shape
        chunk = max(1, min(int(chunk), s))
        inv_n = 1.0 / (b * s)
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        d_head = torch.zeros(hidden, head.shape[-1], dtype=torch.float32,
                             device=h.device)
        d_h = torch.empty_like(h)
        for c0 in range(0, s, chunk):
            c1 = min(c0 + chunk, s)
            ls, d_h[:, c0:c1], d_hd = _ce_chunk_stats(
                h[:, c0:c1], head, labels[:, c0:c1], inv_n)
            loss_sum += ls
            d_head += d_hd
        ctx.save_for_backward(d_h, d_head.to(head.dtype))
        return loss_sum * inv_n

    @staticmethod
    def backward(ctx, g):
        d_h, d_head = ctx.saved_tensors
        return d_h * g.to(d_h.dtype), d_head * g.to(d_head.dtype), None, None


def fused_linear_cross_entropy(h, head, labels, chunk=128):
    """lm_head matmul + mean softmax CE over all b·s tokens, streamed over
    sequence chunks (`fused_linear_cross_entropy` :456): the [b, s, V]
    logits exist in no pass. h [b, s, H], head [H, V], labels [b, s].
    Runs inside the profiler range "fused_ce"."""
    with torch.profiler.record_function("fused_ce"):
        if torch.is_grad_enabled() and (h.requires_grad
                                        or head.requires_grad):
            return _FusedLinearCE.apply(h, head, labels, chunk)
        return _fused_ce_loss_only(h, head, labels, chunk)


def forward_hidden(params, ids, args: LlamaArgs, remat=True):
    """Forward up to the final hidden states, before lm_head
    (`forward_hidden` :543). ids [b, s] integer."""
    h = embed_lookup(params["embedding"], ids)
    cos, sin = rope_tables(ids.shape[1], args.head_dim, args.rope_theta,
                           h.device)
    h = run_layers(params["layers"], h, cos, sin, args, remat)
    return rms_norm(h, params["final_norm"], args.rms_eps)


def forward(params, ids, args: LlamaArgs, remat=True):
    """Logits [b, s, V] (`forward` :516)."""
    return forward_hidden(params, ids, args, remat) @ params["lm_head"]


def forward_and_loss(params, ids, labels, args: LlamaArgs, remat=True,
                     loss_chunk=None):
    """Mean next-token CE (`forward_and_loss` :524). loss_chunk: the fused
    chunked lm_head + CE; else the full logits and `parallel_cross_entropy`."""
    if loss_chunk:
        h = forward_hidden(params, ids, args, remat)
        return fused_linear_cross_entropy(h, params["lm_head"], labels,
                                          int(loss_chunk))
    return parallel_cross_entropy(forward(params, ids, args, remat), labels)
