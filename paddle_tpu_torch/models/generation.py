"""Autoregressive generation over a fixed-size or paged KV cache (port of
`paddle_tpu/models/generation.py`).

The reference traces a whole decode into one XLA program; PyTorch runs
eagerly, so the layer scan is a Python loop over L and the decode scan a
Python loop over steps. What carries over unchanged is the cache design:

  - the stripe cache is ONE buffer [L, b, nkv, max_len, hd] (heads-major,
    the layout the decode kernels read), written at each row's position
    and masked past it;
  - the paged cache is a pool [L, num_pages, nkv, page_size, hd] read
    through per-row block tables [b, P] (page i of row r holds positions
    [i*ps, (i+1)*ps); unused entries point at the null page 0), in the
    model dtype or as a `QuantizedKVPage` pair of int8 codes and
    per-(page, kv head) absmax scales [L, num_pages, nkv] f32.

Weights may be float or weight-only int8 (`quantize_params`:
`QuantizedWeight` leaves, dequant = q * scale / 127). Every matmul goes
through `_wmm`: a float weight takes the plain `@`, an int8 weight kernel
B8 `weight_only_matmul` (`kernels/quantized_matmul.py`). The compute dtype
is the embedding's.

Where JAX returns fresh buffers (donated on the TPU), the port writes the
caches and pools IN PLACE and returns the same tensors.

Attention dispatch (`_cached_attention`), by shape only:
  s == 1                 -> kernel B4 `decode_attention`;
  s * (nh // nkv) <= 64  -> kernel B5 `window_attention`;
  otherwise              -> plain masked attention (matmul + softmax), as
                            the reference computes it outside any kernel.
The paged decode step always runs kernel B6 `paged_decode_attention`, or B7
(the same wrapper with the pool's scales) over an int8 pool, after the
running-absmax write `_kv_quant_write`. The speculative verify window
(`_paged_forward_verify`) writes its tokens into the tail pages, gathers
the row's pages and takes `_cached_attention`'s per-row branch. Each
wrapper routes a CPU tensor to its plain version and a CUDA tensor to the
kernel (`kernels/attention.py`).

Sampling: the reference draws from JAX's threefry; the port from torch
generators. The two never give the same tokens from one seed — parity is
held on greedy decoding; sampling is held to seed reproducibility and
batch-independence within the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.device import check_device, resolve_device
from paddle_tpu_torch.kernels import attention as attn_k
from paddle_tpu_torch.kernels import quantized_matmul as qmm
from paddle_tpu_torch.models import llama_functional as lf

__all__ = ["generate", "prefill", "decode_step", "paged_decode_step",
           "QuantizedWeight", "QuantizedKVPage", "quantize_params",
           "draft_from_params", "params_from_layer"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# int8 weights and KV pages
# ---------------------------------------------------------------------------


class QuantizedWeight(NamedTuple):
    """Weight-only int8 leaf: `q` int8 [..., K, N] with per-output-channel
    absmax `scale` [..., N] f32 (dequant = q * scale / 127). Stacked
    [L, ...] leaves index per layer like plain weights (`Llama.layer`)."""

    q: torch.Tensor
    scale: torch.Tensor


class QuantizedKVPage(NamedTuple):
    """One half (K or V) of an int8 page pool: `q` int8 [..., num_pages,
    nkv, page_size, hd] with per-(page, kv head) absmax `scale` [...,
    num_pages, nkv] f32 (dequant = q * scale / 127)."""

    q: torch.Tensor
    scale: torch.Tensor


def _layer_pool(pool, i):
    """Layer i of a stacked pool (a tensor or a QuantizedKVPage), as views
    that writes go through."""
    if isinstance(pool, QuantizedKVPage):
        return QuantizedKVPage(pool.q[i], pool.scale[i])
    return pool[i]


def _kv_quant_write(pool, page, off, new):
    """Write one token's K or V rows `new` [b, nkv, hd] into an int8 page
    pool at (page[r], :, off[r]), IN PLACE, keeping each (page, kv head)
    absmax scale running: when the token's absmax exceeds the page's
    scale, the page's codes are re-scaled (round(q * old / new)) before
    the write. A write at offset 0 is a page's first (positions fill pages
    in order), so the scale restarts there instead of inheriting the
    previous owner's. Rows own their pages (the host COW gate), except the
    null page 0, a garbage sink. The reference's arithmetic, in f32."""
    q, scale = pool
    b = page.shape[0]
    newf = new.float()
    tok_abs = newf.abs().amax(dim=-1)                          # [b, nkv]
    old_s = torch.where(off[:, None] == 0, 0.0, scale[page])
    new_s = torch.maximum(old_s, tok_abs)
    safe = new_s.clamp_min(1e-9)
    pg = q[page].float() * (old_s / safe)[:, :, None, None]
    pg[torch.arange(b, device=pg.device), :, off] = \
        newf / safe[..., None] * 127.0
    q[page] = torch.round(pg).clamp_(-127, 127).to(torch.int8)
    scale[page] = new_s
    return pool


def _quantize_weight(w):
    """QuantizedWeight of w [..., K, N], one [K, N] matrix at a time so
    that the f32 temporaries stay one matrix wide."""
    if w.dim() == 2:
        return QuantizedWeight(*qmm.quantize_absmax(w))
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_weight(w[i])
    return QuantizedWeight(q, scale)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params):
    """Weight-only int8 quantization (`generation.quantize_params`): every
    per-layer matmul weight and the lm_head become QuantizedWeight leaves;
    the embedding and the norms stay float. `params` is a `Llama` (the
    result is a `Llama` on the same device, quantized there) or a
    parameter tree (the result is a tree)."""
    from paddle_tpu_torch.models.llama import Llama

    if isinstance(params, Llama):
        return Llama(params.args, quantize_params(params.tree()))
    layers = {k: (_quantize_weight(v) if k in _QUANT_KEYS else v)
              for k, v in params["layers"].items()}
    return dict(params, layers=layers,
                lm_head=_quantize_weight(params["lm_head"]))


def draft_from_params(model, num_layers):
    """A draft model for speculative decoding (`draft_from_params` :137):
    a `Llama` whose decoder layers are the target's first `num_layers`,
    as views of its weights (nothing is copied), with the embedding, the
    final norm and the head shared. Works on float and int8 models."""
    from paddle_tpu_torch.models.llama import Llama

    n = int(num_layers)
    if not 1 <= n <= model.args.num_layers:
        raise ValueError(f"draft must keep 1..{model.args.num_layers} "
                         f"layers, got {num_layers}")
    tree = model.tree()
    layers = {k: (QuantizedWeight(v.q[:n], v.scale[:n])
                  if isinstance(v, QuantizedWeight) else v[:n])
              for k, v in tree["layers"].items()}
    return Llama(model.args._replace(num_layers=n), dict(tree, layers=layers))


def params_from_layer(model):
    """The functional tree (`llama_functional.init_params`'s layout, layer
    leaves stacked on a leading [L] dim) of a layer-built
    `LlamaForCausalLM` / `LlamaModel` (`models.llama`;
    `paddle_tpu/models/generation.py:152`). Every weight is [in, out] in
    both. The leaves are new tensors, detached from the layers' (a
    stacked copy; the embedding and the norms are detached views)."""
    core = getattr(model, "model", model)
    lm_head = getattr(model, "lm_head", None)

    def arr(t):
        return t._data.detach()

    layers = core.layers
    names = [("wq", lambda l: l.self_attn.q_proj.weight),
             ("wk", lambda l: l.self_attn.k_proj.weight),
             ("wv", lambda l: l.self_attn.v_proj.weight),
             ("wo", lambda l: l.self_attn.o_proj.weight),
             ("w_gate", lambda l: l.mlp.gate_proj.weight),
             ("w_up", lambda l: l.mlp.up_proj.weight),
             ("w_down", lambda l: l.mlp.down_proj.weight),
             ("ln1", lambda l: l.input_layernorm.weight),
             ("ln2", lambda l: l.post_attention_layernorm.weight)]
    stacked = {key: torch.stack([arr(get(l)) for l in layers])
               for key, get in names}
    return {
        "embedding": arr(core.embed_tokens.weight),
        "layers": stacked,
        "final_norm": arr(core.norm.weight),
        "lm_head": (arr(lm_head.weight) if lm_head is not None
                    else arr(core.embed_tokens.weight).T),
    }


def _wmm(x, w):
    """Matmul that understands QuantizedWeight leaves: a float weight takes
    the plain `@`, an int8 weight kernel B8 (CPU tensors: its plain
    version)."""
    if isinstance(w, QuantizedWeight):
        return qmm.weight_only_matmul(x.contiguous(), w.q, w.scale,
                                      out_dtype=x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _masked_attention(q, cache_k, cache_v, pos):
    """The reference's plain masked attention of q [b, s, nh, hd] over
    the whole cache: query i of row r sees keys <= pos[r] + i (pos an int
    or a [b] tensor). Used for windows too wide for kernel B5."""
    b, s, nh, hd = q.shape
    nkv, max_len = cache_k.shape[1], cache_k.shape[2]
    if nkv != nh:
        cache_k = cache_k.repeat_interleave(nh // nkv, dim=1)
        cache_v = cache_v.repeat_interleave(nh // nkv, dim=1)
    scores = (q.transpose(1, 2) @ cache_k.transpose(-1, -2)) / math.sqrt(hd)
    key_pos = torch.arange(max_len, device=q.device)
    rows = torch.arange(s, device=q.device).reshape(1, 1, s, 1)
    qpos = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1) + rows
    scores = torch.where(key_pos <= qpos, scores,
                         attn_k.neg_inf(scores.dtype))
    probs = torch.softmax(scores.float(), dim=-1)
    return (probs.to(cache_v.dtype) @ cache_v).transpose(1, 2)


def _cached_attention(q, cache_k, cache_v, pos):
    """Attention of q [b, s, nh, hd] over the fixed-size cache
    [b, nkv, max_len, hd] at position pos (an int: every row at the same
    depth; or an int32 [b] tensor: row r at pos[r], query i at pos[r]+i).
    Dispatch by shape only (module docstring)."""
    s, nh = q.shape[1], q.shape[2]
    if s == 1:
        return attn_k.decode_attention(q, cache_k, cache_v, pos)
    if s * (nh // cache_k.shape[1]) <= attn_k.WINDOW_MAX_ROWS:
        return attn_k.window_attention(q, cache_k, cache_v, pos)
    return _masked_attention(q, cache_k, cache_v, pos)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _rope_rows(q, k, cos_r, sin_r):
    """RoPE at per-row positions: q/k [b, 1, heads, hd], cos_r/sin_r
    [b, hd] (table rows gathered at each row's position)."""
    return lf.apply_rope_bcast(q, k, cos_r[:, None, None, :],
                               sin_r[:, None, None, :])


def _mlp_block(lp, h, args):
    hin = lf.rms_norm(h, lp["ln2"], args.rms_eps)
    act = F.silu(_wmm(hin, lp["w_gate"])) * _wmm(hin, lp["w_up"])
    return h + _wmm(act, lp["w_down"])


def _qkv(lp, h, args):
    b, s = h.shape[0], h.shape[1]
    hd = args.head_dim
    hin = lf.rms_norm(h, lp["ln1"], args.rms_eps)
    q = _wmm(hin, lp["wq"]).view(b, s, args.num_heads, hd)
    k = _wmm(hin, lp["wk"]).view(b, s, args.num_kv_heads, hd)
    v = _wmm(hin, lp["wv"]).view(b, s, args.num_kv_heads, hd)
    return q, k, v


def _layer_step(lp, h, cache_k, cache_v, pos, cos, sin, args):
    """One decoder layer over h [b, s, hid] with the cache [b, nkv,
    max_len, hd] of this layer, written in place (write-before-attend).

    pos: an int — every row at the same depth, slots [pos, pos+s) written
    (prefill at 0; the uniform decode step); or an int32 [b] tensor
    (requires s == 1) — the continuous-batching decode step, row r at its
    own position pos[r]: per-row RoPE, per-row cache write, per-row mask."""
    b, s = h.shape[0], h.shape[1]
    q, k, v = _qkv(lp, h, args)
    if torch.is_tensor(pos) and pos.dim() == 1:
        if s != 1:
            raise ValueError(f"per-row pos vector requires s == 1 (got s={s})")
        pos_l = pos.long()
        q, k = _rope_rows(q, k, cos[pos_l], sin[pos_l])
        rows = torch.arange(b, device=h.device)
        cache_k[rows, :, pos_l] = k[:, 0]
        cache_v[rows, :, pos_l] = v[:, 0]
    else:
        p = int(pos)
        if p + s > cache_k.shape[2]:
            raise ValueError(f"writing [{p}, {p + s}) overflows a cache of "
                             f"{cache_k.shape[2]} slots")
        q, k = lf.apply_rope(q, k, cos[p:p + s], sin[p:p + s])
        cache_k[:, :, p:p + s] = k.transpose(1, 2)
        cache_v[:, :, p:p + s] = v.transpose(1, 2)
    attn = _cached_attention(q, cache_k, cache_v, pos)
    h = h + _wmm(attn.reshape(b, s, -1), lp["wo"])
    return _mlp_block(lp, h, args)


def _layer_step_paged(lp, h, pool_k_l, pool_v_l, bt, pos, cos, sin, args,
                      page_size, max_pos=None):
    """One decoder layer's decode step (s == 1) over this layer's page pool
    [num_pages, nkv, ps, hd] (a tensor, or a QuantizedKVPage pair): row r's
    new k/v is written in place at (bt[r, pos[r] // ps], pos[r] % ps) —
    rows own their tail pages (the host-side COW gate), inactive rows
    write into the null page — then kernel B6 (B7 over int8 pages) attends
    through the block tables, its keys split for max_pos (a host-known
    bound on pos, or None)."""
    b, s = h.shape[0], h.shape[1]
    if s != 1:
        raise ValueError(f"paged decode requires s == 1 (got s={s})")
    q, k, v = _qkv(lp, h, args)
    pos_l = pos.long()
    q, k = _rope_rows(q, k, cos[pos_l], sin[pos_l])
    page = bt.long().gather(1, (pos_l // page_size)[:, None])[:, 0]
    off = pos_l % page_size
    if isinstance(pool_k_l, QuantizedKVPage):
        _kv_quant_write(pool_k_l, page, off, k[:, 0])
        _kv_quant_write(pool_v_l, page, off, v[:, 0])
        attn = attn_k.paged_decode_attention(
            q, pool_k_l.q, pool_v_l.q, bt, pos, k_scale=pool_k_l.scale,
            v_scale=pool_v_l.scale, max_pos=max_pos)
    else:
        pool_k_l[page, :, off] = k[:, 0]
        pool_v_l[page, :, off] = v[:, 0]
        attn = attn_k.paged_decode_attention(q, pool_k_l, pool_v_l, bt, pos,
                                             max_pos=max_pos)
    h = h + _wmm(attn.reshape(b, 1, -1), lp["wo"])
    return _mlp_block(lp, h, args)


def _layer_step_paged_verify(lp, h, pool_k_l, pool_v_l, bt, pos, limit, cos,
                             sin, args, page_size):
    """One decoder layer over a speculation window of s tokens against the
    paged cache (`_layer_step_paged_verify` :400): query i of row r sits at
    pos[r] + i. The window's k/v are written into the row's tail pages
    before attention (the host has made them writable through
    min(pos + s - 1, limit)); writes past limit[r], the row's last legal
    KV index, go to the null page. An int8 pool takes them one token at a
    time through the running-absmax write. Attention gathers the row's
    table (dequantized from an int8 pool) and runs `_cached_attention`'s
    per-row branch: kernel B5 when s * (nh // nkv) <= 64 on the card."""
    b, s = h.shape[0], h.shape[1]
    q, k, v = _qkv(lp, h, args)
    prow = pos.long()[:, None] + torch.arange(s, device=h.device)[None, :]
    q, k = lf.apply_rope_bcast(q, k, cos[prow][:, :, None, :],
                               sin[prow][:, :, None, :])
    col = (prow // page_size).clamp_(max=bt.shape[1] - 1)
    page = torch.where(prow <= limit.long()[:, None],
                       bt.long().gather(1, col), 0)
    off = prow % page_size
    if isinstance(pool_k_l, QuantizedKVPage):
        for i in range(s):
            _kv_quant_write(pool_k_l, page[:, i], off[:, i], k[:, i])
            _kv_quant_write(pool_v_l, page[:, i], off[:, i], v[:, i])
        ck = attn_k.paged_gather(pool_k_l.q, bt, pool_k_l.scale, q.dtype)
        cv = attn_k.paged_gather(pool_v_l.q, bt, pool_v_l.scale, q.dtype)
    else:
        nkv, hd = k.shape[2], k.shape[3]
        pool_k_l[page.reshape(-1), :, off.reshape(-1)] = \
            k.reshape(b * s, nkv, hd)
        pool_v_l[page.reshape(-1), :, off.reshape(-1)] = \
            v.reshape(b * s, nkv, hd)
        ck = attn_k.paged_gather(pool_k_l, bt)
        cv = attn_k.paged_gather(pool_v_l, bt)
    attn = _cached_attention(q, ck, cv, pos)
    h = h + _wmm(attn.reshape(b, s, -1), lp["wo"])
    return _mlp_block(lp, h, args)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def _logits(model, h, last_idx=None):
    h = lf.rms_norm(h, model.final_norm, model.args.rms_eps)
    if last_idx is None:
        hl = h[:, -1]
    else:
        idx = torch.as_tensor(last_idx, device=h.device).long()
        idx = idx.reshape(-1).expand(h.shape[0])
        hl = h[torch.arange(h.shape[0], device=h.device), idx]
    return _wmm(hl, model.lm_head).float()


@torch.no_grad()
def _forward_cached(model, ids, caches_k, caches_v, pos, cos, sin,
                    last_idx=None):
    """ids [b, s] -> (next-token logits [b, vocab] f32, caches_k,
    caches_v), the caches [L, b, nkv, max_len, hd] written in place.

    last_idx: index of the last real token of each row (an int or a [b]
    tensor) — padded prefills take their logits there; None takes h[:, -1]."""
    h = model.embedding[ids.long()]
    for i in range(model.args.num_layers):
        h = _layer_step(model.layer(i), h, caches_k[i], caches_v[i], pos,
                        cos, sin, model.args)
    return _logits(model, h, last_idx), caches_k, caches_v


@torch.no_grad()
def _paged_forward_decode(model, ids, pool_k, pool_v, bt, pos, cos, sin,
                          page_size, max_pos=None):
    """ids [b, 1] -> (next-token logits [b, vocab] f32, pool_k, pool_v),
    the pools [L, num_pages, nkv, ps, hd] (tensors or QuantizedKVPage
    pairs) written in place; bt int32 [b, P], pos int32 [b]; max_pos, an
    int bound on pos known to the host, cuts the attention's key split."""
    h = model.embedding[ids.long()]
    for i in range(model.args.num_layers):
        h = _layer_step_paged(model.layer(i), h, _layer_pool(pool_k, i),
                              _layer_pool(pool_v, i), bt, pos, cos, sin,
                              model.args, page_size, max_pos)
    return _logits(model, h), pool_k, pool_v


@torch.no_grad()
def _paged_forward_verify(model, ids, pool_k, pool_v, bt, pos, limit, cos,
                          sin, page_size):
    """The speculative verify forward (`_paged_forward_verify` :490): ids
    [b, s] (the last committed token, then s - 1 draft tokens; token i of
    row r at position pos[r] + i) -> (logits [b, s, vocab] f32 at every
    window position, pool_k, pool_v), the pools written in place."""
    h = model.embedding[ids.long()]
    for i in range(model.args.num_layers):
        h = _layer_step_paged_verify(model.layer(i), h, _layer_pool(pool_k, i),
                                     _layer_pool(pool_v, i), bt, pos, limit,
                                     cos, sin, model.args, page_size)
    h = lf.rms_norm(h, model.final_norm, model.args.rms_eps)
    return _wmm(h, model.lm_head).float(), pool_k, pool_v


def _on_model_device(model, device):
    dev = resolve_device(device)
    check_device(model.device, dev)
    return dev


def paged_decode_step(model, token, pool_k, pool_v, block_tables, pos,
                      page_size, device=None):
    """One continuous-batching decode step over a paged KV cache: token
    [b] at per-row positions pos [b]; K/V pages [L, num_pages, nkv, ps,
    hd] indexed through block_tables [b, P] (unused entries: the null page
    0), in the model dtype or as QuantizedKVPage pairs (int8 codes +
    scales [L, num_pages, nkv]). The pools are written in place. Returns
    (logits [b, vocab] f32, pool_k, pool_v)."""
    dev = _on_model_device(model, device)
    bt = torch.as_tensor(block_tables, dtype=torch.int32).to(dev).contiguous()
    pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
    cos, sin = lf.rope_tables(bt.shape[1] * int(page_size),
                              model.args.head_dim, model.args.rope_theta, dev)
    token = torch.as_tensor(token).to(dev)
    return _paged_forward_decode(model, token[:, None], pool_k, pool_v, bt,
                                 pos, cos, sin, int(page_size))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _per_row(x, b, dtype, device):
    return torch.as_tensor(x, dtype=dtype).to(device).reshape(-1).expand(b)


def _warp_logits(logits, temperature, top_p, top_k):
    """The per-request logit warp (reference `_warp_logits`): temperature,
    then the top-k mask, then the nucleus mask over the k survivors
    (-1e30 for killed entries). Returns (masked [b, vocab], greedy_rows
    [b]). One deliberate difference: where the cumulative probability
    never reaches top_p (top_p = 1.0 and a sum that rounds below 1), the
    reference's out-of-range gather yields NaN and masks every entry; the
    port keeps all k survivors, which is what the reference intends."""
    b, vocab = logits.shape
    dev = logits.device
    t = _per_row(temperature, b, torch.float32, dev)
    greedy_rows = t <= 0.0
    scaled = logits / torch.where(greedy_rows, 1.0, t)[:, None]

    k_vec = _per_row(top_k, b, torch.int64, dev)
    k_eff = torch.where(k_vec <= 0, vocab, k_vec.clamp(max=vocab))
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(vocab, device=dev)[None, :]
    kth = sorted_logits.gather(1, (k_eff - 1)[:, None])
    sorted_masked = torch.where(rank < k_eff[:, None], sorted_logits, NEG_INF)

    p_vec = _per_row(top_p, b, torch.float32, dev)[:, None]
    cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    cutoff_idx = (cum < p_vec).sum(dim=-1, keepdim=True)
    cutoff_idx = torch.minimum(cutoff_idx, (k_eff - 1)[:, None])
    cutoff = sorted_masked.gather(1, cutoff_idx)
    masked = torch.where((scaled >= cutoff) & (scaled >= kth), scaled,
                         NEG_INF)
    return masked, greedy_rows


def _mix64(x):
    """splitmix64's finaliser: every output bit depends on every input bit
    (the CPU generator keeps only the low 32 bits of its seed)."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) >> 1          # a non-negative int64


def _row_uniforms(seeds, pos, vocab, device, salt=0):
    """Uniforms [b, vocab] in [1e-20, 1): row r's are a pure function of
    (seeds[r], pos[r]) — one torch generator per row seeded from the
    pair — so a request's draws do not depend on its batch-mates (the
    port's counterpart of the reference's `_row_keys`). A nonzero `salt`
    gives another stream of the same pair (speculative decoding's accept
    and resample decisions). Torch's generators differ between CPU and
    CUDA, so the draws do too."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    pos = np.broadcast_to(np.asarray(pos, np.int64).reshape(-1), seeds.shape)
    rows = []
    for sd, p in zip(seeds, pos):
        key = ((int(sd) & 0x7FFFFFFF) << 32) | (int(p) & 0xFFFFFFFF)
        if salt:
            key ^= _mix64(int(salt))
        g = torch.Generator(device=device)
        g.manual_seed(_mix64(key))
        rows.append(torch.rand(vocab, generator=g, device=device))
    return torch.stack(rows).clamp_(min=1e-20)


def _sample(logits, sample, temperature, top_p, top_k=0, generator=None,
            seeds=None, pos=None):
    """The per-request sampler (reference `_sample`). sample=False is a
    bare argmax. Otherwise rows with temperature <= 0 stay exact argmax and
    the others draw by gumbel-max from the warped logits: from per-row
    (seed, position) streams when `seeds` (host ints [b]) and `pos` are
    given, else from `generator`."""
    if not sample:
        return logits.argmax(dim=-1).to(torch.int32)
    masked, greedy_rows = _warp_logits(logits, temperature, top_p, top_k)
    b, vocab = logits.shape
    if seeds is not None:
        u = _row_uniforms(seeds, pos, vocab, logits.device)
    else:
        u = torch.rand(b, vocab, generator=generator,
                       device=logits.device).clamp_(min=1e-20)
    drawn = (masked - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(greedy_rows, logits.argmax(dim=-1),
                       drawn).to(torch.int32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _init_cache(model, b, max_len):
    """Zeroed caches [L, b, nkv, max_len, hd] + RoPE tables."""
    a = model.args
    shape = (a.num_layers, b, a.num_kv_heads, max_len, a.head_dim)
    ck = torch.zeros(shape, dtype=model.dtype, device=model.device)
    cv = torch.zeros_like(ck)
    cos, sin = lf.rope_tables(max_len, a.head_dim, a.rope_theta, model.device)
    return ck, cv, cos, sin


def prefill(model, prompt_ids, max_len, device=None):
    """Run the prompt [b, s] through the model once, filling new caches.
    Returns (next-token logits [b, vocab] f32, caches_k, caches_v), caches
    [L, b, nkv, max_len, hd]."""
    dev = _on_model_device(model, device)
    ids = torch.as_tensor(prompt_ids).to(dev)
    ck, cv, cos, sin = _init_cache(model, ids.shape[0], max_len)
    return _forward_cached(model, ids, ck, cv, 0, cos, sin)


def decode_step(model, token, caches_k, caches_v, pos, max_len, device=None):
    """One incremental step: token [b] at position pos — an int (every row
    at that depth) or an int32 [b] vector of per-row positions (the
    continuous-batching step). Caches are written in place."""
    dev = _on_model_device(model, device)
    cos, sin = lf.rope_tables(max_len, model.args.head_dim,
                              model.args.rope_theta, dev)
    if not isinstance(pos, int):
        pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
        if pos.dim() == 0:
            pos = int(pos)
    token = torch.as_tensor(token).to(dev)
    return _forward_cached(model, token[:, None], caches_k, caches_v, pos,
                           cos, sin)


def _decode_loop(fwd, prompt_ids, max_new_tokens, sample, temperature,
                 top_p, generator, use_eos=False, eos_id=0, pad_id=0,
                 top_k=0, seeds=None):
    """prefill -> sample -> decode steps (reference `_decode_loop`):
    fwd(ids, pos) -> logits. Rows that emit eos_id are done and emit
    pad_id from then on; the output is [b, s + max_new_tokens]."""
    b, s = prompt_ids.shape

    def pick(logits, p):
        return _sample(logits, sample, temperature, top_p, top_k, generator,
                       seeds, None if seeds is None else p)

    token = pick(fwd(prompt_ids, 0), s)
    done = token == eos_id if use_eos else None
    out = [prompt_ids.to(torch.int32), token[:, None]]
    for pos in range(s, s + max_new_tokens - 1):
        nxt = pick(fwd(token[:, None], pos), pos + 1)
        if use_eos:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt[:, None])
        token = nxt
    return torch.cat(out, dim=1)


def generate(model, prompt_ids, max_new_tokens=32, temperature=0.0,
             top_p=1.0, generator=None, eos_token_id=None, pad_token_id=0,
             top_k=0, seeds=None, device=None):
    """Generate max_new_tokens after the prompt [b, s]; returns
    [b, s + max_new_tokens] int32. temperature 0 = greedy; top_p < 1 =
    nucleus; top_k > 0 keeps the k largest logits; each may be a scalar or
    a per-row [b] vector. seeds: optional per-row ints — each row then
    samples from its own (seed, position) stream, independent of the
    batch; otherwise draws come from `generator`. Rows that emit
    eos_token_id produce pad_token_id afterwards."""
    dev = _on_model_device(model, device)
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int32)).to(dev)
    if max_new_tokens <= 0:
        return ids
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = bool(np.any(np.asarray(temperature) != 0.0))
    b, s = ids.shape
    ck, cv, cos, sin = _init_cache(model, b, s + max_new_tokens)

    def fwd(x, pos):
        return _forward_cached(model, x, ck, cv, pos, cos, sin)[0]

    use_eos = eos_token_id is not None
    return _decode_loop(fwd, ids, max_new_tokens, sample,
                        temperature if sample else 1.0, top_p, generator,
                        use_eos, int(eos_token_id) if use_eos else 0,
                        int(pad_token_id), top_k,
                        None if seeds is None else np.asarray(seeds))
