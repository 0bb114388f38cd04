"""Decode-time attention: the wrappers of kernels B4, B5, B6, B7 and their
plain PyTorch versions.

  B4  `decode_attention`        replaces `_decode_kernel` (:253)
  B5  `window_attention`        replaces `_window_kernel` (:363)
  B6  `paged_decode_attention`  replaces `_paged_decode_kernel` (:529)
  B7  `paged_decode_attention(..., k_scale=, v_scale=)` over an int8 pool
                                replaces `_paged_decode_kernel_q8` (:595)

(in paddle_tpu/kernels/quantized_matmul.py)

Each wrapper routes by the device of the tensors it is given: a CPU tensor
goes to the plain version beside it (`*_plain`, mirroring the reference's
`_*_xla` oracles), a CUDA tensor to the hand-written kernel in
`csrc/attention.cu`, which the wrapper checks shapes, dtypes and
contiguity for and raises on what the kernel does not take. Nothing falls
back: a CUDA tensor never reaches a plain version. `launches` counts the
kernel launches of each wrapper (a plain call counts nothing), so a run
can show that its main path went through the kernels; `variant_launches`
counts, beside it, the launches in fp16.

While a trace runs (`_tracing`: `make_fx` over fake tensors,
`torch.export`, `torch.compile`) each wrapper goes through its custom
operator instead, B8's pattern: `paddle_tpu_torch::decode_attention`,
`::window_attention`, `::paged_decode_attention` and
`::paged_decode_attention_q8`. A traced program holds one node per call;
the host's ints (the split count the wrapper reads off `decode_splits`,
`window_splits` or `paged_splits`, the scale) are the node's arguments,
fixed at trace time as the reference fixes a static argument, and the
operator's body checks the pointers and launches the kernel at every call
of the program (its plain version on CPU tensors).

Layouts are the reference's: q [b, s, nh, hd] (s = 1 for B4/B6), the
contiguous cache [b, nkv, len, hd], the page pool [num_pages, nkv, ps, hd]
with block tables [b, P] (page i of row r holds its positions
[i*ps, (i+1)*ps); unused entries point at the null page 0), per-row
positions `pos` int32 [b] (or one int for every row). GQA is native: query
head h reads kv head h // (nh // nkv). An int8 pool carries per-(page, kv
head) absmax scales [num_pages, nkv] f32: dequant = code * scale / 127.
The kernels take q (and a float pool) in bf16, fp16 or f32.
"""

from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake

from paddle_tpu_torch.kernels import _build

__all__ = ["decode_attention", "window_attention", "paged_decode_attention",
           "decode_attention_plain", "window_attention_plain",
           "paged_decode_attention_plain", "paged_gather", "launches",
           "reset_launches", "WINDOW_MAX_ROWS", "KERNEL_HEAD_DIMS",
           "row_splits", "cut_keys", "window_splits", "window_split_keys",
           "paged_route", "paged_splits", "paged_split_keys",
           "decode_splits", "decode_split_keys", "WINDOW_SPLIT_TILES",
           "variant_launches", "neg_inf",
           "PAGED_SPLIT_TILES", "DECODE_ATTENTION_OP", "WINDOW_ATTENTION_OP",
           "PAGED_DECODE_ATTENTION_OP", "PAGED_DECODE_ATTENTION_Q8_OP"]

NEG_INF = -1e30
# flattened query rows (s * g) a window kernel block holds; wider windows
# are the caller's plain masked attention (generation._cached_attention)
WINDOW_MAX_ROWS = 64
KERNEL_HEAD_DIMS = (64, 128)
# the dtype codes of the C entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# B4-B7 in bf16 and fp16 walk the keys in tiles of WINDOW_TILE, split over at
# most WINDOW_MAX_SPLITS blocks (one thread-block cluster) per (kv head, row).
# A row takes one split for every WINDOW_SPLIT_TILES (B5) or PAGED_SPLIT_TILES
# (B4, B6, B7) tiles of its own keys (`row_splits`): a count of the row alone,
# so that its bf16 or fp16 result does not depend on the other rows of its
# batch. Both thresholds come from kernels/sweep_decode.py on an H100. B5: 8 of
# 2-32, the smallest worst loss (7.7%) against each shape's fastest at b=1,
# s=16 after 192-2000 keys and on the ragged verify window. B4/B6/B7: 8,
# between the regimes a batch-blind rule must serve: a row decoding alone wants
# more splits (600 keys: 1 split 0.0233 ms, 2 splits 0.0169), 8 ragged rows
# fewer (to 2047 keys: 12 tiles a split 0.0397 ms, 8 tiles 0.0454); the
# engine's 8 rows of 257-320 keys take 1 split under either
WINDOW_TILE = 64
WINDOW_MAX_SPLITS = 8
WINDOW_SPLIT_TILES = 8
PAGED_SPLIT_TILES = 8

launches = {"decode_attention": 0, "window_attention": 0,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}
# each wrapper's launches with an fp16 query, counted beside its total
variant_launches = {f"{k}_f16": 0 for k in launches}


def reset_launches():
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


def _count(name, dtype):
    launches[name] += 1
    variant_launches[f"{name}_f16"] += dtype == torch.float16


# ---------------------------------------------------------------------------
# routing and checks
# ---------------------------------------------------------------------------


def _on_card(*tensors):
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _tracing(*tensors):
    """True while a trace runs: `torch.compile` or `torch.export`, or any
    of `tensors` fake (`make_fx`, a static Program's shape pass). A traced
    tensor has no pointer to read, so a kernel's wrapper goes through its
    custom operator, whose body reads the pointers at every call."""
    return torch.compiler.is_compiling() or any(
        is_fake(t) for t in tensors)


def _dense(t):
    """t as the kernels read it: contiguous and 16-byte aligned (a fresh
    copy, differentiable, when a view is not). A caller that routes a
    strided view to a kernel hands it this. While a trace runs there is no
    pointer to read: the program gets a `contiguous()` node, and the
    kernel op's body checks the alignment at every call."""
    if _tracing(t):
        return t.contiguous()
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_gqa(q, nkv, hd):
    if q.shape[-1] != hd:
        raise ValueError(f"q head_dim {q.shape[-1]} != cache head_dim {hd}")
    if nkv < 1 or q.shape[2] % nkv:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {nkv}")


def _check_kernel(q, others, rows):
    """What the CUDA kernels take: bf16, fp16 or f32, one dtype, contiguous,
    16-byte aligned K/V (read 16 bytes a thread), head_dim 64 or 128, at
    most WINDOW_MAX_ROWS query rows per kv head."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16, float16 or float32, got "
                        f"{q.dtype}")
    for t in (q, *others):
        if t.dtype != q.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs q {q.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in others:
        if t.data_ptr() % 16:
            raise ValueError("kernel K/V must be 16-byte aligned")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if rows > WINDOW_MAX_ROWS:
        raise ValueError(f"{rows} query rows per kv head exceed the "
                         f"kernel's {WINDOW_MAX_ROWS}")


def _check_scales(pool_k, pool_v, k_scale, v_scale):
    """An int8 pool pair and its scales [num_pages, nkv] f32."""
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 pool needs both k_scale and v_scale")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise TypeError(f"scaled pools must be int8 codes, got "
                        f"{pool_k.dtype}/{pool_v.dtype}")
    want = tuple(pool_k.shape[:2])
    for t in (k_scale, v_scale):
        if tuple(t.shape) != want:
            raise ValueError(f"scales {tuple(t.shape)} are not [num_pages, "
                             f"nkv] = {list(want)}")
        if t.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {t.dtype}")


def _int32_on(x, b, device):
    """Per-row int32 vector [b] on `device` from an int or a tensor."""
    t = torch.as_tensor(x, dtype=torch.int32).to(device)
    if t.dim() == 0:
        t = t.expand(b)
    if t.shape != (b,):
        raise ValueError(f"pos must be a scalar or [{b}], got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _scale(scale, hd):
    return scale if scale is not None else 1.0 / math.sqrt(hd)


# ---------------------------------------------------------------------------
# the split of a row's keys (bf16, fp16), mirrored by window_mma_kernel (B5)
# and decode_mma_kernel (B4, B6, B7)
# ---------------------------------------------------------------------------


def row_splits(last, split_tiles):
    """The splits a row whose keys are [0, last] takes: one for every
    `split_tiles` tiles of WINDOW_TILE keys, at most WINDOW_MAX_SPLITS (a
    portable cluster). A function of the row alone: the kernels read it
    off the row's own pos on the card."""
    tiles = last // WINDOW_TILE + 1
    return min(WINDOW_MAX_SPLITS, -(-tiles // split_tiles))


def cut_keys(last, splits):
    """The keys [first, last] split z of `splits` walks for a row whose
    keys are [0, last], as the kernels cut them: whole tiles z * T //
    splits up to (z + 1) * T // splits of the row's T tiles, the last one
    ending at `last`. A split is None when it holds no tile (more splits
    than the row has tiles)."""
    tiles = last // WINDOW_TILE + 1
    keys = []
    for z in range(splits):
        tb, te = z * tiles // splits, (z + 1) * tiles // splits
        keys.append((tb * WINDOW_TILE, min(te * WINDOW_TILE, last + 1) - 1)
                    if te > tb else None)
    return keys


def _row_cut(last, cluster, split_tiles):
    """What each of a cluster's blocks walks for a row whose keys are [0,
    last]: the row's own `row_splits` cut (`cut_keys`), fewer when the
    cluster is smaller, then None for every block past them."""
    own = min(cluster, row_splits(last, split_tiles))
    return cut_keys(last, own) + [None] * (cluster - own)


def window_splits(last):
    """The cluster of B5 in bf16 and fp16: `row_splits` of the widest
    watermark the host knows of, keys [0, last] (`_window_last`),
    WINDOW_SPLIT_TILES tiles a split. Each row cuts its own keys over its
    own count of these blocks (`window_split_keys`)."""
    return row_splits(last, WINDOW_SPLIT_TILES)


def window_split_keys(last, cluster):
    """The keys [first, last] each of `cluster` blocks walks for a row
    whose watermark is `last`, as window_mma_kernel cuts them: the row's
    own `row_splits` (WINDOW_SPLIT_TILES), None past them."""
    return _row_cut(last, cluster, WINDOW_SPLIT_TILES)


def _window_last(pos, s, max_len):
    """The last window watermark the host knows without reading the card:
    min(pos + s - 1, len - 1) for an int (or a CPU tensor) pos, len - 1
    for a tensor on the card."""
    if torch.is_tensor(pos):
        if pos.device.type != "cpu":
            return max_len - 1
        pos = int(pos.max())
    elif not isinstance(pos, int):
        pos = max(int(p) for p in pos)
    return min(pos + s - 1, max_len - 1)


# ---------------------------------------------------------------------------
# B4's, B6's and B7's route and split of the keys, mirrored by
# decode_mma_kernel
# ---------------------------------------------------------------------------


def paged_route(dtype):
    """The kernel a CUDA call of B4, B6 or B7 launches, from q's dtype
    alone: "cluster" (decode_mma_kernel, each row's keys split over a
    cluster) for bf16 and fp16, "shared" (the shared CUDA-core body) for
    f32."""
    return "cluster" if dtype in (torch.bfloat16, torch.float16) \
        else "shared"


def paged_splits(P, ps, max_pos=None):
    """The cluster of B6/B7 in bf16 and fp16. The host cannot read a
    device `pos`, so it is cut for the widest row it knows of: the table's
    P * ps keys, or max_pos + 1 when the caller knows a bound on every
    row's pos (the engine's scheduler does), by `row_splits`
    (PAGED_SPLIT_TILES). Each row
    cuts its own keys over its own count of these blocks
    (`paged_split_keys`), so a bound at or above every pos gives each row
    the cut it gets alone; a bound below a row's pos costs that row its
    own cut (fewer splits), never the result."""
    keys = P * ps if max_pos is None else min(max_pos + 1, P * ps)
    return row_splits(keys - 1, PAGED_SPLIT_TILES)


def paged_split_keys(pos, P, ps, cluster):
    """The keys [first, last] each of `cluster` blocks walks for a row at
    `pos` over a table of P pages of ps keys, as decode_mma_kernel cuts
    them: the row's keys [0, min(pos, P * ps - 1)] over its own
    `row_splits` (PAGED_SPLIT_TILES), in whole tiles; None past them."""
    return _row_cut(min(pos, P * ps - 1), cluster, PAGED_SPLIT_TILES)


def decode_splits(last):
    """The cluster of B4 in bf16 and fp16, cut for the longest row the
    host knows of, keys [0, last] (`_window_last(pos, 1, len)`: min(pos,
    len - 1) for a pos on the host, len - 1 for one on the card), by
    `row_splits` (PAGED_SPLIT_TILES)."""
    return row_splits(last, PAGED_SPLIT_TILES)


def decode_split_keys(pos, length, cluster):
    """The keys [first, last] each of `cluster` blocks walks for a row at
    `pos` over a cache of `length` keys, as decode_mma_kernel cuts them:
    the row's keys [0, min(pos, length - 1)] over its own `row_splits`;
    None past them."""
    return _row_cut(min(pos, length - 1), cluster, PAGED_SPLIT_TILES)


# ---------------------------------------------------------------------------
# plain versions (mirror quantized_matmul._*_xla)
# ---------------------------------------------------------------------------


def _repeat_kv(cache, nh):
    nkv = cache.shape[1]
    return cache if nkv == nh else cache.repeat_interleave(nh // nkv, dim=1)


def neg_inf(dtype):
    """NEG_INF as `dtype` holds it: -inf in fp16, whose range ends at
    65504 (`jnp.where` rounds the reference's -1e30 so). CUDA's `where`
    refuses a Python scalar its dtype cannot hold; -inf it takes."""
    return float("-inf") if dtype == torch.float16 else NEG_INF


def _masked_softmax_attend(q, cache_k, cache_v, qpos, sm_scale):
    """q [b, s, nh, hd] over [b, nkv, len, hd]; qpos broadcasts to
    [b, 1, s, 1] — key j is live for query (r, i) when j <= qpos."""
    nh, max_len = q.shape[2], cache_k.shape[2]
    k = _repeat_kv(cache_k, nh)
    v = _repeat_kv(cache_v, nh)
    scores = (q.transpose(1, 2) @ k.transpose(-1, -2)) * sm_scale
    key_pos = torch.arange(max_len, device=q.device)
    scores = torch.where(key_pos <= qpos, scores, neg_inf(scores.dtype))
    probs = torch.softmax(scores.float(), dim=-1)
    return (probs.to(v.dtype) @ v).transpose(1, 2)


def decode_attention_plain(q, cache_k, cache_v, pos, scale=None):
    """B4's plain version (`_decode_attention_xla`): masked attention of
    q [b, 1, nh, hd] over the full cache, keys [0, pos[r]]."""
    qpos = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1)
    return _masked_softmax_attend(q, cache_k, cache_v, qpos,
                                  _scale(scale, q.shape[-1]))


def window_attention_plain(q, cache_k, cache_v, pos, scale=None):
    """B5's plain version (`_window_attention_xla`): query i of row r at
    pos[r] + i attends keys [0, pos[r] + i]."""
    s = q.shape[1]
    rows = torch.arange(s, device=q.device).reshape(1, 1, s, 1)
    qpos = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1) + rows
    return _masked_softmax_attend(q, cache_k, cache_v, qpos,
                                  _scale(scale, q.shape[-1]))


def paged_gather(pool, block_tables, scale=None, out_dtype=None):
    """Gather a pool [num_pages, nkv, ps, hd] through block tables [b, P]
    into the contiguous per-row layout [b, nkv, P*ps, hd]
    (`quantized_matmul.paged_gather`): pages in table order are the row's
    sequence. With `scale` [num_pages, nkv] the pool is int8 and the
    gather dequantizes in f32 (code * scale / 127), then casts to
    `out_dtype` (default f32)."""
    b, P = block_tables.shape
    nkv, ps, hd = pool.shape[1:]
    bt = block_tables.long()
    g = pool[bt].transpose(1, 2)                     # [b, nkv, P, ps, hd]
    if scale is not None:
        sc = scale[bt].transpose(1, 2)               # [b, nkv, P]
        g = (g.float() * (sc / 127.0)[..., None, None]).to(
            out_dtype or torch.float32)
    elif out_dtype is not None:
        g = g.to(out_dtype)
    return g.reshape(b, nkv, P * ps, hd)


def paged_decode_attention_plain(q, pool_k, pool_v, block_tables, pos,
                                 scale=None, k_scale=None, v_scale=None):
    """B6's and B7's plain version (`_paged_decode_attention_xla`): gather
    the tables (dequantizing an int8 pool into q's dtype), then B4's plain
    version."""
    return decode_attention_plain(
        q, paged_gather(pool_k, block_tables, k_scale, q.dtype),
        paged_gather(pool_v, block_tables, v_scale, q.dtype), pos, scale)


# ---------------------------------------------------------------------------
# launches (the pointer checks and the kernel call, on CUDA tensors)
# ---------------------------------------------------------------------------


def _check_q_pairs(q, splits):
    """The cluster route reads q a column pair at a time."""
    if splits and q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned (read a column pair at a "
                         "time)")


def _decode_kernel(q, cache_k, cache_v, pos_t, splits, scale):
    """B4 on the card: `splits` blocks a (kv head, row) cluster, 0 for the
    shared body."""
    b, _, nh, hd = q.shape
    nkv, max_len = cache_k.shape[1], cache_k.shape[2]
    _check_kernel(q, (cache_k, cache_v), nh // nkv)
    _check_q_pairs(q, splits)
    out = torch.empty_like(q)
    rc = _build.launch(
        "attention", "pt_decode_attention", q.device, q.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), b, nh, nkv, max_len, hd, _DTYPES[q.dtype],
        PAGED_SPLIT_TILES, splits, scale)
    _raise_on(rc, "decode_attention")
    _count("decode_attention", q.dtype)
    return out


def _window_kernel(q, cache_k, cache_v, pos_t, splits, scale):
    """B5 on the card, its keys split over a cluster of `splits` blocks."""
    b, s, nh, hd = q.shape
    nkv, max_len = cache_k.shape[1], cache_k.shape[2]
    _check_kernel(q, (cache_k, cache_v), s * (nh // nkv))
    out = torch.empty_like(q)
    rc = _build.launch(
        "attention", "pt_window_attention", q.device, q.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), b, s, nh, nkv, max_len, hd, _DTYPES[q.dtype],
        WINDOW_SPLIT_TILES, splits, scale)
    _raise_on(rc, "window_attention")
    _count("window_attention", q.dtype)
    return out


def _paged_kernel(q, pool_k, pool_v, block_tables, pos_t, splits, scale,
                  k_scale=None, v_scale=None):
    """B6 on the card, or B7 over an int8 pool with its scales."""
    b, _, nh, hd = q.shape
    nkv, ps = pool_k.shape[1], pool_k.shape[2]
    P = block_tables.shape[1]
    quantized = k_scale is not None
    if quantized:
        _check_kernel(q, (), nh // nkv)
        for t in (pool_k, pool_v, k_scale, v_scale):
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
        for t in (pool_k, pool_v):
            if t.data_ptr() % 16:
                raise ValueError("kernel K/V must be 16-byte aligned")
    else:
        _check_kernel(q, (pool_k, pool_v), nh // nkv)
    if block_tables.dtype != torch.int32 or not block_tables.is_contiguous():
        raise TypeError("block tables must be contiguous int32")
    _check_q_pairs(q, splits)
    out = torch.empty_like(q)
    if quantized:
        rc = _build.launch(
            "attention", "pt_paged_decode_attention_q8", q.device,
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            pos_t.data_ptr(), out.data_ptr(), b, nh, nkv, ps, P, hd,
            _DTYPES[q.dtype], PAGED_SPLIT_TILES, splits, scale)
        name = "paged_decode_attention_int8"
    else:
        rc = _build.launch(
            "attention", "pt_paged_decode_attention", q.device, q.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), block_tables.data_ptr(),
            pos_t.data_ptr(), out.data_ptr(), b, nh, nkv, ps, P, hd,
            _DTYPES[q.dtype], PAGED_SPLIT_TILES, splits, scale)
        name = "paged_decode_attention"
    _raise_on(rc, name)
    _count(name, q.dtype)
    return out


# ---------------------------------------------------------------------------
# custom operators: one node of a traced program each, launched at its call
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu_torch::decode_attention",
                         mutates_args=())
def _decode_attention_op(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, pos: torch.Tensor,
                         splits: int, scale: float) -> torch.Tensor:
    """B4 on CUDA tensors (`splits` from `decode_splits`), its plain
    version on CPU tensors."""
    if not _on_card(q, cache_k, cache_v, pos):
        return decode_attention_plain(q, cache_k, cache_v, pos,
                                      scale).contiguous()
    return _decode_kernel(q, cache_k, cache_v, pos, splits, scale)


@_decode_attention_op.register_fake
def _(q, cache_k, cache_v, pos, splits, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::window_attention",
                         mutates_args=())
def _window_attention_op(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, pos: torch.Tensor,
                         splits: int, scale: float) -> torch.Tensor:
    """B5 on CUDA tensors (`splits` from `window_splits`), its plain
    version on CPU tensors."""
    if not _on_card(q, cache_k, cache_v, pos):
        return window_attention_plain(q, cache_k, cache_v, pos,
                                      scale).contiguous()
    return _window_kernel(q, cache_k, cache_v, pos, splits, scale)


@_window_attention_op.register_fake
def _(q, cache_k, cache_v, pos, splits, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::paged_decode_attention",
                         mutates_args=())
def _paged_decode_attention_op(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor,
                               block_tables: torch.Tensor, pos: torch.Tensor,
                               splits: int, scale: float) -> torch.Tensor:
    """B6 on CUDA tensors (`splits` from `paged_splits`), its plain
    version on CPU tensors."""
    if not _on_card(q, pool_k, pool_v, block_tables, pos):
        return paged_decode_attention_plain(
            q, pool_k, pool_v, block_tables, pos, scale).contiguous()
    return _paged_kernel(q, pool_k, pool_v, block_tables, pos, splits, scale)


@_paged_decode_attention_op.register_fake
def _(q, pool_k, pool_v, block_tables, pos, splits, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::paged_decode_attention_q8",
                         mutates_args=())
def _paged_decode_attention_q8_op(
        q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        block_tables: torch.Tensor, pos: torch.Tensor, splits: int,
        scale: float) -> torch.Tensor:
    """B7 on CUDA tensors, its plain version on CPU tensors."""
    if not _on_card(q, pool_k, pool_v, k_scale, v_scale, block_tables, pos):
        return paged_decode_attention_plain(
            q, pool_k, pool_v, block_tables, pos, scale, k_scale,
            v_scale).contiguous()
    return _paged_kernel(q, pool_k, pool_v, block_tables, pos, splits, scale,
                         k_scale, v_scale)


@_paged_decode_attention_q8_op.register_fake
def _(q, pool_k, pool_v, k_scale, v_scale, block_tables, pos, splits, scale):
    return q.new_empty(q.shape)


# the operators' overloads, as a traced graph names them
DECODE_ATTENTION_OP = torch.ops.paddle_tpu_torch.decode_attention.default
WINDOW_ATTENTION_OP = torch.ops.paddle_tpu_torch.window_attention.default
PAGED_DECODE_ATTENTION_OP = \
    torch.ops.paddle_tpu_torch.paged_decode_attention.default
PAGED_DECODE_ATTENTION_Q8_OP = \
    torch.ops.paddle_tpu_torch.paged_decode_attention_q8.default


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _decode_host_splits(q, pos, max_len):
    """B4's split count as the host knows it (0: the shared body)."""
    if paged_route(q.dtype) != "cluster":
        return 0
    return decode_splits(_window_last(pos, 1, max_len))


def _window_host_splits(q, pos, s, max_len):
    """B5's cluster as the host knows it (1 for f32's shared body)."""
    if paged_route(q.dtype) != "cluster":
        return 1
    return window_splits(_window_last(pos, s, max_len))


def _paged_host_splits(q, P, ps, max_pos):
    """B6's and B7's split count as the host knows it (0: the shared
    body)."""
    if paged_route(q.dtype) != "cluster":
        return 0
    return paged_splits(P, ps, max_pos)



def decode_attention(q, cache_k, cache_v, pos, scale=None):
    """B4: single-query attention of q [b, 1, nh, hd] over the contiguous
    cache [b, nkv, len, hd], keys [0, pos[r]] for row r. The kernel follows
    `paged_route`: in bf16 and fp16 the keys of each (kv head, row)
    arrive by TMA and are split over `decode_splits` blocks of one
    cluster; f32 runs the shared body. Each row cuts its keys over its own
    `row_splits` of the cluster's blocks, so its result is the same in any
    batch. Cache slots past a row's pos are never part of its result,
    whatever they hold."""
    b, s, nh, hd = q.shape
    if s != 1:
        raise ValueError(f"decode attention takes one query per row, got {s}")
    if cache_k.dim() != 4 or cache_k.shape[0] != b or \
            cache_v.shape != cache_k.shape:
        raise ValueError(f"cache shapes {tuple(cache_k.shape)}/"
                         f"{tuple(cache_v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    nkv, max_len = cache_k.shape[1], cache_k.shape[2]
    _check_gqa(q, nkv, cache_k.shape[3])
    card = _on_card(q, cache_k, cache_v)
    if _tracing(q, cache_k, cache_v, pos):
        splits = _decode_host_splits(q, pos, max_len) if card else 0
        return _decode_attention_op(q, cache_k, cache_v,
                                    _int32_on(pos, b, q.device), splits,
                                    _scale(scale, hd))
    if not card:
        return decode_attention_plain(q, cache_k, cache_v, pos, scale)
    return _decode_kernel(q, cache_k, cache_v, _int32_on(pos, b, q.device),
                          _decode_host_splits(q, pos, max_len),
                          _scale(scale, hd))


def window_attention(q, cache_k, cache_v, pos, scale=None):
    """B5: attention of a short query window q [b, s, nh, hd] over the
    contiguous cache: query i of row r sits at pos[r] + i and attends keys
    [0, pos[r] + i]; the walk stops at the last query's watermark, clamped
    to the cache end. The kernel takes s * (nh // nkv) <= 64. In bf16 and
    fp16 the keys of each (kv head, row) are split over the row's own
    `row_splits` of a cluster of `window_splits` blocks, which combine
    their partial softmax sums in a fixed order."""
    b, s, nh, hd = q.shape
    if cache_k.dim() != 4 or cache_k.shape[0] != b or \
            cache_v.shape != cache_k.shape:
        raise ValueError(f"cache shapes {tuple(cache_k.shape)}/"
                         f"{tuple(cache_v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    nkv, max_len = cache_k.shape[1], cache_k.shape[2]
    _check_gqa(q, nkv, cache_k.shape[3])
    card = _on_card(q, cache_k, cache_v)
    if _tracing(q, cache_k, cache_v, pos):
        splits = _window_host_splits(q, pos, s, max_len) if card else 1
        return _window_attention_op(q, cache_k, cache_v,
                                    _int32_on(pos, b, q.device), splits,
                                    _scale(scale, hd))
    if not card:
        return window_attention_plain(q, cache_k, cache_v, pos, scale)
    return _window_kernel(q, cache_k, cache_v, _int32_on(pos, b, q.device),
                          _window_host_splits(q, pos, s, max_len),
                          _scale(scale, hd))


def paged_decode_attention(q, pool_k, pool_v, block_tables, pos, scale=None,
                           k_scale=None, v_scale=None, max_pos=None):
    """B6: single-query attention of q [b, 1, nh, hd] over the page pool
    [num_pages, nkv, ps, hd] through block tables [b, P], keys
    [0, pos[r]]. Table entries must be valid page ids; the kernel reads
    only entries [0, pos[r] // ps].

    B7: with k_scale / v_scale [num_pages, nkv] f32 the pools are int8
    codes (scale 0 reads as zeros).

    The kernel follows `paged_route`: in bf16 and fp16 the keys of each (kv
    head, row) are split over the row's own `row_splits` of a cluster of
    `paged_splits` blocks (cut for max_pos, an int bound on pos known to
    the caller, when given), B7's
    scales folded into the scores and probabilities; f32 runs the shared
    body, which dequantizes B7's keys in shared memory."""
    b, s, nh, hd = q.shape
    if s != 1:
        raise ValueError(f"paged decode takes one query per row, got {s}")
    if pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}/"
                         f"{tuple(pool_v.shape)} are not [pages, nkv, ps, hd]")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block tables {tuple(block_tables.shape)} do not "
                         f"fit batch {b}")
    nkv, ps = pool_k.shape[1], pool_k.shape[2]
    P = block_tables.shape[1]
    _check_gqa(q, nkv, pool_k.shape[3])
    quantized = k_scale is not None or v_scale is not None
    if quantized:
        _check_scales(pool_k, pool_v, k_scale, v_scale)
    tensors = (q, pool_k, pool_v, block_tables) + (
        (k_scale, v_scale) if quantized else ())
    card = _on_card(*tensors)
    if _tracing(*tensors, pos):
        splits = _paged_host_splits(q, P, ps, max_pos) if card else 0
        pos_t = _int32_on(pos, b, q.device)
        if quantized:
            return _paged_decode_attention_q8_op(
                q, pool_k, pool_v, k_scale, v_scale, block_tables, pos_t,
                splits, _scale(scale, hd))
        return _paged_decode_attention_op(q, pool_k, pool_v, block_tables,
                                          pos_t, splits, _scale(scale, hd))
    if not card:
        return paged_decode_attention_plain(q, pool_k, pool_v, block_tables,
                                            pos, scale, k_scale, v_scale)
    return _paged_kernel(q, pool_k, pool_v, block_tables,
                         _int32_on(pos, b, q.device),
                         _paged_host_splits(q, P, ps, max_pos),
                         _scale(scale, hd), k_scale, v_scale)
