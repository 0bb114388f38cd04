"""Legacy parameter-server recommendation, tree-retrieval and
text-matching ops (`paddle_tpu/ops/legacy_ps.py`; reference kernels
`paddle/phi/kernels/{impl,cpu,gpu}/batch_fc_*`, `rank_attention_*`,
`match_matrix_tensor_*`, `tdm_child_*`, `tdm_sampler_*`,
`class_center_sample_*`, `merge_selected_rows_*`, `pyramid_hash_kernel`).

batch_fc, rank_attention and match_matrix_tensor are gathers and einsums,
differentiable through torch's autograd. The tree and sampling ops are
host-side index work, as the reference's CPU-only kernels are; they draw
from numpy's `RandomState(seed)` as the JAX package does, so one seed gives
the same samples in both packages.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import device as _device

__all__ = ["batch_fc", "rank_attention", "match_matrix_tensor",
           "tdm_child", "tdm_sampler", "class_center_sample",
           "merge_selected_rows", "SelectedRows", "pyramid_hash"]


def _host(x, dtype=None):
    a = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _placed(a, like, dtype=None):
    """numpy `a` as a Tensor on `like`'s device (the creation place when
    `like` is not a Tensor)."""
    dev = like._data.device if isinstance(like, Tensor) else _device.place()
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return Tensor(t if dtype is None else t.to(dtype))


def batch_fc(input, w, bias, name=None):
    """Per-slot batched FC: input [slot, B, in], w [slot, in, out], bias
    [slot, out] -> [slot, B, out]."""
    return apply(lambda x, wv, b: torch.einsum("sbi,sio->sbo", x, wv)
                 + b[:, None, :], input, w, bias, _name="batch_fc")


def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0,
                   name=None):
    """Rank attention for CTR models: x [B, in]; rank_offset [B, 2 *
    max_rank + 1] int (col 0 this instance's rank, 1-based, 0 invalid; col
    2k+1 the k-th neighbour's rank, col 2k+2 its row in x); rank_param
    [max_rank * max_rank * in, out], block (rank - 1) * max_rank +
    (neighbour rank - 1) the [in, out] matrix of the pair. out[b] = sum_k
    valid(b, k) x[idx(b, k)] @ P[block(b, k)]."""
    def fn(xv, ro, pv):
        B, in_col = xv.shape
        P = pv.reshape(max_rank * max_rank, in_col, pv.shape[-1])
        cur = ro[:, 0].long() - 1
        others = ro[:, 1::2].long() - 1
        idxs = ro[:, 2::2].long()
        valid = (cur[:, None] >= 0) & (others >= 0)
        xg = xv[idxs.clamp(0, B - 1)]
        block = cur[:, None].clamp(min=0) * max_rank + others.clamp(min=0)
        Pb = P[block.clamp(0, max_rank * max_rank - 1)]
        xg = torch.where(valid[..., None], xg, 0.0)
        return torch.einsum("bki,bkio->bo", xg, Pb)

    return apply(fn, x, rank_offset, rank_param, _name="rank_attention")


def match_matrix_tensor(x, y, w, dim_t=1, name=None):
    """Bilinear text matching: x [B, Lx, D], y [B, Ly, D], w [D, dim_t, D]
    -> (out [B, dim_t, Lx, Ly], tmp = x @ w [B, Lx, dim_t, D])."""
    def fn(xv, yv, wv):
        tmp = torch.einsum("bid,dte->bite", xv, wv)
        return torch.einsum("bite,bje->btij", tmp, yv), tmp

    return apply(fn, x, y, w, _name="match_matrix_tensor")


def tdm_child(x, tree_info, child_nums, dtype="int32", name=None):
    """Children in a TDM tree: tree_info rows are [item_id, layer_id,
    parent_id, child_0 ... child_{n-1}] (0 = none). Returns (child [...,
    child_nums], leaf_mask), the mask 1 where a child is a leaf (its
    item_id != 0)."""
    xi = _host(x, np.int64)
    ti = _host(tree_info, np.int64)
    child = ti[xi.reshape(-1)][:, 3:3 + child_nums]
    item_of_child = ti[np.clip(child, 0, ti.shape[0] - 1), 0]
    leaf = ((child != 0) & (item_of_child != 0)).astype(np.int64)
    shape = xi.shape + (child_nums,)
    dt = torch.int64 if str(dtype) in ("int64", "3") else torch.int32
    return (_placed(child.reshape(shape), x, dt),
            _placed(leaf.reshape(shape), x, dt))


def tdm_sampler(x, travel, layer, output_positive=True,
                neg_samples_num_list=(), layer_offset=(), seed=0,
                dtype=2, name=None):
    """A positive and negative samples per layer along a TDM tree path:
    travel [N, L] holds sample n's path node per layer; `layer` is the
    flat node list, layer l spanning layer_offset[l]:layer_offset[l+1].
    For each sample and layer: the path node (label 1), then
    neg_samples_num_list[l] uniform negatives other than it (label 0).
    Returns (out [N, total], label, mask), mask 0 on the slots of samples
    whose path ended early (travel node 0)."""
    rng = np.random.RandomState(seed or None)
    tr = _host(travel, np.int64)
    ly = _host(layer, np.int64).reshape(-1)
    N, L = tr.shape
    offs = list(layer_offset) or list(
        np.linspace(0, len(ly), L + 1).astype(int))
    negs = list(neg_samples_num_list) or [1] * L
    total = sum((1 if output_positive else 0) + negs[l] for l in range(L))
    out = np.zeros((N, total), np.int64)
    lab = np.zeros((N, total), np.int64)
    mask = np.zeros((N, total), np.int64)
    for n in range(N):
        col = 0
        for l in range(L):
            pos = tr[n, l]
            nodes = ly[offs[l]:offs[l + 1]]
            alive = pos != 0
            if output_positive:
                out[n, col] = pos
                lab[n, col] = mask[n, col] = 1 if alive else 0
                col += 1
            for _ in range(negs[l]):
                if alive and len(nodes) > 1:
                    while True:
                        cand = nodes[rng.randint(len(nodes))]
                        if cand != pos:
                            break
                    out[n, col] = cand
                    mask[n, col] = 1
                col += 1
    dt = torch.int64 if int(dtype) == 3 else torch.int32
    return tuple(_placed(a, x, dt) for a in (out, lab, mask))


def class_center_sample(label, num_classes, num_samples, ring_id=0, rank=0,
                        nranks=1, fix_seed=False, seed=0, name=None):
    """Class centers for partial-FC: every class present in `label`, then
    uniform negatives up to num_samples. Returns (remapped label, sampled
    class index)."""
    lv = _host(label, np.int64).reshape(-1)
    rng = np.random.RandomState(seed if fix_seed else None)
    pos = np.unique(lv)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = rng.choice(rest, size=num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, np.sort(extra)])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return _placed(remap[lv], label), _placed(sampled, label)


class SelectedRows:
    """A sparse set of rows of a [height, ...] tensor (reference
    `paddle/phi/core/selected_rows.h`): `rows` may repeat;
    `merge_selected_rows` sums the duplicates."""

    def __init__(self, rows, value, height=None):
        self.rows = np.asarray(rows, np.int64).reshape(-1)
        self.value = value if isinstance(value, Tensor) else Tensor(
            torch.as_tensor(np.asarray(value), device=_device.place()))
        self.height = height if height is not None else (
            int(self.rows.max()) + 1 if self.rows.size else 0)


def merge_selected_rows(x, name=None):
    """Sum the duplicate rows of a SelectedRows (the gradient merge of
    sparse embedding gradients): one index_add on the value's device."""
    if not isinstance(x, SelectedRows):
        raise TypeError("merge_selected_rows takes a SelectedRows")
    uniq, inv = np.unique(x.rows, return_inverse=True)

    def fn(v):
        out = v.new_zeros((len(uniq),) + tuple(v.shape[1:]))
        return out.index_add(0, torch.as_tensor(inv, device=v.device), v)

    return SelectedRows(uniq, apply(fn, x.value, _name="merge_selected_rows"),
                        x.height)


def pyramid_hash(x, w, white_list=None, black_list=None, num_emb=0,
                 space_len=0, pyramid_layer=2, rand_len=0,
                 drop_out_percent=0.0, is_training=False, use_filter=True,
                 white_list_len=0, black_list_len=0, seed=0,
                 lr=0.0, distribute_update_vars="", name=None):
    """Pyramid hash embedding: every n-gram of length 2..pyramid_layer+1
    of the id sequence is hashed into w [space_len + rand_len, 1]; its
    embedding is num_emb / rand_len chunks of rand_len weights, chunk j at
    hash(ngram, j * rand_len) % space_len. x [L] or [B, L] int ids -> rows
    [n_terms, num_emb] ([B, n_terms, num_emb]).

    The hash is the JAX package's zlib.crc32 of the id bytes and the seed
    (the reference hashes with XXH32); white and black lists are id lists
    filtered per token."""
    xv = _host(x, np.int64)
    wv = _host(w, np.float32).reshape(-1)

    def id_set(lst):
        if lst is None or not use_filter:
            return None
        return set(_host(lst, np.int64).ravel().tolist())

    wl, bl = id_set(white_list), id_set(black_list)
    if rand_len <= 0 or num_emb <= 0 or num_emb % rand_len:
        raise ValueError("pyramid_hash needs num_emb > 0 divisible by "
                         "rand_len > 0")
    if space_len <= 0:
        raise ValueError("pyramid_hash needs space_len > 0 (the hash "
                         "bucket count; w holds space_len + rand_len "
                         "rows)")
    if len(wv) < space_len + rand_len:
        raise ValueError(f"w has {len(wv)} weights; needs >= space_len + "
                         f"rand_len = {space_len + rand_len}")
    batched = xv.ndim == 2
    rng = np.random.RandomState(seed or None)

    def h(ngram, s):
        return zlib.crc32(ngram.tobytes() + np.int32(s).tobytes()) \
            % space_len

    outs = []
    for seq in (xv if batched else xv[None]):
        rows = []
        for d in range(2, pyramid_layer + 2):
            for i in range(len(seq) - d + 1):
                ng = seq[i:i + d].astype(np.int64)
                if wl is not None and not all(int(t) in wl for t in ng):
                    continue
                if bl is not None and any(int(t) in bl for t in ng):
                    continue
                emb = np.zeros(num_emb, np.float32)
                pos = h(ng, 0)
                for j in range(0, num_emb, rand_len):
                    emb[j:j + rand_len] = wv[pos:pos + rand_len]
                    pos = h(ng, j + rand_len)
                if is_training and drop_out_percent > 0 and \
                        rng.rand() < drop_out_percent:
                    emb[:] = 0.0
                rows.append(emb)
        outs.append(np.stack(rows) if rows
                    else np.zeros((0, num_emb), np.float32))
    if batched:
        padded = np.zeros((len(outs), max(o.shape[0] for o in outs),
                           num_emb), np.float32)
        for i, o in enumerate(outs):
            padded[i, :o.shape[0]] = o
        return _placed(padded, w)
    return _placed(outs[0], w)
