"""paddle.geometric (`paddle_tpu/geometric/__init__.py`; reference
`python/paddle/geometric/`, kernels `paddle/phi/kernels/*/segment_pool_
kernel.*`, `graph_send_recv_kernel.*`, `graph_send_ue_recv_kernel.*`).

Every message-passing primitive is a segment reduction over the
destination ids: `index_add` for sum and mean, `scatter_reduce` for max
and min, on the device the features lie on. Ids outside [0, n) are
dropped, as `jax.ops.segment_*` drops them; an empty segment gives 0
(max and min: any non-finite result gives 0, as the JAX package does).

The sampling ops (`sample_neighbors`, `weighted_sample_neighbors`,
`khop_sampler`) and the reindexing ops have outputs whose size depends on
the data, so they run on the host, as the JAX package's do, and hand back
tensors on the device of the graph they were given. They draw from the
port's CPU generator (`framework.random`), so a draw repeats under
`paddle.seed`; the JAX package draws from an unseeded numpy generator.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "send_u_recv", "send_ue_recv", "send_uv", "reindex_graph",
]


def _num_segments(ids, n):
    if n is not None:
        return int(n)
    return int(ids._data.max().item()) + 1 if ids.shape[0] else 0


def _kept(d, i, n):
    """d and i without the ids outside [0, n) (dropped, as the JAX
    package's segment reductions drop them)."""
    i = i.long()
    keep = (i >= 0) & (i < n)
    if bool(keep.all()):
        return d, i
    return d[keep], i[keep]


def _seg_sum(d, i, n):
    d, i = _kept(d, i, n)
    return d.new_zeros((n,) + tuple(d.shape[1:])).index_add(0, i, d)


def _seg_extreme(d, i, n, how):
    """Segment max ("amax") or min ("amin"); an empty segment holds the
    identity of the reduction (-inf / inf for floats)."""
    d, i = _kept(d, i, n)
    if d.is_floating_point():
        fill = float("-inf") if how == "amax" else float("inf")
    else:
        info = torch.iinfo(d.dtype)
        fill = info.min if how == "amax" else info.max
    out = torch.full((n,) + tuple(d.shape[1:]), fill, dtype=d.dtype,
                     device=d.device)
    idx = i.view((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
    return out.scatter_reduce(0, idx, d, how, include_self=True)


def _finite_or_zero(out):
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _seg_mean(d, i, n):
    s = _seg_sum(d, i, n)
    c = _seg_sum(torch.ones(i.shape, dtype=d.dtype, device=d.device), i, n)
    return s / torch.clamp(c.reshape((-1,) + (1,) * (d.dim() - 1)), min=1)


def segment_sum(data, segment_ids, name=None):
    n = _num_segments(segment_ids, None)
    return apply(lambda d, i: _seg_sum(d, i, n), data, segment_ids,
                 _name="segment_sum")


def segment_mean(data, segment_ids, name=None):
    n = _num_segments(segment_ids, None)
    return apply(lambda d, i: _seg_mean(d, i, n), data, segment_ids,
                 _name="segment_mean")


def segment_max(data, segment_ids, name=None):
    n = _num_segments(segment_ids, None)
    # empty segments: the reference returns 0
    return apply(lambda d, i: _finite_or_zero(_seg_extreme(d, i, n, "amax")),
                 data, segment_ids, _name="segment_max")


def segment_min(data, segment_ids, name=None):
    n = _num_segments(segment_ids, None)
    return apply(lambda d, i: _finite_or_zero(_seg_extreme(d, i, n, "amin")),
                 data, segment_ids, _name="segment_min")


_REDUCERS = {"max": "amax", "min": "amin"}


def _reduce(msg, dst, n, pool):
    if pool in ("sum", "add"):
        return _seg_sum(msg, dst, n)
    if pool == "mean":
        return _seg_mean(msg, dst, n)
    return _finite_or_zero(_seg_extreme(msg, dst, n, _REDUCERS[pool]))


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather src features, reduce at dst (reference
    `geometric/message_passing/send_recv.py` send_u_recv)."""
    n = out_size or x.shape[0]
    return apply(lambda a, s, d: _reduce(a[s.long()], d, int(n), reduce_op),
                 x, src_index, dst_index, _name="send_u_recv")


_MSG_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine src node features with edge features, reduce at dst."""
    n = out_size or x.shape[0]
    mop = _MSG_OPS[message_op]
    return apply(lambda a, e, s, d: _reduce(mop(a[s.long()], e), d, int(n),
                                            reduce_op),
                 x, y, src_index, dst_index, _name="send_ue_recv")


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from src (x) and dst (y) node features."""
    mop = _MSG_OPS[message_op]
    return apply(lambda a, b, s, d: mop(a[s.long()], b[d.long()]),
                 x, y, src_index, dst_index, _name="send_uv")


# -- host-side ops: reindexing and sampling ---------------------------------


def _np1d(t, dtype):
    """Any tensor-like -> flat numpy array on the host."""
    if isinstance(t, Tensor):
        t = t._data
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype).reshape(-1)


def _device_of(t):
    if isinstance(t, Tensor):
        return t._data.device
    if isinstance(t, torch.Tensor):
        return t.device
    from paddle_tpu_torch.framework import device as _device

    return _device.place(None)


def _out(a, dev):
    return Tensor(torch.from_numpy(np.ascontiguousarray(a)).to(dev))


def _cat(parts, dev):
    """The int64 parts joined, as one tensor on dev."""
    return _out(np.concatenate(parts) if parts else np.zeros(0, np.int64),
                dev)


def _sampled(outs, counts, oeids, return_eids, dev):
    """A sampler's (out, out_count[, out_eids]) from its per-node draws."""
    res = (_cat(outs, dev), _out(np.asarray(counts, np.int32), dev))
    return res + (_cat(oeids, dev),) if return_eids else res


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Compact global node ids to local ids (host-side; reference
    `geometric/reindex.py`): x's nodes keep their order first, then new
    ones in order of first appearance among the neighbors."""
    xs = _np1d(x, np.int64)
    nb = _np1d(neighbors, np.int64)
    order = {int(v): i for i, v in enumerate(xs)}
    nxt = len(xs)
    mapping = {}
    for v in np.concatenate([xs, nb]).tolist():
        if v not in mapping:
            if v in order:
                mapping[v] = order[v]
            else:
                mapping[v] = nxt
                nxt += 1
    reindex_src = np.asarray([mapping[int(v)] for v in nb], np.int64)
    reindex_dst = np.repeat(np.arange(len(xs), dtype=np.int64),
                            _np1d(count, np.int64))
    out_nodes = np.asarray(sorted(mapping, key=mapping.get), np.int64)
    dev = _device_of(x)
    return _out(reindex_src, dev), _out(reindex_dst, dev), \
        _out(out_nodes, dev)


def _csc(row, colptr):
    return _np1d(row, np.int64), _np1d(colptr, np.int64)


def _check_eids(eids, return_eids):
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires eids (the edge-id "
                         "tensor aligned with `row`)")


def _draw(lo, deg, size, gen):
    """Edge positions [lo, lo + deg): all of them when deg <= size (or
    size is -1/None), else `size` of them without replacement, uniformly,
    from `gen`."""
    if size in (-1, None) or deg <= size:
        return np.arange(lo, lo + deg)
    return lo + torch.randperm(deg, generator=gen)[:size].numpy()


def graph_sample_neighbors(row, colptr, x, eids=None, perm_buffer=None,
                           sample_size=-1, return_eids=False,
                           flag_perm_buffer=False, name=None):
    """Uniform neighbour sampling on a CSC graph (reference
    graph_sample_neighbors / python `geometric.sample_neighbors`): for
    each node in x, draw up to sample_size neighbours from
    row[colptr[n]:colptr[n+1]]. Host-side (dynamic output), like the
    reference CPU kernel. Returns (out, out_count[, out_eids])."""
    r, c = _csc(row, colptr)
    _check_eids(eids, return_eids)
    xs = _np1d(x, np.int64)
    ev = _np1d(eids, np.int64) if eids is not None else None
    gen = _rng.generator("cpu")
    outs, counts, oeids = [], [], []
    for n in xs:
        lo, hi = int(c[n]), int(c[n + 1])
        sel = _draw(lo, hi - lo, sample_size, gen)
        outs.append(r[sel])
        counts.append(len(sel))
        if return_eids:
            oeids.append(ev[sel])
    return _sampled(outs, counts, oeids, return_eids, _device_of(row))


sample_neighbors = graph_sample_neighbors  # python-api name


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              eids=None, sample_size=-1, return_eids=False,
                              name=None):
    """Weighted neighbour sampling (reference weighted_sample_neighbors):
    neighbours drawn without replacement with probability proportional to
    edge_weight (A-Res weighted reservoir: the sample_size largest keys
    u^(1/w), like the reference kernel)."""
    r, c = _csc(row, colptr)
    _check_eids(eids, return_eids)
    w = _np1d(edge_weight, np.float64)
    xs = _np1d(input_nodes, np.int64)
    ev = _np1d(eids, np.int64) if eids is not None else None
    gen = _rng.generator("cpu")
    outs, counts, oeids = [], [], []
    for n in xs:
        lo, hi = int(c[n]), int(c[n + 1])
        deg = hi - lo
        idx = np.arange(lo, hi)
        if not (sample_size in (-1, None) or deg <= sample_size):
            u = torch.rand(deg, generator=gen, dtype=torch.float64).numpy()
            keys = u ** (1.0 / np.maximum(w[idx], 1e-12))
            idx = idx[np.argsort(-keys)[:sample_size]]
        outs.append(r[idx])
        counts.append(len(idx))
        if return_eids:
            oeids.append(ev[idx])
    return _sampled(outs, counts, oeids, return_eids, _device_of(row))


def graph_khop_sampler(row, colptr, x, eids=None, sample_sizes=(),
                       return_eids=False, name=None):
    """Multi-hop sampling + subgraph reindexing (reference
    graph_khop_sampler / python `geometric.khop_sampler`): hop h samples
    sample_sizes[h] neighbours of the frontier; the union of visited
    nodes is renumbered [x first, then new nodes in discovery order].
    Returns (out_src, out_dst, sample_index, reindex_x[, out_eids]):
    edges in local ids, the local->global map, and x's local ids."""
    r, c = _csc(row, colptr)
    _check_eids(eids, return_eids)
    xs = _np1d(x, np.int64)
    ev = _np1d(eids, np.int64) if eids is not None else None
    gen = _rng.generator("cpu")
    local = {int(n): i for i, n in enumerate(xs)}
    order = [int(n) for n in xs]
    src, dst, es = [], [], []
    frontier = list(order)
    for size in sample_sizes:
        nxt = []
        for n in frontier:
            lo, hi = int(c[n]), int(c[n + 1])
            for j in _draw(lo, hi - lo, size, gen):
                nb = int(r[j])
                if nb not in local:
                    local[nb] = len(order)
                    order.append(nb)
                    nxt.append(nb)
                src.append(local[nb])
                dst.append(local[n])
                if ev is not None:
                    es.append(ev[j])
        frontier = nxt
    dev = _device_of(row)
    res = (_out(np.asarray(src, np.int64), dev),
           _out(np.asarray(dst, np.int64), dev),
           _out(np.asarray(order, np.int64), dev),
           _out(np.asarray([local[int(n)] for n in xs], np.int64), dev))
    if return_eids:
        res = res + (_out(np.asarray(es, np.int64), dev),)
    return res


khop_sampler = graph_khop_sampler  # python-api name


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Heterogeneous-edge-type reindex (reference `geometric/reindex.py`
    reindex_heter_graph): neighbors/count are per edge type lists sharing
    one id space; all types reindex against one mapping (x first, then
    new nodes in first-appearance order across types)."""
    xs = _np1d(x, np.int64)
    nbs = [_np1d(n, np.int64) for n in neighbors]
    cts = [_np1d(c, np.int64) for c in count]
    mapping = {int(v): i for i, v in enumerate(xs)}
    for nb in nbs:
        for v in nb:
            if int(v) not in mapping:
                mapping[int(v)] = len(mapping)
    srcs, dsts = [], []
    for nb, ct in zip(nbs, cts):
        srcs.append(np.asarray([mapping[int(v)] for v in nb], np.int64))
        dsts.append(np.repeat(np.arange(len(xs), dtype=np.int64), ct))
    out_nodes = np.asarray(sorted(mapping, key=mapping.get), np.int64)
    dev = _device_of(x)
    return _cat(srcs, dev), _cat(dsts, dev), _out(out_nodes, dev)
