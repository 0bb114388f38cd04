"""Search and sort ops (`paddle_tpu/ops/search.py`; reference
`python/paddle/tensor/search.py`). Index outputs are int64, as in Paddle.
The metric and decoding ops whose output is packed by the data
(`mode`, `edit_distance`, `chunk_eval`, `ctc_align`) run on the host, as
the reference's CPU kernels do."""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.ops._common import raw as _raw
from paddle_tpu_torch.ops.manipulation import take_along_axis


def _host(v):
    return np.asarray(v.numpy() if isinstance(v, Tensor) else v)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = x._data.detach()
    if axis is None:
        return Tensor(torch.argmax(d.reshape(-1)))
    return Tensor(torch.argmax(d, int(axis), keepdim))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = x._data.detach()
    if axis is None:
        return Tensor(torch.argmin(d.reshape(-1)))
    return Tensor(torch.argmin(d, int(axis), keepdim))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return Tensor(torch.argsort(x._data.detach(), dim=axis,
                                descending=descending, stable=True))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply(lambda a: torch.sort(a, dim=axis, descending=descending,
                                      stable=True).values, x, _name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The k largest (smallest) along `axis` and their int64 indices; ties
    go to the lower index, as a stable sort gives them."""
    if isinstance(k, Tensor):
        k = int(k.item())
    ax = -1 if axis is None else int(axis)
    idx = torch.argsort(x._data.detach(), dim=ax, descending=largest,
                        stable=True).narrow(ax, 0, k)
    return take_along_axis(x, Tensor(idx), axis=ax), Tensor(idx)


def nonzero(x, as_tuple=False, name=None):
    d = x._data.detach()
    if as_tuple:
        return tuple(Tensor(i.reshape(-1, 1))
                     for i in torch.nonzero(d, as_tuple=True))
    return Tensor(torch.nonzero(d))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = sorted_sequence._data.detach()
    v = _raw(values, seq).detach()
    if seq.dim() > 1:
        v = v.reshape(seq.shape[:-1] + (-1,))
    out = torch.searchsorted(seq, v, out_int32=out_int32, right=right)
    return Tensor(out.reshape(_raw(values, seq).shape))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest among ties) and
    the last index it occurs at."""
    arr = _host(x)
    moved = np.moveaxis(arr, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals, idxs = [], []
    for row in flat:
        u, c = np.unique(row, return_counts=True)
        v = u[np.argmax(c)]
        vals.append(v)
        idxs.append(np.where(row == v)[0][-1])
    v = np.array(vals, arr.dtype).reshape(moved.shape[:-1])
    i = np.array(idxs, np.int64).reshape(moved.shape[:-1])
    if keepdim:
        v, i = np.expand_dims(v, axis), np.expand_dims(i, axis)
    dev = x._data.device
    return (Tensor(torch.from_numpy(np.ascontiguousarray(v)).to(dev)),
            Tensor(torch.from_numpy(np.ascontiguousarray(i)).to(dev)))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    idx = torch.argsort(x._data.detach(), dim=axis, stable=True) \
        .narrow(axis, k - 1, 1)
    vals = take_along_axis(x, Tensor(idx), axis=axis)
    if not keepdim:
        vals = apply(lambda a: a.squeeze(axis), vals, _name="kthvalue")
        idx = idx.squeeze(axis)
    return vals, Tensor(idx)


def index_sample(x, index):
    from paddle_tpu_torch.ops.manipulation import index_sample as _is

    return _is(x, index)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None, **kwargs):
    """Nucleus sampling (reference search.py top_p_sampling): keep the
    smallest prefix of descending-probability tokens whose mass reaches ps,
    renormalise, sample (Gumbel-max over the framework generator). x:
    [batch, vocab] probs; ps: [batch] or [batch, 1]. Returns
    (sampled_prob, sampled_id int64)."""
    d = x._data
    pv = _raw(ps, d).reshape(-1, 1).float()
    gen = (_rng.generator(d.device) if seed in (None, -1) else
           torch.Generator(device=d.device).manual_seed(int(seed)))
    u = torch.rand(d.shape, device=d.device, generator=gen)

    def fn(probs):
        p = probs.float()
        order = torch.argsort(-p, dim=-1, stable=True)
        sp = torch.take_along_dim(p, order, -1)
        cum = torch.cumsum(sp, -1)
        keep = (cum - sp) < pv   # always keeps the top token
        filt = torch.where(keep, sp, 0.0)
        filt = filt / filt.sum(-1, keepdim=True)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        choice = torch.argmax(torch.log(torch.clamp(filt, min=1e-20))
                              + gumbel, -1)
        ids = torch.take_along_dim(order, choice[:, None], -1)
        return torch.take_along_dim(p, ids, -1), ids

    return tuple(apply(fn, x, _name="top_p_sampling"))


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance per sequence pair (reference edit_distance), on
    the host. Returns (distance [B, 1] f32, number of sequences)."""
    a, b = _host(input), _host(label)
    il = (_host(input_length) if input_length is not None
          else np.full(a.shape[0], a.shape[1]))
    ll = (_host(label_length) if label_length is not None
          else np.full(b.shape[0], b.shape[1]))
    ignored = set(ignored_tokens or ())

    def one(sa, sb):
        sa = [t for t in sa if t not in ignored]
        sb = [t for t in sb if t not in ignored]
        m, n = len(sa), len(sb)
        prev = list(range(n + 1))
        for i in range(1, m + 1):
            cur = [i] + [0] * n
            for j in range(1, n + 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                             prev[j - 1] + (sa[i - 1] != sb[j - 1]))
            prev = cur
        return prev[n], n

    out = np.zeros((a.shape[0], 1), np.float32)
    for i in range(a.shape[0]):
        d, n = one(list(a[i][:int(il[i])]), list(b[i][:int(ll[i])]))
        out[i, 0] = d / max(n, 1) if normalized else d
    dev = input._data.device if isinstance(input, Tensor) else None
    return (Tensor(torch.from_numpy(out).to(dev)),
            Tensor(torch.tensor(a.shape[0], dtype=torch.int64, device=dev)))


def beam_search(pre_ids, pre_scores, ids, scores, level=0, beam_size=4,
                end_id=0, is_accumulated=True, name=None):
    """One beam-search expansion step (reference `ops.yaml:538`
    beam_search), dense: pre_ids / pre_scores [B, K], scores [B, K, V]
    (accumulated log-probs when is_accumulated), ids an optional candidate
    remap [B, K, V]. Returns (selected_ids, selected_scores, parent_idx),
    each [B, K]. A finished beam (pre_ids == end_id) offers one
    candidate, end_id at its unchanged score."""
    sc = _raw(scores).float()
    p_ids = _raw(pre_ids, sc)
    p_sc = _raw(pre_scores, sc).float()
    B, K, V = sc.shape
    if not is_accumulated:
        sc = p_sc[..., None] + torch.log(torch.clamp(sc, min=1e-30))
    finished = p_ids == end_id
    end_col = torch.arange(V, device=sc.device)[None, None, :] == end_id
    fin_sc = torch.where(end_col, p_sc[..., None], -1e30)
    sc = torch.where(finished[..., None], fin_sc, sc)
    flat = sc.reshape(B, K * V)
    kk = min(beam_size, K * V)
    pos = torch.argsort(flat, dim=1, descending=True, stable=True)[:, :kk]
    top = torch.take_along_dim(flat, pos, 1)
    parent = torch.div(pos, V, rounding_mode="floor")
    token = pos % V
    if ids is not None:
        cand = _raw(ids, sc)
        token = torch.take_along_dim(cand.reshape(B, K * V), pos, 1).long()
        par_fin = torch.take_along_dim(finished, parent, 1)
        token = torch.where(par_fin, torch.full_like(token, end_id), token)
    return Tensor(token), Tensor(top), Tensor(parent)


def beam_search_decode(step_ids, parent_idx, beam_size=None, end_id=0,
                       name=None):
    """Backtrack beam-search steps into full sequences (reference
    beam_search_decode_op): step_ids / parent_idx [T, B, K] -> [B, K, T]."""
    ids = _raw(step_ids)
    par = _raw(parent_idx, ids)
    T, B, K = ids.shape
    binx = torch.arange(B, device=ids.device)[:, None]
    beam = torch.arange(K, device=ids.device)[None].repeat(B, 1)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids[t][binx, beam])
        beam = par[t][binx, beam].long()
    return Tensor(torch.stack(toks[::-1], -1))


def chunk_eval(inference, label, chunk_scheme="IOB", num_chunk_types=1,
               excluded_chunk_types=None, seq_length=None, name=None):
    """Chunk-level precision / recall / F1 for sequence labelling
    (reference `ops.yaml:5470` chunk_eval), on the host. Schemes: IOB, IOE,
    IOBES, plain; tag = type * n + pos with n tags a type, and type ==
    num_chunk_types means Outside. Returns (precision, recall, f1,
    num_infer_chunks, num_label_chunks, num_correct_chunks)."""
    schemes = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
    if chunk_scheme not in schemes:
        raise ValueError(f"unknown chunk_scheme {chunk_scheme!r}")
    npos = schemes[chunk_scheme]
    excl = set(excluded_chunk_types or ())
    inf, lab = _host(inference), _host(label)
    if inf.ndim == 1:
        inf, lab = inf[None], lab[None]
    inf = inf.reshape(inf.shape[0], -1)
    lab = lab.reshape(lab.shape[0], -1)
    lens = (_host(seq_length).reshape(-1) if seq_length is not None
            else np.full(inf.shape[0], inf.shape[1]))
    out_tag = num_chunk_types * npos

    def chunks(seq):
        got = set()
        start = ctype = None
        for i, t in enumerate(list(seq) + [out_tag]):
            t = int(t)
            ttype, pos = (t // npos, t % npos) if t < out_tag else (None,
                                                                    None)
            ends = start is not None and (
                ttype != ctype
                or (chunk_scheme == "IOB" and pos == 0)
                or (chunk_scheme == "IOBES" and pos in (0, 3)))
            if chunk_scheme == "IOE" and start is not None and \
                    ttype == ctype and i > 0 and int(seq[i - 1]) % npos == 1:
                ends = True
            if chunk_scheme == "IOBES" and start is not None and i > 0 \
                    and int(seq[i - 1]) < out_tag \
                    and int(seq[i - 1]) % npos == 2:
                ends = True
            if chunk_scheme == "plain":
                ends = start is not None
            if ends:
                if ctype not in excl:
                    got.add((start, i - 1, ctype))
                start = ctype = None
            if ttype is not None and start is None:
                start, ctype = i, ttype
                if chunk_scheme == "IOBES" and pos == 3:
                    if ctype not in excl:
                        got.add((i, i, ctype))
                    start = ctype = None
        return got

    n_inf = n_lab = n_cor = 0
    for b in range(inf.shape[0]):
        L = int(lens[b])
        ci, cl = chunks(inf[b][:L]), chunks(lab[b][:L])
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    prec = n_cor / n_inf if n_inf else 0.0
    rec = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    dev = inference._data.device if isinstance(inference, Tensor) else None

    def mk(v, dt):
        return Tensor(torch.tensor([v], dtype=dt, device=dev))

    return (mk(prec, torch.float32), mk(rec, torch.float32),
            mk(f1, torch.float32), mk(n_inf, torch.int64),
            mk(n_lab, torch.int64), mk(n_cor, torch.int64))


def crf_decoding(emission, transition, label=None, length=None, name=None):
    """Viterbi decode of a linear-chain CRF (reference crf_decoding op).
    emission [B, T, N] (or [T, N]); transition [N+2, N]: row 0 the start
    scores, row 1 the end scores, rows 2.. the pairwise transitions.
    Returns the best tag path [B, T] int64, or with `label` its 0/1 match
    mask."""
    e = _raw(emission).float()
    w = _raw(transition, e).float()
    squeeze = e.dim() == 2
    if squeeze:
        e = e[None]
    B, T, N = e.shape
    start, end, trans = w[0], w[1], w[2:]
    alpha = start[None] + e[:, 0]                    # [B, N]
    back = []
    for t in range(1, T):
        score = alpha[:, :, None] + trans[None] + e[:, t][:, None, :]
        alpha, arg = score.max(dim=1)
        back.append(arg)
    alpha = alpha + end[None]
    tag = torch.argmax(alpha, -1)
    path = [tag]
    for bp in reversed(back):
        tag = torch.take_along_dim(bp, tag[:, None], 1)[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], 1).long()
    if label is not None:
        lab = _raw(label, e).reshape(B, T)
        out = (path == lab).long()
        return Tensor(out[0] if squeeze else out)
    return Tensor(path[0] if squeeze else path)


def ctc_align(input, blank=0, merge_repeated=True, padding_value=0,
              input_length=None, name=None):
    """CTC best-path alignment (reference ctc_align op), on the host:
    collapse repeats, drop blanks, left-pack, pad with padding_value.
    Returns (aligned ids, lengths int64)."""
    a = _host(input)
    squeeze = a.ndim == 1
    if squeeze:
        a = a[None]
    lens = (_host(input_length).reshape(-1) if input_length is not None
            else np.full(a.shape[0], a.shape[1]))
    out = np.full_like(a, padding_value)
    out_lens = np.zeros(a.shape[0], np.int64)
    for b in range(a.shape[0]):
        prev, j = None, 0
        for t in range(int(lens[b])):
            tok = int(a[b, t])
            if tok != blank and not (merge_repeated and tok == prev):
                out[b, j] = tok
                j += 1
            prev = tok
        out_lens[b] = j
    dev = input._data.device if isinstance(input, Tensor) else None
    res = torch.from_numpy(np.ascontiguousarray(out[0] if squeeze else out))
    return Tensor(res.to(dev)), Tensor(torch.from_numpy(out_lens).to(dev))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
