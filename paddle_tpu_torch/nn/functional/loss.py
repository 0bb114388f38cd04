"""Loss functionals (`paddle_tpu/nn/functional/loss.py`; reference
`python/paddle/nn/functional/loss.py`), in plain PyTorch with the JAX
package's formulas: the cross entropies in f32, a weighted mean divided by
the sum of the sample weights, CTC over `log_softmax` of its input, the
RNN-T lattice by its forward recursion (FastEmit as the loss with the
blank log-probabilities held constant, added with its weight)."""

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.ops._common import raw

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "huber_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "sigmoid_focal_loss", "log_loss", "square_error_cost", "ctc_loss",
    "npair_loss", "dice_loss", "identity_loss", "margin_cross_entropy",
    "hsigmoid_loss", "warprnnt", "rnnt_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _pick(logp, idx, axis):
    """logp's entries at the class ids idx along `axis`."""
    return torch.gather(logp, axis, idx.long().unsqueeze(axis)).squeeze(axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    lbl = raw(label)

    def fn(logits, *w):
        lg = logits.float()
        ax = axis % lg.ndim
        logp = torch.log_softmax(lg, dim=ax) if use_softmax else \
            torch.log(torch.clamp(lg, min=1e-30))
        k = logits.shape[ax]
        if soft_label:
            tgt = lbl.to(lg.device).float()
            if label_smoothing > 0:
                tgt = (1 - label_smoothing) * tgt + label_smoothing / k
            return _reduce(-(tgt * logp).sum(dim=ax), reduction)
        lab = lbl.to(lg.device)
        if lab.ndim == logits.ndim and lab.shape[ax] == 1:
            lab = lab.squeeze(ax)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        picked = _pick(logp, safe, ax)
        if label_smoothing > 0:
            picked = (1 - label_smoothing) * picked + \
                label_smoothing * logp.mean(dim=ax)
        loss = torch.where(valid, -picked, 0.0)
        wt = None
        if w:
            wt = w[0][safe] * valid.to(loss.dtype)
            loss = loss * wt
        if reduction == "mean":
            denom = wt.sum() if wt is not None else valid.float().sum()
            return loss.sum() / torch.clamp(denom, min=1e-12)
        return _reduce(loss, reduction)

    args = [weight] if weight is not None else []
    return apply(fn, input, *args, _name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from paddle_tpu_torch.nn.functional.activation import softmax
    from paddle_tpu_torch.ops.manipulation import unsqueeze

    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lbl = raw(label)

    def fn(logp, *w):
        lab = lbl.to(logp.device)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        loss = torch.where(valid, -_pick(logp, safe, 1), 0.0)
        wt = None
        if w:
            wt = w[0][safe] * valid.to(loss.dtype)
            loss = loss * wt
        if reduction == "mean":
            denom = wt.sum() if wt is not None else \
                torch.clamp(valid.float().sum(), min=1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)

    args = [weight] if weight is not None else []
    return apply(fn, input, *args, _name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce((a - b) ** 2, reduction), input,
                 label, _name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce(torch.abs(a - b), reduction), input,
                 label, _name="l1_loss")


def _huber(a, b, delta, strict):
    d = torch.abs(a - b)
    small = d < delta if strict else d <= delta
    return torch.where(small, 0.5 * d * d, delta * (d - 0.5 * delta))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return apply(lambda a, b: _reduce(_huber(a, b, delta, True), reduction),
                 input, label, _name="smooth_l1")


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return apply(lambda a, b: _reduce(_huber(a, b, delta, False), reduction),
                 input, label, _name="huber_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, t, *w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-7)
        loss = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        return _reduce(loss * w[0] if w else loss, reduction)

    args = [weight] if weight is not None else []
    return apply(fn, input, label, *args, _name="bce")


def _bce_logits(z, t, pw=None):
    soft = torch.log1p(torch.exp(-torch.abs(z)))
    if pw is None:
        return torch.clamp(z, min=0) - z * t + soft
    log_weight = (pw - 1) * t + 1
    return (1 - t) * z + log_weight * (soft + torch.clamp(-z, min=0))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def fn(z, t, *rest):
        w = rest[0] if weight is not None else None
        pw = rest[-1] if pos_weight is not None else None
        loss = _bce_logits(z, t, pw)
        return _reduce(loss if w is None else loss * w, reduction)

    args = [t for t in (weight, pos_weight) if t is not None]
    return apply(fn, logit, label, *args, _name="bce_with_logits")


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def fn(lp, t):
        if log_target:
            loss = torch.exp(t) * (t - lp)
        else:
            loss = t * (torch.log(torch.clamp(t, min=1e-30)) - lp)
        if reduction == "batchmean":
            return loss.sum() / lp.shape[0]
        return _reduce(loss, reduction)

    return apply(fn, input, label, _name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply(lambda a, b, t: _reduce(
        torch.clamp(-t * (a - b) + margin, min=0.0), reduction),
        input, other, label, _name="margin_ranking")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply(lambda a, t: _reduce(
        torch.where(t == 1, a, torch.clamp(margin - a, min=0.0)), reduction),
        input, label, _name="hinge_embedding")


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def fn(a, b, t):
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1)
                                 + 1e-12)
        return _reduce(torch.where(t == 1, 1 - cos,
                                   torch.clamp(cos - margin, min=0.0)),
                       reduction)

    return apply(fn, input1, input2, label, _name="cosine_embedding")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.pow(torch.abs(a - b), p).sum(-1) + epsilon,
                         1 / p)

    def fn(a, pos, neg):
        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return apply(fn, input, positive, negative, _name="triplet_margin")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, t, *n):
        p = torch.sigmoid(z)
        ce = _bce_logits(z, t)
        p_t = p * t + (1 - p) * (1 - t)
        a_t = alpha * t + (1 - alpha) * (1 - t)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        return _reduce(loss / n[0] if n else loss, reduction)

    args = [normalizer] if normalizer is not None else []
    return apply(fn, logit, label, *args, _name="focal")


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply(lambda p, t: -t * torch.log(p + epsilon)
                 - (1 - t) * torch.log(1 - p + epsilon),
                 input, label, _name="log_loss")


def square_error_cost(input, label):
    return apply(lambda a, b: (a - b) ** 2, input, label,
                 _name="square_error")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log_softmax(log_probs) [T, B, C] (Paddle's layout; the
    input is normalised as warpctc's logits are); "mean" averages each
    sample's loss over its label length."""
    lbl, il, ll = raw(labels), raw(input_lengths), raw(label_lengths)

    def fn(lp):
        logp = torch.log_softmax(lp.float(), dim=-1)
        loss = TF.ctc_loss(logp, lbl.to(lp.device).long(),
                           il.to(lp.device).long(), ll.to(lp.device).long(),
                           blank=blank, reduction="none")
        if reduction == "mean":
            return (loss / torch.clamp(ll.to(lp.device).float(),
                                       min=1.0)).mean()
        return _reduce(loss, reduction)

    return apply(fn, log_probs, _name="ctc_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def fn(a, p, lab):
        sim = a @ p.T
        lv = lab.reshape(-1, 1)
        target = (lv == lv.T).float()
        target = target / target.sum(-1, keepdim=True)
        ce = -(target * torch.log_softmax(sim, -1)).sum(-1)
        reg = l2_reg * ((a * a).sum() + (p * p).sum()) / (2 * a.shape[0])
        return ce.mean() + reg

    return apply(fn, anchor, positive, labels, _name="npair")


def dice_loss(input, label, epsilon=1e-5, name=None):
    def fn(p, t):
        t1 = TF.one_hot(t[..., 0].long(), p.shape[-1]).to(p.dtype)
        dims = tuple(range(1, p.ndim))
        inter = (p * t1).sum(dims)
        union = p.sum(dims) + t1.sum(dims)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()

    return apply(fn, input, label, _name="dice")


def identity_loss(x, reduction="none", name=None):
    """The loss marker: sum (0, "sum"), mean (1, "mean") or x itself."""
    if reduction in (0, "sum"):
        return apply(torch.sum, x, _name="identity_loss")
    if reduction in (1, "mean"):
        return apply(torch.mean, x, _name="identity_loss")
    return x


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace/CosFace margin softmax over cosine logits: the target
    class's logit becomes cos(m1 theta + m2) - m3, all scaled by s."""
    lbl = raw(label).reshape(-1)

    def fn(cos_t):
        c = torch.clamp(cos_t.float(), -1.0, 1.0)
        lab = lbl.to(c.device).long()
        target = torch.cos(margin1 * torch.arccos(c) + margin2) - margin3
        onehot = TF.one_hot(lab, c.shape[-1]) > 0
        logp = torch.log_softmax(torch.where(onehot, target, c) * scale, -1)
        loss = -_pick(logp, lab, 1)
        return _reduce(loss, reduction), torch.exp(logp)

    loss, sm = apply(fn, logits, _name="margin_cross_entropy")
    return (loss, sm) if return_softmax else loss


def _default_tree(num_classes):
    """The complete-binary-tree coding of hsigmoid: internal nodes 0 ..
    num_classes - 2; leaf c at heap position num_classes - 1 + c; its path
    the ancestors root to parent, its code the turns (right = 1)."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    tables, codes = [], []
    for c in range(num_classes):
        pos = num_classes - 1 + c
        pt, pc = [], []
        while pos > 0:
            parent = (pos - 1) // 2
            pt.append(parent)
            pc.append(float(pos == 2 * parent + 2))
            pos = parent
        pt, pc = pt[::-1], pc[::-1]
        tables.append((pt + [-1] * (depth - len(pt)))[:depth])
        codes.append((pc + [0.0] * (depth - len(pc)))[:depth])
    return np.asarray(tables, np.int64), np.asarray(codes, np.float32)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: the BCE of each path node's logit against its
    code, summed over the path ([B, 1])."""
    dev = input._data.device
    lab = raw(label).reshape(-1).to(dev).long()
    if path_table is None:
        tables, codes = _default_tree(num_classes)
        table = torch.as_tensor(tables, device=dev)[lab]
        code = torch.as_tensor(codes, device=dev)[lab]
    else:
        table = raw(path_table).to(dev).long()[lab]
        code = raw(path_code).to(dev).float()[lab]
    valid = (table >= 0).float()
    safe = torch.clamp(table, min=0)

    def fn(x, w, *b):
        logit = torch.einsum("bdf,bf->bd", w[safe], x.float())
        if b:
            logit = logit + b[0].reshape(-1)[safe]
        return (_bce_logits(logit, code) * valid).sum(-1, keepdim=True)

    args = (input, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, _name="hsigmoid_loss")


def _rnnt_forward(logp, lab, in_len, lab_len, blank, sg_blank=False):
    """-log P(label | input) of each sample over the RNN-T lattice:
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u), alpha[t, u-1]
    + y(t, u-1)); loss = -(alpha[T-1, U] + blank(T-1, U))."""
    B, T, U1, _ = logp.shape
    U = U1 - 1
    blank_lp = logp[..., blank]
    if sg_blank:
        blank_lp = blank_lp.detach()
    y_lp = torch.gather(logp[:, :, :U, :], 3,
                        lab.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
    neg = torch.tensor(-1e30, dtype=logp.dtype, device=logp.device)
    alphas, prev_row = [], None
    for t in range(T):
        if t == 0:
            top = torch.where(torch.arange(U1, device=logp.device) == 0,
                              0.0, neg).expand(B, U1)
        else:
            top = prev_row + blank_lp[:, t - 1]
        cols, left = [], neg.expand(B)
        for u in range(U1):
            emit = y_lp[:, t, u - 1] if u > 0 else neg.expand(B)
            left = torch.logaddexp(top[:, u], left + emit)
            cols.append(left)
        prev_row = torch.stack(cols, dim=1)
        alphas.append(prev_row)
    alphas = torch.stack(alphas)                     # [T, B, U+1]
    t_idx = in_len.long() - 1
    u_idx = lab_len.long()
    bidx = torch.arange(B, device=logp.device)
    return -(alphas[t_idx, bidx, u_idx] + blank_lp[bidx, t_idx, u_idx])


def warprnnt(input, label, input_lengths, label_lengths, blank=0,
             fastemit_lambda=0.0, name=None):
    """The RNN-Transducer loss of each sample: input [B, T, U+1, V]
    (normalised by log_softmax), label [B, U]. FastEmit adds lambda times
    the same loss with the blank log-probabilities held constant, whose
    gradient flows through the emissions only."""
    def fn(logits, lab, in_len, lab_len):
        logp = torch.log_softmax(logits.float(), dim=-1)
        base = _rnnt_forward(logp, lab, in_len, lab_len, blank)
        if fastemit_lambda:
            return base + fastemit_lambda * _rnnt_forward(
                logp, lab, in_len, lab_len, blank, sg_blank=True)
        return base

    return apply(fn, input, label, input_lengths, label_lengths,
                 _name="warprnnt")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    loss = warprnnt(input, label, input_lengths, label_lengths, blank=blank,
                    fastemit_lambda=fastemit_lambda)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
