"""The rest of nn.functional (`paddle_tpu/nn/functional/extra_fns.py`;
reference `python/paddle/nn/functional/{loss,pooling,activation,
flash_attention}.py`): more losses, lp_pool1d, feature alpha dropout, the
in-place activations and the masked attentions.

`flashmask_attention` expands its row intervals to a dense additive mask
and goes through `scaled_dot_product_attention` (the plain path, since a
mask is given), as the JAX package does; `sparse_attention` masks dense
logits by its CSR pattern.
"""

import math

import numpy as np
import torch

from paddle_tpu_torch.core.ops_patch import make_inplace
from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.nn.functional import activation as _act
from paddle_tpu_torch.nn.functional.common import SELU_ALPHA, SELU_SCALE
from paddle_tpu_torch.nn.functional.loss import _reduce
from paddle_tpu_torch.ops._common import raw

__all__ = [
    "pairwise_distance", "poisson_nll_loss", "gaussian_nll_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss",
    "multi_margin_loss", "triplet_margin_with_distance_loss",
    "adaptive_log_softmax_with_loss", "feature_alpha_dropout",
    "lp_pool1d", "elu_", "hardtanh_", "leaky_relu_", "tanh_",
    "thresholded_relu_", "class_center_sample", "flashmask_attention",
    "sparse_attention",
]


def _p_norm(d, p, keepdim):
    if p == float("inf"):
        return torch.amax(torch.abs(d), dim=-1, keepdim=keepdim)
    return torch.linalg.vector_norm(d, ord=p, dim=-1, keepdim=keepdim)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + epsilon||_p along the last dim."""
    return apply(lambda a, b: _p_norm(a - b + epsilon, p, keepdim), x, y,
                 _name="pairwise_distance")


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def fn(inp, lab):
        if log_input:
            loss = torch.exp(inp) - lab * inp
        else:
            loss = inp - lab * torch.log(inp + epsilon)
        if full:   # Stirling's approximation of log(label!)
            stir = lab * torch.log(lab) - lab + \
                0.5 * torch.log(2 * math.pi * lab)
            loss = loss + torch.where(lab > 1, stir, 0.0)
        return _reduce(loss, reduction)

    return apply(fn, input, label, _name="poisson_nll_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, lab, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + (lab - mu) ** 2 / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)

    return apply(fn, input, label, variance, _name="gaussian_nll_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, t: _reduce(torch.log1p(torch.exp(-t * a)),
                                      reduction),
                 input, label, _name="soft_margin_loss")


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def fn(a, t, *w):
        ls = torch.nn.functional.logsigmoid
        loss = -(t * ls(a) + (1 - t) * ls(-a))
        if w:
            loss = loss * w[0]
        return _reduce(loss.mean(dim=-1), reduction)

    args = [weight] if weight is not None else []
    return apply(fn, input, label, *args,
                 _name="multi_label_soft_margin_loss")


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def fn(a, t, *w):
        t = t.long()
        true_score = torch.gather(a, 1, t[:, None])
        diff = torch.clamp(margin - true_score + a, min=0.0) ** p
        if w:
            diff = diff * w[0][t][:, None]
        others = torch.arange(a.shape[1], device=a.device)[None] != t[:, None]
        loss = torch.where(others, diff, 0.0).sum(dim=1) / a.shape[1]
        return _reduce(loss, reduction)

    args = [weight] if weight is not None else []
    return apply(fn, input, label, *args, _name="multi_margin_loss")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or pairwise_distance
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn2 = dist(positive, negative)
        dn = apply(torch.minimum, dn, dn2, _name="minimum")
    return apply(lambda p_, n_: _reduce(torch.clamp(p_ - n_ + margin,
                                                    min=0.0), reduction),
                 dp, dn, _name="triplet_margin_with_distance")


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al. 2017): the classes below cutoffs[0]
    in the head, each later range [cutoffs[i], cutoffs[i+1]) a
    down-projected tail cluster routed by one head column. Returns (each
    sample's log-probability of its label, the mean loss)."""
    shortlist = cutoffs[0]
    bounds = list(zip(cutoffs[:-1], cutoffs[1:]))
    has_bias = head_bias is not None
    flat_tails = [w for pair in tail_weights for w in pair]

    def fn(x, lab, hw, *rest):
        lab = lab.long()
        hb = rest[0] if has_bias else None
        tails = rest[1 if has_bias else 0:]
        head_logits = x @ hw
        if hb is not None:
            head_logits = head_logits + hb
        head_lp = torch.log_softmax(head_logits, dim=-1)
        out = torch.gather(head_lp, 1, lab.clamp(0, shortlist - 1)[:, None])
        out = torch.where(lab < shortlist, out[:, 0], 0.0)
        for ci, (lo, hi) in enumerate(bounds):
            tail_lp = torch.log_softmax((x @ tails[2 * ci])
                                        @ tails[2 * ci + 1], dim=-1)
            idx = (lab - lo).clamp(0, tail_lp.shape[1] - 1)
            lp = head_lp[:, shortlist + ci] + \
                torch.gather(tail_lp, 1, idx[:, None])[:, 0]
            out = torch.where((lab >= lo) & (lab < hi), lp, out)
        return out, -out.mean()

    args = [input, label, head_weight] + ([head_bias] if has_bias else [])
    return apply(fn, *args, *flat_tails,
                 _name="adaptive_log_softmax_with_loss")


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole feature maps: one draw per (sample,
    channel) from the framework generator, then alpha_dropout's affine
    map, which keeps a SELU network's mean 0 and variance 1."""
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(raw(x))
    alpha_p = -SELU_ALPHA * SELU_SCALE
    # Paddle's affine map, alpha_dropout's: it keeps unit variance (the
    # JAX package drops the (1 - p) factor, ROADMAP §C)
    A = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    B = -A * p * alpha_p

    def fn(a):
        shape = (a.shape[0], a.shape[1]) + (1,) * (a.ndim - 2)
        keep = torch.rand(shape, device=a.device,
                          generator=_rng.generator(a.device)) < 1 - p
        return A * torch.where(keep, a, alpha_p) + B

    return apply(fn, x, _name="feature_alpha_dropout")


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """(sum of |x|^p over each 1-D window)^(1/p)."""
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = stride if stride is not None else k
    s = s if isinstance(s, int) else s[0]

    def fn(a):
        powed = torch.nn.functional.pad(torch.abs(a) ** norm_type,
                                        (padding, padding))
        return powed.unfold(-1, k, s).sum(-1) ** (1.0 / norm_type)

    return apply(fn, x, _name="lp_pool1d")


def _inplace_act(fn_name):
    op_ = make_inplace(getattr(_act, fn_name))
    op_.__name__ = fn_name + "_"
    return op_


elu_ = _inplace_act("elu")
hardtanh_ = _inplace_act("hardtanh")
leaky_relu_ = _inplace_act("leaky_relu")
tanh_ = _inplace_act("tanh")
thresholded_relu_ = _inplace_act("thresholded_relu")


def class_center_sample(label, num_classes, num_samples, group=None):
    from paddle_tpu_torch.ops.legacy_ps import class_center_sample as ccs

    return ccs(label, num_classes, num_samples)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """FlashMask attention: startend_row_indices [B, H, S, k] marks, per
    key column, the query rows masked out: rows >= start (k = 1), or rows
    in [start, end) (k = 2). Expanded to a dense -inf mask for
    `scaled_dot_product_attention`."""
    from paddle_tpu_torch.nn.functional.flash_attention import \
        scaled_dot_product_attention

    mask = None
    if startend_row_indices is not None:
        idx = raw(startend_row_indices)
        q = query._data
        qrow = torch.arange(q.shape[1], device=idx.device)[None, None, :,
                                                          None]
        st = idx[..., 0][..., None].transpose(-1, -2)
        masked = qrow >= st
        if idx.shape[-1] > 1:
            masked = masked & (qrow < idx[..., 1][..., None]
                               .transpose(-1, -2))
        mask = Tensor(torch.where(masked, float("-inf"), 0.0)
                      .to(q.dtype).to(q.device))
    return scaled_dot_product_attention(
        query, key, value, attn_mask=mask, dropout_p=dropout,
        is_causal=causal, training=training)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of q [B, H, S, D] where each query row sees only the key
    columns its CSR row lists (offsets [B, H, S + 1], columns [B, H,
    nnz]): a dense mask over the logits, rows with no key give 0."""
    B, H, S, _ = query.shape
    off = raw(sparse_csr_offset).cpu().numpy().astype(np.int64)
    cols = raw(sparse_csr_columns).cpu().numpy().astype(np.int64)
    m = np.zeros((B, H, S, S), bool)
    for b in range(B):
        for h in range(H):
            for r in range(S):
                m[b, h, r, cols[b, h, off[b, h, r]:off[b, h, r + 1]]] = True

    def fn(q, k, v):
        allow = torch.as_tensor(m, device=q.device)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
            q.shape[-1])
        w = torch.softmax(torch.where(allow, logits, float("-inf")), dim=-1)
        w = torch.where(torch.isnan(w), 0.0, w)
        return torch.einsum("bhqk,bhkd->bhqd", w, v)

    return apply(fn, query, key, value, _name="sparse_attention")
