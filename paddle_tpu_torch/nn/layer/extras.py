"""The rest of nn (`paddle_tpu/nn/layer/extras.py`; reference
`python/paddle/nn/__init__.py` members not covered elsewhere): thin Layer
wrappers over the functional forms, RNN cell runners, and seq2seq decoding
(`python/paddle/nn/decode.py`)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor, _as_torch
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = [
    "Silu", "Softmax2D", "PairwiseDistance", "Unflatten", "ZeroPad1D",
    "ZeroPad3D", "FractionalMaxPool2D", "FractionalMaxPool3D", "LPPool1D",
    "LPPool2D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "FeatureAlphaDropout", "GaussianNLLLoss", "PoissonNLLLoss",
    "SoftMarginLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "TripletMarginWithDistanceLoss", "RNNTLoss", "HSigmoidLoss",
    "AdaptiveLogSoftmaxWithLoss", "ParameterDict", "RNNCellBase", "RNN",
    "BiRNN", "BeamSearchDecoder", "dynamic_decode",
]


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.silu(x)


class Softmax2D(Layer):
    """softmax over the channel dim of NCHW input (reference nn.Softmax2D)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        from paddle_tpu_torch.nn import functional as F

        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        import paddle_tpu_torch as paddle

        return paddle.unflatten(x, self.axis, self.shape)


class _ZeroPadN(Layer):
    _NDIM = None

    def __init__(self, padding, data_format=None, name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self._NDIM)
        self.padding = list(padding)
        self.data_format = data_format

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format or
                     ("NCL" if self._NDIM == 1 else "NCDHW"))


class ZeroPad1D(_ZeroPadN):
    _NDIM = 1


class ZeroPad3D(_ZeroPadN):
    _NDIM = 3


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.kw = dict(output_size=output_size, kernel_size=kernel_size,
                       random_u=random_u, return_mask=return_mask)

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.fractional_max_pool2d(x, **self.kw)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.fractional_max_pool3d(x, **self.kw)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.lp_pool2d(x, *self.args)


class _MaxUnPoolN(Layer):
    _FN = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kw = dict(kernel_size=kernel_size, stride=stride,
                       padding=padding, output_size=output_size)
        if data_format is not None:
            self.kw["data_format"] = data_format

    def forward(self, x, indices):
        from paddle_tpu_torch.nn import functional as F

        return getattr(F, self._FN)(x, indices, **self.kw)


class MaxUnPool1D(_MaxUnPoolN):
    _FN = "max_unpool1d"


class MaxUnPool2D(_MaxUnPoolN):
    _FN = "max_unpool2d"


class MaxUnPool3D(_MaxUnPoolN):
    _FN = "max_unpool3d"


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F

        return F.feature_alpha_dropout(x, self.p, training=self.training)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        from paddle_tpu_torch.nn import functional as F

        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.kw = dict(log_input=log_input, full=full, epsilon=epsilon,
                       reduction=reduction)

    def forward(self, input, label):
        from paddle_tpu_torch.nn import functional as F

        return F.poisson_nll_loss(input, label, **self.kw)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        from paddle_tpu_torch.nn import functional as F

        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        from paddle_tpu_torch.nn import functional as F

        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.kw = dict(p=p, margin=margin, weight=weight, reduction=reduction)

    def forward(self, input, label):
        from paddle_tpu_torch.nn import functional as F

        return F.multi_margin_loss(input, label, **self.kw)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.kw = dict(distance_function=distance_function, margin=margin,
                       swap=swap, reduction=reduction)

    def forward(self, input, positive, negative):
        from paddle_tpu_torch.nn import functional as F

        return F.triplet_margin_with_distance_loss(
            input, positive, negative, **self.kw)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.lam, self.reduction = blank, fastemit_lambda, reduction

    def forward(self, logits, labels, logit_lengths, label_lengths):
        from paddle_tpu_torch.nn import functional as F

        return F.rnnt_loss(logits, labels, logit_lengths, label_lengths,
                           blank=self.blank, fastemit_lambda=self.lam,
                           reduction=self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss layer (reference nn.HSigmoidLoss):
    owns the tree weight/bias and delegates to F.hsigmoid_loss."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        import math

        from paddle_tpu_torch.nn import initializer as I

        rows = num_classes - 1 if not is_custom else num_classes
        std = 1.0 / math.sqrt(feature_size)
        self.weight = self.create_parameter(
            [rows, feature_size], attr=weight_attr,
            default_initializer=I.Uniform(-std, std))
        self.bias = self.create_parameter(
            [rows, 1], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-std, std))

    def forward(self, input, label, path_table=None, path_code=None):
        from paddle_tpu_torch.nn import functional as F

        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """reference nn.AdaptiveLogSoftmaxWithLoss: owns head + tail
    projections; cutoffs EXCLUDES n_classes (appended internally)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or min(cutoffs) <= 0
                or max(cutoffs) > n_classes - 1
                or len(set(cutoffs)) != len(cutoffs)):
            raise ValueError(
                "cutoffs must be a sorted list of unique positive ints "
                "< n_classes")
        self.cutoffs = cutoffs + [n_classes]
        self.n_clusters = len(self.cutoffs) - 1
        shortlist = self.cutoffs[0]
        from paddle_tpu_torch.nn import initializer as I

        self.head_weight = self.create_parameter(
            [in_features, shortlist + self.n_clusters],
            default_initializer=I.XavierUniform())
        self.head_bias = self.create_parameter(
            [shortlist + self.n_clusters], is_bias=True,
            default_initializer=I.Constant(0.0)) if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter([in_features, hsz],
                                       default_initializer=I.XavierUniform())
            w2 = self.create_parameter([hsz, osz],
                                       default_initializer=I.XavierUniform())
            setattr(self, f"_tail_{i}_0", w1)
            setattr(self, f"_tail_{i}_1", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        from paddle_tpu_torch.nn import functional as F

        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            head_bias=self.head_bias)

    def log_prob(self, input):
        """Full [N, n_classes] log-probabilities."""
        with torch.no_grad():
            x = _as_torch(input, like=self.head_weight._data)
            hw = self.head_weight._data
            head = x @ hw + (self.head_bias._data
                             if self.head_bias is not None else 0.0)
            hlp = torch.log_softmax(head, dim=-1)
            shortlist = self.cutoffs[0]
            parts = [hlp[:, :shortlist]]
            for i, (w1, w2) in enumerate(self.tail_weights):
                tl = torch.log_softmax((x @ w1._data) @ w2._data, dim=-1)
                parts.append(hlp[:, shortlist + i:shortlist + i + 1] + tl)
            return Tensor(torch.cat(parts, dim=1))

    def predict(self, input):
        return Tensor(torch.argmax(self.log_prob(input)._data, dim=1))


class ParameterDict(Layer):
    """dict-style parameter container (reference nn.ParameterDict)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            items = parameters.items() if hasattr(parameters, "items") \
                else parameters
            for k, v in items:
                self.add_parameter(str(k), v)

    def __getitem__(self, key):
        return self._parameters[str(key)]

    def __setitem__(self, key, param):
        self.add_parameter(str(key), param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def __contains__(self, key):
        return str(key) in self._parameters

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        items = parameters.items() if hasattr(parameters, "items") \
            else parameters
        for k, v in items:
            self.add_parameter(str(k), v)


class RNNCellBase(Layer):
    """Base for user-defined recurrent cells (reference
    `python/paddle/nn/layer/rnn.py` RNNCellBase): provides
    get_initial_states for RNN/BiRNN/decoders."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        import paddle_tpu_torch as paddle

        batch = batch_ref.shape[batch_dim_idx]
        shape = shape if shape is not None else self.state_shape

        def build(s):
            if isinstance(s, (list, tuple)) and s and isinstance(
                    s[0], (list, tuple)):
                return type(s)(build(x) for x in s)
            dims = [batch] + [int(d) for d in s]
            return paddle.full(dims, init_value,
                               dtype=dtype or batch_ref.dtype)

        if isinstance(shape, (list, tuple)) and shape and isinstance(
                shape[0], (list, tuple)):
            return type(shape)(build(s) for s in shape)
        return build(shape)

    @property
    def state_shape(self):
        raise NotImplementedError(
            "cells must define state_shape to use get_initial_states")


def _run_cell(cell, inputs, initial_states, time_major, reverse=False,
              sequence_length=None):
    """Unroll a cell over time in eager mode. sequence_length freezes
    states past each sample's length (reference RNN mask semantics)."""
    import paddle_tpu_torch as paddle

    axis = 0 if time_major else 1
    T = inputs.shape[axis]
    steps = range(T - 1, -1, -1) if reverse else range(T)
    states = initial_states
    outs = [None] * T
    seq = None
    if sequence_length is not None:
        seq = _as_torch(sequence_length, like=inputs._data)
    for t in steps:
        x_t = inputs[:, t] if axis == 1 else inputs[t]
        out, new_states = cell(x_t, states)
        if seq is not None:
            alive = Tensor((t < seq).to(out._data.dtype)[:, None])
            out = out * alive
            if isinstance(new_states, (tuple, list)):
                new_states = type(new_states)(
                    n * alive + s * (1.0 - alive)
                    for n, s in zip(new_states, states))
            else:
                new_states = new_states * alive + states * (1.0 - alive)
        outs[t] = out
        states = new_states
    stacked = paddle.stack(outs, axis=axis)
    return stacked, states


class RNN(Layer):
    """Runs any cell over a sequence (reference nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            if hasattr(self.cell, "get_initial_states"):
                initial_states = self.cell.get_initial_states(
                    inputs, batch_dim_idx=1 if self.time_major else 0)
            else:
                out, initial_states = self.cell(
                    inputs[0] if self.time_major else inputs[:, 0], None)
                initial_states = _tree_map(lambda s: s * 0.0,
                                           initial_states)
        return _run_cell(self.cell, inputs, initial_states, self.time_major,
                         reverse=self.is_reverse,
                         sequence_length=sequence_length)


class BiRNN(Layer):
    """Forward + backward cells over one sequence (reference nn.BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        import paddle_tpu_torch as paddle

        fw_init = bw_init = None
        if initial_states is not None:
            fw_init, bw_init = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, fw_init, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw_init, sequence_length)
        return paddle.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


def _tree_map(fn, tree):
    """fn over the Tensor leaves of nested lists, tuples and dicts."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


def _repeat_beams(x, k):
    """[B, ...] -> [B * k, ...], each row repeated k times in place."""
    d = x._data if isinstance(x, Tensor) else _as_torch(x)
    return Tensor(d.repeat_interleave(k, dim=0))


class BeamSearchDecoder:
    """Beam-search decoding over a cell (reference
    `python/paddle/nn/decode.py:BeamSearchDecoder`): scores are summed
    log-probs; finished beams are frozen with end_token."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        return _repeat_beams(x, beam_size)


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False,
                   **kwargs):
    """Decode until all beams finish or max_step_num (reference
    `python/paddle/nn/decode.py:dynamic_decode`). An eager loop: decoding
    is autoregressive and data-dependent."""
    cell = decoder.cell
    K = decoder.beam_size
    max_steps = int(max_step_num or 32)

    if inits is None:
        raise ValueError(
            "dynamic_decode requires inits (the cell's initial states, "
            "e.g. paddle.zeros([batch, hidden])) — the batch size cannot "
            "be inferred without them")
    # per-(batch*beam) running state
    states = _tree_map(lambda s: _repeat_beams(s, K), inits)
    probe = _tree_leaves(states)[0]
    BK = probe.shape[0]
    B = BK // K
    dev = probe._data.device
    scores = torch.tensor([0.0] + [-1e9] * (K - 1), device=dev).repeat(B)
    tokens = torch.full((BK,), decoder.start_token, dtype=torch.int32,
                        device=dev)
    finished = torch.zeros(BK, dtype=torch.bool, device=dev)
    collected = []
    lengths = torch.zeros(BK, dtype=torch.int32, device=dev)
    for step in range(max_steps):
        emb = decoder.embedding_fn(Tensor(tokens)) if decoder.embedding_fn \
            else Tensor(torch.nn.functional.one_hot(
                tokens.long(), probe.shape[-1]).float())
        out, new_states = cell(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        lp = torch.log_softmax(
            logits._data if isinstance(logits, Tensor) else logits, dim=-1)
        V = lp.shape[-1]
        # frozen beams only extend with end_token at zero cost
        frozen = torch.full((V,), -1e9, device=dev)
        frozen[decoder.end_token] = 0.0
        lp = torch.where(finished[:, None], frozen[None, :], lp)
        total = scores[:, None] + lp                      # [B*K, V]
        flat = total.reshape(B, K * V)
        top_v, top_i = torch.topk(flat, K)                # [B, K]
        beam_src = top_i // V                             # [B, K]
        tok = (top_i % V).to(torch.int32)
        gidx = (torch.arange(B, device=dev)[:, None] * K
                + beam_src).reshape(-1)
        scores = top_v.reshape(-1)
        tokens = tok.reshape(-1)
        finished = finished[gidx] | (tokens == decoder.end_token)
        lengths = torch.where(finished, lengths[gidx], lengths[gidx] + 1)
        states = _tree_map(lambda s: Tensor(_as_torch(s)[gidx]), new_states)
        # re-point already-collected history at the surviving beams
        collected = [c[gidx] for c in collected]
        collected.append(tokens)
        if bool(finished.all()):
            break
    ids = torch.stack(collected, dim=1).reshape(B, K, -1)  # [B, K, T]
    if output_time_major:
        ids = ids.movedim(-1, 0)
    out = (Tensor(ids), Tensor(scores.reshape(B, K)))
    if return_length:
        return out + (Tensor(lengths.reshape(B, K)),)
    return out
