"""`Llama`: the nn.Module that owns a functional Llama parameter tree.

The weights stay in the reference layout (`llama_functional`): [in, out]
matrices, decoder-layer leaves stacked on a leading [num_layers] dim. The
forward functions are `models.generation`'s; the module holds the weights
and the config they run with.

A leaf is a float tensor or, in a weight-only int8 tree
(`generation.quantize_params`), a `QuantizedWeight`: its int8 codes and
f32 scales are the parameters `<key>_q` and `<key>_scale`, and the leaf
reads back as a QuantizedWeight of the two (`lm_head`, `layer(i)`,
`tree()`). The embedding, the norms and every float matmul weight share
one dtype, the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.generation import QuantizedWeight
from paddle_tpu_torch.models.llama_functional import LAYER_KEYS, LlamaArgs

__all__ = ["Llama"]


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def _entries(key, leaf):
    """{name: Parameter} of one leaf: the tensor under its key, or a
    QuantizedWeight's codes and scales under `<key>_q` and `<key>_scale`."""
    if isinstance(leaf, QuantizedWeight):
        if leaf.q.dtype != torch.int8 or leaf.scale.dtype != torch.float32:
            raise ValueError(f"{key}: a QuantizedWeight holds int8 codes "
                             "and float32 scales")
        return {f"{key}_q": _param(leaf.q),
                f"{key}_scale": _param(leaf.scale)}
    return {key: _param(leaf)}


def _leaf(store, key):
    if key in store:
        return store[key]
    return QuantizedWeight(store[f"{key}_q"], store[f"{key}_scale"])


class Llama(nn.Module):
    """Inference weights of a Llama decoder (no gradients).

    params: a tree as `llama_functional.init_params` returns it (or as
    `generation.quantize_params` returns it), of tensors on one device.
    """

    def __init__(self, args: LlamaArgs, params):
        super().__init__()
        self.args = args
        if set(params["layers"]) != set(LAYER_KEYS):
            raise ValueError(f"layer keys {sorted(params['layers'])} != "
                             f"{sorted(LAYER_KEYS)}")
        leaves = [params["embedding"], params["final_norm"],
                  params["lm_head"], *params["layers"].values()]
        floats = [t for t in leaves if not isinstance(t, QuantizedWeight)]
        tensors = floats + [t for v in leaves
                            if isinstance(v, QuantizedWeight) for t in v]
        if len({t.device for t in tensors}) != 1 or \
                len({t.dtype for t in floats}) != 1:
            raise ValueError("parameters must share one device, and the "
                             "float ones one dtype")
        self.embedding = _param(params["embedding"])
        self.layers = nn.ParameterDict(
            {n: t for k in LAYER_KEYS
             for n, t in _entries(k, params["layers"][k]).items()})
        self.final_norm = _param(params["final_norm"])
        for n, t in _entries("lm_head", params["lm_head"]).items():
            setattr(self, n, t)
        self._check_shapes()

    def __getattr__(self, name):
        # a quantized lm_head is stored as lm_head_q and lm_head_scale
        if name == "lm_head":
            try:
                return _leaf(self._parameters, name)
            except KeyError:
                raise AttributeError(name) from None
        return super().__getattr__(name)

    def _check_shapes(self):
        a = self.args
        h, hd, L = a.hidden_size, a.head_dim, a.num_layers
        want = {"embedding": (a.vocab_size, h), "final_norm": (h,),
                "lm_head": (h, a.vocab_size),
                "wq": (L, h, a.num_heads * hd),
                "wk": (L, h, a.num_kv_heads * hd),
                "wv": (L, h, a.num_kv_heads * hd),
                "wo": (L, a.num_heads * hd, h),
                "w_gate": (L, h, a.intermediate_size),
                "w_up": (L, h, a.intermediate_size),
                "w_down": (L, a.intermediate_size, h),
                "ln1": (L, h), "ln2": (L, h)}
        tree = self.tree()
        have = {"embedding": tree["embedding"],
                "final_norm": tree["final_norm"],
                "lm_head": tree["lm_head"], **tree["layers"]}
        for k, shape in want.items():
            leaf = have[k]
            got = tuple(leaf.q.shape if isinstance(leaf, QuantizedWeight)
                        else leaf.shape)
            if got != shape:
                raise ValueError(f"{k}: shape {got}, the config wants "
                                 f"{shape}")
            if isinstance(leaf, QuantizedWeight) and \
                    tuple(leaf.scale.shape) != shape[:-2] + shape[-1:]:
                raise ValueError(f"{k}: scale {tuple(leaf.scale.shape)} is "
                                 f"not {shape[:-2] + shape[-1:]}")

    @property
    def quantized(self):
        """True when a matmul weight is int8 (a QuantizedWeight)."""
        return any(n.endswith("_q") for n, _ in self.named_parameters())

    @property
    def device(self):
        return self.embedding.device

    @property
    def dtype(self):
        """The compute dtype: the embedding's."""
        return self.embedding.dtype

    def tree(self):
        """The parameter tree these weights came from (the same tensors;
        an int8 leaf as a QuantizedWeight)."""
        return {"embedding": self.embedding,
                "layers": {k: _leaf(self.layers, k) for k in LAYER_KEYS},
                "final_norm": self.final_norm, "lm_head": self.lm_head}

    def layer(self, i):
        """Layer i's weights as a dict of views."""
        return {k: (QuantizedWeight(v.q[i], v.scale[i])
                    if isinstance(v, QuantizedWeight) else v[i])
                for k, v in self.tree()["layers"].items()}

    def forward(self, ids, caches_k, caches_v, pos, cos, sin, last_idx=None):
        """`generation._forward_cached`: next-token logits [b, vocab] f32;
        the caches are written in place."""
        return generation._forward_cached(self, ids, caches_k, caches_v, pos,
                                          cos, sin, last_idx)

    def paged_decode(self, ids, pool_k, pool_v, block_tables, pos, cos, sin,
                     page_size):
        """`generation._paged_forward_decode`: one decode step over the
        page pool (written in place)."""
        return generation._paged_forward_decode(
            self, ids, pool_k, pool_v, block_tables, pos, cos, sin, page_size)
