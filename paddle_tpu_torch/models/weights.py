"""Carry a reference parameter tree into the port.

`params_from_numpy` takes the tree `paddle_tpu.models.llama_functional
.init_params` builds, with its leaves as numpy arrays, and returns the
port's `Llama` over the same numbers. The layouts are the same, so nothing
is transposed: a wrong layout fails on shape, it is never silently
reinterpreted. A weight-only int8 tree (the reference's `quantize_params`)
arrives with each `QuantizedWeight` as a (q, scale) pair of numpy arrays;
the port then runs on the same int8 codes and scales.

For training, `tree_from_numpy` carries the same tree as plain tensors
(leaves requiring grad when asked), `adamw_state_from_numpy` the JAX
engine's AdamW state ({"m", "v", "step"[, "master"]}, a factored second
moment as {"r", "c"}), and `tree_to_numpy` brings either back. A trained
tree serves through `Llama(args, tree)` once detached.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tree import tree_map
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.bert import BERT_LAYER_KEYS, Bert
from paddle_tpu_torch.models.generation import QuantizedWeight
from paddle_tpu_torch.models.gpt import GPT_LAYER_KEYS, Gpt
from paddle_tpu_torch.models.llama import Llama
from paddle_tpu_torch.models.llama_functional import LAYER_KEYS

__all__ = ["params_from_numpy", "tree_from_numpy", "adamw_state_from_numpy",
           "tree_to_numpy", "gpt_params_from_numpy", "bert_params_from_numpy"]


def params_from_numpy(tree, args, device=None, dtype=torch.float32):
    """tree: {"embedding", "layers": {wq, wk, wv, wo, w_gate, w_up, w_down,
    ln1, ln2} stacked on [L], "final_norm", "lm_head" [H, V]} of numpy
    arrays (or anything np.asarray takes); a matmul weight may be a
    (q int8, scale) pair. Returns `Llama(args, ...)` on `device` (CUDA
    unless device="cpu"), float leaves in `dtype`, int8 codes as they are,
    scales in f32."""
    dev = resolve_device(device)

    def t(x):
        if isinstance(x, tuple):
            q, scale = x
            return QuantizedWeight(
                torch.from_numpy(np.array(q, np.int8)).to(dev),
                torch.from_numpy(np.array(scale, np.float32)).to(dev))
        return torch.from_numpy(np.array(x, np.float32)).to(device=dev,
                                                            dtype=dtype)

    params = {"embedding": t(tree["embedding"]),
              "layers": {k: t(tree["layers"][k]) for k in LAYER_KEYS},
              "final_norm": t(tree["final_norm"]),
              "lm_head": t(tree["lm_head"])}
    return Llama(args, params)


def _tensor(x, dev, dtype=None):
    """x (numpy or anything np.asarray takes) as a tensor on dev: in
    `dtype`, else in x's own float type (float32, or bfloat16)."""
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(device=dev,
                                                        dtype=dtype)


def tree_from_numpy(tree, device=None, dtype=torch.float32,
                    requires_grad=False):
    """A reference parameter tree as the same nested dicts of plain
    tensors on `device` (CUDA unless device="cpu"), in `dtype`; leaves
    require grad when asked (for training)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev, dtype).requires_grad_(
        requires_grad), tree)


def adamw_state_from_numpy(state, device=None):
    """The JAX engine's AdamW state (`adamw_init` :64) as the port's: m, v
    (a factored leaf as {"r", "c"}) and master in their own float types on
    `device`, step as a 0-d int64 tensor on the host."""
    dev = resolve_device(device)
    out = {k: tree_map(lambda x: _tensor(x, dev), state[k])
           for k in ("m", "v", "master") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])))
    return out


def tree_to_numpy(tree):
    """A tree of tensors (params, grads, or an AdamW state) as float32
    numpy arrays; a 0-d integer tensor (the step) as an int."""
    def back(t):
        if not t.dtype.is_floating_point and t.dim() == 0:
            return int(t)
        return t.detach().float().cpu().numpy()

    return tree_map(back, tree)


def gpt_params_from_numpy(tree, args, device=None, dtype=torch.float32):
    """tree: {"word_emb", "pos_emb", "layers": {ln1_w, ..., fc2_b} stacked
    on [L], "lnf_w", "lnf_b"} of numpy arrays (the reference's
    `gpt_params_from_layer`). Returns `Gpt(args, ...)` on `device` (CUDA
    unless device="cpu") in `dtype`."""
    dev = resolve_device(device)
    params = {k: _tensor(tree[k], dev, dtype)
              for k in ("word_emb", "pos_emb", "lnf_w", "lnf_b")}
    params["layers"] = {k: _tensor(tree["layers"][k], dev, dtype)
                        for k in GPT_LAYER_KEYS}
    return Gpt(args, params, device=dev)


# the port's BERT leaf -> the reference BertModel's parameter name
_BERT_TOP = {"word_emb": "embeddings.word_embeddings.weight",
             "pos_emb": "embeddings.position_embeddings.weight",
             "type_emb": "embeddings.token_type_embeddings.weight",
             "emb_ln_w": "embeddings.layer_norm.weight",
             "emb_ln_b": "embeddings.layer_norm.bias",
             "pool_w": "pooler.weight", "pool_b": "pooler.bias"}
_BERT_LAYER = {"wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
               "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
               "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
               "wo": "self_attn.out_proj.weight",
               "bo": "self_attn.out_proj.bias",
               "ln1_w": "norm1.weight", "ln1_b": "norm1.bias",
               "fc1_w": "linear1.weight", "fc1_b": "linear1.bias",
               "fc2_w": "linear2.weight", "fc2_b": "linear2.bias",
               "ln2_w": "norm2.weight", "ln2_b": "norm2.bias"}


def bert_params_from_numpy(state, cfg, device=None, dtype=torch.float32):
    """state: a reference `BertModel`'s parameters by name
    (`state_dict()`, leaves as numpy). Returns `Bert(cfg, ...)` on `device` (CUDA
    unless device="cpu") in `dtype`, the encoder layers stacked on [L]."""
    dev = resolve_device(device)
    params = {k: _tensor(state[name], dev, dtype)
              for k, name in _BERT_TOP.items()}
    params["layers"] = {
        k: _tensor(np.stack([np.asarray(
            state[f"encoder.layers.{i}.{_BERT_LAYER[k]}"], np.float32)
            for i in range(cfg.num_hidden_layers)]), dev, dtype)
        for k in BERT_LAYER_KEYS}
    return Bert(cfg, params, device=dev)
