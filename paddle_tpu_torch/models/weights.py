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
from paddle_tpu_torch.models.generation import QuantizedWeight
from paddle_tpu_torch.models.llama import Llama
from paddle_tpu_torch.models.llama_functional import LAYER_KEYS

__all__ = ["params_from_numpy", "tree_from_numpy", "adamw_state_from_numpy",
           "tree_to_numpy"]


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
