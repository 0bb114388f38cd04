"""Carry a reference parameter tree into the port.

`params_from_numpy` takes the tree `paddle_tpu.models.llama_functional
.init_params` builds, with its leaves as numpy arrays, and returns the
port's `Llama` over the same numbers. The layouts are the same, so nothing
is transposed: a wrong layout fails on shape, it is never silently
reinterpreted. A weight-only int8 tree (the reference's `quantize_params`)
arrives with each `QuantizedWeight` as a (q, scale) pair of numpy arrays;
the port then runs on the same int8 codes and scales.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.generation import QuantizedWeight
from paddle_tpu_torch.models.llama import Llama
from paddle_tpu_torch.models.llama_functional import LAYER_KEYS

__all__ = ["params_from_numpy"]


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
