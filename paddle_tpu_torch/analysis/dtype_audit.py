"""Dtype-policy audit: no stray f32 matmuls under a bf16 policy (port of
`paddle_tpu/analysis/dtype_audit.py`).

Under bf16 training every matrix product should take bf16 operands — an
f32 product runs the H100's tensor cores at TF32 rate at best (and at the
CUDA cores' rate with TF32 off), and usually means a cast crept in
upstream (the classic silent 2-8x). The few *intentional* f32 sites (loss
math, the normalization stack, optimizer master-weight math) are
allowlisted BY PROVENANCE — file + function of the node's first user
frame (`graph_walk.user_frame`) — so the allowlist survives refactors
that move lines but not functions.

The products are `aten.mm`, `bmm`, `addmm`, `baddbmm`, `matmul` and
`linear` (every overload); their operands are the two matrices (the
bias of `addmm`/`baddbmm`/`linear` is not an operand).

Rule id: dtype.f32-dot-under-bf16.
"""

from __future__ import annotations

import os

import torch
import torch.fx

from paddle_tpu_torch.analysis.base import Violation
from paddle_tpu_torch.analysis.graph_walk import (iter_eqns, provenance,
                                                  user_frame, values)

__all__ = ["DEFAULT_F32_DOT_ALLOWLIST", "MATMUL_OPERANDS",
           "check_dtype_policy"]

# "file.py::function" sites allowed to run f32 matrix products under bf16:
# the loss epilogue accumulates in f32 by design, rms_norm's statistics
# are f32, and the optimizer's master-weight update is the entire point
# of keeping f32 around. Everything else must justify itself here.
DEFAULT_F32_DOT_ALLOWLIST = (
    # the fused CE's d_head: bf16 operands summed into f32 on the card
    # (`mm(out_dtype=f32)`); on the CPU the operands are widened first
    "llama_functional.py::_mm_f32",
    # one CE chunk's f32 logit statistics and their input grads
    "llama_functional.py::_ce_chunk_stats",
    # the unchunked loss's f32 softmax
    "llama_functional.py::parallel_cross_entropy",
    # RMSNorm's statistics are f32
    "llama_functional.py::rms_norm",
    # adamw master-weight math
    "hybrid_engine.py::_update_leaf",
)

# matrix product -> the positions of its two operands in node.args
MATMUL_OPERANDS = {
    "mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "linear": (0, 1),
    "addmm": (1, 2), "baddbmm": (1, 2),
}


def _product(node):
    t = node.target
    if not isinstance(t, torch._ops.OpOverload) or t.namespace != "aten":
        return None
    return MATMUL_OPERANDS.get(t._schema.name.split("::")[-1])


def _allowed(node, allowlist):
    fr = user_frame(node)
    if fr is None:
        return False
    fname = str(fr.file_name or "")
    func = str(fr.function_name or "")
    for entry in allowlist:
        efile, _, efunc = entry.partition("::")
        if os.path.basename(fname) == efile and (not efunc or efunc == func):
            return True
    return False


def check_dtype_policy(graph, program, policy="bf16",
                       allowlist=DEFAULT_F32_DOT_ALLOWLIST):
    """Flag f32-operand matrix products when the program's compute policy
    is bf16. `policy` other than "bf16" disables the rule (f32 training is
    allowed to be f32)."""
    if policy != "bf16":
        return []
    out = []
    for node, path in iter_eqns(graph):
        pos = _product(node)
        if pos is None:
            continue
        ops = [values(node.args[i])[0] if i < len(node.args)
               and isinstance(node.args[i], torch.fx.Node)
               and values(node.args[i]) else None for i in pos]
        if not any(v is not None and v.dtype == torch.float32 for v in ops):
            continue
        if _allowed(node, allowlist):
            continue
        shapes = [tuple(v.shape) if v is not None else () for v in ops]
        out.append(Violation(
            rule="dtype.f32-dot-under-bf16",
            program=program,
            message=(f"f32 {node.target._schema.name.split('::')[-1]} "
                     f"{shapes[0]} x {shapes[1]} under bf16 policy "
                     "(f32 tensor-core rate at best); cast operands to bf16 "
                     "or allowlist the site with a justification"),
            provenance=provenance(node)))
    return out
