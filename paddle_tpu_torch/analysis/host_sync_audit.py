"""Host-sync audit: step programs must not round-trip through the host
(port of `paddle_tpu/analysis/host_sync_audit.py`).

A read of a traced value on the host (`.item()`, `int(t)`, `bool(t)`, a
branch on a tensor) or a copy of one to the host inside a train or serving
step serializes the card against the Python thread every single step, and
a step that does it cannot be captured in a CUDA graph. The audit names
the line that introduced one. It finds three kinds:

  - `aten._local_scalar_dense` nodes: a value read into Python whose use
    the trace could still record (`.item()` feeding arithmetic);
  - copies to the host: `_to_copy` / `copy_` / `to` nodes whose output
    lies on the CPU while their input lies on another device;
  - reads the trace could not get past: under fake tensors a branch,
    `int(t)` or `bool(t)` on a traced value has no answer and stops the
    trace (`GuardOnDataDependentSymNode`). `programs.trace` keeps the line
    that read in the program's `host_reads`, and the rule reports it.

A value that lives on the host by design (the optimizer's step counter, a
0-d CPU tensor) is not traced: the builders keep it out of a program's
inputs, as the reference keeps a static argument.

Rule id: host-sync.callback-in-step.
"""

from __future__ import annotations

import torch
import torch.fx

from paddle_tpu_torch.analysis.base import Violation
from paddle_tpu_torch.analysis.graph_walk import (iter_eqns, op_name,
                                                  provenance, values)

__all__ = ["HOST_SYNC_PRIMITIVES", "COPY_PRIMITIVES", "check_host_sync"]

HOST_SYNC_PRIMITIVES = frozenset({
    "aten._local_scalar_dense.default",
    "aten.item.default",
})
COPY_PRIMITIVES = frozenset({
    "aten._to_copy.default", "aten.copy_.default", "aten.to.device",
    "aten.to.dtype_layout", "aten.to.other", "aten._copy_from.default",
})


def _device(x):
    vs = values(x) if isinstance(x, torch.fx.Node) else []
    return vs[0].device if vs else None


def _to_host(node):
    """The source device of a copy whose output is on the CPU and whose
    source is on another device, else None."""
    if op_name(node) not in COPY_PRIMITIVES or not node.args:
        return None
    dst = _device(node)
    src = _device(node.args[1] if op_name(node) == "aten.copy_.default"
                  else node.args[0])
    if dst is not None and src is not None and dst.type == "cpu" and \
            src.type != "cpu":
        return src
    return None


def check_host_sync(graph, program):
    """Flag host reads and copies to the host anywhere in the program.
    `graph` is an `AuditProgram` (its recorded `host_reads` are reported
    too) or a GraphModule."""
    out = []
    for line, what in getattr(graph, "host_reads", ()):
        out.append(Violation(
            rule="host-sync.callback-in-step",
            program=program,
            message=(f"host read of a traced value inside the step "
                     f"program ({what}) — every step now blocks on the "
                     "Python thread"),
            provenance=line))
    gm = getattr(graph, "graph_module", graph)
    if gm is None:
        return out
    for node, path in iter_eqns(gm):
        name = op_name(node)
        if name in HOST_SYNC_PRIMITIVES:
            kind = f"'{name}' reads a traced value into Python"
        elif _to_host(node) is not None:
            kind = (f"'{name}' copies a {_to_host(node).type} value to "
                    "the host")
        else:
            continue
        where = "/".join(path) if path else "top level"
        out.append(Violation(
            rule="host-sync.callback-in-step",
            program=program,
            message=(f"host round-trip: {kind} inside the step program "
                     f"({where}) — every step now blocks on the Python "
                     "thread"),
            provenance=provenance(node)))
    return out
