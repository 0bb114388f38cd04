"""Buffer audit: what the traced program materializes (port of
`paddle_tpu/analysis/buffer_audit.py`).

Three rules over the graph's intermediate values:

  top_intermediates    the k largest buffers any node writes — the report
                       half (what would a memory profile blame?).
  check_byte_ceiling   no single intermediate may exceed a per-program
                       byte budget (buffer.byte-ceiling). Budgets are
                       pinned per program family in analysis.presets.
  check_forbidden_shape  the generalized no-[b, s, vocab] rule from the
                       fused-CE work (buffer.forbidden-shape): the given
                       shape must not appear anywhere in the program,
                       forward or backward, including every subgraph.

An intermediate is a buffer a node allocates: the output of a view
(`view`, `select`, `transpose`, ...) shares its input's storage and the
output of an in-place operator is the buffer it wrote, so neither counts.
`has_shape` is the predicate form.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.analysis.base import Violation
from paddle_tpu_torch.analysis.graph_walk import (format_eqn, iter_eqns,
                                                  iter_shaped_values,
                                                  provenance, values)

__all__ = ["intermediates", "top_intermediates", "has_shape",
           "check_forbidden_shape", "check_byte_ceiling", "allocates"]


# views the schema does not mark as such (the reshape of a matmul's output)
_UNMARKED_VIEWS = frozenset({"aten::_unsafe_view"})


def allocates(node):
    """False for a node whose output aliases an input (a view, an in-place
    write, a tuple projection): its output is no new buffer."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t._schema.name not in _UNMARKED_VIEWS and \
            all(r.alias_info is None for r in t._schema.returns)
    return getattr(t, "__name__", "") != "getitem"


def _nbytes(val):
    try:
        return int(val.numel()) * val.element_size()
    except Exception:
        return 0


def intermediates(graph):
    """Every buffer a node writes: [(nbytes, value, node, path)], deduped
    (a multi-output node's tensors are each counted once), sorted
    largest-first."""
    out, seen = [], set()
    for node, path in iter_eqns(graph):
        if not allocates(node):
            continue
        for v in values(node):
            if id(v) in seen:
                continue
            seen.add(id(v))
            out.append((_nbytes(v), v, node, path))
    out.sort(key=lambda t: t[0], reverse=True)
    return out


def top_intermediates(graph, k=10):
    """Top-k largest intermediates as report rows
    {nbytes, shape, dtype, op, provenance}."""
    return [{
        "nbytes": nb,
        "shape": tuple(v.shape),
        "dtype": str(v.dtype).replace("torch.", ""),
        "op": format_eqn(node, path),
        "provenance": provenance(node),
    } for nb, v, node, path in intermediates(graph)[:k]]


def has_shape(graph, shape):
    """True iff any value (read or written, any subgraph) has exactly
    `shape`."""
    shape = tuple(shape)
    return any(tuple(v.shape) == shape
               for v, _, _, _ in iter_shaped_values(graph))


def check_forbidden_shape(graph, shape, program, what="buffer"):
    """No value of exactly `shape` may exist anywhere in the program:
    pass shape=(b, s, vocab) and a rematerialized logits buffer — forward
    OR backward — fails the audit with the node that built it."""
    shape = tuple(shape)
    out = []
    seen_nodes = set()
    for v, node, path, role in iter_shaped_values(graph):
        if tuple(v.shape) != shape or id(node) in seen_nodes:
            continue
        seen_nodes.add(id(node))
        out.append(Violation(
            rule="buffer.forbidden-shape",
            program=program,
            message=(f"forbidden {what} shape {shape} "
                     f"({str(v.dtype).replace('torch.', '')}) "
                     f"{'read' if role == 'in' else 'written'} by "
                     f"{format_eqn(node, path)}"),
            provenance=provenance(node)))
        if len(out) >= 5:  # the first few sites identify the leak
            break
    return out


def check_byte_ceiling(graph, ceiling_bytes, program):
    """No single intermediate may exceed `ceiling_bytes`: presets pins one
    per program family at the landed program's high-water mark plus
    headroom."""
    out = []
    for nb, v, node, path in intermediates(graph):
        if nb <= ceiling_bytes:
            break  # sorted descending
        out.append(Violation(
            rule="buffer.byte-ceiling",
            program=program,
            message=(f"intermediate {tuple(v.shape)} "
                     f"{str(v.dtype).replace('torch.', '')} is {nb} bytes "
                     f"> ceiling {ceiling_bytes} ({format_eqn(node, path)})"),
            provenance=provenance(node)))
        if len(out) >= 5:
            break
    return out
