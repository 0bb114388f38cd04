"""Collective audit: census + fingerprint of a program's collectives (port
of `paddle_tpu/analysis/collective_audit.py`).

The TP serving programs (and the hybrid engine's sharded step) have a
*known* collective structure: every row-parallel matmul carries exactly
one all-reduce epilogue — 2 per decoder layer (wo, w_down), nothing
else. An accidentally doubled all-reduce is always slow; a dropped one is
silently wrong on more than one card and invisible on a one-card rig.
The census catches both at trace time.

A traced program holds collectives as `_c10d_functional.*` nodes (the
functional collectives of `torch.distributed`) or `c10d.*` nodes (the
process-group operators). The census names them as the reference names
its primitives — `all_reduce` with "sum" is `psum` ("max" `pmax`, "min"
`pmin`), `all_gather_into_tensor` is `all_gather`,
`reduce_scatter_tensor` is `psum_scatter`, `all_to_all_single` is
`all_to_all` — and their process group by the mesh axis the caller maps
its name to (`axes`, a {group name: axis name} dict; an unmapped group
keeps its own name). So `fingerprint` hashes the same text as the
reference's, and the reference's goldens are the port's goldens.

  collective_census(graph)   ordered [{prim, axes, shape, ...}] of every
                             collective, in program order.
  fingerprint(census)        stable 12-hex digest of the (prim, axes)
                             sequence — goldens pin it per program.
  check_collectives(...)     count and/or fingerprint must match.

Rule ids: collective.count-mismatch, collective.fingerprint-mismatch.
"""

from __future__ import annotations

import hashlib

import torch

from paddle_tpu_torch.analysis.base import Violation
from paddle_tpu_torch.analysis.graph_walk import (iter_eqns, provenance,
                                                  values)

__all__ = ["COLLECTIVE_PRIMITIVES", "collective_census", "fingerprint",
           "check_collectives", "prim_of"]

# the reference's collective primitives: the names the census gives
COLLECTIVE_PRIMITIVES = frozenset({
    "psum", "psum2", "pmax", "pmin", "ppermute", "pbroadcast",
    "all_gather", "all_to_all", "psum_scatter", "reduce_scatter",
})

_REDUCE = {"sum": "psum", "max": "pmax", "min": "pmin", "avg": "psum"}
# functional collective -> the reference primitive (None: by reduce op)
_FUNCTIONAL = {
    "all_reduce": None, "all_reduce_": None, "all_reduce_coalesced": None,
    "all_reduce_coalesced_": None,
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "psum_scatter",
    "reduce_scatter_tensor_coalesced": "psum_scatter",
    "all_to_all_single": "all_to_all",
    "broadcast": "pbroadcast", "broadcast_": "pbroadcast",
}
# process-group operator -> the reference primitive
_C10D = {
    "allreduce_": "psum", "allreduce_coalesced_": "psum",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "psum_scatter", "_reduce_scatter_base_":
    "psum_scatter", "alltoall_": "all_to_all", "alltoall_base_":
    "all_to_all", "broadcast_": "pbroadcast", "send": "ppermute",
    "recv_": "ppermute",
}


def prim_of(node):
    """(reference primitive, process group name) of a collective node, or
    None for any other node."""
    t = node.target
    if not isinstance(t, torch._ops.OpOverload):
        return None
    ns, op = t.namespace, t._schema.name.split("::")[-1]
    if ns == "_c10d_functional" and op in _FUNCTIONAL:
        prim = _FUNCTIONAL[op]
        if prim is None:
            red = node.args[1] if len(node.args) > 1 else "sum"
            prim = _REDUCE.get(str(red).lower(), f"all_reduce_{red}")
        group = node.args[-1] if node.args else ""
        return prim, str(group)
    if ns == "c10d" and op in _C10D:
        group = next((a for a in node.args if isinstance(a, str)), "")
        return _C10D[op], group
    return None


def collective_census(graph, axes=None):
    """Ordered census of the program's collectives:
    [{prim, axes, shape, path, provenance}] in deterministic walk order.
    `axes` maps a process group's name to the mesh axis it spans."""
    axes = axes or {}
    out = []
    for node, path in iter_eqns(graph):
        hit = prim_of(node)
        if hit is None:
            continue
        prim, group = hit
        vals = values(node)
        out.append({
            "prim": prim,
            "axes": (str(axes.get(group, group)),),
            "shape": tuple(vals[0].shape) if vals else (),
            "path": "/".join(path),
            "provenance": provenance(node),
        })
    return out


def fingerprint(census):
    """Order-sensitive digest of the (prim, axes) sequence. Shapes are
    excluded so the fingerprint is stable across batch-size/toy-size
    changes; a doubled, dropped, or reordered collective changes it."""
    text = ";".join(f"{c['prim']}@{','.join(c['axes'])}" for c in census)
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def check_collectives(graph, program, expect_count=None,
                      expect_fingerprint=None, axes=None):
    """Pin the program's collective structure. `expect_count` is usually
    a formula of the model (2 * num_layers all-reduces for Megatron TP);
    `expect_fingerprint` is the golden digest — regenerate with
    `fingerprint(collective_census(graph))` after an INTENTIONAL change
    and say why in the diff."""
    census = collective_census(graph, axes=axes)
    out = []
    if expect_count is not None and len(census) != expect_count:
        sites = ", ".join(
            f"{c['prim']}@{','.join(c['axes'])} [{c['provenance']}]"
            for c in census[:6]) or "none"
        out.append(Violation(
            rule="collective.count-mismatch",
            program=program,
            message=(f"expected {expect_count} collectives, found "
                     f"{len(census)}: {sites}"
                     + (" ..." if len(census) > 6 else "")),
            provenance=census[0]["provenance"] if census else ""))
    if expect_fingerprint is not None:
        got = fingerprint(census)
        if got != expect_fingerprint:
            seq = ";".join(f"{c['prim']}@{','.join(c['axes'])}"
                           for c in census)
            out.append(Violation(
                rule="collective.fingerprint-mismatch",
                program=program,
                message=(f"collective fingerprint {got} != golden "
                         f"{expect_fingerprint} (sequence: {seq or 'empty'})"
                         " — doubled/dropped/reordered collective, or an "
                         "intentional change that must update the golden"),
                provenance=census[0]["provenance"] if census else ""))
    return out
