"""Donation audit: donated state must be updated in place (port of
`paddle_tpu/analysis/donation_audit.py`).

The reference donates its step's state to XLA (`donate_argnums`) and
checks that the lowered program really aliases each donated input to an
output. The port's form of donation is state written IN PLACE: a train
step updates its params and optimizer state through in-place operators,
a serving step writes the KV page pool through views. A refactor that
returns a fresh buffer instead (`p = p - lr * u`, a pool rebuilt with
`torch.cat`) doubles the state's memory and breaks every caller that
holds the old tensor, without failing anything else. The audit reads the
traced graph: every leaf of a donated argument must be the target,
directly or through a chain of views (`select`, `slice`, `view`, ...), of
an in-place operator (`copy_`, `add_`, `index_put_`, `index_copy_`, ...),
by the operator's schema (a `Tensor(a!)` argument).

Audited invariants (wired up in analysis.presets):
  - the train step's params AND optimizer state (m, v, the f32 master
    weights) are written in place;
  - the optimizer write-back writes params + optimizer state in place;
  - the serving step programs write the KV page pool (pk/pv) in place.

The reference's `hlo_alias_map` and `check_donation(kept=,
compiled_text=)` have no counterpart: the port has no lowering that
prunes arguments or resolves aliases at compile time (ROADMAP §C). The
optimizer's step counter is a host value kept out of the traced inputs,
so it is not part of a donated argument here.

Rule id: donation.not-aliased.
"""

from __future__ import annotations

import torch
import torch.fx

from paddle_tpu_torch.analysis.base import Violation
from paddle_tpu_torch.analysis.graph_walk import provenance, values

__all__ = ["written_inputs", "alias_root", "check_donation"]


def _schema(node):
    t = node.target
    return t._schema if isinstance(t, torch._ops.OpOverload) else None


def _arg(node, i, a):
    if i < len(node.args):
        return node.args[i]
    return node.kwargs.get(a.name)


def alias_root(node):
    """Follow a node back through views, in-place results and tuple
    projections of views to the node whose buffer it is (a placeholder
    for an input's storage)."""
    seen = set()
    while isinstance(node, torch.fx.Node) and id(node) not in seen:
        seen.add(id(node))
        if node.op != "call_function":
            return node
        if getattr(node.target, "__name__", "") == "getitem":
            src = node.args[0]
            sch = _schema(src) if isinstance(src, torch.fx.Node) else None
            if sch is not None and any(r.alias_info is not None
                                       for r in sch.returns):
                node = src
                continue
            return node
        sch = _schema(node)
        if sch is None or not sch.returns or \
                sch.returns[0].alias_info is None:
            return node
        # the output aliases the argument that carries the same alias set
        sets = sch.returns[0].alias_info.before_set
        nxt = None
        for i, a in enumerate(sch.arguments):
            if a.alias_info is not None and \
                    a.alias_info.before_set & sets:
                nxt = _arg(node, i, a)
                break
        if not isinstance(nxt, torch.fx.Node):
            return node
        node = nxt
    return node


def written_inputs(gm):
    """The placeholders of `gm` some in-place operator writes, directly or
    through views."""
    out = set()
    for node in gm.graph.nodes:
        sch = _schema(node) if node.op == "call_function" else None
        if sch is None:
            continue
        for i, a in enumerate(sch.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            root = alias_root(_arg(node, i, a))
            if isinstance(root, torch.fx.Node) and root.op == "placeholder":
                out.add(root)
    return out


def _fresh_outputs(gm):
    """{(shape, dtype): node} of the outputs the program builds anew."""
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    fresh = {}
    for leaf in torch.utils._pytree.tree_leaves(out_node.args):
        if isinstance(leaf, torch.fx.Node) and \
                alias_root(leaf).op != "placeholder":
            for v in values(leaf):
                fresh.setdefault((tuple(v.shape), v.dtype), leaf)
    return fresh


def check_donation(program):
    """Every tensor leaf of every donated argument of `program` (an
    `AuditProgram`) must be written in place in its graph. Reports at most
    five leaves an argument, then a count; a violation's provenance is the
    node of a fresh output of the leaf's shape and dtype (the buffer
    standing in for it), when the program returns one."""
    gm, name = program.graph_module, program.name
    if gm is None or not program.donated:
        return []
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    written = written_inputs(gm)
    fresh = _fresh_outputs(gm)
    out = []
    for argnum in program.donated:
        arg = (program.arg_names[argnum] if program.arg_names
               else f"arg{argnum}")
        missing = [(i, path) for i, (a, path) in enumerate(program.leaves)
                   if a == argnum and phs[i] not in written]
        for i, path in missing[:5]:
            v = values(phs[i])
            sd = (tuple(v[0].shape), v[0].dtype) if v else None
            stand_in = fresh.get(sd)
            extra = (f"; the program returns a fresh {sd[0]} "
                     f"{str(sd[1]).replace('torch.', '')} buffer instead"
                     if stand_in is not None else "")
            out.append(Violation(
                rule="donation.not-aliased",
                program=name,
                message=(f"donated input {arg}{path} (flat arg {i}) is "
                         "never written in place in the program — its "
                         f"update lands in a second buffer{extra}"),
                provenance=(provenance(stand_in) if stand_in is not None
                            else "")))
        if len(missing) > 5:
            out.append(Violation(
                rule="donation.not-aliased", program=name,
                message=(f"... and {len(missing) - 5} more leaves of {arg} "
                         "not written in place")))
    return out
