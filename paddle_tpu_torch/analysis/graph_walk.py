"""Reusable walker over `torch.fx` graphs: one home for "visit every node,
including the nested ones", so audit rules (and tests) stop hand-rolling
partial traversals (port of `paddle_tpu/analysis/jaxpr_walk.py`; the
package binds `analysis.jaxpr_walk` to this module, so the reference's
names resolve).

A program is a `GraphModule` as `make_fx` traces it over fake tensors
(`programs.trace`): aten operators, the kernels' custom operators
(`paddle_tpu_torch::flash_fwd` ...), and higher-order operators
(`torch.cond`, `while_loop`, ...) whose branches and bodies are
GraphModules the node reads through `get_attr` nodes. The walker finds
those by scanning every argument of a node for a `get_attr` that names a
GraphModule, so new higher-order operators keep working.

Shapes and dtypes come from `node.meta["val"]`, the fake tensor (or tuple
of them) the tracer recorded for the node's output.

Provenance: `stamping()` wraps the recording of every node while a
program is traced and writes the first frame outside torch (and outside
the standard library and this file) into `node.meta["user_frame"]`:
the line of port code, or of the code that built the program, whose call
made the node. A node replayed from a graph dynamo captured (a branch of
a `torch.cond`) carries that graph's `stack_trace` instead, which names
the branch's own line. `provenance(node)` renders the frame as
"file.py:line (function)", or "" when there is none.
"""

from __future__ import annotations

import contextlib
import os
import sys
import sysconfig
import traceback
from typing import NamedTuple

import torch
import torch.fx
import torch.utils._pytree as pytree

__all__ = ["subgraphs", "subjaxprs", "iter_eqns", "iter_shaped_values",
           "provenance", "user_frame", "format_eqn", "op_name", "values",
           "stamping", "frame_of_traceback", "provenance_of", "Frame"]


class Frame(NamedTuple):
    """A source frame, under the names the reference's frames carry."""

    file_name: str
    start_line: int
    function_name: str


# torch, the standard library and this file (the stamping hook): frames
# that never name the code that built a node
_HERE = os.path.abspath(__file__)
_INTERNAL = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,) + \
    tuple({os.path.abspath(sysconfig.get_paths()[k]) + os.sep
           for k in ("stdlib", "platstdlib")})


def _internal(filename):
    if not filename or filename.startswith("<"):
        return True
    path = os.path.abspath(filename)
    return path == _HERE or path.startswith(_INTERNAL)


def _first_user(frames):
    """The first (innermost-first order) frame outside torch, the standard
    library and this file, as a Frame, or None."""
    for filename, line, func in frames:
        if not _internal(filename):
            return Frame(filename, line, func)
    return None


def _stack(frame):
    while frame is not None:
        yield frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name
        frame = frame.f_back


def frame_of_traceback(tb):
    """The innermost user frame of an exception's traceback: the line whose
    call raised (a host read that a fake trace cannot answer)."""
    frames = [(f.f_code.co_filename, line, f.f_code.co_name)
              for f, line in traceback.walk_tb(tb)]
    return _first_user(reversed(frames))


@contextlib.contextmanager
def stamping():
    """While active, every node a graph records carries the first user
    frame of the stack that recorded it in `meta["user_frame"]`. The
    node metadata of a graph the tracer replays (the branches of a
    `torch.cond`, which dynamo captures first) is carried onto the nodes
    it records, `stack_trace` included."""
    import torch.fx.traceback as fx_traceback

    orig = torch.fx.Graph.create_node

    def create_node(self, *args, **kwargs):
        node = orig(self, *args, **kwargs)
        fr = _first_user(_stack(sys._getframe(1)))
        if fr is not None:
            node.meta.setdefault("user_frame", fr)
        return node

    torch.fx.Graph.create_node = create_node
    try:
        with fx_traceback.preserve_node_meta():
            yield
    finally:
        torch.fx.Graph.create_node = orig


def _module_of(item):
    if isinstance(item, torch.fx.GraphModule):
        return item
    gm = getattr(item, "graph_module", None)
    if isinstance(gm, torch.fx.GraphModule):
        return gm
    return None


def _attr(owner, target):
    obj = owner
    for part in str(target).split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def subgraphs(node, owner):
    """Yield every GraphModule a node reads through a `get_attr` argument
    of `owner` (a higher-order operator's branches and bodies; nested
    tuples and lists of arguments are scanned)."""
    leaves = pytree.tree_leaves((node.args, node.kwargs))
    for a in leaves:
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            sub = _attr(owner, a.target)
            if isinstance(sub, torch.fx.GraphModule):
                yield sub


subjaxprs = subgraphs


def op_name(node):
    """"aten.mm.default", "paddle_tpu_torch.flash_fwd.default", "cond",
    "getitem": the name a message and a census show for a node."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return str(t)
    if isinstance(t, torch._ops.HigherOrderOperator):
        return t.name()
    return getattr(t, "__name__", str(t))


def iter_eqns(program):
    """DFS over (node, path) pairs of every `call_function` node of a
    GraphModule (or an `AuditProgram`) and of every subgraph it reaches.
    `path` is the tuple of enclosing higher-order operator names, e.g.
    ("cond",) or ("while_loop", "cond"): the breadcrumb a violation
    message shows. Subgraphs shared by several nodes are visited once."""
    root = _module_of(program)
    if root is None:
        raise TypeError(f"not a graph module: {type(program).__name__}")
    seen = set()

    def walk(gm, path):
        if id(gm) in seen:
            return
        seen.add(id(gm))
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            yield node, path
            for sub in subgraphs(node, gm):
                yield from walk(sub, path + (op_name(node),))

    yield from walk(root, ())


def values(node):
    """The tensors of a node's recorded output (`meta["val"]`), flattened."""
    val = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return [v for v in pytree.tree_leaves(val) if isinstance(v, torch.Tensor)]


def iter_shaped_values(program):
    """Yield (value, node, path, role) for every tensor a node reads
    ("in") or writes ("out"), across all subgraphs."""
    for node, path in iter_eqns(program):
        for a in pytree.tree_leaves((node.args, node.kwargs)):
            if isinstance(a, torch.fx.Node):
                for v in values(a):
                    yield v, node, path, "in"
        for v in values(node):
            yield v, node, path, "out"


def _stack_trace_frame(node):
    """The innermost user frame of the node's recorded `stack_trace`
    (outermost frame first, as Python prints it), or None."""
    text = node.meta.get("stack_trace") or ""
    frames = []
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip().startswith("File ")]
    for ln in reversed(lines):
        # File "path", line N, in func
        try:
            path = ln.split('"')[1]
            rest = ln.split('"')[2]
            line = int(rest.split("line")[1].split(",")[0])
            func = rest.split(" in ")[-1].strip()
        except (IndexError, ValueError):
            continue
        frames.append((path, line, func))
    return _first_user(frames)


def user_frame(node):
    """The node's first user frame (a Frame), or None: the innermost user
    frame of its `stack_trace` (the source a replayed graph recorded it
    at), else the frame stamped while it was recorded."""
    return _stack_trace_frame(node) or node.meta.get("user_frame")


def provenance_of(fr):
    """A Frame -> "file.py:line (function)"."""
    return f"{os.path.basename(fr.file_name)}:{fr.start_line} " \
        f"({fr.function_name})"


def provenance(node):
    """Node -> "file.py:line (function)", or "" when unavailable."""
    fr = user_frame(node)
    return "" if fr is None else provenance_of(fr)


def format_eqn(node, path=()):
    """Short human label for a node in a violation message."""
    shapes = ",".join(str(tuple(v.shape)) for v in values(node))
    where = "/".join(path) if path else "top"
    return f"{op_name(node)} -> {shapes} [{where}]"
