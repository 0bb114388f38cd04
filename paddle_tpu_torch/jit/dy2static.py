"""Dynamic-to-static control-flow capture (`paddle_tpu/jit/dy2static.py`;
reference `python/paddle/jit/dy2static/program_translator.py`, the
`ifelse`/`loop`/`logical` transformers and `convert_operators.py`).

The AST transformer is the JAX package's, copied: `if`/`while`/`for
range`/`and`/`or`/`not` become calls into the converted-op runtime below,
which dispatches on tracedness:

  - `if t:` with a traced predicate becomes `torch.cond`'s operator over
    the branch-assigned variables (each branch's outputs cloned: a branch
    may not return its input);
  - `while t:` becomes `torch._higher_order_ops.while_loop`'s operator
    with the body-assigned variables as the carry (Python numbers in the
    carry become tensors on the predicate's device);
  - `a and b` / `a or b` / `not a` keep Python's short-circuit for
    concrete values and become element-wise logical ops for traced ones;
  - a concrete predicate runs the Python statement, so a converted
    function is a drop-in replacement in eager and traced execution.

"Traced" means a fake tensor: `jit.to_static` traces the forward with
`torch.export` (non-strict), which runs the port's eager code over
`FakeTensor`s (inside `torch.cond`/`while_loop` branches too), and
`torch._subclasses.fake_tensor.is_fake` tells them from real tensors. A
real tensor is concrete, and its predicate is read with `bool()`.

The operators are called directly (`cond_op`, `while_loop_op`), not
through `torch.cond`/`while_loop`, which would run dynamo over the port's
eager code. Their tracer bakes a tensor a branch reads through a closure
into the branch as a constant, so the runtime lifts every traced tensor a
branch or loop reads other than through its arguments (closure cells, a
Layer's parameters, globals: `_free_tensors`) into the operator's
operands.

Conversion is best-effort: what the transformer cannot prove it can
convert is left as ordinary Python, which traces fine on a concrete
predicate or raises a data-dependent guard error under the trace, and
`StaticFunction` then runs the callable eagerly. Branches or a loop carry
whose values do not match raise `Dy2StaticFallback` with the region, and
`StaticFunction` retries with that region left as Python.
"""

from __future__ import annotations

import ast
import functools
import inspect
import operator
import textwrap
import types

import torch
import torch.utils._pytree as _pytree
from torch._higher_order_ops.cond import cond_op as _cond_op
from torch._higher_order_ops.while_loop import while_loop_op as _while_loop_op
from torch._subclasses.fake_tensor import is_fake as _is_fake

from paddle_tpu_torch.core.tensor import Tensor

__all__ = [
    "convert_function", "converted_layer_call", "convert_ifelse",
    "convert_while", "convert_for_range", "convert_logical_and",
    "convert_logical_or", "convert_logical_not", "convert_call",
    "Dy2StaticFallback",
]

_RUNTIME_NAME = "__pt_jst__"


class Dy2StaticFallback(Exception):
    """Raised by the converted-op runtime when a construct turns out to be
    uncompilable at trace time (branch values that do not match, a loop
    carry that changes). Carries the failing REGION — (function qualname,
    region id) — so StaticFunction can re-convert with just that region
    left as Python and retry, instead of running the whole callable
    eagerly (the reference SOT's sub-graph fallback,
    `jit/sot/translate.py:37`, done at AST granularity)."""

    def __init__(self, msg, region=None):
        super().__init__(msg)
        self.region = region


# --------------------------------------------------------------------------
# converted-op runtime (reference convert_operators.py: convert_ifelse,
# convert_while_loop, convert_logical_and/or/not)
# --------------------------------------------------------------------------


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _is_traced(x):
    u = _unwrap(x)
    return isinstance(u, torch.Tensor) and _is_fake(u)


def _any_traced(tree):
    return any(_is_traced(v) for v in _pytree.tree_leaves(tree))


def _pred_scalar(pred):
    """Boolean scalar for torch.cond / while_loop. Multi-element
    predicates are ambiguous, as Python's bool(tensor) is."""
    p = _unwrap(pred)
    if not isinstance(p, torch.Tensor):
        p = torch.as_tensor(p)
    if p.numel() != 1:
        raise Dy2StaticFallback(
            "to_static: condition tensor must have exactly one element, got "
            f"shape {tuple(p.shape)} (reduce it with .all()/.any())")
    return p.reshape(()).to(torch.bool)


def _flat_tensors(x, what, device):
    """(leaves as torch tensors, treespec) of a value that must live inside
    compiled control flow; a Python number becomes a tensor on
    `device`."""
    leaves, spec = _pytree.tree_flatten(x)
    out = []
    for v in leaves:
        u = _unwrap(v)
        if isinstance(u, torch.Tensor):
            out.append(u)
        elif isinstance(u, (bool, int, float)):
            out.append(torch.as_tensor(u, device=device))
        else:
            raise Dy2StaticFallback(
                f"to_static: {what} produced {u!r}, a value that cannot "
                "live inside compiled control flow")
    return out, spec


def _to_tensor_tree(leaves, spec):
    return _pytree.tree_unflatten([Tensor(v) for v in leaves], spec)


def _tag_region(region):
    """Decorator: Dy2StaticFallback escaping the converted op gets stamped
    with the op's region (innermost region wins — nested converted ops
    re-raise with their own region already set)."""
    def deco(call):
        try:
            return call()
        except Dy2StaticFallback as e:
            if e.region is None:
                e.region = region
            raise
    return deco


def _hop_mismatch(e):
    """Whether `e` is what tracing `torch.cond`'s or `while_loop`'s
    operator raises for branches or a carry that do not match: torch's
    metadata check (`UncapturedHigherOrderOpError`) or the TypeError of a
    structure that differs, where the JAX runtime catches lax's
    TypeError. Any other error is the program's, and propagates."""
    from torch._dynamo.exc import UncapturedHigherOrderOpError

    return isinstance(e, (UncapturedHigherOrderOpError, TypeError))


def _free_tensors(*fns):
    """The traced Tensors `fns` read other than through their arguments:
    through closure cells (a Tensor, a Layer's parameters and buffers, a
    converted loop's range bounds, a list/tuple/dict of them, a nested
    function's own cells) and through
    the globals their code names. `torch.cond` and `while_loop`'s
    operators trace a branch with a tracer of its own, which would bake
    such a tensor into the branch as a constant: they become the
    operator's operands instead (`_swapped_in`)."""
    from paddle_tpu_torch.nn.layer.layers import Layer

    seen, found = set(), []

    def add(v, depth=0):
        if id(v) in seen or depth > 4:
            return
        seen.add(id(v))
        if isinstance(v, Tensor):
            if _is_fake(v._data):
                found.append(v)
        elif isinstance(v, Layer):
            for _, t in v.named_parameters():
                add(t, depth + 1)
            for _, t in v.named_buffers():
                add(t, depth + 1)
        elif isinstance(v, RangeArgs):
            for e in (v.start, v.stop):
                add(e, depth + 1)
        elif isinstance(v, (list, tuple)):
            for e in v:
                add(e, depth + 1)
        elif isinstance(v, dict):
            for e in v.values():
                add(e, depth + 1)
        elif isinstance(v, types.MethodType):
            add(v.__self__, depth + 1)
            add(v.__func__, depth + 1)
        elif isinstance(v, types.FunctionType):
            for cell in v.__closure__ or ():
                try:
                    add(cell.cell_contents, depth + 1)
                except ValueError:  # an empty cell
                    pass
            g = v.__globals__
            for name in _code_names(v.__code__):
                if name in g and not isinstance(g[name], types.ModuleType):
                    add(g[name], depth + 1)

    for fn in fns:
        add(fn)
    return found


def _code_names(co):
    names = set(co.co_names)
    for c in co.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


def _unique(tensors, avoid=()):
    """(the distinct tensors of `tensors` as a tuple, the index of each
    entry in it): an operator's operands must be distinct tensors. A
    tensor also in `avoid` (a loop carry) is passed as a copy."""
    uniq, where = [], []
    for t in tensors:
        j = next((k for k, u in enumerate(uniq) if u is t), None)
        if j is None:
            if any(t is a for a in avoid):
                t = t.clone()
            uniq.append(t)
            j = len(uniq) - 1
        where.append(j)
    return tuple(uniq), where


class _swapped_in:
    """Point the lifted Tensors at the operator's operands while a branch
    or loop body traces, and back after."""

    def __init__(self, lifted, datas):
        self.lifted, self.datas = lifted, datas

    def __enter__(self):
        self.saved = [t._data for t in self.lifted]
        for t, d in zip(self.lifted, self.datas):
            t._data = d

    def __exit__(self, *exc):
        for t, d in zip(self.lifted, self.saved):
            t._data = d
        return False


def convert_ifelse(pred, true_fn, false_fn, init=(), region=None):
    """`if pred: <assigns>` -> the tuple of branch-assigned variables.
    `init` carries the variables' pre-branch values in as branch-function
    parameters (a name assigned inside a branch is local to the generated
    function, so it cannot also be read through the closure).
    Traced predicate: `torch.cond` (both branches traced, one run).
    Concrete predicate: plain Python — only the taken branch runs,
    preserving eager semantics exactly."""
    if not _is_traced(pred):
        taken = true_fn if _truthy(pred) else false_fn
        return taken(*init)
    return _tag_region(region)(lambda: _convert_ifelse_traced(
        pred, true_fn, false_fn, init))


def _convert_ifelse_traced(pred, true_fn, false_fn, init):
    p = _pred_scalar(pred)
    init_leaves, init_spec = _pytree.tree_flatten(tuple(init))
    slots = [i for i, v in enumerate(init_leaves)
             if isinstance(_unwrap(v), torch.Tensor)]
    lifted = _free_tensors(true_fn, false_fn)
    operands, where = _unique([_unwrap(init_leaves[i]) for i in slots] +
                              [t._data for t in lifted])
    n_init = len(slots)
    specs = []

    def branch(fn, what):
        def run(*uniq):
            ops = [uniq[j] for j in where]
            leaves = list(init_leaves)
            for i, o in zip(slots, ops[:n_init]):
                leaves[i] = Tensor(o)
            with _swapped_in(lifted, ops[n_init:]):
                out, spec = _flat_tensors(
                    fn(*_pytree.tree_unflatten(leaves, init_spec)), what,
                    p.device)
            specs.append((spec, [(tuple(o.shape), o.dtype) for o in out]))
            return tuple(o.clone() for o in out)
        return run

    try:
        out = _cond_op(p, branch(true_fn, "the true branch"),
                       branch(false_fn, "the false branch"), operands)
    except Dy2StaticFallback:
        raise
    except Exception as e:
        if not _hop_mismatch(e):
            raise
        raise Dy2StaticFallback(
            f"to_static: if/else branches returned mismatched values: {e}"
        ) from None
    if len(specs) < 2 or specs[0] != specs[1]:
        # torch.cond would give a branch of another shape an unbacked
        # size; the JAX runtime's lax.cond refuses it, and so does this
        raise Dy2StaticFallback(
            "to_static: if/else branches returned mismatched values: "
            f"{specs[0][1] if specs else None} vs "
            f"{specs[1][1] if len(specs) > 1 else None}")
    return _to_tensor_tree(list(out), specs[0][0])


def convert_while(cond_fn, body_fn, init, region=None):
    """`while cond: <body>` over the body-assigned loop variables.
    Traced condition or state: `while_loop` with the variables as the
    carry (fixed to their traced shapes and dtypes). Concrete: Python
    loop."""
    first = cond_fn(*init)
    if not _is_traced(first) and not _any_traced(tuple(init)):
        state = tuple(init)
        c = first
        while _truthy(c):
            state = tuple(body_fn(*state))
            c = cond_fn(*state)
        return state

    return _tag_region(region)(
        lambda: _convert_while_traced(cond_fn, body_fn, init, first))


def _convert_while_traced(cond_fn, body_fn, init, first):
    dev = _device_of(first, init)
    carry, spec = _flat_tensors(tuple(init), "the loop state", dev)
    # a loop variable bound to another's tensor is a carry of its own
    carry = [c.clone() if any(c is d for d in carry[:i]) else c
             for i, c in enumerate(carry)]
    n = len(carry)
    lifted = _free_tensors(cond_fn, body_fn)
    extra, where = _unique([t._data for t in lifted], avoid=carry)

    def c_fn(*s):
        with _swapped_in(lifted, [s[n + j] for j in where]):
            return _pred_scalar(cond_fn(*_to_tensor_tree(list(s[:n]),
                                                         spec)))

    def b_fn(*s):
        with _swapped_in(lifted, [s[n + j] for j in where]):
            out, ospec = _flat_tensors(
                tuple(body_fn(*_to_tensor_tree(list(s[:n]), spec))),
                "the loop body", dev)
        # loop variables may be pytrees (tuples/dicts of tensors): compare
        # structure and each leaf's shape and dtype
        if ospec != spec:
            raise Dy2StaticFallback(
                "to_static: while-loop variables changed structure across "
                "an iteration; compiled loops need a stable carry")
        for i, (a, b) in enumerate(zip(s[:n], out)):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise Dy2StaticFallback(
                    "to_static: while-loop carry leaf "
                    f"#{i} changed {tuple(a.shape)}/{a.dtype} -> "
                    f"{tuple(b.shape)}/{b.dtype} across an iteration; "
                    "compiled loops need stable shapes/dtypes")
        return tuple(o.clone() for o in out)

    try:
        out = _while_loop_op(c_fn, b_fn, tuple(carry), extra)
    except Dy2StaticFallback:
        raise
    except Exception as e:
        if not _hop_mismatch(e):
            raise
        raise Dy2StaticFallback(
            f"to_static: while loop is not compilable: {e}") from None
    return tuple(_to_tensor_tree(list(out), spec))


def _device_of(*trees):
    for v in _pytree.tree_leaves(trees):
        u = _unwrap(v)
        if isinstance(u, torch.Tensor):
            return u.device
    return None


class _Undef:
    """Marker for a loop variable unbound before its loop (reference
    dy2static UndefinedVar). Any use raises, like reading an unbound name."""

    _INSTANCE = None

    def __repr__(self):
        return "<undefined local>"

    def __bool__(self):
        raise NameError("variable used before assignment in converted "
                        "control flow")


UNDEF = _Undef()
_Undef._INSTANCE = UNDEF


def lookup_or_undef(local_ns, name):
    return local_ns.get(name, UNDEF)


class RangeArgs:
    """Normalized range(...) bounds for converted for-loops (reference
    loop_transformer's for->while rewrite). The step must be concrete
    (its SIGN decides the loop condition); numpy integer scalars are
    accepted like range() accepts them (__index__)."""

    __slots__ = ("start", "stop", "step")

    def __init__(self, *args):
        if len(args) == 1:
            self.start, self.stop, self.step = 0, args[0], 1
        elif len(args) == 2:
            (self.start, self.stop), self.step = args, 1
        else:
            self.start, self.stop, self.step = args
        if _is_traced(self.step):
            raise Dy2StaticFallback(
                "to_static: range() step must be a Python number in "
                "converted for-loops (the direction decides the loop "
                "condition)")
        try:
            self.step = int(operator.index(self.step))
        except TypeError:
            raise Dy2StaticFallback(
                f"to_static: invalid range step {self.step!r}") from None
        if self.step == 0:
            raise Dy2StaticFallback("to_static: range() step must not be 0")


def range_continue(i, r):
    if r.step > 0:
        return _lt(i, r.stop)
    return _lt(r.stop, i)


def _lt(a, b):
    ua, ub = _unwrap(a), _unwrap(b)
    if isinstance(ua, torch.Tensor) or isinstance(ub, torch.Tensor):
        return Tensor(torch.as_tensor(ua) < torch.as_tensor(ub))
    return ua < ub


def range_next(i, r):
    u = _unwrap(i)
    if isinstance(u, torch.Tensor):
        return Tensor(u + r.step)
    return u + r.step


# Python-unroll budget for concrete-bound for-loops with traced state: small
# loops keep exact Python semantics (side effects, non-tensor state);
# bigger ones compile to ONE while_loop instead of a graph with thousands
# of body copies.
_UNROLL_LIMIT = 64


def convert_for_range(cond_fn, body_fn, init, r, region=None,
                      has_guard=False):
    """Converted `for target in range(...)`. init = (counter, target,
    *loop_vars); counter rides the carry, target is assigned from it at
    the top of each body (so after the loop it holds Python's LAST body
    value, and a zero-trip loop leaves it untouched/unbound).

    has_guard: the body came from break/continue desugaring — the loop
    condition carries a break-guard that must be re-checked between
    iterations, so the fixed-trip-count unroll path is invalid."""
    def loop_init():
        # the carry needs a concrete leaf for the target; the body assigns
        # it from the counter before any use (only the data-dependent
        # zero-trip "target stays unbound" nuance is unexpressible)
        st = list(init)
        if st[1] is UNDEF:
            st[1] = r.start
        return tuple(st)

    if has_guard:
        first = cond_fn(*init)
        if not _is_traced(first) and not _any_traced(tuple(init)):
            return convert_while(cond_fn, body_fn, init, region=region)
        return convert_while(cond_fn, body_fn, loop_init(), region=region)
    if _is_traced(r.stop) or _is_traced(r.start):
        return convert_while(cond_fn, body_fn, loop_init(), region=region)
    n = len(range(int(operator.index(_index(r.start))),
                  int(operator.index(_index(r.stop))), r.step))
    if n <= _UNROLL_LIMIT:
        state = tuple(init)
        for _ in range(n):
            state = tuple(body_fn(*state))
        return state
    return convert_while(cond_fn, body_fn, loop_init(), region=region)


def _index(v):
    u = _unwrap(v)
    return int(u) if isinstance(u, torch.Tensor) else u


def _truthy(x):
    return bool(_unwrap(x))


def _logical(op, x, y):
    a, b = torch.as_tensor(_unwrap(x)), torch.as_tensor(_unwrap(y))
    fn = {"and": torch.logical_and, "or": torch.logical_or}[op]
    return Tensor(fn(a.to(torch.bool), b.to(torch.bool)))


def convert_logical_and(x_fn, y_fn):
    x = x_fn()
    if _is_traced(x):
        return _logical("and", x, y_fn())
    if not _truthy(x):
        return x  # short-circuit, y never evaluated — exact Python
    return y_fn()


def convert_logical_or(x_fn, y_fn):
    x = x_fn()
    if _is_traced(x):
        return _logical("or", x, y_fn())
    if _truthy(x):
        return x
    return y_fn()


def convert_logical_not(x):
    if _is_traced(x):
        return Tensor(torch.logical_not(
            torch.as_tensor(_unwrap(x)).to(torch.bool)))
    return not x


def convert_call(fn):
    """Call-site conversion of callees (reference `convert_operators.py`
    convert_call + `convert_call_func.py`): user functions and sublayers
    reached from a converted function get converted too, so tensor-dependent
    control flow in a helper compiles instead of degrading the whole model —
    and a helper that CAN'T convert stays ordinary Python, losing only
    itself. Framework and library callables pass through untouched (the
    port's internals trace as they are; torch and numpy likewise)."""
    from paddle_tpu_torch.nn.layer.layers import Layer

    def library_mod(m):
        # exact top-level package match: a user module named e.g.
        # `torch_utils` must NOT be exempted by a bare prefix test
        return (m.split(".", 1)[0]
                in ("paddle_tpu_torch", "torch", "numpy", "functools"))

    if isinstance(fn, Layer):
        fwd = getattr(type(fn), "forward", None)
        if library_mod(getattr(fwd, "__module__", "") or ""):
            return fn  # builtin layer: its forward traces as it is
        return converted_layer_call(fn)
    if not isinstance(fn, (types.FunctionType, types.MethodType)):
        return fn  # builtins, classes, callables without source
    if library_mod(getattr(fn, "__module__", "") or ""):
        return fn
    return convert_function(fn)


# --------------------------------------------------------------------------
# AST transformer (reference ifelse_transformer.py / loop_transformer.py)
# --------------------------------------------------------------------------


class _NameCollector(ast.NodeVisitor):
    """Names assigned anywhere in a statement subtree, excluding nested
    function/class scopes (their locals don't leak)."""

    def __init__(self):
        self.names = []
        self._seen = set()

    def _add(self, name):
        if name.startswith("__pt_"):
            return  # synthetic conversion locals: never loop/branch state
        if name not in self._seen:
            self._seen.add(name)
            self.names.append(name)

    def _target(self, t):
        if isinstance(t, ast.Name):
            self._add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e)
        elif isinstance(t, ast.Starred):
            self._target(t.value)
        # Attribute/Subscript stores mutate objects, not local bindings

    def visit_Assign(self, node):
        for t in node.targets:
            self._target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._target(node.target)
        self.generic_visit(node)

    def visit_For(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_withitem(self, node):
        if node.optional_vars is not None:
            self._target(node.optional_vars)
        self.generic_visit(node)

    def visit_NamedExpr(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # def/class names are NOT collected as branch/loop state: function
        # objects can't ride compiled control flow, and the generated __pt_*
        # helpers of already-converted inner constructs must stay local
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _assigned_names(stmts):
    c = _NameCollector()
    for s in stmts:
        c.visit(s)
    return c.names


class _CtlFlowFinder(ast.NodeVisitor):
    """Detect Return/Raise at any depth, and Break/Continue belonging to
    THIS loop level (not to a nested loop), within a statement list."""

    def __init__(self):
        self.has_return = False
        self.has_break = False
        self.has_continue = False
        self.has_raise = False

    @property
    def has_break_continue(self):
        return self.has_break or self.has_continue

    def visit_Return(self, node):
        self.has_return = True

    def visit_Raise(self, node):
        # a converted branch is TRACED even when untaken — a data-dependent
        # guard (`if bad: raise`) must stay Python so it degrades to eager
        # instead of raising spuriously at trace time
        self.has_raise = True

    def visit_Break(self, node):
        self.has_break = True

    def visit_Continue(self, node):
        self.has_continue = True

    def visit_For(self, node):
        # break/continue inside a nested loop bind to it — only returns leak
        for s in node.body + node.orelse:
            _ReturnOnly.check(s, self)

    def visit_While(self, node):
        for s in node.body + node.orelse:
            _ReturnOnly.check(s, self)

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


class _ReturnOnly(ast.NodeVisitor):
    def __init__(self, sink):
        self.sink = sink

    @staticmethod
    def check(stmt, sink):
        _ReturnOnly(sink).visit(stmt)

    def visit_Return(self, node):
        self.sink.has_return = True

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _ctlflow(stmts):
    f = _CtlFlowFinder()
    for s in stmts:
        f.visit(s)
    return f


class _ReadCollector(ast.NodeVisitor):
    """All names READ in a subtree (Name loads + AugAssign targets, which
    read-modify-write). Conservative: nested function bodies count (they
    may close over the name)."""

    def __init__(self):
        self.reads = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.reads.add(node.id)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name):
            self.reads.add(node.target.id)
        self.generic_visit(node)


def _reads(stmts):
    c = _ReadCollector()
    for s in stmts if isinstance(stmts, list) else [stmts]:
        c.visit(s)
    return c.reads


def _name(id_, ctx):
    return ast.Name(id=id_, ctx=ctx)


def _fn_def(name, args, body):
    fd = ast.FunctionDef(name=name, args=args, body=body,
                         decorator_list=[], returns=None, type_comment=None)
    if hasattr(fd, "type_params"):  # 3.12+
        fd.type_params = []
    return fd


def _runtime_attr(fn_name):
    return ast.Attribute(value=_name(_RUNTIME_NAME, ast.Load()),
                         attr=fn_name, ctx=ast.Load())


def _names_tuple(names, ctx):
    return ast.Tuple(elts=[_name(n, ctx) for n in names], ctx=ctx)


def _ends_in_return(stmts):
    return bool(stmts) and isinstance(stmts[-1], ast.Return)


def _assign_const(name, val):
    return ast.Assign(targets=[_name(name, ast.Store())],
                      value=ast.Constant(value=val))


def _tail_return_body(stmts):
    """Branch statements ending in Return, with a bare `return` normalized
    to `return None` (torch.cond branches must produce a value)."""
    ret = stmts[-1]
    val = ret.value if ret.value is not None else ast.Constant(value=None)
    return stmts[:-1] + [ast.Return(value=val)]


# builtins called so often that wrapping them in convert_call (a no-op for
# non-user callables) would only add trace-time overhead
_DIRECT_CALLS = frozenset({
    "locals", "globals", "super", "range", "len", "print", "isinstance",
    "issubclass", "enumerate", "zip", "int", "float", "bool", "str", "list",
    "tuple", "dict", "set", "frozenset", "min", "max", "abs", "sum",
    "getattr", "setattr", "hasattr", "type", "id", "repr", "sorted",
    "reversed", "map", "filter", "any", "all", "divmod", "round", "iter",
    "next", "vars", "format", "slice",
})


class ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites if/while/bool-ops into converted-op runtime calls.

    skip_uids: region ids to leave as ordinary Python (per-region fallback:
    StaticFunction re-converts with the trace-time-failing region skipped).
    Region ids are allocated at the ENTRY of every if/while/for visit, so
    they are stable across re-conversions with different skip sets.
    """

    def __init__(self, skip_uids=frozenset(), qualname="<fn>", report=None):
        self._n = 0
        self._range_shadowed = False
        self._skip = frozenset(skip_uids)
        self._qual = qualname
        self.report = report if report is not None else []
        # live-after stack: the set of names possibly READ after the
        # statement currently being converted (branch/loop carries are
        # restricted to live names — a dead assigned name must not force
        # both torch.cond branches to produce it)
        self._live = [set()]
        # per-statement function-tail flags (a fold may append an implicit
        # `return None` ONLY where falling off the block ends the function)
        self._stmt_tail = []
        # desugar-synthesized guard numbering (see _desugar_loop_body)
        self._synth_loop = None
        self._synth_seq = 0

    def _uid(self):
        self._n += 1
        return self._n

    def _live_after(self):
        return self._live[-1]

    def _note(self, kind, line, uid, status, reason=None):
        self.report.append({"kind": kind, "line": line, "region": uid,
                            "status": status, "reason": reason})

    def _region_kw(self, uid):
        return ast.keyword(arg="region", value=ast.Tuple(
            elts=[ast.Constant(value=self._qual), ast.Constant(value=uid)],
            ctx=ast.Load()))

    # -- statement-list processing with return folding -----------------------
    def _process_block(self, stmts, tail=False):
        outer_live = set(self._live[-1])
        # tails[i] = names read by statements AFTER i (plus the block's own
        # live-after set)
        tails = [None] * len(stmts)
        live_tail = set(outer_live)
        for i in range(len(stmts) - 1, -1, -1):
            tails[i] = set(live_tail)
            live_tail |= _reads(stmts[i])
        out = []
        i = 0
        while i < len(stmts):
            s = stmts[i]
            rest = stmts[i + 1:]
            if isinstance(s, ast.If):
                b_ret = _ends_in_return(s.body)
                o_ret = bool(s.orelse) and _ends_in_return(s.orelse)
                folded = None
                if b_ret != o_ret:
                    # one branch always returns: the statements after the If
                    # run exactly when the other branch was taken — fold them
                    # into it so the two-sided tail-return rewrite can fire.
                    # With nothing following, falling past the If ends the
                    # function ONLY in tail position (`return None`).
                    if rest:
                        if b_ret:
                            folded = ast.If(test=s.test, body=s.body,
                                            orelse=(s.orelse or [])
                                            + list(rest))
                        else:
                            folded = ast.If(test=s.test,
                                            body=s.body + list(rest),
                                            orelse=s.orelse)
                    elif tail:
                        implicit = [ast.Return(value=ast.Constant(value=None))]
                        if b_ret:
                            folded = ast.If(test=s.test, body=s.body,
                                            orelse=(s.orelse or [])
                                            + implicit)
                        else:
                            folded = ast.If(test=s.test,
                                            body=s.body + implicit,
                                            orelse=s.orelse)
                if folded is not None:
                    ast.copy_location(folded, s)
                    self._live.append(outer_live)
                    self._stmt_tail.append(tail)
                    out.extend(self._process_stmt(folded))
                    self._stmt_tail.pop()
                    self._live.pop()
                    return out
            self._live.append(tails[i])
            self._stmt_tail.append(tail and i == len(stmts) - 1)
            out.extend(self._process_stmt(s))
            self._stmt_tail.pop()
            self._live.pop()
            i += 1
        return out

    def _process_stmt(self, s):
        r = self.visit(s)
        if r is None:
            return []
        return r if isinstance(r, list) else [r]

    def visit_FunctionDef(self, node):
        node.args = self.visit(node.args)
        prev = self._range_shadowed
        params = {a.arg for a in node.args.args}
        self._range_shadowed = ("range" in _assigned_names(node.body)
                                or "range" in params)
        node.body = self._process_block(node.body, tail=True)
        self._range_shadowed = prev
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- call-site conversion ------------------------------------------------
    def visit_Call(self, node):
        """user_call(args) -> __pt_jst__.convert_call(user_call)(args):
        callees get converted too (tensor control flow in helpers compiles;
        unconvertible helpers lose only themselves). Runtime attrs and
        common builtins stay direct."""
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name) and f.id in _DIRECT_CALLS:
            return node
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == _RUNTIME_NAME):
            return node
        node.func = ast.Call(func=_runtime_attr("convert_call"),
                             args=[f], keywords=[])
        return node

    # -- if ------------------------------------------------------------------
    def visit_If(self, node):
        # synthesized guards carry their own loop-derived region id; only
        # source constructs consume the main counter (id stability across
        # re-conversions with different skip sets)
        uid = getattr(node, "_pt_region", None)
        if uid is None:
            uid = self._uid()
        line = getattr(node, "lineno", 0)
        # raw reads BEFORE conversion: the generated inner carries read
        # their UNDEF-guarded names structurally, which must not count as
        # pre-branch uses
        raw_reads = _reads(node.body) | _reads(node.orelse)
        node.test = self.visit(node.test)
        stmt_tail = self._stmt_tail[-1] if self._stmt_tail else False
        node.body = self._process_block(node.body, tail=stmt_tail)
        node.orelse = self._process_block(node.orelse, tail=stmt_tail)

        body_f = _ctlflow(node.body)
        else_f = _ctlflow(node.orelse)
        if uid in self._skip:
            self._note("if", line, uid, "python", "fell back at trace time")
            return node

        # two-sided tail-return: both branches END in a return — each branch
        # becomes a function returning its value (subsumes the single-return
        # `if c: return A else: return B` case; the _process_block folds
        # normalize one-sided returns into this shape)
        if (node.orelse and _ends_in_return(node.body)
                and _ends_in_return(node.orelse)
                and not _ctlflow(node.body[:-1]).has_return
                and not _ctlflow(node.orelse[:-1]).has_return
                and not body_f.has_raise and not else_f.has_raise
                and not body_f.has_break_continue
                and not else_f.has_break_continue):
            names = [n for n in _assigned_names(node.body[:-1]
                                                + node.orelse[:-1])
                     if n in raw_reads]
            tname, fname = f"__pt_true_{uid}", f"__pt_false_{uid}"
            args = _params(names)
            tdef = _fn_def(tname, args, _tail_return_body(node.body))
            fdef = _fn_def(fname, _copy_args(args),
                           _tail_return_body(node.orelse))
            call = ast.Call(
                func=_runtime_attr("convert_ifelse"),
                args=[node.test, _name(tname, ast.Load()),
                      _name(fname, ast.Load()),
                      _names_tuple(names, ast.Load())],
                keywords=[self._region_kw(uid)])
            self._note("if", line, uid, "converted")
            return ([tdef, fdef] + _undef_guards(names)
                    + [ast.Return(value=call)])

        if body_f.has_return or else_f.has_return:
            # mid-branch returns the folds couldn't normalize
            self._note("if", line, uid, "python", "mid-branch return")
            return node
        if body_f.has_raise or else_f.has_raise:
            # raising guards: leave as Python (eager fallback)
            self._note("if", line, uid, "python", "raise in branch")
            return node
        if body_f.has_break_continue or else_f.has_break_continue:
            return node  # break/continue: handled by the enclosing loop

        # carry = assigned ∩ (read AFTER the if ∪ read INSIDE a branch) —
        # branch-internal reads need the pre-branch value as a parameter
        need = self._live_after() | raw_reads
        names = [n for n in _assigned_names(node.body + node.orelse)
                 if n in need]
        tname, fname = f"__pt_true_{uid}", f"__pt_false_{uid}"
        # branch-assigned names come IN as parameters: a name assigned in a
        # branch is local to the generated function, so its pre-branch value
        # cannot be read through the closure
        args = _params(names)
        ret = ast.Return(value=_names_tuple(names, ast.Load()))
        tdef = _fn_def(tname, args,
                       (node.body or [ast.Pass()]) + [ret])
        fdef = _fn_def(fname, _copy_args(args),
                       (node.orelse or [ast.Pass()]) + [_copy_ret(ret)])
        call = ast.Call(
            func=_runtime_attr("convert_ifelse"),
            args=[node.test, _name(tname, ast.Load()),
                  _name(fname, ast.Load()),
                  _names_tuple(names, ast.Load())],
            keywords=[self._region_kw(uid)])
        if names:
            assign = ast.Assign(targets=[_names_tuple(names, ast.Store())],
                                value=call)
        else:
            assign = ast.Expr(value=call)
        self._note("if", line, uid, "converted")
        return [tdef, fdef] + _undef_guards(names) + [assign]

    # -- break/continue desugaring -------------------------------------------
    def _desugar_loop_body(self, stmts, brk, cont):
        """Rewrite break/continue at THIS loop level into guard-variable
        assignments, wrapping the statements after a guard-setting `if` in
        `if not (brk or cont):` (reference
        `transformers/break_continue_transformer.py:87` bool guard vars).
        Returns the new statement list, or None when a break/continue sits
        under an unsupported container (try/with) at this level."""
        out = []
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Break):
                out.append(_assign_const(brk, True))
                return out  # statements after a bare break are unreachable
            if isinstance(s, ast.Continue):
                out.append(_assign_const(cont, True))
                return out
            f = _ctlflow([s])
            if f.has_break_continue:
                if not isinstance(s, ast.If):
                    return None  # break under try/with at this level
                body = self._desugar_loop_body(s.body, brk, cont)
                orelse = self._desugar_loop_body(s.orelse, brk, cont)
                if body is None or orelse is None:
                    return None
                out.append(ast.copy_location(
                    ast.If(test=s.test, body=body or [ast.Pass()],
                           orelse=orelse), s))
                rest = self._desugar_loop_body(stmts[i + 1:], brk, cont)
                if rest is None:
                    return None
                if rest:
                    guard = ast.If(test=self._guard_expr(brk, cont),
                                   body=rest, orelse=[])
                    # synthesized guards get a region id DERIVED from the
                    # owning loop, off the main uid counter: whether a loop
                    # desugars depends on the skip set, so letting guards
                    # consume main-counter uids would shift every later
                    # region's id across re-conversions
                    self._synth_seq += 1
                    guard._pt_region = ("s", self._synth_loop,
                                        self._synth_seq)
                    out.append(guard)
                return out
            out.append(s)
        return out

    def _guard_expr(self, brk, cont):
        names = [n for n in (brk, cont) if n is not None]
        e = _name(names[0], ast.Load())
        if len(names) == 2:
            e = ast.BoolOp(op=ast.Or(),
                           values=[e, _name(names[1], ast.Load())])
        return ast.UnaryOp(op=ast.Not(), operand=e)

    # -- while ---------------------------------------------------------------
    def visit_While(self, node):
        uid = self._uid()
        line = getattr(node, "lineno", 0)
        inits = []
        f0 = _ctlflow(node.body)
        if (f0.has_break_continue and not f0.has_return and not f0.has_raise
                and not node.orelse and uid not in self._skip):
            brk = f"_jst_brk{uid}" if f0.has_break else None
            cont = f"_jst_cont{uid}" if f0.has_continue else None
            self._synth_loop, self._synth_seq = uid, 0
            new_body = self._desugar_loop_body(node.body, brk, cont)
            if new_body is not None:
                # guards are ordinary loop state: initialized before the
                # loop, cont reset each iteration, brk folded into the test
                inits = [_assign_const(g, False) for g in (brk, cont) if g]
                if cont:
                    new_body = [_assign_const(cont, False)] + new_body
                test = node.test
                if brk:
                    test = ast.BoolOp(op=ast.And(), values=[
                        ast.UnaryOp(op=ast.Not(),
                                    operand=_name(brk, ast.Load())),
                        test])
                node = ast.copy_location(
                    ast.While(test=test, body=new_body, orelse=[]), node)
        out = self._finish_while(node, uid, line)
        if inits:
            return inits + (out if isinstance(out, list) else [out])
        return out

    def _finish_while(self, node, uid, line):
        node.test = self.visit(node.test)
        # the loop BACK EDGE makes every body/test read live after every
        # body statement (next iteration reads it)
        back_edge = _reads(node.body) | _reads(node.test) | self._live_after()
        self._live.append(back_edge)
        node.body = self._process_block(node.body)
        self._live.pop()
        node.orelse = self._process_block(node.orelse)

        f = _ctlflow(node.body)
        if uid in self._skip:
            self._note("while", line, uid, "python",
                       "fell back at trace time")
            return node
        if f.has_return or f.has_break_continue or f.has_raise or node.orelse:
            reason = ("return in loop body" if f.has_return
                      else "break/continue under try/with"
                      if f.has_break_continue
                      else "raise in loop body" if f.has_raise
                      else "while-else")
            self._note("while", line, uid, "python", reason)
            return node
        need = back_edge  # raw body/test reads captured pre-conversion
        names = [n for n in _assigned_names(node.body) if n in need]
        if not names:
            return node  # side-effect-only loop: nothing to carry

        cname, bname = f"__pt_cond_{uid}", f"__pt_body_{uid}"
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[])
        cdef = _fn_def(cname, args, [ast.Return(value=node.test)])
        bdef = _fn_def(bname, _copy_args(args),
                       node.body + [ast.Return(value=_names_tuple(
                           names, ast.Load()))])
        guards = _undef_guards(names)
        call = ast.Call(
            func=_runtime_attr("convert_while"),
            args=[_name(cname, ast.Load()), _name(bname, ast.Load()),
                  _names_tuple(names, ast.Load())],
            keywords=[self._region_kw(uid)])
        assign = ast.Assign(targets=[_names_tuple(names, ast.Store())],
                            value=call)
        self._note("while", line, uid, "converted")
        return [cdef, bdef] + guards + [assign]

    # -- for-range -----------------------------------------------------------
    def visit_For(self, node):
        """`for i in range(...)` -> the while conversion (reference
        loop_transformer for->while): tensor bounds become a
        while_loop; concrete bounds keep Python unrolling via
        convert_while's Python path. break/continue bodies are desugared
        into guard variables first (the guard rides the loop carry and the
        loop condition). Non-range iterables, tuple targets, and
        return/raise bodies stay untouched."""
        uid = self._uid()
        line = getattr(node, "lineno", 0)
        # shape check on the RAW iter (visit_Call would wrap the range call)
        is_range = (not self._range_shadowed
                    and isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and 1 <= len(node.iter.args) <= 3
                    and isinstance(node.target, ast.Name)
                    and not node.orelse)
        if is_range:
            node.iter.args = [self.visit(a) for a in node.iter.args]
        else:
            node.iter = self.visit(node.iter)
        f0 = _ctlflow(node.body)
        brk = cont = None
        has_guard = False
        if (is_range and f0.has_break_continue and not f0.has_return
                and not f0.has_raise and uid not in self._skip):
            # desugar ONLY when the loop will definitely convert: a
            # desugared body without the condition guard would keep
            # iterating past a break
            brk = f"_jst_brk{uid}" if f0.has_break else None
            cont = f"_jst_cont{uid}" if f0.has_continue else None
            self._synth_loop, self._synth_seq = uid, 0
            new_body = self._desugar_loop_body(node.body, brk, cont)
            if new_body is not None:
                if cont:
                    new_body = [_assign_const(cont, False)] + new_body
                node = ast.copy_location(
                    ast.For(target=node.target, iter=node.iter,
                            body=new_body, orelse=[]), node)
                # only BREAK alters the trip count; continue-only loops may
                # still unroll in Python (keeps the index concrete)
                has_guard = brk is not None
            else:
                brk = cont = None
        back_edge = (_reads(node.body) | {node.target.id}
                     if isinstance(node.target, ast.Name)
                     else _reads(node.body)) | self._live_after()
        # the break guard is read by the SYNTHESIZED loop condition, which
        # liveness over the body text cannot see — force it live so the
        # desugared `brk = True` branch carries it out
        back_edge |= {n for n in (brk, cont) if n}
        self._live.append(back_edge)
        node.body = self._process_block(node.body)
        self._live.pop()
        node.orelse = self._process_block(node.orelse)
        if uid in self._skip:
            self._note("for", line, uid, "python", "fell back at trace time")
            return node
        if not is_range:
            if self._range_shadowed or not isinstance(node.iter, ast.Call):
                return node  # plain iteration: no conversion intended
            self._note("for", line, uid, "python",
                       "non-range iterable, tuple target, or for-else")
            return node
        f = _ctlflow(node.body)
        if f.has_return or f.has_break_continue or f.has_raise:
            reason = ("return in loop body" if f.has_return
                      else "break/continue under try/with"
                      if f.has_break_continue
                      else "raise in loop body")
            self._note("for", line, uid, "python", reason)
            return node

        tgt = node.target.id
        rname = f"__pt_range_{uid}"
        cname = f"__pt_i_{uid}"  # internal counter: the user target is
        # assigned FROM it at the top of each body, so after the loop it
        # holds Python's last body value and a zero-trip loop leaves it
        # unbound (exact for-semantics)
        need = back_edge  # raw body reads captured pre-conversion
        forced = [n for n in (brk, cont) if n]  # guards always ride the
        # carry: brk feeds the condition even when nothing reads it in-body
        names = [cname, tgt] + [n for n in _assigned_names(node.body)
                                if n != tgt and (n in need or n in forced)]
        for n in forced:
            if n not in names:
                names.append(n)
        args = _params(names)
        r_assign = ast.Assign(
            targets=[_name(rname, ast.Store())],
            value=ast.Call(func=_runtime_attr("RangeArgs"),
                           args=list(node.iter.args), keywords=[]))
        i_init = ast.Assign(
            targets=[_name(cname, ast.Store())],
            value=ast.Attribute(value=_name(rname, ast.Load()),
                                attr="start", ctx=ast.Load()))
        guard_inits = [_assign_const(g, False) for g in forced]
        cond_expr = ast.Call(
            func=_runtime_attr("range_continue"),
            args=[_name(cname, ast.Load()), _name(rname, ast.Load())],
            keywords=[])
        if brk:
            # `not brk and in_range` — visit converts it to the thunked
            # logical ops so a traced guard composes into the compiled condition
            cond_expr = self.visit(ast.BoolOp(op=ast.And(), values=[
                ast.UnaryOp(op=ast.Not(), operand=_name(brk, ast.Load())),
                cond_expr]))
        cdef = _fn_def(f"__pt_fcond_{uid}", args,
                       [ast.Return(value=cond_expr)])
        set_tgt = ast.Assign(targets=[_name(tgt, ast.Store())],
                             value=_name(cname, ast.Load()))
        bump = ast.Assign(
            targets=[_name(cname, ast.Store())],
            value=ast.Call(func=_runtime_attr("range_next"),
                           args=[_name(cname, ast.Load()),
                                 _name(rname, ast.Load())],
                           keywords=[]))
        bdef = _fn_def(
            f"__pt_fbody_{uid}", _copy_args(args),
            [set_tgt] + node.body
            + [bump, ast.Return(value=_names_tuple(names, ast.Load()))])
        call = ast.Call(
            func=_runtime_attr("convert_for_range"),
            args=[_name(f"__pt_fcond_{uid}", ast.Load()),
                  _name(f"__pt_fbody_{uid}", ast.Load()),
                  _names_tuple(names, ast.Load()),
                  _name(rname, ast.Load())],
            keywords=[self._region_kw(uid)]
            + ([ast.keyword(arg="has_guard",
                            value=ast.Constant(value=True))]
               if has_guard else []))
        assign = ast.Assign(targets=[_names_tuple(names, ast.Store())],
                            value=call)
        self._note("for", line, uid, "converted")
        return ([r_assign, i_init, cdef, bdef] + guard_inits
                + _undef_guards(names[1:]) + [assign])

    # -- bool ops ------------------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        # fold left-assoc: a and b and c -> and(and(a, b), c), each operand
        # thunked to keep short-circuit evaluation for concrete values
        expr = node.values[0]
        for v in node.values[1:]:
            expr = ast.Call(
                func=_runtime_attr(fn),
                args=[ast.Lambda(args=_empty_args(), body=expr),
                      ast.Lambda(args=_empty_args(), body=v)],
                keywords=[])
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_runtime_attr("convert_logical_not"),
                            args=[node.operand], keywords=[])
        return node


def _empty_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _params(names):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names], vararg=None,
        kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])


def _undef_guards(names):
    """`name = lookup_or_undef(locals(), 'name')` per name: a variable
    assigned only inside the construct may be unbound before it; bind it to
    the UNDEF marker so building the initial-state tuple doesn't
    UnboundLocalError (Python semantics preserved — reading UNDEF fails
    just like reading an unbound name)."""
    return [
        ast.Assign(
            targets=[_name(n, ast.Store())],
            value=ast.Call(
                func=_runtime_attr("lookup_or_undef"),
                args=[ast.Call(func=_name("locals", ast.Load()),
                               args=[], keywords=[]),
                      ast.Constant(value=n)],
                keywords=[]))
        for n in names
    ]


def _copy_args(a):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=x.arg) for x in a.args],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])


def _copy_ret(r):
    return ast.Return(value=ast.copy_location(
        _names_tuple([e.id for e in r.value.elts], ast.Load()), r.value))


# --------------------------------------------------------------------------
# function conversion
# --------------------------------------------------------------------------

# the port's own cache attribute: a function converted by both packages
# (the parity tests do that) keeps one converted copy for each
_CACHE_ATTR = "__pt_torch_dy2static_converted__"

# the active per-region fallback blacklist — set by StaticFunction around
# build/trace so convert_call-converted CALLEES observe the same skip set
# (regions are namespaced by module.qualname, so sets compose safely)
import contextvars as _contextvars

_ACTIVE_SKIP = _contextvars.ContextVar("dy2static_skip_regions",
                                       default=frozenset())


def _fn_region_ns(raw):
    return f"{getattr(raw, '__module__', '?')}.{raw.__qualname__}"


def convert_function(fn, skip_regions=None):
    """Best-effort AST conversion of `fn`. Returns the converted function,
    or `fn` unchanged when source is unavailable or conversion fails.
    The converted function is a drop-in replacement in eager execution
    (concrete predicates take the Python path of the converted ops).

    skip_regions: set of (namespace, uid) regions to leave as ordinary
    Python (per-region fallback). Defaults to the active blacklist of the
    enclosing StaticFunction (contextvar), so callees converted at call
    sites honor it too."""
    if skip_regions is None:
        skip_regions = _ACTIVE_SKIP.get()
    raw = fn.__func__ if isinstance(fn, types.MethodType) else fn
    try:
        ns_key = _fn_region_ns(raw)
    except AttributeError:
        return fn
    rel = frozenset(uid for qn, uid in skip_regions if qn == ns_key)
    cache = getattr(raw, _CACHE_ATTR, None)
    if cache is not None and rel in cache:
        # the cache lives on the underlying function (shared across
        # instances for methods) — rebind to THIS instance on a hit
        cached = cache[rel]
        if isinstance(fn, types.MethodType):
            return types.MethodType(cached, fn.__self__)
        return cached
    if hasattr(raw, "__wrapped__"):
        # functools.wraps-style wrapper: getsource would unwrap to the
        # ORIGINAL def and conversion would silently drop the wrapper's
        # behavior — leave it alone (the wrapped inner fn still traces,
        # and genuinely dynamic control flow degrades to eager)
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(raw))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return fn
        if fdef.name != raw.__name__:
            return fn  # source doesn't correspond to this function
        fdef.decorator_list = []  # don't re-apply @to_static and friends
        tr = ControlFlowTransformer(skip_uids=rel, qualname=ns_key)
        new_tree = tr.visit(tree)
        ast.fix_missing_locations(new_tree)
        ns = dict(raw.__globals__)
        from paddle_tpu_torch.jit import dy2static as _rt

        ns[_RUNTIME_NAME] = _rt
        filename = f"<dy2static {raw.__code__.co_filename}>"
        free = raw.__code__.co_freevars
        if free:
            # Re-bind the ORIGINAL closure cells so later nonlocal updates
            # stay visible: compile the converted def nested in a factory
            # (making the free names real freevars of the new code object),
            # then rebuild the function over raw.__closure__.
            factory = _fn_def("__pt_factory__", _params(list(free)),
                              [new_tree.body[0],
                               ast.Return(value=_name(fdef.name,
                                                      ast.Load()))])
            mod = ast.Module(body=[factory], type_ignores=[])
            ast.fix_missing_locations(mod)
            exec(compile(mod, filename, "exec"), ns)
            probe = ns["__pt_factory__"](*([None] * len(free)))
            if probe.__code__.co_freevars != free:
                return fn  # conversion changed the free-variable set
            new_fn = types.FunctionType(
                probe.__code__, ns, raw.__name__, raw.__defaults__,
                raw.__closure__)
            new_fn.__kwdefaults__ = raw.__kwdefaults__
        else:
            exec(compile(new_tree, filename, "exec"), ns)
            new_fn = ns[fdef.name]
        functools.update_wrapper(new_fn, raw,
                                 assigned=("__name__", "__doc__",
                                           "__qualname__"), updated=())
        del new_fn.__wrapped__  # set by update_wrapper; see bail-out above
        new_fn.__pt_dy2static_report__ = {"namespace": ns_key,
                                          "regions": tr.report}
        from paddle_tpu_torch import jit as _jit_mod

        if getattr(_jit_mod, "_code_level", 0) > 0:
            # paddle.jit.set_code_level: dump the converted source. A
            # dump failure must not discard the successful conversion.
            try:
                print(f"[dy2static] converted {ns_key}:\n"
                      + ast.unparse(new_tree))
            except Exception as dump_err:  # pragma: no cover
                print(f"[dy2static] converted {ns_key} "
                      f"(source dump failed: {dump_err})")
    except (OSError, TypeError, SyntaxError, ValueError, IndentationError,
            AttributeError, KeyError):
        return fn
    try:
        if cache is None:
            cache = {}
            setattr(raw, _CACHE_ATTR, cache)
        cache[rel] = new_fn
    except (AttributeError, TypeError):
        pass
    if isinstance(fn, types.MethodType):
        return types.MethodType(new_fn, fn.__self__)
    return new_fn


def converted_layer_call(layer):
    """A callable equivalent to `layer.__call__` but running the dy2static-
    converted `forward` (pre/post forward hooks preserved via the shared
    Layer._call_with_forward dispatch)."""
    conv_fwd = convert_function(layer.forward)

    def call(*inputs, **kwargs):
        return layer._call_with_forward(conv_fwd, *inputs, **kwargs)

    return call
