"""SOT — the second (symbolic-capture) compilation path for dygraph code
(`paddle_tpu/jit/sot.py`; reference `python/paddle/jit/sot/translate.py:37`).

The reference simulates bytecode in a frame evaluator. Here, as in the JAX
package, every eager op already goes through one Python dispatch waist
(`core.tensor.apply`), so capture hooks the waist instead:

  capture:   the wrapped function runs EAGERLY (full CPython semantics).
             Every waist op is recorded into a tape (`_op_capture`);
             `bool()/int()/float()/item()` on a traced tensor records a
             GUARD (`_concrete_hook`); an in-place change of a traced
             tensor, `.numpy()` on one, a read of one outside the waist (an
             op that closes over a tensor instead of passing it to
             `apply`), or a draw of the framework RNG outside an op marks
             the call uncapturable: it stays eager and is reported
             (`_mutation_hook`).
  replay:    the tape is split at guards into segments. A segment replays
             as one function over torch tensors, re-entered through
             `apply`, so torch's autograd differentiates it; on a CUDA
             device the function is compiled with `torch.compile` (dynamo
             over plain torch code, inductor), on the CPU it runs as it
             is. Guards are re-read between segments on every call.
  guards:    plans are cached per (input structure, tensor shapes and
             dtypes, scalar arguments) and per guard-outcome vector. A
             guard flip re-runs eagerly once, captures the new path, and
             both plans stay cached. Layer parameters and closure tensors
             are "externals": the tape holds the Tensor OBJECT and re-reads
             its data at every replay, so optimizer updates flow into
             compiled steps.

Semantics (the reference SOT's trade):
  - Python side effects happen at capture only; a replay re-runs the
    tensor compute.
  - int()/float()/item() values are guarded by equality.
  - An op that draws the framework RNG inside its function (dropout)
    redraws at every replay, so masks are fresh each call; a draw outside
    an op (a tensor made random in Python and closed over) breaks capture.
  - Every tensor an op reads is an input of the op (the port's ops pass
    ids, labels and index tensors to `apply`), so no replay reads a stale
    tensor; an op that still reads one outside the waist (`ops._common.raw`)
    is a break.
"""

from __future__ import annotations

import functools
import sys
from collections import OrderedDict

import numpy as np
import torch
import torch.utils._pytree as _pytree

from paddle_tpu_torch.core import tensor as _tc
from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng

__all__ = ["symbolic_translate", "SotFunction", "sot_report",
           "scan_function"]

_MAX_PLANS_PER_KEY = 8
_MAX_KEYS = 64


def _is_leaf(x):
    return isinstance(x, Tensor)


# --------------------------------------------------------------------------
# tape structures
# --------------------------------------------------------------------------


class _Op:
    __slots__ = ("fn", "refs", "dtypes", "base", "nout", "name", "grad_on")

    def __init__(self, fn, refs, dtypes, base, nout, name, grad_on):
        self.fn = fn            # the waist closure, replayed verbatim
        self.refs = refs        # input refs: ('a',i) arg | ('x',i) ext | ('n',i) node
        self.dtypes = dtypes    # per-input dtype the waist dispatched with (AMP)
        self.base = base        # first output node id
        self.nout = nout
        self.name = name
        self.grad_on = grad_on  # False: ran under no_grad, and replays so


class _Guard:
    __slots__ = ("ref", "kind", "value")

    def __init__(self, ref, kind, value):
        self.ref = ref          # ref whose concrete value was read
        self.kind = kind        # 'bool' | 'int' | 'float' | 'item'
        self.value = value      # value observed at capture


class _Capture:
    def __init__(self):
        self.entries = []       # _Op | _Guard, in program order
        self.refmap = {}        # id(torch.Tensor) -> ref
        self.pins = []          # keep tensors alive so ids stay unique
        self.externals = []     # holder Tensor objects discovered mid-trace
        self.n_nodes = 0
        self.broken = None      # fallback reason, or None

    # -- hooks installed on the waist --------------------------------------
    def on_op(self, fn, tensors, cast, outs, name, grad_on):
        if self.broken:
            return
        refs, dtypes = [], []
        for t, c in zip(tensors, cast):
            refs.append(self._ref_for(t))
            dtypes.append(c.dtype if c.dtype != t._data.dtype else None)
        self.entries.append(
            _Op(fn, refs, dtypes, self.n_nodes, len(outs), name, grad_on))
        for j, o in enumerate(outs):
            self.refmap[id(o)] = ("n", self.n_nodes + j)
            self.pins.append(o)
        self.n_nodes += len(outs)

    def on_concrete(self, t, kind, value):
        if self.broken:
            return
        ref = self.refmap.get(id(t._data))
        if ref is None:
            # a branch/scalar read on a tensor the tape has never seen: no
            # guard can track where its value came from -> not capturable
            self.broken = (f"{kind}() on a tensor unseen by the tape "
                           "(produced outside the dispatch waist)")
            return
        self.entries.append(_Guard(ref, kind, value))

    def on_mutation(self, t, why):
        if self.broken:
            return
        if id(t._data) in self.refmap:
            # changing (or reading outside the waist) a tensor the tape has
            # seen would desync a replay from eager semantics
            self.broken = f"non-waist access to a traced tensor ({why})"

    def on_rng(self):
        if not self.broken:
            self.broken = ("framework RNG drawn outside the dispatch waist "
                           "inside the traced region")

    # -- ref resolution ----------------------------------------------------
    def _ref_for(self, t):
        ref = self.refmap.get(id(t._data))
        if ref is None:
            # first sight of a tensor the tape did not produce: an implicit
            # external input (a Layer parameter, a closure tensor, a
            # constant built inside the function). The holder Tensor is
            # kept and its data re-read at every replay.
            ref = ("x", len(self.externals))
            self.externals.append(t)
            self.refmap[id(t._data)] = ref
            self.pins.append(t._data)
        return ref


# --------------------------------------------------------------------------
# compiled plan
# --------------------------------------------------------------------------


class _Segment:
    __slots__ = ("ops", "in_refs", "out_nodes", "guards", "_fn")

    def __init__(self, ops, in_refs, out_nodes, guards):
        self.ops = ops
        self.in_refs = in_refs      # ordered refs this segment consumes
        self.out_nodes = out_nodes  # node ids this segment must emit
        self.guards = guards        # guards evaluated right after it runs
        self._fn = None

    def fn(self, on_cuda):
        """The segment as one function over torch tensors: compiled with
        `torch.compile` on a CUDA device, the plain replay on the CPU."""
        if self._fn is None:
            ops, in_refs, out_nodes = self.ops, self.in_refs, self.out_nodes

            def replay(*arrs):
                env = dict(zip(in_refs, arrs))
                for op in ops:
                    ins = [env[r] if dt is None else env[r].to(dt)
                           for r, dt in zip(op.refs, op.dtypes)]
                    if op.grad_on:
                        out = op.fn(*ins)
                    else:
                        # the op ran under no_grad at capture: it adds no
                        # path to the segment's backward
                        with torch.no_grad():
                            out = op.fn(*ins)
                    outs = list(out) if isinstance(out, (tuple, list)) \
                        else [out]
                    for j, o in enumerate(outs):
                        env[("n", op.base + j)] = o
                return tuple(env[("n", n)] for n in out_nodes)

            self._fn = torch.compile(replay) if on_cuda else replay
        return self._fn


class _Plan:
    __slots__ = ("segments", "externals", "ext_avals", "out_spec",
                 "guard_vector")

    def __init__(self, capture, out_spec):
        self.externals = capture.externals
        self.ext_avals = [(t._data.shape, t._data.dtype)
                          for t in capture.externals]
        self.out_spec = out_spec  # (treespec, leaf specs)

        # split the tape at guard groups: ops..., guards..., ops..., ...
        boundaries = []  # [(ops, guards)]
        cur_ops, cur_guards = [], []
        for e in capture.entries:
            if isinstance(e, _Op):
                if cur_guards:
                    boundaries.append((cur_ops, cur_guards))
                    cur_ops, cur_guards = [], []
                cur_ops.append(e)
            else:
                cur_guards.append(e)
        boundaries.append((cur_ops, cur_guards))
        n_seg = len(boundaries)

        # liveness: node -> latest consumer "time". An op in segment sj
        # consumes at sj; a guard attached to segment sj reads after sj runs
        # (time sj + 0.5); a returned leaf consumes at n_seg. A node must be
        # emitted by its producing segment if any consumer time exceeds the
        # producer's in-segment availability.
        produced_in = {}
        for si, (ops, _) in enumerate(boundaries):
            for op in ops:
                for j in range(op.nout):
                    produced_in[op.base + j] = si
        last_use = {}

        def use(ref, when):
            if ref[0] == "n":
                last_use[ref[1]] = max(last_use.get(ref[1], -1.0), when)

        for si, (ops, guards) in enumerate(boundaries):
            for op in ops:
                for r in op.refs:
                    use(r, float(si))
            for g in guards:
                use(g.ref, si + 0.5)
        _, spec = out_spec
        for lf in spec:
            if lf[0] == "n":
                last_use[lf[1]] = float(n_seg)

        self.segments = []
        for si, (ops, guards) in enumerate(boundaries):
            in_refs, seen = [], set()
            for op in ops:
                for r in op.refs:
                    crosses = r[0] != "n" or produced_in[r[1]] != si
                    if crosses and r not in seen:
                        seen.add(r)
                        in_refs.append(r)
            out_nodes = sorted(
                n for n, sp in produced_in.items()
                if sp == si and last_use.get(n, -1.0) > si)
            self.segments.append(_Segment(ops, in_refs, out_nodes, guards))
        self.guard_vector = tuple(
            g.value for _, guards in boundaries for g in guards)


# --------------------------------------------------------------------------
# the translated callable
# --------------------------------------------------------------------------


def _base_key(args, kwargs):
    leaves, treedef = _pytree.tree_flatten((args, kwargs), is_leaf=_is_leaf)
    parts = []
    for lf in leaves:
        if isinstance(lf, Tensor):
            parts.append(("T", tuple(lf._data.shape), str(lf._data.dtype),
                          str(lf._data.device), lf.stop_gradient))
        elif isinstance(lf, (np.ndarray, torch.Tensor)):
            parts.append(("A", tuple(lf.shape), str(lf.dtype)))
        else:
            try:
                hash(lf)
                parts.append(lf)
            except TypeError:
                parts.append(repr(lf))
    return (treedef, tuple(parts))


def _in_waist():
    """True when called from inside an op's function (below `apply` on
    the stack): a draw there is redrawn at every replay."""
    code = apply.__code__
    f = sys._getframe(2)
    while f is not None:
        if f.f_code is code:
            return True
        f = f.f_back
    return False


class SotFunction:
    """Callable produced by `symbolic_translate` (the reference's
    `jit/sot/translate.py:37` return value)."""

    def __init__(self, fn):
        self._fn = fn
        self._plans = OrderedDict()     # base_key -> [plans, MRU first]
        self._uncapturable = {}         # base_key -> reason
        self.stats = {"captures": 0, "hits": 0, "guard_restarts": 0,
                      "eager_calls": 0, "fallbacks": {}}
        functools.update_wrapper(
            self, fn, assigned=("__name__", "__doc__", "__qualname__"),
            updated=())

    # -- capture -----------------------------------------------------------
    def _capture(self, key, args, kwargs):
        if _tc._op_capture is not None:
            # nested translate: let the OUTER capture record our ops
            return self._fn(*args, **kwargs)
        cap = _Capture()
        leaves, _ = _pytree.tree_flatten((args, kwargs), is_leaf=_is_leaf)
        n_args = 0
        for lf in leaves:
            if isinstance(lf, Tensor):
                cap.refmap[id(lf._data)] = ("a", n_args)
                cap.pins.append(lf._data)
                n_args += 1

        orig_generator = _rng.generator

        def traced_generator(*a, **k):
            # a draw inside an op's function is redrawn at every replay;
            # one outside (a random tensor closed over) cannot be
            if not _in_waist():
                cap.on_rng()
            return orig_generator(*a, **k)

        _tc._op_capture = cap.on_op
        _tc._concrete_hook = cap.on_concrete
        _tc._mutation_hook = cap.on_mutation
        _rng.generator = traced_generator
        try:
            result = self._fn(*args, **kwargs)
        finally:
            _tc._op_capture = None
            _tc._concrete_hook = None
            _tc._mutation_hook = None
            _rng.generator = orig_generator

        if cap.broken is None:
            out_leaves, out_def = _pytree.tree_flatten(result,
                                                       is_leaf=_is_leaf)
            spec = []
            for lf in out_leaves:
                if isinstance(lf, Tensor):
                    ref = cap.refmap.get(id(lf._data))
                    if ref is None:
                        cap.broken = ("an output tensor was produced outside "
                                      "the dispatch waist")
                        break
                    spec.append(ref + (lf.stop_gradient,))
                else:
                    spec.append(("c", lf))
            if cap.broken is None:
                plan = _Plan(cap, (out_def, spec))
                plans = self._plans.setdefault(key, [])
                plans.insert(0, plan)
                del plans[_MAX_PLANS_PER_KEY:]
                self._plans.move_to_end(key)
                while len(self._plans) > _MAX_KEYS:
                    self._plans.popitem(last=False)
                self.stats["captures"] += 1
        if cap.broken is not None:
            self._uncapturable[key] = cap.broken
            self.stats["fallbacks"][cap.broken] = \
                self.stats["fallbacks"].get(cap.broken, 0) + 1
        return result

    # -- replay ------------------------------------------------------------
    def _try_replay(self, plan, arg_tensors):
        """Run one plan's segments; None if a guard/shape mismatch occurs."""
        ext = plan.externals
        for t, (shape, dtype) in zip(ext, plan.ext_avals):
            if t._data.shape != shape or t._data.dtype != dtype:
                return None
        env = {}

        def resolve(ref):
            kind, idx = ref
            if kind == "a":
                return arg_tensors[idx]
            if kind == "x":
                return ext[idx]
            return env[idx]

        for seg in plan.segments:
            if seg.ops:
                ins = [resolve(r) for r in seg.in_refs]
                on_cuda = any(t._data.is_cuda for t in ins)
                outs = apply(seg.fn(on_cuda), *ins, _name="sot_segment")
                if not isinstance(outs, list):
                    outs = [outs]
                for n, t in zip(seg.out_nodes, outs):
                    env[n] = t
            for g in seg.guards:
                raw = resolve(g.ref)._data.detach()
                got = {"bool": lambda: bool(raw), "int": lambda: int(raw),
                       "float": lambda: float(raw),
                       "item": lambda: raw.item()}[g.kind]()
                if got != g.value:
                    return None
        treedef, spec = plan.out_spec
        out_leaves = []
        for lf in spec:
            if lf[0] == "c":
                out_leaves.append(lf[1])
                continue
            kind, idx, stop_grad = lf
            t = resolve((kind, idx))
            if stop_grad and not t.stop_gradient:
                t = Tensor(t._data.detach())
            out_leaves.append(t)
        return (_pytree.tree_unflatten(out_leaves, treedef),)

    def __call__(self, *args, **kwargs):
        key = _base_key(args, kwargs)
        if key in self._uncapturable:
            self.stats["eager_calls"] += 1
            return self._fn(*args, **kwargs)
        plans = self._plans.get(key)
        if not plans:
            return self._capture(key, args, kwargs)
        leaves, _ = _pytree.tree_flatten((args, kwargs), is_leaf=_is_leaf)
        arg_tensors = [lf for lf in leaves if isinstance(lf, Tensor)]
        for i, plan in enumerate(plans):
            res = self._try_replay(plan, arg_tensors)
            if res is not None:
                if i:
                    plans.insert(0, plans.pop(i))  # MRU
                self.stats["hits"] += 1
                return res[0]
            self.stats["guard_restarts"] += 1
        # no recorded path matches this call's guard outcomes: take the
        # eager road once and remember the new path
        return self._capture(key, args, kwargs)

    # -- reporting (reference GraphLogger/InfoCollector role) --------------
    def report(self):
        return {"function": getattr(self._fn, "__qualname__", str(self._fn)),
                "plans": sum(len(v) for v in self._plans.values()),
                "keys": len(self._plans),
                "uncapturable": sorted(set(self._uncapturable.values())),
                **self.stats}

    def diagnose(self):
        """Static bytecode pre-scan of the wrapped function: where it will
        guard, fork plans, or break capture (see scan_function). For a
        translated Layer the scan targets its `forward`."""
        target = self._fn
        holder = getattr(target, "__self__", None)
        if (holder is not None and hasattr(holder, "forward")
                and getattr(target, "__name__", "") == "__call__"):
            # only the Layer dispatch wrapper redirects; a bound method
            # like model.encode is scanned as itself
            target = holder.forward
        return scan_function(target)


_registry = []


def symbolic_translate(fn, **kwargs):
    """Entry point of the SOT path (reference `jit/sot/translate.py:37`).

    Works on plain functions, bound methods, and Layers (a Layer's
    parameters become tape externals, so optimizer updates are picked up
    by replay)."""
    from paddle_tpu_torch.nn.layer.layers import Layer

    sf = SotFunction(fn.__call__ if isinstance(fn, Layer) else fn)
    _registry.append(sf)
    return sf


def sot_report():
    """Capture/guard/fallback stats of every translated function (the
    reference's `paddle.jit.sot` InfoCollector summary)."""
    return [sf.report() for sf in _registry]


# --------------------------------------------------------------------------
# bytecode pre-scan (diagnostics)
# --------------------------------------------------------------------------

# method names whose appearance on a traced value maps to a capture event.
# The break set is the SAME registry the runtime mutation hook covers
# (core/tensor.py MUTATION_METHODS), so diagnosis cannot drift from
# behavior when in-place methods are added.
_SCAN_GUARD_METHODS = {"item": "value guard (equality; recaptures on change)"}
_SCAN_BREAK_METHODS = {
    m: ("materialization break (falls back to eager)"
        if m in ("numpy", "tolist") else "in-place mutation break")
    for m in _tc.MUTATION_METHODS
}
_SCAN_CAST_FNS = {"float": "value guard", "int": "value guard",
                  "bool": "bool guard (branch; one plan per outcome)"}


def scan_function(fn):
    """Static bytecode scan (reference: the SOT opcode translator walks the
    same instruction stream to DECIDE; here the walk DIAGNOSES — execution
    capture happens on the dispatch waist, so this scan has zero soundness
    burden and exists to tell users ahead of time where a function will
    guard, fork plans, or fall back).

    Returns {"guards": [...], "breaks": [...], "branches": [...]}, each
    entry (line, detail). Heuristic: attribute/global names are matched
    textually; a tensor-valued jump is flagged as a potential plan fork.
    """
    import dis
    import types

    code = getattr(fn, "__code__", None)
    if code is None and hasattr(fn, "__call__"):
        code = getattr(fn.__call__, "__code__", None)
    guards, breaks, branches = [], [], []
    if code is None:
        return {"guards": guards, "breaks": breaks, "branches": branches}

    def walk(co):
        line = co.co_firstlineno
        for ins in dis.get_instructions(co):
            # positions.lineno is stable across 3.11+ (starts_line changed
            # type to bool in 3.13)
            pos = getattr(ins, "positions", None)
            if pos is not None and pos.lineno:
                line = pos.lineno
            name = ins.argval if isinstance(ins.argval, str) else None
            if ins.opname in ("LOAD_ATTR", "LOAD_METHOD") and name:
                if name in _SCAN_GUARD_METHODS:
                    guards.append((line, f".{name}(): "
                                   f"{_SCAN_GUARD_METHODS[name]}"))
                elif name in _SCAN_BREAK_METHODS:
                    breaks.append((line, f".{name}(): "
                                   f"{_SCAN_BREAK_METHODS[name]}"))
            elif ins.opname == "LOAD_GLOBAL" and name in _SCAN_CAST_FNS:
                guards.append((line, f"{name}(): {_SCAN_CAST_FNS[name]}"))
            elif ins.opname.startswith("POP_JUMP"):
                # covers POP_JUMP_IF_* (3.12) and the FORWARD/BACKWARD
                # variants (3.11)
                branches.append(
                    (line, "conditional jump: if the predicate is a traced "
                           "tensor this is a bool guard (one cached plan "
                           "per outcome)"))
        for const in co.co_consts:
            if isinstance(const, types.CodeType):
                walk(const)  # lambdas, inner defs, genexprs

    walk(code)
    return {"guards": guards, "breaks": breaks, "branches": branches}
