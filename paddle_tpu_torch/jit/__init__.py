"""paddle.jit: `save` and `load` (`paddle_tpu/jit/__init__.py:399`, :552;
reference `python/paddle/jit/api.py:955`).

`save(layer, path, input_spec=[...])` writes what the inference
`Predictor` serves, in the JAX package's two files:

  - `path.pdmodel`: a pickled dict with the JAX package's keys `class`,
    `input_names`, `output_names` and `param_keys`, the saved inputs'
    dtypes (`input_dtypes`), the device the program was traced on
    (`device`) and, under `torch_export`, the bytes of `torch.export.save`
    of the layer's forward (where the JAX package keeps a StableHLO
    program under `stablehlo`);
  - `path.pdiparams`: a pickle of numpy arrays keyed by `param_keys`, as
    the JAX package writes it; a bf16 array goes through
    `framework/io.py`'s raw-word convention, so the JAX package unpickles
    the port's file into bf16 arrays and the port reads the JAX package's.

The program takes the weights as inputs, as the JAX save does through
`functionalize` (:97-127, :511-529): while tracing, each Parameter's and
buffer's `_data` is swapped for one of the program's inputs (`_Swapped`),
so the program holds no weight and the parameters file holds them all.
The trace is `torch.export.export(..., strict=False)` in eval mode and
under no_grad, through the module and the call to_static's programs use
(`_TraceModule`, `_export`): the port's eager ops run over fake tensors,
and a kernel wrapper's custom op (`paddle_tpu_torch::flash_fwd`, B1)
stays in the graph as one node whose body runs at every call of the
program. A dimension given as None or -1
gets a `torch.export.Dim` of its own; a named one shares its `Dim` with
every input that names it, as the JAX scope shares a symbol (:475-501);
dimensions the program ties together (a batch two inputs share) must
share a name. A dynamic dimension is traced at size 2.

`quantize="weight_only_int8"` saves every quantizable Linear's weight as
int8 codes with an f32 `<weight key>.__scale__` beside it
(`quantization.weight_only_int8_patched`); the program computes each such
Linear through B8's custom operator (`paddle_tpu_torch::weight_only_matmul`,
one node), which launches B8 on the card and runs B8's plain version on
the CPU. `quantize="int8_ptq"` with `calib_reader=` (an iterable of input
batches) calibrates each Linear's and Conv2D's input absmax on the
unpatched model, then saves int8 weights and a program doing int8 x int8
-> int32 products (`quantization.ptq_int8`). Either way the codes and
scales are program inputs like every other weight, `.pdiparams` holds
them as int8 and f32 arrays under the JAX package's keys, and
`.pdmodel` records `quantize` and `quantized_keys`.

Without `input_spec` only the weights are saved, as in the JAX package.

`to_static` (`paddle_tpu/jit/__init__.py:97-350`) is Paddle's second way
to run a model. `functionalize` swaps a layer's parameters and buffers for
a program's inputs (`_SwappedState`), the dy2static-converted forward
(`jit.dy2static`) runs over them, and `StaticFunction` traces that with
`torch.export` (non-strict, under `no_grad`): one program for each static
skeleton of the arguments and each input shape. A kernel wrapper's custom
operator stays one node of the program, its body launching the kernel at
every call. The route is by device, as the kernels' is: a program traced
on CUDA tensors runs through `torch.compile` (inductor, default mode; no
CUDA graphs, which would count launches only at capture), one traced on
the CPU runs as the traced graph, without inductor, whose compile costs
tens of seconds on a CPU. Outputs are fresh Tensors that carry no
gradient, as the JAX package's (which departs from Paddle there). A
data-dependent guard under the trace (`bool`/`float`/`int` of a traced
tensor, `.numpy()`) makes the callable run eagerly from then on, with a
warning and a `fallback_report()` record; no other error does.
`full_graph=False` gives SOT (`jit.sot`) instead.
"""

import contextlib
import functools
import io
import os
import pickle
import time as _time
import warnings

import torch
import torch.utils._pytree as _pytree
from torch._subclasses import fake_tensor as _fake
from torch.fx.experimental import symbolic_shapes as _symbolic

from paddle_tpu_torch.core import tensor as _tc
from paddle_tpu_torch.core.tensor import Tensor, no_grad
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.jit import dy2static, sot  # noqa: F401
from paddle_tpu_torch.jit.dy2static import Dy2StaticFallback
from paddle_tpu_torch.jit.sot import sot_report, symbolic_translate
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework.io import _host_array, _leaf, _Unpickler
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn.layer.layers import Parameter as _Parameter

__all__ = ["to_static", "functionalize", "save", "load", "not_to_static",
           "TracedLayer", "fallback_count", "fallback_report", "sot",
           "symbolic_translate", "sot_report"]

_PROGRAM_KEY = "torch_export"
_QUANTIZE = (None, "weight_only_int8", "int8_ptq")
# the example size a dynamic dimension is traced at: 0 and 1 would be
# specialized by torch.export
_TRACE_DIM = 2


def _read_params(path):
    """{key: CPU torch tensor} of a `.pdiparams` file written by either
    package (bf16 bit for bit, without ml_dtypes)."""
    with open(path, "rb") as f:
        state = _Unpickler(f).load()
    cpu = torch.device("cpu")
    return {k: _leaf(v, False, cpu)._data for k, v in state.items()}


class _Swapped:
    """The layer's parameters and buffers pointed at given tensors while a
    forward runs (the JAX package's `_SwappedState`, :47 and :97), restored
    after: the one swap of jit.save's trace and of functionalize."""

    def __init__(self, layer):
        self.layer = layer
        self.params = dict(layer.named_parameters())
        self.buffers = dict(layer.named_buffers())

    def keys(self):
        return list(self.params) + list(self.buffers)

    def tensors(self):
        return [t._data.detach() for t in
                list(self.params.values()) + list(self.buffers.values())]

    def call(self, param_datas, buffer_datas, forward, args, kwargs):
        """(forward's output, {buffer key: data after the forward}) with
        the parameters at `param_datas` and the buffers at
        `buffer_datas`, under no_grad."""
        saved_p = {k: p._data for k, p in self.params.items()}
        saved_b = {k: b._data for k, b in self.buffers.items()}
        try:
            for k, p in self.params.items():
                p._data = param_datas[k]
            for k, b in self.buffers.items():
                if k in buffer_datas:
                    b._data = buffer_datas[k]
            with _no_grad():
                out = forward(*args, **kwargs)
            return out, {k: b._data for k, b in self.buffers.items()}
        finally:
            for k, p in self.params.items():
                p._data = saved_p[k]
            for k, b in self.buffers.items():
                b._data = saved_b[k]


# the JAX package's name for it (`paddle_tpu/jit/__init__.py:47`)
_SwappedState = _Swapped


def _tree_data(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_data(v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_data(v) for k, v in x.items()}
    return x


class _TraceModule(torch.nn.Module):
    """forward(weights, dyn) = run(weights, dyn): the module torch.export
    traces for jit.save and for to_static, the weights among its inputs.
    `run` is a function, not a submodule: export traces a deep copy of the
    module, and a deep copy shares functions."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, weights, dyn):
        return self.run(weights, dyn)


def _export(run, weights, dyn, dynamic_shapes=None):
    """The ExportedProgram of `run(weights, dyn)` (non-strict, under
    no_grad): jit.save's program and each of to_static's."""
    with no_grad():
        return torch.export.export(_TraceModule(run), (weights, dyn),
                                   dynamic_shapes=dynamic_shapes,
                                   strict=False)


def _spec_dims(input_spec):
    """(example shapes, dynamic_shapes of the feeds) of the specs."""
    named, shapes, dyn = {}, [], []
    n_auto = 0
    for spec in input_spec:
        shape, dims = [], {}
        for i, d in enumerate(list(spec.shape)):
            if isinstance(d, str):
                if d.startswith("_autodim"):
                    raise ValueError(
                        f"dim name {d!r} collides with the auto-generated "
                        "symbol namespace (_autodimN)")
                if d not in named:
                    named[d] = torch.export.Dim(d)
                dims[i] = named[d]
                shape.append(_TRACE_DIM)
            elif d is None or d == -1:
                dims[i] = torch.export.Dim(f"_autodim{n_auto}")
                n_auto += 1
                shape.append(_TRACE_DIM)
            else:
                shape.append(int(d))
        shapes.append(shape)
        dyn.append(dims or None)
    return shapes, dyn


def save(layer, path, input_spec=None, quantize=None, platforms=None,
         calib_reader=None, **configs):
    """jit.save: the weights, and with `input_spec` (objects with `.shape`,
    `.dtype` and `.name`, such as `hapi.model.InputSpec`) the program the
    Predictor runs. `platforms` is accepted and unused: the Predictor
    moves the program to its device."""
    if quantize not in _QUANTIZE:
        raise ValueError(f"unsupported quantize={quantize!r} "
                         "(None | 'weight_only_int8' | 'int8_ptq')")
    if quantize is not None and input_spec is None:
        raise ValueError("quantize requires input_spec (the dequant is part "
                         "of the exported program)")
    quant_cm = None
    if quantize == "int8_ptq":
        if calib_reader is None:
            raise ValueError("quantize='int8_ptq' requires calib_reader="
                             "<iterable of input batches> for activation-"
                             "scale calibration")
        from paddle_tpu_torch.quantization.ptq_int8 import (calibrate_absmax,
                                                            int8_patched)

        # calibration runs now, on the eager unpatched model; the patch is
        # entered right before tracing, so a bad input_spec cannot leave
        # the live model int8-patched
        quant_cm = int8_patched(layer, calibrate_absmax(layer, calib_reader))
    elif quantize == "weight_only_int8":
        from paddle_tpu_torch.quantization import weight_only_int8_patched

        quant_cm = weight_only_int8_patched(layer)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"class": type(layer).__name__}
    if input_spec is None:
        state = {k: _host_array(v._data)
                 for k, v in layer.state_dict().items()}
    else:
        shapes, dyn = _spec_dims(input_spec)
        dts = [_dtypes.convert_dtype(getattr(s, "dtype", None) or "float32")
               for s in input_spec]
        was_training = getattr(layer, "training", False)
        layer.eval()
        quant_keys = []
        try:
            if quant_cm is not None:
                # live from the weights' capture (int8 codes and scales are
                # program inputs) through the trace of the patched forwards
                quant_keys = quant_cm.__enter__()
            swapped = _Swapped(layer)
            weights = swapped.tensors()
            dev = weights[0].device if weights else _device.place()
            feeds = [torch.zeros(s, dtype=dt, device=dev)
                     for s, dt in zip(shapes, dts)]
            n_p = len(swapped.params)

            def run(ws, fs):
                out, _ = swapped.call(
                    dict(zip(swapped.params, ws[:n_p])),
                    dict(zip(swapped.buffers, ws[n_p:])), layer,
                    [Tensor(a) for a in fs], {})
                return _tree_data(out)

            ep = _export(run, weights, feeds,
                         ([None] * len(weights), dyn))
        finally:
            if was_training:
                layer.train()
            if quant_cm is not None:
                quant_cm.__exit__(None, None, None)
        # the example inputs are the weights themselves: they stay out of
        # the program file
        ep._example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        n_out = len(ep.graph_signature.user_outputs)
        meta.update({
            "input_names": [getattr(s, "name", None) or f"input_{i}"
                            for i, s in enumerate(input_spec)],
            "output_names": [f"output_{i}" for i in range(n_out)],
            "param_keys": swapped.keys(),
            "input_dtypes": [_dtypes.dtype_name(dt) for dt in dts],
            "device": str(dev),
            _PROGRAM_KEY: buf.getvalue(),
        })
        if quantize is not None:
            meta["quantize"] = quantize
            meta["quantized_keys"] = sorted(quant_keys)
        state = {k: _host_array(t) for k, t in zip(swapped.keys(), weights)}
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(state, f)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f)


def load(path, **configs):
    """The weights `save` wrote (by either package) as a `LoadedLayer`:
    Parameters on the creation place, `state_dict()` by their saved keys;
    its forward raises."""
    state = _read_params(path + ".pdiparams")

    class LoadedLayer(Layer):
        def __init__(self):
            super().__init__()
            dev = _device.place()
            self._state = {k: _Parameter(v.to(dev))
                           for k, v in state.items()}
            for k, p in self._state.items():
                self.add_parameter(k.replace(".", "__"), p)

        def forward(self, *args):
            raise NotImplementedError(
                "jit.load restores weights; rebuild the architecture and "
                "call set_state_dict, or use paddle_tpu_torch.inference for "
                "saved predictors")

        def state_dict(self, *a, **kw):
            return dict(self._state)

    return LoadedLayer()


# --------------------------------------------------------------------------
# functionalize and to_static (`paddle_tpu/jit/__init__.py:47-350`)
# --------------------------------------------------------------------------

_fallback_count = 0
_fallback_records = []

# what a trace raises where a JAX trace raises a tracer error: a branch or
# a guard on a traced value, a value read from a traced tensor
_DATA_DEPENDENT = (_symbolic.GuardOnDataDependentSymNode,
                   _fake.DataDependentOutputException,
                   _fake.DynamicOutputShapeException, _tc.TracedValueError)


def fallback_count():
    """Number of to_static callables that degraded WHOLLY to eager this
    process (dy2static-converted models must keep this at zero).
    Per-region fallbacks do not count: the callable stays compiled."""
    return _fallback_count


def fallback_report():
    """What fell back, per callable (the reference SOT's breakgraph
    counters): a list of {"name", "event": "region"|"eager", "detail"}
    records in order."""
    return list(_fallback_records)


def _no_grad():
    """no_grad, or nothing where grad is off already: a trace runs under
    no_grad, and a grad-mode switch inside it would be a node of the
    program (which torch.export's pass over nested control flow mishandles)."""
    return no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()


def _wrap_tree(x):
    return _pytree.tree_map(
        lambda a: Tensor(a) if isinstance(a, torch.Tensor) else a, x)


def _seeded(seed, device):
    """A generator context for the layer's random ops: the framework's
    (seed None) or a fresh one seeded by `seed` (an int) or `seed` itself
    (a torch.Generator)."""
    if seed is None:
        return contextlib.nullcontext()
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    return _rng.use_generator(gen)


def functionalize(layer, forward=None):
    """(pure_fn, params, buffers): pure_fn(params, buffers, seed, *args,
    **kwargs) -> (outputs, new_buffers) over dicts of torch tensors.

    The layer's random ops draw from a generator seeded by `seed` (an int
    or a torch.Generator; None: the framework generator), and a buffer
    update (batch norm's running statistics) comes back in new_buffers.
    The default forward is the layer's call (hooks included) over the
    dy2static-converted forward, so tensor-dependent if/while trace to
    torch.cond/while_loop."""
    state = _SwappedState(layer)
    fwd = forward or dy2static.converted_layer_call(layer)

    def pure_fn(param_datas, buffer_datas, seed, *args, **kwargs):
        dev = next(iter(param_datas.values())).device if param_datas \
            else None
        with _seeded(seed, dev or "cpu"):
            out, new_buffers = state.call(
                param_datas, buffer_datas, fwd, _wrap_tree(args),
                _wrap_tree(kwargs))
        return _tree_data(out), new_buffers

    params = {k: p._data.detach() for k, p in state.params.items()}
    buffers = {k: b._data for k, b in state.buffers.items()}
    return pure_fn, params, buffers


class _DynSlot:
    __slots__ = ()

    def __repr__(self):
        return "<dyn>"


_DYN = _DynSlot()  # placeholder for a tensor leaf in a static skeleton


def _is_leaf(x):
    return isinstance(x, Tensor)


def _check_no_traced_constants(gm):
    """Refuse a program that baked a traced tensor in as a constant (a
    branch that read one the dy2static runtime did not lift): it would
    fail or, worse, replay a stale value."""
    for mod in gm.modules():
        for name, v in vars(mod).items():
            if isinstance(v, torch.Tensor) and _fake.is_fake(v):
                raise RuntimeError(
                    f"to_static: the traced program holds a traced tensor "
                    f"as the constant {name!r}: a converted branch or loop "
                    "reads a tensor through an object the runtime cannot "
                    "see into; pass it as a variable of the function")


def _target_name(t):
    """A graph node's target by name: `higher_order.cond`,
    `paddle_tpu_torch.flash_fwd.default`, `aten.mm.default`."""
    if isinstance(t, torch._ops.HigherOrderOperator):
        return f"higher_order.{t.name()}"
    return str(t)


class _CompiledProgram:
    """One traced program of `run(weights, dyn) -> (outputs, new
    buffers)`: the exported graph of its flat tensor outputs and new
    buffers, run through inductor on a CUDA device and as it is on the
    CPU; the outputs' structure and constants are kept at trace time
    (`spec`)."""

    def __init__(self, run, weights, dyn):
        spec = []

        def flat(ws, dyn_datas):
            out, new_buffers = run(ws, dyn_datas)
            leaves, tree = _pytree.tree_flatten(out)
            if any(v is dy2static.UNDEF for v in leaves):
                raise NameError("a variable is returned before any "
                                "assignment (a loop that ran no iteration)")
            slots = [isinstance(v, torch.Tensor) for v in leaves]
            spec[:] = [(tree, slots,
                        [None if s else v for v, s in zip(leaves, slots)])]
            return ([v for v, s in zip(leaves, slots) if s],
                    list(new_buffers.values()))

        t0 = _time.perf_counter()
        self.exported = _export(flat, weights, dyn)
        self.spec = spec[0]
        gm = self.exported.module()
        _check_no_traced_constants(gm)
        devs = {t.device.type for t in list(weights) + list(dyn)}
        self.device_type = "cuda" if "cuda" in devs else "cpu"
        self.fn = torch.compile(gm) if self.device_type == "cuda" else gm
        self.trace_seconds = _time.perf_counter() - t0

    def graph_targets(self):
        """The call targets of the traced graph (custom operators by their
        qualified names), for a check that the kernels are in it."""
        out = []
        for gm in self.exported.graph_module.modules():
            if isinstance(gm, torch.fx.GraphModule):
                out += [_target_name(n.target) for n in gm.graph.nodes
                        if n.op == "call_function"]
        return out

    def __call__(self, weights, dyn):
        with no_grad():
            flat, new_buffers = self.fn(weights, dyn)
        tree, slots, consts = self.spec
        it = iter(flat)
        leaves = [Tensor(next(it)) if s else c
                  for s, c in zip(slots, consts)]
        return _pytree.tree_unflatten(leaves, tree), new_buffers



class StaticFunction:
    """Callable wrapper produced by to_static (the reference's
    StaticFunction of `jit/dy2static/program_translator.py`)."""

    _MAX_REGION_RETRIES = 8
    _RETRACE_WARN_AT = 32
    _GLOBAL_ENABLE = True

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None):
        from paddle_tpu_torch.nn.layer.layers import Layer

        self._fn = function
        self._layer = function if isinstance(function, Layer) else None
        self._built = False
        self._programs = {}  # (skeleton, input shapes) -> _CompiledProgram
        self._eager_only = False
        # per-region fallback blacklist: (namespace, uid) regions left as
        # Python on re-conversion
        self._skip_regions = set()
        self._converted = None
        self._pure_fn = None

    def _build(self):
        tok = dy2static._ACTIVE_SKIP.set(frozenset(self._skip_regions))
        try:
            self._programs = {}
            if self._layer is not None:
                self._converted = dy2static.convert_function(
                    self._layer.forward)
                self._pure_fn = functionalize(self._layer)[0]
            else:
                self._converted = dy2static.convert_function(self._fn)
            self._built = True
        finally:
            dy2static._ACTIVE_SKIP.reset(tok)

    def _split_static(self, args, kwargs):
        """Split (args, kwargs) into dynamic tensor leaves and a STATIC
        skeleton. Non-tensor Python leaves (bools, ints, strs, None, ...)
        are compile-time constants, as the reference's dy2static bakes
        non-tensor arguments into the program, so a concrete `if flag:`
        stays concrete inside the trace."""
        import numpy as np

        leaves, treedef = _pytree.tree_flatten((args, kwargs),
                                               is_leaf=_is_leaf)
        dyn, skel = [], []
        for leaf in leaves:
            if isinstance(leaf, Tensor):
                dyn.append(leaf._data.detach())
                skel.append(_DYN)
            elif isinstance(leaf, torch.Tensor):
                dyn.append(leaf.detach())
                skel.append(_DYN)
            elif isinstance(leaf, np.ndarray):
                dyn.append(Tensor(leaf)._data)
                skel.append(_DYN)
            else:
                skel.append(leaf)

        def hashable(s):
            try:
                hash(s)
                return s
            except TypeError:
                # keying a mutable object by id would silently reuse a
                # program with its old contents baked in after a mutation
                raise TypeError(
                    f"to_static: non-tensor argument {s!r} is unhashable; "
                    "non-tensor arguments are compile-time constants and "
                    "must be hashable (pass data as Tensors/arrays)")

        skey = (treedef, tuple(hashable(s) for s in skel),
                tuple((tuple(d.shape), d.dtype, d.device) for d in dyn))
        return dyn, skel, treedef, skey

    def _weights(self):
        if self._layer is None:
            return [], [], []
        params = dict(self._layer.named_parameters())
        buffers = dict(self._layer.named_buffers())
        return (list(params), list(buffers),
                [p._data.detach() for p in params.values()] +
                [b._data for b in buffers.values()])

    def _program_for(self, skel, treedef, skey, weights, dyn):
        prog = self._programs.get(skey)
        if prog is not None:
            return prog
        if len(self._programs) == self._RETRACE_WARN_AT:
            warnings.warn(
                f"to_static({self._name()}): {self._RETRACE_WARN_AT} "
                "compiled variants — a changing Python scalar argument "
                "forces a recompile per value (non-tensor arguments are "
                "compile-time constants); pass it as a Tensor to compile "
                "once. (The reference SOT's guard-retrace warning.)")
        skel = list(skel)

        def rebuild(dyn_datas):
            it = iter(dyn_datas)
            leaves = [Tensor(next(it)) if s is _DYN else s for s in skel]
            return _pytree.tree_unflatten(leaves, treedef)

        if self._layer is not None:
            pkeys, bkeys, _ = self._weights()
            pure_fn = self._pure_fn

            def run(ws, dyn_datas):
                a, kw = rebuild(dyn_datas)
                return pure_fn(dict(zip(pkeys, ws[:len(pkeys)])),
                               dict(zip(bkeys, ws[len(pkeys):])), None,
                               *a, **kw)
        else:
            fn = self._converted

            def run(ws, dyn_datas):
                a, kw = rebuild(dyn_datas)
                with _no_grad():
                    return _tree_data(fn(*a, **kw)), {}

        prog = _CompiledProgram(run, weights, dyn)
        self._programs[skey] = prog
        return prog

    def _run_once(self, args, kwargs):
        dyn, skel, treedef, skey = self._split_static(args, kwargs)
        pkeys, bkeys, weights = self._weights()
        # a layer cast, moved or switched between train and eval after a
        # call gets a program of its own
        skey += (tuple((tuple(w.shape), w.dtype, w.device) for w in weights),
                 getattr(self._layer, "training", None))
        prog = self._program_for(skel, treedef, skey, weights, dyn)
        out, new_buffers = prog(weights, dyn)
        if self._layer is not None:
            buffers = dict(self._layer.named_buffers())
            for k, d in zip(bkeys, new_buffers):
                buffers[k]._data = d
        return out

    def _name(self):
        return getattr(self._fn, "__name__", type(self._fn).__name__)

    def __call__(self, *args, **kwargs):
        global _fallback_count
        if self._eager_only or not StaticFunction._GLOBAL_ENABLE:
            return self._fn(*args, **kwargs)
        for _ in range(self._MAX_REGION_RETRIES + 1):
            if not self._built:
                self._build()
            tok = dy2static._ACTIVE_SKIP.set(frozenset(self._skip_regions))
            try:
                return self._run_once(args, kwargs)
            except Dy2StaticFallback as e:
                region = getattr(e, "region", None)
                if region is not None and region not in self._skip_regions:
                    # per-region fallback: re-convert with just this region
                    # left as Python and retry; if its predicates are
                    # concrete the callable stays compiled, minus a region
                    self._skip_regions.add(region)
                    self._built = False
                    _fallback_records.append(
                        {"name": self._name(), "event": "region",
                         "detail": f"{region[0]}#r{region[1]}: {e}"})
                    warnings.warn(
                        f"to_static({self._name()}): region "
                        f"{region[0]}#r{region[1]} is not compilable "
                        f"({e}); retrying with it as ordinary Python.")
                    continue
                break  # regionless or already skipped: whole-callable eager
            except _DATA_DEPENDENT:
                break
            finally:
                dy2static._ACTIVE_SKIP.reset(tok)
        # tensor-dependent Python control flow the converter could not
        # capture and region retries could not isolate: the whole callable
        # runs eagerly from now on, with a warning
        _fallback_count += 1
        _fallback_records.append({"name": self._name(), "event": "eager",
                                  "detail": "whole callable degraded"})
        warnings.warn(
            f"to_static({self._name()}): tensor-dependent Python control "
            "flow cannot be traced; this callable now runs eagerly. Rewrite "
            "with paddle.where / torch.cond-style control flow to compile.")
        self._eager_only = True
        return self._fn(*args, **kwargs)

    def conversion_report(self):
        """Per-region conversion outcome of the top callable and the
        active per-region fallback set (the reference SOT's info
        collector)."""
        if not self._built and not self._eager_only:
            self._build()
        rep = getattr(self._converted, "__pt_dy2static_report__", None)
        # key=repr: the set mixes int region ids and synthesized tuple ids
        return {"report": rep,
                "fallback_regions": sorted(self._skip_regions, key=repr),
                "eager_only": self._eager_only}

    def programs(self):
        """The traced programs, one per skeleton and input shape."""
        return list(self._programs.values())

    @property
    def forward(self):
        return self


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=None, **kwargs):
    """@paddle.jit.to_static: trace a Layer or function into one program.

    full_graph picks the capture path, as the reference's switch does:
    True/None (default) the AST conversion and one trace
    (`StaticFunction`); False the SOT capture (`jit.sot`), which keeps
    full Python semantics and falls back per call path."""
    from paddle_tpu_torch.nn.layer.layers import Layer

    def decorator(fn):
        if full_graph is False:
            return symbolic_translate(fn)
        sf = StaticFunction(fn, input_spec, build_strategy, backend)
        if not isinstance(fn, Layer):
            functools.update_wrapper(sf, fn, assigned=("__name__", "__doc__"),
                                     updated=())
        return sf

    if function is not None:
        return decorator(function)
    return decorator


def not_to_static(fn):
    return fn


def ignore_module(modules):
    pass


class TracedLayer:
    """A layer traced by `TracedLayer.trace` (reference
    `jit/dy2static` TracedLayer); `jit.load` returns weights, so
    TranslatedLayer is this same wrapper."""

    def __init__(self, static_fn):
        self._fn = static_fn

    @staticmethod
    def trace(layer, inputs):
        sf = StaticFunction(layer)
        out = sf(*inputs)
        return out, TracedLayer(sf)

    def __call__(self, *args):
        return self._fn(*args)


TranslatedLayer = TracedLayer

# -- the reference's knobs (jit/sot verbosity, the global switch) -----------

_code_level = 0
_verbosity = 0


def set_code_level(level=100, also_to_stdout=False):
    """reference `jit/dy2static/logging_utils.py` set_code_level: level > 0
    prints each converted function's source once, at conversion."""
    global _code_level
    _code_level = level


def set_verbosity(level=0, also_to_stdout=False):
    global _verbosity
    _verbosity = level


def enable_to_static(flag=True):
    """The process-wide dy2static switch (reference
    `paddle.jit.enable_to_static`): False makes every StaticFunction run
    its callable eagerly."""
    StaticFunction._GLOBAL_ENABLE = bool(flag)
