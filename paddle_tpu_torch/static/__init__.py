"""paddle.static: the static-graph API (`paddle_tpu/static/__init__.py`;
reference `python/paddle/static/`).

With `paddle.enable_static()`, `static.data` makes Variables (Tensors over
fake tensors), every op on them is recorded into the active Program
through the dispatch waist, and `Executor.run(feed, fetch_list)` replays
the program as one function traced once for each feed signature (plus the
optimizer update after `minimize(loss)`), compiled with inductor on a CUDA
device and run as the traced graph on the CPU (`static/graph.py`).
`save_inference_model` writes through `jit.save`, `load_inference_model`
and the Executor serve a saved program through the inference Predictor.
The Executor runs on its place (default: the creation place,
`framework.device.place`).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = [
    "nn",
    "InputSpec", "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "global_scope",
    "scope_guard", "save_inference_model", "load_inference_model",
    "name_scope", "cpu_places", "device_guard", "Variable",
    "create_parameter", "create_global_var", "gradients",
    "append_backward", "py_func", "accuracy", "auc",
    "ExponentialMovingAverage", "WeightNormParamAttr", "BuildStrategy",
    "CompiledProgram", "cuda_places", "xpu_places", "Print",
    "serialize_program", "deserialize_program", "serialize_persistables",
    "deserialize_persistables", "save_to_file", "load_from_file", "save",
    "load", "load_program_state", "set_program_state",
    "normalize_program", "ctr_metric_bundle", "IpuStrategy",
    "IpuCompiledProgram", "ipu_shard_guard", "set_ipu_shard",
]


class InputSpec:
    """Placeholder spec (reference `python/paddle/static/input.py`)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        from paddle_tpu_torch.framework import dtypes

        return cls(tensor.shape, dtypes.dtype_name(tensor.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


from paddle_tpu_torch.core.tensor import Tensor as Variable  # noqa: E402
from paddle_tpu_torch.framework import device as _device  # noqa: E402
from paddle_tpu_torch.framework import dtypes as _dtypes  # noqa: E402
from paddle_tpu_torch.static import graph as _graph  # noqa: E402
from paddle_tpu_torch.static import nn  # noqa: E402,F401
from paddle_tpu_torch.static.graph import (  # noqa: E402,F401
    Program, default_main_program, default_startup_program,
    in_static_graph_mode, program_guard)


class name_scope:
    def __init__(self, prefix=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class device_guard(name_scope):
    pass


def data(name, shape, dtype="float32", lod_level=0):
    """Feed placeholder. In static-graph mode (`paddle.enable_static()`) an
    abstract Variable of the default main program; in dygraph a zero
    Tensor of the given shape (dims of -1/None become 1)."""
    if in_static_graph_mode():
        return _graph.data(name, shape, dtype)
    shp = [1 if (d is None or int(d) < 0) else int(d) for d in shape]
    t = Variable(torch.zeros(shp, dtype=_dtypes.convert_dtype(dtype),
                             device=_device.place()))
    t.name = name
    return t


def cpu_places(device_count=None):
    return [torch.device("cpu")] * (device_count or 1)


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [torch.device("cuda", int(i)) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


class _Scope:
    def __init__(self):
        self.vars = {}


_scope = _Scope()


def global_scope():
    return _scope


class scope_guard:
    def __init__(self, scope):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _feed_array(v, dt, dev):
    if isinstance(v, Variable):
        return v._data.to(dev)
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return Variable(np.asarray(v))._data.to(device=dev, dtype=dt)


class Executor:
    """Static-program executor (reference `base/executor.py:1734`
    Executor.run): replays the recorded Program as one function traced
    once for each feed signature (`static/graph.py`). Also runs loaded
    inference programs through the Predictor and plain callables."""

    def __init__(self, place=None):
        self.place = _device.place(place)
        self._monitor = None

    def _get_monitor(self):
        if self._monitor is None:
            from paddle_tpu_torch.observability import TrainingMonitor

            # nan_action='none': the fetches go back to the caller anyway
            self._monitor = TrainingMonitor(source="static_executor",
                                            nan_action="none")
        return self._monitor

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kw):
        if isinstance(program, _LoadedInferenceProgram):
            return program.run(feed or {})
        if program is None and in_static_graph_mode():
            program = default_main_program()
        if isinstance(program, CompiledProgram):
            program = program.program
        if isinstance(program, Program):
            return self._run_program(program, feed or {}, fetch_list or [],
                                     return_numpy)
        if callable(program):
            out = program(**(feed or {}))
            return out if isinstance(out, (list, tuple)) else [out]
        raise ValueError(
            "Executor.run needs a static Program (enable_static + "
            "program_guard), a loaded inference program "
            "(load_inference_model) or a callable")

    def _run_program(self, program, feed, fetch_list, return_numpy):
        if not program.ops and not fetch_list:
            # startup program: the parameters are already made eagerly
            # (the Scope is the parameter Tensors themselves)
            return []
        fetch_refs = []
        for v in fetch_list:
            ref = program._refs.get(id(v._data)) if isinstance(
                v, Variable) else None
            if ref is None:
                raise ValueError(
                    f"fetch target {v!r} is not a Variable of this Program")
            fetch_refs.append(ref)
        feed_names = sorted(feed)
        feed_arrays = []
        for n in feed_names:
            decl = program.feeds.get(n)
            feed_arrays.append(_feed_array(
                feed[n], None if decl is None else decl.dtype, self.place))
        train = program.opt is not None
        key = ("train" if train else "infer", tuple(feed_names),
               tuple((tuple(a.shape), a.dtype) for a in feed_arrays),
               tuple(fetch_refs))
        monitor = self._get_monitor()
        ext_vals = [t._data.detach() for t in program.externals]
        entry = program._run_cache.get(key)
        if train:
            opt = program.opt[0]
            lr = torch.tensor(_graph.resolve_lr(opt), dtype=torch.float32,
                              device=self.place)
        if entry is None:
            # a cache miss is a compilation on this executor: one traced
            # program per feed signature
            monitor.record_compile("train" if train else "infer")
            if train:
                params = [a for a, t in zip(ext_vals, program.externals)
                          if not t.stop_gradient]
                slots = _graph.init_slots(opt, params)
                example = (feed_arrays, ext_vals, slots, lr)
            else:
                slots = None
                example = (feed_arrays, ext_vals)
            entry = program._run_cache[key] = {
                "fn": program.compile(feed_names, fetch_refs, train,
                                      example),
                "slots": slots,
            }
        samples = feed_arrays[0].shape[0] if (
            feed_arrays and feed_arrays[0].dim()) else None
        monitor.start_step()
        if train:
            fetches, new_ext, entry["slots"] = entry["fn"](
                feed_arrays, ext_vals, entry["slots"], lr)
            # the updated parameters go back into the shared Tensors (the
            # Scope write the reference executor does)
            for t, a in zip(program.externals, new_ext):
                if not t.stop_gradient:
                    t._refill(a)
        else:
            fetches = entry["fn"](feed_arrays, ext_vals)
        out = [f.detach().cpu().numpy() if return_numpy else Variable(f)
               for f in fetches]
        monitor.end_step(samples=samples)
        return out

    def close(self):
        pass


class _LoadedInferenceProgram:
    def __init__(self, path_prefix):
        from paddle_tpu_torch.inference import Config, create_predictor

        self._predictor = create_predictor(Config(path_prefix))
        self.feed_names = self._predictor.get_input_names()
        self.fetch_names = self._predictor.get_output_names()

    def run(self, feed):
        ins = [np.asarray(feed[n]) for n in self.feed_names]
        return [o.numpy() if hasattr(o, "numpy") else np.asarray(o)
                for o in self._predictor.run(ins)]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kw):
    """reference `static/io.py:513`: the model is a Layer passed as
    `layer=`, saved through `jit.save` with the feed Variables' specs."""
    layer = kw.get("layer")
    if layer is None:
        raise ValueError(
            "save_inference_model exports a Layer: "
            "save_inference_model(path, feed_vars, fetch_vars, "
            "layer=my_layer), or use paddle_tpu_torch.jit.save(layer, path, "
            "input_spec=...)")
    from paddle_tpu_torch import jit as pjit

    specs = [InputSpec(v.shape, _dtypes.dtype_name(v.dtype),
                       getattr(v, "name", None)) for v in feed_vars]
    pjit.save(layer, path_prefix, input_spec=specs)


def load_inference_model(path_prefix, executor=None, **kw):
    prog = _LoadedInferenceProgram(path_prefix)
    return prog, prog.feed_names, prog.fetch_names


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference `static/nn/common.py` create_parameter: an eagerly made
    Parameter (XavierNormal unless an initializer is given)."""
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.nn.layer.layers import Parameter

    dt = _dtypes.convert_dtype(dtype)
    init = default_initializer or XavierNormal()
    data = init(list(shape), dt) if callable(init) else \
        torch.zeros(list(shape), dtype=dt, device=_device.place())
    p = Parameter(data, name=name)
    p.stop_gradient = False
    return p


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    return Variable(torch.full(tuple(shape), value,
                               dtype=_dtypes.convert_dtype(dtype),
                               device=_device.place()))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None,
              name=None):
    """reference `static/gradients`: in static-graph mode, new Variables
    differentiating the recorded tape at run; in dygraph, autograd."""
    if in_static_graph_mode():
        return _graph.gradients(targets, inputs, target_gradients,
                                no_grad_set, name)
    from paddle_tpu_torch.core.backward import grad as _grad

    outs = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return _grad(list(outs), list(ins), grad_outputs=target_gradients,
                 retain_graph=True, allow_unused=True)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """reference `static/append_backward`: the gradients on the
    parameters (`loss.backward()`); returns (param, grad) pairs."""
    loss.backward(retain_graph=True)
    params = parameter_list or []
    return [(p, p.grad) for p in params if getattr(p, "grad", None)
            is not None]


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """reference `static/nn/common.py` py_func: an eager call-through."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return func(*xs)


def accuracy(input, label, k=1, correct=None, total=None):
    from paddle_tpu_torch import metric as _m

    return _m.accuracy(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    from paddle_tpu_torch import metric as _m

    m = _m.Auc(num_thresholds=num_thresholds)
    probs = np.asarray(input.numpy() if hasattr(input, "numpy") else input)
    lab = np.asarray(label.numpy() if hasattr(label, "numpy") else label)
    m.update(probs, lab)
    val = Variable(np.float32(m.accumulate()))
    return val, val, val


class ExponentialMovingAverage:
    """reference `static/ema.py`: shadow-parameter EMA with an
    apply/restore context."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._params = None

    def update(self, parameters=None):
        if parameters is None:
            raise ValueError("pass parameters=... (there is no global "
                             "program to harvest them from)")
        self._params = list(parameters)
        for i, p in enumerate(self._params):
            d = p._data.detach()
            s = self._shadow.get(i)
            self._shadow[i] = (d.clone() if s is None
                               else self._decay * s + (1 - self._decay) * d)

    def apply(self, executor=None, need_restore=True):
        ema = self

        class _Ctx:
            def __enter__(ctx):
                ema._backup = {i: p._data.detach().clone()
                               for i, p in enumerate(ema._params)}
                for i, p in enumerate(ema._params):
                    p._refill(ema._shadow[i].to(p.dtype))
                return ctx

            def __exit__(ctx, *exc):
                if need_restore:
                    ema.restore()
                return False

        return _Ctx()

    def restore(self, executor=None):
        for i, p in enumerate(self._params or []):
            if i in self._backup:
                p._refill(self._backup[i])


class WeightNormParamAttr:
    """Accepted for source compatibility (reference static/nn weight-norm
    attr); use nn.utils.weight_norm."""

    def __init__(self, dim=None, **kw):
        self.dim = dim
        self.__dict__.update(kw)


class BuildStrategy:
    """Accepted for source compatibility (inductor owns fusion)."""


class CompiledProgram:
    """reference CompiledProgram: a Program already runs traced and
    compiled, so this wraps it unchanged."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """reference static Print op: an eager print-through."""
    print(f"{message or ''} {input}")
    return input


# -- program/persistable serialization: the program is jit.save's traced
# -- export, the persistables the weights ------------------------------------

def serialize_program(feed_vars, fetch_vars, **kwargs):
    return pickle.dumps({"feed": [getattr(v, "name", None)
                                  for v in (feed_vars or [])],
                         "fetch": len(fetch_vars or [])})


def deserialize_program(data):
    return pickle.loads(data)


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    params = {}
    for v in fetch_vars or []:
        layer = getattr(v, "_layer", None)
        if layer is not None:
            params.update({k: p.numpy()
                           for k, p in layer.state_dict().items()})
    return pickle.dumps(params)


def deserialize_persistables(program, data, executor=None):
    return pickle.loads(data)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def save(program, model_path, protocol=4, **configs):
    """reference static.save: a model's state (a Layer-backed program's
    state_dict) as numpy arrays."""
    state = getattr(program, "state_dict", lambda: {})()
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump({k: v.numpy() if hasattr(v, "numpy") else v
                     for k, v in state.items()}, f, protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        state = pickle.load(f)
    setter = getattr(program, "set_state_dict", None)
    if setter is not None:
        setter(state)
    return state


def load_program_state(model_path, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)


def set_program_state(program, state_dict):
    setter = getattr(program, "set_state_dict", None)
    if setter is not None:
        setter(state_dict)


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    return program  # the traced export is already feed/fetch-normalized


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """reference static ctr_metric_bundle over the streaming Auc."""
    a, _, _ = auc(input, label)
    return a, a


class _IpuUnsupported:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "IPU support does not exist on this backend (CUDA build); "
            "Graphcore-specific APIs are intentionally absent")


IpuStrategy = _IpuUnsupported
IpuCompiledProgram = _IpuUnsupported


def ipu_shard_guard(*a, **k):
    raise NotImplementedError("IPU sharding is not available on the CUDA "
                              "build")


def set_ipu_shard(*a, **k):
    raise NotImplementedError("IPU sharding is not available on the CUDA "
                              "build")
