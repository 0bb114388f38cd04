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
The trace is `torch.export.export(..., strict=False)` in eval mode: the
port's eager ops run over fake tensors, and a kernel wrapper's custom op
(`paddle_tpu_torch::flash_fwd`, B1) stays in the graph as one node whose
body runs at every call of the program. A dimension given as None or -1
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
The rest of the JAX package's `jit` (to_static, SOT, TracedLayer, ...)
waits for A10f part 2 and raises naming it.
"""

import io
import os
import pickle

import torch

from paddle_tpu_torch.core.tensor import Tensor, no_grad  # noqa: F401
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework.io import _host_array, _leaf, _Unpickler
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn.layer.layers import Parameter as _Parameter
from paddle_tpu_torch.ops._common import waits_for as _waits_for

__all__ = ["save", "load", "to_static", "functionalize", "not_to_static",
           "TracedLayer", "fallback_count", "fallback_report",
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
    """The layer's parameters and buffers pointed at the program's inputs
    while it traces (the JAX package's `_SwappedState`, :97), restored
    after."""

    def __init__(self, layer):
        self.layer = layer
        self.params = dict(layer.named_parameters())
        self.buffers = dict(layer.named_buffers())

    def keys(self):
        return list(self.params) + list(self.buffers)

    def tensors(self):
        return [t._data.detach() for t in
                list(self.params.values()) + list(self.buffers.values())]

    def run(self, datas, feeds):
        owners = list(self.params.values()) + list(self.buffers.values())
        saved = [t._data for t in owners]
        try:
            for t, d in zip(owners, datas):
                t._data = d
            out = self.layer(*[Tensor(a) for a in feeds])
            return _tree_data(out)
        finally:
            for t, d in zip(owners, saved):
                t._data = d


def _tree_data(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_data(v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_data(v) for k, v in x.items()}
    return x


class _Program(torch.nn.Module):
    """forward(weights, feeds): the layer's outputs, weights as inputs."""

    def __init__(self, swapped):
        super().__init__()
        self.swapped = swapped

    def forward(self, weights, feeds):
        return self.swapped.run(weights, feeds)


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
            ep = torch.export.export(
                _Program(swapped), (weights, feeds),
                dynamic_shapes=([None] * len(weights), dyn), strict=False)
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


def _later(name):
    def call(*args, **kwargs):
        raise _waits_for(f"jit.{name}", "A10f part 2",
                         "dynamic-to-static and SOT")
    call.__name__ = call.__qualname__ = name
    call.__doc__ = (f"jit.{name}: waits for ROADMAP A10f part 2 and raises "
                    "NotImplementedError naming it.")
    return call


_LATER = ("to_static", "functionalize", "not_to_static", "ignore_module",
         "TracedLayer", "TranslatedLayer", "StaticFunction",
         "fallback_count", "fallback_report", "symbolic_translate",
         "sot_report", "set_code_level", "set_verbosity",
         "enable_to_static")
for _name in _LATER:
    globals()[_name] = _later(_name)
del _name
