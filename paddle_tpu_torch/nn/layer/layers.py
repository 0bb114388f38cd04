"""Layer base class (`paddle_tpu/nn/layer/layers.py`; reference
`python/paddle/nn/layer/layers.py:353` Layer, with parameters, sublayers,
buffers, hooks and state_dict semantics).

A `Layer` is not a `torch.nn.Module`: its parameters are port Tensors
(`Parameter`), each over a leaf torch tensor that needs a gradient, kept
in the JAX package's layouts and structured names, so a state dict carries
across the two packages with no transpose. `parameters()` lists them in
the JAX package's order (sublayers depth first, each layer's own in the
order they were assigned): optimizer state is keyed by that position.

A parameter is created on the creation place (`framework.device.place`):
the card unless the caller chose the CPU; without a card and without
`set_device('cpu')` creation raises. `to(device=...)` moves parameters
and buffers; a cast (`to(dtype=...)`, `astype`, `float`/`half`/
`bfloat16`) rebinds each one's data to a new leaf that still needs a
gradient (`_set_data`), so an optimizer reads `p._data` afresh each step.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, _torch_data
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes


def _set_data(t, new):
    """Make the torch tensor `new` the value of Tensor `t`, cutting its
    history: a tensor that needs a gradient becomes a leaf that needs one,
    keeping its gradient when shape, dtype and device hold."""
    old = t._data
    new = new.detach()
    if old.requires_grad:
        new.requires_grad_(True)
        if old.is_leaf and old.grad is not None and \
                (new.shape, new.dtype, new.device) == \
                (old.shape, old.dtype, old.device):
            new.grad = old.grad
    t._data = new
    t._attach_hooks()


class Parameter(Tensor):
    """Trainable tensor (reference: `python/paddle/base/framework.py` EagerParamBase)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "do_model_average",
                 "need_clip", "is_distributed", "initializer", "_init_fn")

    def __init__(self, data, trainable=True, name=None):
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True
        self.is_distributed = False
        self.persistable = True


class ParamAttr:
    """reference: `python/paddle/base/param_attr.py`"""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


_name_counters = collections.defaultdict(int)


def _unique_name(prefix):
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix] - 1}"


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        object.__setattr__(self, "_parameters", collections.OrderedDict())
        object.__setattr__(self, "_sub_layers", collections.OrderedDict())
        object.__setattr__(self, "_buffers", collections.OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names_set", set())
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._full_name = _unique_name(name_scope or self.__class__.__name__.lower())
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._casted_by_pure_fp16 = False

    # -- naming -------------------------------------------------------------
    def full_name(self):
        return self._full_name

    # -- parameter creation -------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from paddle_tpu_torch.nn import initializer as I

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtypes.convert_dtype(dtype) or self._dtype
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(shape, dtype)
        p = Parameter(data, trainable=attr.trainable, name=attr.name or _unique_name("param"))
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, dtype=None):
        return Tensor(torch.zeros([], dtype=dtypes.convert_dtype(dtype)
                                  or self._dtype, device=_device.place()))

    # -- registration -------------------------------------------------------
    def add_parameter(self, name, parameter):
        if parameter is None:
            self._parameters[name] = None
        else:
            self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names_set.add(name)
        elif tensor is not None:
            tensor.persistable = True
        return tensor

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            params[name] = value
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            layers[name] = value
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = []
        for store in ("_parameters", "_sub_layers", "_buffers"):
            extra += list(self.__dict__.get(store, {}).keys())
        return super().__dir__() + extra

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for layer_prefix, layer in self.named_sublayers(prefix=prefix, include_self=True):
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (layer_prefix + "." + name if layer_prefix else name), p
            if not include_sublayers:
                break

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            p = prefix + "." + name if prefix else name
            yield from layer.named_sublayers(prefix=p, include_self=True)

    def children(self):
        return [l for _, l in self.named_children()]

    def named_children(self):
        for name, l in self._sub_layers.items():
            if l is not None:
                yield name, l

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for layer_prefix, layer in self.named_sublayers(prefix=prefix, include_self=True):
            for name, b in layer._buffers.items():
                if b is None:
                    continue
                yield (layer_prefix + "." + name if layer_prefix else name), b
            if not include_sublayers:
                break

    def apply(self, fn):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # -- modes --------------------------------------------------------------
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        return self

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call ---------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        return self._call_with_forward(self.forward, *inputs, **kwargs)

    def _call_with_forward(self, forward, *inputs, **kwargs):
        """__call__ semantics over an arbitrary forward implementation
        (dy2static substitutes a converted forward; hooks stay in force)."""
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, inputs, outputs)
            if res is not None:
                outputs = res
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self._sub_layers.items():
            rep = repr(layer).split("\n")
            head = f"({name}): {rep[0]}"
            lines += [head] + ["  " + r for r in rep[1:]]
        main = f"{type(self).__name__}({extra}"
        if lines:
            return main + "\n  " + "\n  ".join(lines) + "\n)"
        return main + ")"

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, structured_name_prefix="",
                   use_hook=True, keep_vars=True):
        dest = collections.OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(prefix=structured_name_prefix.rstrip(".")):
            dest[name] = p
        for name, b in self.named_buffers(prefix=structured_name_prefix.rstrip(".")):
            layer_name = name.rsplit(".", 1)[-1]
            owner = self
            if "." in name:
                for part in name.split(".")[:-1]:
                    owner = owner._sub_layers.get(part, owner)
            if layer_name not in getattr(owner, "_non_persistable_buffer_names_set", set()):
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k in own:
                tgt = own[k]
                arr = v._data if isinstance(v, Tensor) else _torch_data(
                    np.asarray(v), place=tgt.place)
                if tuple(tgt.shape) != tuple(arr.shape):
                    raise ValueError(f"shape mismatch for {k}: {tgt.shape} vs {list(arr.shape)}")
                _set_data(tgt, arr.to(tgt.place, tgt.dtype))
            else:
                unexpected.append(k)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device movement -------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        if device is not None:
            dev = _device.place(device)
            for t in self.parameters() + self.buffers():
                if t.place != dev:
                    _set_data(t, t._data.to(dev))
        if dtype is not None:
            self._to_dtype(dtypes.convert_dtype(dtype))
        return self

    def astype(self, dtype):
        self._to_dtype(dtypes.convert_dtype(dtype))
        return self

    def _to_dtype(self, dt, only_float=True):
        for _, p in self.named_parameters():
            if not only_float or dtypes.is_floating_point(p.dtype):
                _set_data(p, p._data.to(dt))
        for _, b in self.named_buffers():
            if not only_float or dtypes.is_floating_point(b.dtype):
                _set_data(b, b._data.to(dt))
        for l in self.sublayers(include_self=True):
            l._dtype = dt

    def float(self):
        self._to_dtype(torch.float32)
        return self

    def half(self):
        self._to_dtype(torch.float16)
        return self

    def bfloat16(self):
        self._to_dtype(torch.bfloat16)
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()
