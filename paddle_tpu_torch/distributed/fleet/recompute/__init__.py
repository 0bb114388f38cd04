"""Activation recomputation (`paddle_tpu/distributed/fleet/recompute/
__init__.py`; reference `python/paddle/distributed/fleet/recompute/
recompute.py:128`, the RecomputeFunction PyLayer, and the user API at
:463).

`recompute(fn, *args)` runs `fn` without keeping its activations and, in
backward, runs it again under the generator states it saw (the framework
generator of the inputs' device and the model-parallel tracker's states)
and in the auto_cast scope it ran in, so the replay draws the same dropout
bits and casts as the forward did. The replayed graph is
backpropagated at once: gradients reach the replay's inputs, returned to
the outer graph, and every parameter `fn` reads through its closure,
which accumulate into their `.grad` as in the reference. So the kernels
of `fn` run twice forward and once backward: in a Llama decoder layer, B1
and B9 again in the replay, then B2/B3 and B10. As in the reference's
reentrant form, the gradients of closure parameters reach `.grad`
(`backward`), not `paddle.grad`'s outputs.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.autograd import PyLayer
from paddle_tpu_torch.core import tensor as _tmod
from paddle_tpu_torch.core.backward import run_backward
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import random as _random
from paddle_tpu_torch.nn.functional.flash_attention import \
    routes_for_backward as _routes_for_backward

__all__ = ["recompute", "RecomputeFunction", "recompute_sequential"]


def _rng_device(args):
    for a in args:
        if isinstance(a, Tensor):
            return a._data.device
    return None


class RecomputeFunction(PyLayer):

    @staticmethod
    def forward(ctx, run_function, preserve_rng_state, *args):
        ctx.run_function = run_function
        ctx.preserve_rng_state = preserve_rng_state
        ctx.inputs = args[:-1]   # the last is the record anchor
        # the auto_cast scope the forward ran in, for the replay
        ctx.amp_state = getattr(_tmod.amp_local, "state", None)
        if preserve_rng_state:
            from paddle_tpu_torch.distributed.fleet.layers.mpu.random import (
                get_rng_state_tracker,
            )

            ctx.device = _rng_device(ctx.inputs)
            ctx.fw_rng_state = _random.get_rng_state(ctx.device)
            ctx.fw_tracker_states = get_rng_state_tracker().get_states_tracker()
        # attention routes as in the replay, which runs with grad
        with _routes_for_backward():
            return run_function(*ctx.inputs)

    @staticmethod
    def backward(ctx, *grads):
        # replay the forward with grad enabled under the saved RNG states
        detached = []
        for a in ctx.inputs:
            if isinstance(a, Tensor):
                d = a._data.detach()
                if not a.stop_gradient:
                    d.requires_grad_(True)
                detached.append(Tensor(d, stop_gradient=a.stop_gradient))
            else:
                detached.append(a)

        if ctx.preserve_rng_state:
            from paddle_tpu_torch.distributed.fleet.layers.mpu.random import (
                get_rng_state_tracker,
            )

            cur = _random.get_rng_state(ctx.device)
            _random.set_rng_state(ctx.fw_rng_state, ctx.device)
            tracker = get_rng_state_tracker()
            cur_tracker = tracker.get_states_tracker()
            tracker.set_states_tracker(ctx.fw_tracker_states)
        amp_state = getattr(_tmod.amp_local, "state", None)
        _tmod.amp_local.state = ctx.amp_state
        try:
            with torch.enable_grad():
                outputs = ctx.run_function(*detached)
        finally:
            _tmod.amp_local.state = amp_state
            if ctx.preserve_rng_state:
                _random.set_rng_state(cur, ctx.device)
                tracker.set_states_tracker(cur_tracker)

        outs = list(outputs) if isinstance(outputs, (tuple, list)) else [outputs]
        seeds, gseeds = [], []
        for o, g in zip(outs, grads):
            if isinstance(o, Tensor) and not o.stop_gradient and \
                    g is not None:
                seeds.append(o)
                gseeds.append(g)
        tensor_inputs = [d for d in detached if isinstance(d, Tensor)]
        with torch.enable_grad():
            run_backward(seeds, gseeds, retain_graph=False)
        # one gradient a Tensor input, and none for the record anchor
        return tuple(Tensor(t._data.grad) if t._data.grad is not None
                     else None for t in tensor_inputs) + (None,)


def recompute(function, *args, **kwargs):
    """Reference recompute.py:463. kwargs: use_reentrant, preserve_rng_state."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    if kwargs:
        raise ValueError(f"unexpected kwargs {list(kwargs)}")
    if not _tmod.is_grad_enabled():
        return function(*args)
    # the parameters enter through the closure, not as arguments: an empty
    # tensor that needs a gradient makes autograd record the node even
    # when no argument needs one
    anchor = Tensor(torch.empty(0, requires_grad=True), stop_gradient=False)
    return RecomputeFunction.apply(function, preserve, *args, anchor)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Reference incubate recompute_sequential: chunk a Sequential."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    chunk = max(1, len(funcs) // max(1, segments))
    out = args
    for i in range(0, len(funcs), chunk):
        seg = funcs[i:i + chunk]

        def run_seg(*xs, _seg=seg):
            y = xs
            for f in _seg:
                y = f(*y) if isinstance(y, tuple) else f(y)
            return y

        out = recompute(run_seg, *(out if isinstance(out, tuple) else (out,)), **kwargs)
    return out
