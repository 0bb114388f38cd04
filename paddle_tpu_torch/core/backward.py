"""Backward over torch's autograd engine (`paddle_tpu/core/backward.py`).

The JAX package keeps its own dependency-counted queue over `jax.vjp`
closures (reference `paddle/fluid/eager/backward.cc:106` RunBackward);
torch already has that engine:
  - `run_backward` is `torch.autograd.backward`: gradients accumulate into
    the leaves' `.grad`; `retain_graph` and `create_graph` pass through;
    an output with more than one element needs an explicit gradient;
  - `grad` (paddle.grad, reference `eager/general_grad.h`) is
    `torch.autograd.grad`, which writes no `.grad`;
  - tensor hooks are `torch.Tensor.register_hook`.
"""

from __future__ import annotations

import itertools

import torch

from paddle_tpu_torch.core.tensor import Tensor, _as_torch

_hook_ids = itertools.count(1)


class RemovableHandle:
    def __init__(self, tensor, hook_id):
        self._tensor = tensor
        self._hook_id = hook_id

    def remove(self):
        hooks = self._tensor._hooks or {}
        entry = hooks.pop(self._hook_id, None)
        if entry is not None and entry[1] is not None:
            entry[1].remove()


def register_tensor_hook(tensor, hook):
    """Call `hook(Tensor grad)` on the gradient reaching `tensor`; a
    non-None return (Tensor or array) replaces it."""
    def torch_hook(g):
        out = hook(Tensor(g))
        return None if out is None else _as_torch(out, like=g)

    hook_id = next(_hook_ids)
    if tensor._hooks is None:
        tensor._hooks = {}
    handle = (tensor._data.register_hook(torch_hook)
              if tensor._data.requires_grad else None)
    tensor._hooks[hook_id] = [torch_hook, handle]
    return RemovableHandle(tensor, hook_id)


def run_backward(tensors, grad_tensors=None, retain_graph=False,
                 create_graph=False):
    """Seed gradients on `tensors` and accumulate into every reachable
    leaf's `.grad`. A tensor that needs no gradient is skipped; one with
    more than one element and no gradient given raises RuntimeError."""
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if not t._data.requires_grad:
            continue
        if g is None:
            if t.size != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs; "
                    f"got shape {t.shape}")
            g = torch.ones_like(t._data)
        else:
            g = _as_torch(g, like=t._data)
        roots.append(t._data)
        seeds.append(g)
    if roots:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph,
                                create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    a list of Tensors (None for an input the outputs do not reach, with
    allow_unused=True; RuntimeError without). No `.grad` is written."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and \
            not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outs)
    roots, seeds = [], []
    for t, g in zip(outs, grad_outputs):
        if not t._data.requires_grad:
            continue
        if g is None:
            if t.size != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs; "
                    f"got shape {t.shape}")
            g = torch.ones_like(t._data)
        roots.append(t._data)
        seeds.append(_as_torch(g, like=t._data))
    live = [i for i, t in enumerate(ins) if t._data.requires_grad]
    got = [None] * len(ins)
    if roots and live:
        res = torch.autograd.grad(
            roots, [ins[i]._data for i in live], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError("one of the input tensors received no gradient; "
                           "pass allow_unused=True to permit this")
    return [None if g is None else Tensor(g) for g in got]
