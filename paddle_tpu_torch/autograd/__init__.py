"""paddle.autograd of the port (`paddle_tpu/autograd/__init__.py`; reference
`python/paddle/autograd/`): backward, PyLayer, jacobian and hessian over
torch's autograd engine."""

import numpy as np
import torch

from paddle_tpu_torch.core.backward import run_backward, grad  # noqa: F401
from paddle_tpu_torch.core.tensor import (  # noqa: F401
    Tensor, enable_grad, is_grad_enabled, no_grad, set_grad_enabled)


def backward(tensors, grad_tensors=None, retain_graph=False):
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is not None and \
            not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph)


class PyLayerContext:
    """reference: `python/paddle/autograd/py_layer.py` PyLayerContext."""

    def __init__(self):
        self._saved = []
        self.not_inplace_tensors = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return self._saved

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        pass

    def set_materialize_grads(self, value):
        self.materialize_grads = value


class _PyLayerFunction(torch.autograd.Function):
    """The torch node of one PyLayer call: forward and backward run the
    user's over port Tensors with the PyLayerContext."""

    @staticmethod
    def forward(tctx, layer, pctx, kwargs, *flat):
        args = [Tensor(a) if isinstance(a, torch.Tensor) else a
                for a in flat]
        out = layer.forward(pctx, *args, **kwargs)
        tctx.multi = isinstance(out, (tuple, list))
        outs = list(out) if tctx.multi else [out]
        tctx.layer, tctx.pctx = layer, pctx
        tctx.tensor_pos = [i for i, a in enumerate(flat)
                           if isinstance(a, torch.Tensor)]
        tctx.n_flat = len(flat)
        return tuple(o._data if isinstance(o, Tensor) else o for o in outs)

    @staticmethod
    def backward(tctx, *grads):
        cts = [Tensor(g) for g in grads]
        with torch.no_grad():
            res = tctx.layer.backward(tctx.pctx, *cts)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        flat = [None] * tctx.n_flat
        for pos, g in zip(tctx.tensor_pos, res):
            flat[pos] = g._data if isinstance(g, Tensor) else g
        return (None, None, None, *flat)


class PyLayer:
    """User-defined autograd op (reference
    `python/paddle/autograd/py_layer.py`): `forward(ctx, *args)` and
    `backward(ctx, *grads)` over eager Tensors, recorded as one
    `torch.autograd.Function` node. `backward` returns one gradient per
    Tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        flat = [a._data if isinstance(a, Tensor) else a for a in args]
        outs = _PyLayerFunction.apply(cls, PyLayerContext(), kwargs, *flat)
        wrapped = [Tensor(o) if isinstance(o, torch.Tensor) else o
                   for o in outs]
        return tuple(wrapped) if len(wrapped) != 1 else wrapped[0]


class saved_tensors_hooks:
    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def _numel(shape):
    return int(np.prod(shape)) if len(shape) else 1


def jacobian(ys, xs, batch_axis=None):
    """Dense Jacobian d(ys)/d(xs) (reference `paddle.autograd.jacobian`):
    one row per element of ys, each a vjp through the recorded graph with
    create_graph, so the result is itself differentiable. The reference's
    API takes computed tensors, not a function, so this is the engine
    under `torch.autograd.functional.jacobian`, not that function. ys, xs:
    Tensors (or lists) -> [ys.size, xs.size] (nested lists for lists); with
    batch_axis=0 a [B, ys_row, xs_row] per-sample Jacobian."""
    from paddle_tpu_torch.ops.manipulation import stack

    ys_list = ys if isinstance(ys, (list, tuple)) else [ys]
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]

    def one(y, x):
        ysz = _numel(y.shape)
        rows = []
        for i in range(ysz):
            seed = torch.zeros(ysz, dtype=y.dtype, device=y.place)
            seed[i] = 1.0
            gi = grad([y], [x], grad_outputs=[Tensor(seed.reshape(y.shape))],
                      retain_graph=True, create_graph=True,
                      allow_unused=True)[0]
            if gi is None:
                gi = Tensor(torch.zeros(x.shape, dtype=x.dtype,
                                        device=x.place))
            rows.append(gi.reshape([-1]))
        out = stack(rows, axis=0)
        if batch_axis == 0:
            # per-sample Jacobian: the b-th diagonal block of [B, M, B, N]
            B = y.shape[0]
            M = ysz // B if B else 0
            N = _numel(x.shape) // x.shape[0] if x.ndim else 1
            blocks = out._data.reshape(B, M, x.shape[0], N)
            return Tensor(torch.diagonal(blocks, dim1=0, dim2=2)
                          .movedim(-1, 0))
        return out

    if isinstance(ys, (list, tuple)) or isinstance(xs, (list, tuple)):
        return [[one(y, x) for x in xs_list] for y in ys_list]
    return one(ys, xs)


def hessian(ys, xs, batch_axis=None):
    """Dense Hessian of a scalar ys with respect to xs (reference
    `paddle.autograd.hessian`): the Jacobian of the create_graph
    gradient."""
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    ys_list = ys if isinstance(ys, (list, tuple)) else [ys]
    if sum(_numel(y.shape) for y in ys_list) != 1:
        raise ValueError("hessian needs a scalar ys")
    gs = grad([ys_list[0]], list(xs_list), retain_graph=True,
              create_graph=True, allow_unused=True)

    def block(g, xi, xj):
        if g is None:
            return Tensor(torch.zeros(_numel(xi.shape), _numel(xj.shape),
                                      dtype=xj.dtype, device=xj.place))
        return jacobian(g, xj)

    outs = [[block(g, xi, xj) for xj in xs_list]
            for g, xi in zip(gs, xs_list)]
    return outs if isinstance(xs, (list, tuple)) else outs[0][0]
