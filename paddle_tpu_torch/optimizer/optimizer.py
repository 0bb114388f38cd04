"""Optimizers (`paddle_tpu/optimizer/optimizer.py`; reference
`python/paddle/optimizer/optimizer.py:128` base, `adamw.py`,
`momentum.py`).

Each step updates every parameter leaf by leaf in plain PyTorch, under
no_grad, and writes the result back (`nn.layer.layers._set_data`): the
parameter stays a leaf that needs a gradient, and the next step reads
`p._data` afresh (a cast by `amp.decorate` or `Layer.to` between steps is seen).
The JAX package runs Adam/AdamW as one jitted tree-level program
(`_fused_adam_apply`); the port computes the same per leaf, in the same
order of operations. It has no Pallas kernel, so the port has no
hand-written one either (a fused AdamW is speed work, ROADMAP A8b).

Accumulators are keyed by (name, id(param)) in memory and by the
parameter's position in the parameter list in `state_dict`, so a
`.pdopt` written by either package loads into the other. Stochastically
rounded bf16 moments (`moment_dtype='bfloat16'`) draw their noise from a
torch generator seeded by (step, the parameter's slot): reproducible, and
unbiased like the JAX package's, but not its bits.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.numerics import stochastic_round_bf16
from paddle_tpu_torch.core.tensor import Tensor, _torch_data, no_grad
from paddle_tpu_torch.nn.layer.layers import Parameter, _set_data
from paddle_tpu_torch.optimizer.lr import LRScheduler


def _write(p, new):
    """`new` becomes parameter p's value, in p's dtype: a leaf that needs a
    gradient, as before."""
    _set_data(p, new.to(p.dtype))


def _f32(x):
    """x rounded to float32, as a Python float (a JAX f32 scalar)."""
    return float(np.float32(x))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters) if parameters is not None else None
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators = {}
        self._step_count = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state --------------------------------------------------------------
    def _acc(self, name, param, init=None):
        key = (name, id(param))
        if key not in self._accumulators:
            self._accumulators[key] = torch.zeros_like(param._data) \
                if init is None else init
        return self._accumulators[key]

    def _set_acc(self, name, param, value):
        self._accumulators[(name, id(param))] = value

    def state_dict(self):
        """Accumulators are keyed by the parameter's position in the parameter
        list, which is stable across processes (id() is not)."""
        sd = {}
        id_to_idx = {id(p): i for i, p in enumerate(self._parameter_list or [])}
        for (name, pid), v in self._accumulators.items():
            idx = id_to_idx.get(pid)
            if idx is not None:
                sd[f"{name}@p{idx}"] = Tensor(v) if isinstance(v, torch.Tensor) else v
        sd["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._step_count = state_dict.get("@step", 0)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        params = self._parameter_list or []
        for key, v in state_dict.items():
            if "@p" not in key:
                continue
            name, idx_s = key.rsplit("@p", 1)
            idx = int(idx_s)
            if idx < len(params):
                dev = params[idx]._data.device
                data = v._data.to(dev) if isinstance(v, Tensor) else \
                    _torch_data(np.asarray(v), place=dev)
                self._accumulators[(name, id(params[idx]))] = data

    # -- grad plumbing -------------------------------------------------------
    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    def _apply_grad_clip(self, params_grads):
        clip = self._grad_clip
        if clip is None:
            return params_grads
        from paddle_tpu_torch import nn

        if isinstance(clip, nn.ClipGradByGlobalNorm):
            clipable = [(p, g) for p, g in params_grads if getattr(p, "need_clip", True)]
            if not clipable:
                return params_grads
            total = torch.sqrt(sum(torch.sum(torch.square(g.float())) for _, g in clipable))
            coef = torch.clamp(clip.clip_norm / torch.clamp(total, min=1e-6), max=1.0)
            return [(p, (g * coef.to(g.dtype)) if getattr(p, "need_clip", True) else g)
                    for p, g in params_grads]
        if isinstance(clip, nn.ClipGradByNorm):
            out = []
            for p, g in params_grads:
                if getattr(p, "need_clip", True):
                    n = torch.sqrt(torch.sum(torch.square(g.float())))
                    coef = torch.clamp(clip.clip_norm / torch.clamp(n, min=1e-6), max=1.0)
                    g = g * coef.to(g.dtype)
                out.append((p, g))
            return out
        if isinstance(clip, nn.ClipGradByValue):
            return [(p, torch.clamp(g, clip.min, clip.max) if getattr(p, "need_clip", True) else g)
                    for p, g in params_grads]
        return params_grads

    def _params_grads(self):
        return [(p, p._data.grad) for p in self._parameter_list
                if p._data.grad is not None and not p.stop_gradient]

    # -- the update ---------------------------------------------------------
    def _update_param(self, p, g, lr):
        raise NotImplementedError

    @property
    def _param_groups(self):
        return self._parameter_list

    def step(self):
        assert self._parameter_list is not None, "optimizer created without parameters"
        with no_grad():
            params_grads = self._apply_grad_clip(self._params_grads())
            lr = self.get_lr()
            self._step_count += 1
            for p, g in params_grads:
                plr = lr * p.optimize_attr.get("learning_rate", 1.0) if isinstance(p, Parameter) else lr
                if getattr(p, "regularizer", None) is not None and hasattr(p.regularizer, "coeff"):
                    g = g + p.regularizer.coeff * p._data
                self._update_param(p, g, plr)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        from paddle_tpu_torch.static import graph as _graph

        if _graph.in_static_graph_mode() and \
                _graph.default_main_program().is_variable(loss):
            # static-graph mode: the update is recorded on the Program, and
            # the Executor traces the gradients and the functional rule
            # into the train step (the reference's minimize appends the
            # backward and optimizer ops to the ProgramDesc)
            _graph.default_main_program().record_minimize(self, loss)
            return None, None
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def _apply_optimize(self, loss=None, startup_program=None, params_grads=None):
        self.step()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        _write(p, (p._data - lr * g))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        v = self._acc("velocity", p)
        v = self._momentum * v + g
        self._set_acc("velocity", p, v)
        if self._nesterov:
            _write(p, (p._data - lr * (g + self._momentum * v)))
        else:
            _write(p, (p._data - lr * v))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        m = self._acc("moment", p, torch.full_like(p._data, self._init_acc))
        m = m + g * g
        self._set_acc("moment", p, m)
        _write(p, (p._data - lr * g / (torch.sqrt(m) + self._epsilon)))


class Adadelta(Optimizer):
    """Reference: `python/paddle/optimizer/adadelta.py` (adadelta_ kernel)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        avg_sq = self._rho * avg_sq + (1 - self._rho) * g * g
        upd = (torch.sqrt(avg_upd + self._epsilon)
               / torch.sqrt(avg_sq + self._epsilon)) * g
        avg_upd = self._rho * avg_upd + (1 - self._rho) * upd * upd
        self._set_acc("avg_squared_grad", p, avg_sq)
        self._set_acc("avg_squared_update", p, avg_upd)
        _write(p, (p._data - lr * upd))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        ms = self._acc("mean_square", p)
        ms = self._rho * ms + (1 - self._rho) * g * g
        self._set_acc("mean_square", p, ms)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg = self._rho * mg + (1 - self._rho) * g
            self._set_acc("mean_grad", p, mg)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        v = self._acc("velocity", p)
        v = self._momentum * v + lr * g / denom
        self._set_acc("velocity", p, v)
        _write(p, (p._data - v))




class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, name=None,
                 moment_dtype="float32"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision
        # memory-lean moment storage: 'bfloat16' halves the optimizer state
        # (stochastic-rounding write-back keeps the EMA unbiased; math stays
        # f32)
        if moment_dtype not in ("float32", "bfloat16"):
            raise ValueError("moment_dtype must be 'float32' or 'bfloat16'")
        self._moment_dtype = torch.bfloat16 if moment_dtype == "bfloat16" \
            else torch.float32
        self._is_adamw = False

    def _leaf_decay_cfg(self, p, lr_scale):
        """(extra lr scale, Adam-style L2 coeff, AdamW decoupled decay)."""
        l2 = float(self._weight_decay) if self._weight_decay else 0.0
        return lr_scale, l2, 0.0

    def step(self):
        """The JAX package's `_fused_adam_apply` (`optimizer.py:259`), leaf
        by leaf: the regularizer and Adam's L2 in g's dtype; AdamW's
        decoupled decay as p * (1 - lr * decay), the factor rounded to p's
        dtype, or on the f32 master (multi_precision); the moments in f32
        (stored in `moment_dtype`, bf16 stochastically rounded); the update
        from the f32 master or p in f32; lr and the bias corrections as f32
        scalars."""
        assert self._parameter_list is not None, \
            "optimizer created without parameters"
        with no_grad():
            params_grads = self._apply_grad_clip(self._params_grads())
            lr = _f32(self.get_lr())
            self._step_count += 1
            if not params_grads:
                return
            t = self._step_count
            b1, b2 = self._beta1, self._beta2
            b1t, b2t = _f32(1.0 - b1 ** t), _f32(1.0 - b2 ** t)
            mdt = self._moment_dtype
            bf16_m = mdt == torch.bfloat16
            slots = self.__dict__.setdefault("_sr_slots", {})
            masters = [self._accumulators.get(("master", id(p)))
                       for p, _ in params_grads]
            have_masters = self._multi_precision and \
                all(m is not None for m in masters)
            for (p, g), master in zip(params_grads, masters):
                lr_scale = (float(p.optimize_attr.get("learning_rate", 1.0))
                            if isinstance(p, Parameter) else 1.0)
                reg = 0.0
                if (getattr(p, "regularizer", None) is not None
                        and hasattr(p.regularizer, "coeff")):
                    reg = float(p.regularizer.coeff)
                lr_scale, l2, decay = self._leaf_decay_cfg(p, lr_scale)
                plr = _f32(lr * _f32(lr_scale))
                pd = p._data
                m = self._acc("moment1", p, torch.zeros_like(pd, dtype=mdt))
                v = self._acc("moment2", p, torch.zeros_like(pd, dtype=mdt))
                if reg:
                    g = g + reg * pd.to(g.dtype)
                if l2:
                    g = g + l2 * pd.to(g.dtype)
                keep = _f32(1.0 - _f32(plr * decay)) \
                    if self._is_adamw and decay else 1.0
                if have_masters:
                    # the decay acts on the f32 master (Paddle's AdamW); the
                    # JAX package decays the low-precision copy, which the
                    # master then overwrites (ROADMAP §C)
                    base = master * keep
                else:
                    # p * keep, keep rounded to p's dtype first
                    base = (pd * torch.tensor(keep).to(pd.dtype)).float() \
                        if keep != 1.0 else pd.float()
                g32 = g.float()
                m32 = b1 * m.float() + (1 - b1) * g32
                v32 = b2 * v.float() + (1 - b2) * g32 * g32
                if bf16_m:
                    slot = slots.setdefault(id(p), len(slots))
                    m_store, v_store = (
                        stochastic_round_bf16(x, torch.Generator(
                            device=x.device).manual_seed(
                                (t * 1_000_003 + slot) * 2 + which))
                        for which, x in ((0, m32), (1, v32)))
                else:
                    m_store, v_store = m32, v32
                mhat = m32 / b1t
                vhat = v32 / b2t
                new = base - plr * mhat / (torch.sqrt(vhat) + self._epsilon)
                _write(p, new)
                self._set_acc("moment1", p, m_store)
                self._set_acc("moment2", p, v_store)
                if self._multi_precision:
                    self._set_acc("master", p, new)


class AdamW(Adam):
    """Decoupled weight decay (reference: `python/paddle/optimizer/adamw.py`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, name=None,
                 moment_dtype="float32"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None,
                         grad_clip, lazy_mode, multi_precision, name=name,
                         moment_dtype=moment_dtype)
        self._wd = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._is_adamw = True

    def _leaf_decay_cfg(self, p, lr_scale):
        if self._lr_ratio is not None:
            lr_scale = lr_scale * float(self._lr_ratio(p))
        decay = float(self._wd) if self._wd else 0.0
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            decay = 0.0
        return lr_scale, 0.0, decay


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        if self._weight_decay:
            g = g + float(self._weight_decay) * p._data
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        t = self._step_count
        m = self._beta1 * m + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * u, g.abs())
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        _write(p, (p._data - lr / (1 - self._beta1 ** t) * m / (u + self._epsilon)))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        t = self._step_count
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) else self._wd
        update = r + wd * p._data
        w_norm = torch.linalg.vector_norm(p._data)
        u_norm = torch.linalg.vector_norm(update)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)
        _write(p, (p._data - lr * ratio * update))


class Rprop(Optimizer):
    """Resilient backprop (reference `python/paddle/optimizer/rprop.py` /
    rprop_ kernel): per-element step sizes grow by eta_positive while the
    grad sign persists and shrink by eta_negative on a sign flip (the
    flip step is skipped)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _update_param(self, p, g, lr):
        g32 = g.float()
        step = self._acc("step_size", p,
                         torch.full_like(p._data, float(lr), dtype=torch.float32))
        prev = self._acc("prev_grad", p, torch.zeros_like(p._data, dtype=torch.float32))
        sign = torch.sign(g32 * prev)
        step = torch.clamp(
            torch.where(sign > 0, step * self._eta_pos,
                        torch.where(sign < 0, step * self._eta_neg, step)),
            self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)  # skip the flip step
        self._set_acc("step_size", p, step)
        self._set_acc("prev_grad", p, g_eff)
        _write(p, (p._data.float()
                   - step * torch.sign(g_eff)))


class ASGD(Optimizer):
    """Averaged SGD (reference `python/paddle/optimizer/asgd.py` / asgd_
    kernel): SGD steps plus a running average of the last `batch_num`
    gradients used as the effective gradient."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._n = max(int(batch_num), 1)

    def _update_param(self, p, g, lr):
        g32 = g.float()
        if self._weight_decay:
            g32 = g32 + float(self._weight_decay) * p._data.float()
        d = self._acc("d", p, torch.zeros_like(p._data, dtype=torch.float32))
        ys = self._acc("ys", p, p._data.new_zeros(
            (self._n,) + tuple(p._data.shape), dtype=torch.float32))
        slot = (self._step_count - 1) % self._n
        old = ys[slot]
        d = d - old + g32
        ys = ys.clone()
        ys[slot] = g32
        self._set_acc("d", p, d)
        self._set_acc("ys", p, ys)
        denom = min(self._step_count, self._n)
        _write(p, (p._data.float() - lr * d / denom))


class NAdam(Optimizer):
    """Nesterov Adam (reference `python/paddle/optimizer/nadam.py`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update_param(self, p, g, lr):
        g32 = g.float()
        if self._weight_decay:
            g32 = g32 + float(self._weight_decay) * p._data.float()
        t = self._step_count
        mu_t = self._b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        prod = self._acc("mu_prod", p, p._data.new_ones((), dtype=torch.float32))
        prod_t = prod * mu_t
        self._set_acc("mu_prod", p, prod_t)
        m = self._acc("m", p, torch.zeros_like(p._data, dtype=torch.float32))
        v = self._acc("v", p, torch.zeros_like(p._data, dtype=torch.float32))
        m = self._b1 * m + (1 - self._b1) * g32
        v = self._b2 * v + (1 - self._b2) * g32 * g32
        self._set_acc("m", p, m)
        self._set_acc("v", p, v)
        mhat = (mu_t1 * m / (1 - prod_t * mu_t1)
                + (1 - mu_t) * g32 / (1 - prod_t))
        vhat = v / (1 - self._b2 ** t)
        _write(p, (p._data.float()
                   - lr * mhat / (torch.sqrt(vhat) + self._eps)))


class RAdam(Optimizer):
    """Rectified Adam (reference `python/paddle/optimizer/radam.py`): the
    variance-rectification term switches between SGD-with-momentum and
    Adam as the second-moment estimate becomes reliable."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        import math

        g32 = g.float()
        if self._weight_decay:
            g32 = g32 + float(self._weight_decay) * p._data.float()
        t = self._step_count
        m = self._acc("m", p, torch.zeros_like(p._data, dtype=torch.float32))
        v = self._acc("v", p, torch.zeros_like(p._data, dtype=torch.float32))
        m = self._b1 * m + (1 - self._b1) * g32
        v = self._b2 * v + (1 - self._b2) * g32 * g32
        self._set_acc("m", p, m)
        self._set_acc("v", p, v)
        rho_inf = 2.0 / (1 - self._b2) - 1
        b2t = self._b2 ** t
        rho_t = rho_inf - 2.0 * t * b2t / (1 - b2t)
        mhat = m / (1 - self._b1 ** t)
        if rho_t > 5.0:
            r = math.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
            vhat = torch.sqrt(v / (1 - b2t))
            upd = r * mhat / (vhat + self._eps)
        else:
            upd = mhat
        _write(p, (p._data.float() - lr * upd))


class LBFGS(Optimizer):
    """L-BFGS (reference `python/paddle/optimizer/lbfgs.py`): closure-based
    full-batch quasi-Newton with a two-loop recursion over the last
    history_size (s, y) pairs and optional strong-Wolfe backtracking line
    search. step(closure) re-evaluates the closure; parameters update in
    place like the reference."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._max_iter = max_iter
        self._tol_g = tolerance_grad
        self._tol_x = tolerance_change
        self._hist = history_size
        self._ls = line_search_fn
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._s, self._y = [], []

    def _flat(self, arrs):
        return torch.cat([a.detach().reshape(-1).float() for a in arrs])

    def _gather_grads(self):
        return self._flat([
            p._data.grad if p._data.grad is not None
            else torch.zeros_like(p._data)  # unused param: zero direction
            for p in self._parameter_list])

    def _set_params(self, flat):
        i = 0
        with no_grad():
            for p in self._parameter_list:
                n = p._data.numel()
                _write(p, flat[i:i + n].reshape(p._data.shape))
                i += n

    def _eval(self, closure, flat_x):
        self._set_params(flat_x)
        for p in self._parameter_list:
            p.grad = None
        loss = closure()
        return float(loss), self._gather_grads()

    def step(self, closure):
        x = self._flat([p._data for p in self._parameter_list])
        self._n_eval = 1
        loss, g = self._eval(closure, x)
        lr = float(self.get_lr())
        for _ in range(self._max_iter):
            if self._n_eval >= self._max_eval:
                break
            if float(g.abs().max()) <= self._tol_g:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / float(torch.dot(y, s))
                a = rho * float(torch.dot(s, q))
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y:
                y_l, s_l = self._y[-1], self._s[-1]
                gamma = float(torch.dot(s_l, y_l)) / float(torch.dot(y_l, y_l))
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * float(torch.dot(y, q))
                q = q + (a - b) * s
            d = -q
            # line search: strong-wolfe-flavored backtracking on the
            # Armijo condition (the reference's 'strong_wolfe' option)
            t = lr
            gtd = float(torch.dot(g, d))
            if gtd > -1e-16:
                break  # not a descent direction; restart memory
            new_loss, new_g, new_x = loss, g, x
            for _ in range(20 if self._ls else 1):
                cand = x + t * d
                cl, cg = self._eval(closure, cand)
                self._n_eval += 1
                if not self._ls or cl <= loss + 1e-4 * t * gtd:
                    new_loss, new_g, new_x = cl, cg, cand
                    break
                t *= 0.5
            s_vec = new_x - x
            y_vec = new_g - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self._hist:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(s_vec.abs().max()) <= self._tol_x:
                loss, g, x = new_loss, new_g, new_x
                break
            loss, g, x = new_loss, new_g, new_x
        self._set_params(x)
        return Tensor(torch.tensor(loss, dtype=torch.float32, device=x.device))
