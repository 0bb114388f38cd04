"""Static-graph mode: deferred programs over the dispatch waist
(`paddle_tpu/static/graph.py`; reference `python/paddle/base/framework.py:5890`
Program and `base/executor.py:1734` Executor.run).

  build:  `paddle.enable_static()` + `static.data(...)` make Variables:
          Tensors whose data is a fake tensor (`FakeTensorMode`, the
          counterpart of the JAX package's `jax.ShapeDtypeStruct`). Every op
          on one reaches the dispatch waist, which records (fn, input refs,
          outputs) into the active Program and gets the outputs' shapes
          from a run of fn over fake tensors (`jax.eval_shape`'s role): no
          flop runs at build. Layer parameters stay real Tensors and are
          recorded as externals (the Scope): a run re-reads them, so eager
          code and static programs share parameter storage.
  run:    `Executor.run(feed=..., fetch_list=...)` replays the tape as one
          function from (feeds, externals) to fetches, traced once for each
          feed signature (`make_fx` over fake tensors; a kernel's custom
          operator stays one node). On a CUDA device the traced graph runs
          through `torch.compile` (inductor), on the CPU as it is.
          `optimizer.minimize(loss)` turns the function into a train step:
          the gradients of the trainable externals (`torch.autograd.grad`
          in the traced function, so the backward is part of the graph)
          and a functional optimizer update in the JAX package's order
          (SGD, Momentum, Adam, AdamW, with their L2 decay and Nesterov;
          `minimize` raises on an option the update lacks: grad_clip,
          lr_ratio, apply_decay_param_fun, bf16 moments, a parameter's
          own rate or regularizer), whose new parameters are written back
          into the shared Tensors after each run. The learning rate is an input of the step, read
          from the optimizer (a scheduler asked afresh) at every run.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as _pytree
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.fx.experimental.proxy_tensor import make_fx

from paddle_tpu_torch.core import tensor as _tc
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "enable_static_graph",
           "disable_static_graph", "in_static_graph_mode", "gradients"]

_fake_mode = None


def _mode():
    """The one fake mode every Program records under (Variables of two
    programs must not mix, which `Program.ref_for` checks)."""
    global _fake_mode
    if _fake_mode is None:
        _fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    return _fake_mode


def _is_abstract(t):
    return is_fake(t._data)


class Program:
    """Deferred op tape (the reference's Program/ProgramDesc role)."""

    def __init__(self):
        self.ops = []          # (fn, refs, first_node, nout, name)
        self.feeds = {}        # name -> fake tensor (declared shape/dtype)
        self.feed_order = []
        self.externals = []    # real Tensors read at run (params/consts)
        self._ext_ids = {}     # id(torch data) -> ext index
        self._refs = {}        # id(fake data) -> ref of a Variable
        self._pins = []        # keep the fake data alive so ids stay unique
        self.node_avals = []
        self._grad_entries = {}  # node id -> (target_ref, in_refs, j)
        self.opt = None        # (optimizer, loss_ref) from minimize()
        self._run_cache = {}
        self.random_seed = None

    # -- build-time recording (called from the waist) ----------------------
    def ref_for(self, t):
        d = t._data
        ref = self._refs.get(id(d))
        if ref is not None:
            return ref
        if is_fake(d):
            raise RuntimeError(
                "abstract Variable from another Program used here")
        idx = self._ext_ids.get(id(d))
        if idx is None:
            idx = len(self.externals)
            self.externals.append(t)
            self._ext_ids[id(d)] = idx
            self._pins.append(d)
        return ("ext", idx)

    def _variable(self, fake, ref, name=None):
        v = Tensor(fake, name=name)
        self._refs[id(fake)] = ref
        self._pins.append(fake)
        return v

    def record(self, fn, tensors, name):
        if not any(_is_abstract(t) for t in tensors):
            return None  # concrete subexpression: let eager run it
        refs = [self.ref_for(t) for t in tensors]
        with _mode(), torch.no_grad():
            out = fn(*[t._data for t in tensors])
        multi = isinstance(out, (tuple, list))
        avals = list(out) if multi else [out]
        base = len(self.node_avals)
        self.ops.append((fn, refs, base, len(avals), name))
        outs = []
        for j, av in enumerate(avals):
            if not is_fake(av):
                # an output that does not depend on the inputs' values
                # (a constant the op made): recorded like the others
                av = _mode().from_tensor(av)
            self.node_avals.append(av)
            outs.append(self._variable(av, ("n", base + j)))
        self._invalidate()
        return outs if multi else outs[0]

    def add_feed(self, name, shape, dtype):
        shp = tuple(1 if (s is None or s == -1) else int(s) for s in shape)
        dt = _dtypes.convert_dtype(dtype)
        with _mode():
            av = torch.empty(shp, dtype=dt, device=_device.place())
        self.feeds[name] = av
        self.feed_order.append(name)
        self._invalidate()
        return self._variable(av, ("feed", name), name=name)

    def record_minimize(self, optimizer, loss):
        ref = self._refs.get(id(loss._data))
        if ref is None:
            raise ValueError("minimize(loss): loss is not part of this "
                             "static Program")
        check_functional(optimizer, [t for t in self.externals
                                     if not t.stop_gradient])
        self.opt = (optimizer, ref)
        self._invalidate()

    def record_gradients(self, targets, inputs):
        """static.gradients: new Variables holding d(target)/d(input),
        computed at run by differentiating the prefix replay."""
        tgt = targets[0] if isinstance(targets, (list, tuple)) else targets
        t_ref = self._refs.get(id(tgt._data))
        if t_ref is None:
            raise ValueError("gradients(): target is not in this Program")
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        in_refs = [self.ref_for(v) for v in ins]
        outs = []
        base = len(self.node_avals)
        for j, v in enumerate(ins):
            with _mode():
                av = torch.empty(tuple(v.shape), dtype=v.dtype,
                                 device=v._data.device)
            self.node_avals.append(av)
            self._grad_entries[base + j] = (t_ref, in_refs, j)
            outs.append(self._variable(av, ("n", base + j)))
        self.ops.append(("__grad__", in_refs, base, len(ins), "gradients"))
        self._invalidate()
        return outs

    def is_variable(self, t):
        return id(t._data) in self._refs

    def _invalidate(self):
        self._run_cache.clear()

    # -- compat surface -----------------------------------------------------
    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self

    def all_parameters(self):
        return [t for t in self.externals if not t.stop_gradient]

    @property
    def blocks(self):
        return [self]

    # -- run time ------------------------------------------------------------
    def _replay(self, feed_env, ext_vals, upto=None):
        env = dict(feed_env)
        for i, a in enumerate(ext_vals):
            env[("ext", i)] = a
        n_ops = len(self.ops) if upto is None else upto
        for fn, refs, base, nout, name in self.ops[:n_ops]:
            if fn == "__grad__":
                t_ref, in_refs, _ = self._grad_entries[base]
                vals = [env[r].detach().requires_grad_(True)
                        for r in in_refs]
                env2 = dict(env)
                env2.update(zip(in_refs, vals))
                with torch.enable_grad():
                    tgt = self._replay_from(env2, base, t_ref,
                                            frozen=set(in_refs))
                    grads = torch.autograd.grad(tgt.float().sum(), vals,
                                                allow_unused=True)
                for j in range(nout):
                    g = grads[j]
                    env[("n", base + j)] = torch.zeros_like(vals[j]) \
                        if g is None else g
                continue
            out = fn(*[env[r] for r in refs])
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for j, o in enumerate(outs):
                env[("n", base + j)] = o
        return env

    def _replay_from(self, env, base_limit, want, frozen=()):
        """Re-run the prefix tape; refs in `frozen` are the inputs a
        __grad__ entry differentiates and keep their injected values."""
        for fn, refs, base, nout, name in self.ops:
            if base >= base_limit:
                break
            if fn == "__grad__":
                continue
            out = fn(*[env[r] for r in refs])
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for j, o in enumerate(outs):
                ref = ("n", base + j)
                if ref not in frozen:
                    env[ref] = o
        return env[want]

    def step_function(self, feed_names, fetch_refs, train):
        """The function a run replays: fn(feeds, ext_vals) -> fetches, or
        with minimize() fn(feeds, ext_vals, slots, lr) -> (fetches, new
        externals, new slots)."""
        if not train or self.opt is None:
            def run_fn(feed_arrays, ext_vals):
                env = {("feed", n): a for n, a in
                       zip(feed_names, feed_arrays)}
                with torch.no_grad():
                    env = self._replay(env, ext_vals)
                return [env[r] for r in fetch_refs]

            return run_fn

        optimizer, loss_ref = self.opt
        train_mask = [not t.stop_gradient for t in self.externals]

        def step_fn(feed_arrays, ext_vals, slots, lr):
            env0 = {("feed", n): a for n, a in zip(feed_names, feed_arrays)}
            train_vals = [a.detach().requires_grad_(True)
                          for a, m in zip(ext_vals, train_mask) if m]
            vals, it = [], iter(train_vals)
            for a, m in zip(ext_vals, train_mask):
                vals.append(next(it) if m else a.detach())
            with torch.enable_grad():
                env = self._replay(env0, vals)
                loss = env[loss_ref].float()
                grads = torch.autograd.grad(loss, train_vals,
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(train_vals, grads)]
            with torch.no_grad():
                new_train, new_slots = _functional_step(
                    optimizer, [p.detach() for p in train_vals], grads,
                    slots, lr)
            new_ext, it = [], iter(new_train)
            for a, m in zip(ext_vals, train_mask):
                new_ext.append(next(it) if m else a)
            return ([env[r].detach() for r in fetch_refs], new_ext,
                    new_slots)

        return step_fn

    def compile(self, feed_names, fetch_refs, train, example):
        """The step function traced on `example` (its arguments) with
        `make_fx` over fake tensors: run through `torch.compile` on a CUDA
        device, as it is on the CPU."""
        fn = self.step_function(feed_names, fetch_refs, train)
        # a real tensor an op closes over (a constant it made at build)
        # is a constant of the trace
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*example)
        if any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in _pytree.tree_leaves(example)):
            return torch.compile(gm)
        return gm


# -- functional optimizer updates (the static-mode optimizer ops the
# -- reference's minimize() appends to the program) --------------------------


def _hyper(opt, *names, default=None):
    for n in names:
        v = getattr(opt, n, None)
        if v is not None:
            if isinstance(v, Tensor):
                v = float(v._data)
            return v
    return default


def resolve_lr(opt):
    """The optimizer's CURRENT scalar learning rate (a scheduler asked
    afresh). Executor.run reads it before every step and passes it in as
    an input, so a schedule is never frozen into the traced step."""
    lr = opt.get_lr() if hasattr(opt, "get_lr") else _hyper(
        opt, "_learning_rate", "learning_rate", default=0.01)
    return float(lr)


def init_slots(opt, params):
    """The optimizer state the functional step carries, made before the
    first step so the traced step has one structure: Momentum's
    velocities, Adam's f32 moments and step count."""
    kind = type(opt).__name__
    if kind == "Momentum":
        return {"velocity": [torch.zeros_like(p) for p in params]}
    if kind in ("Adam", "AdamW"):
        return {"m": [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params],
                "v": [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=params[0].device if params
                                    else None)}
    return {}


def check_functional(opt, params):
    """Raise NotImplementedError naming each option of `opt`, or of a
    parameter it trains, that `_functional_step` does not implement, so a
    static Program never trains differently from the eager optimizer."""
    kind = type(opt).__name__
    found = [name for attr, name in (
        ("_grad_clip", "grad_clip"),
        ("_apply_decay_param_fun", "apply_decay_param_fun"),
        ("_lr_ratio", "lr_ratio")) if getattr(opt, attr, None) is not None]
    if getattr(opt, "_moment_dtype", torch.float32) != torch.float32:
        found.append("moment_dtype='bfloat16'")
    for p in params:
        if float(getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)) != 1.0:
            found.append(f"the learning-rate scale of {p.name}")
        if getattr(p, "regularizer", None) is not None:
            found.append(f"the regularizer of {p.name}")
    if found:
        raise NotImplementedError(
            f"static-mode minimize: {kind} with {', '.join(found)} has no "
            "functional update yet; train it eagerly")


def _l2(opt):
    """The coupled L2 coefficient of SGD, Momentum and Adam (eager:
    g + weight_decay * p); AdamW's decay is decoupled (`_wd`)."""
    wd = getattr(opt, "_weight_decay", None)
    return float(wd) if wd else 0.0


def _functional_step(opt, params, grads, slots, lr=None):
    """One update in the JAX package's order (`graph.py:269-318`): SGD,
    Momentum (Nesterov too), Adam and AdamW with f32 moments and
    p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p); the coupled L2 decay
    of SGD, Momentum and Adam as the eager optimizers apply it."""
    kind = type(opt).__name__
    if lr is None:  # direct callers outside the traced step
        lr = resolve_lr(opt)
    dev = params[0].device if params else None
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    l2 = _l2(opt)
    if l2:
        grads = [g + l2 * p.to(g.dtype) for p, g in zip(params, grads)]
    if kind == "SGD":
        return ([p - (lr * g.float()).to(p.dtype)
                 for p, g in zip(params, grads)], slots)
    if kind == "Momentum":
        mu = _hyper(opt, "_momentum", "momentum", default=0.9)
        vel = slots.get("velocity") or [torch.zeros_like(p) for p in params]
        new_v = [mu * v + g.to(v.dtype) for v, g in zip(vel, grads)]
        if getattr(opt, "_nesterov", False):
            steps = [g.to(v.dtype) + mu * v for v, g in zip(new_v, grads)]
        else:
            steps = new_v
        return ([p - (lr * v.float()).to(p.dtype)
                 for p, v in zip(params, steps)],
                {**slots, "velocity": new_v})
    if kind in ("Adam", "AdamW"):
        b1 = _hyper(opt, "_beta1", "beta1", default=0.9)
        b2 = _hyper(opt, "_beta2", "beta2", default=0.999)
        eps = _hyper(opt, "_epsilon", "epsilon", default=1e-8)
        # eager AdamW decays by 0 where weight_decay is None or 0
        wd = float(getattr(opt, "_wd", None) or 0.0) \
            if kind == "AdamW" else 0.0
        if "m" not in slots:
            slots = {**slots, **init_slots(opt, params)}
        step = slots["step"] + 1
        b1t = 1.0 - b1 ** step.float()
        b2t = 1.0 - b2 ** step.float()
        new_p, new_m, new_v = [], [], []
        for p, g, mi, vi in zip(params, grads, slots["m"], slots["v"]):
            g32 = g.float()
            mi = b1 * mi + (1 - b1) * g32
            vi = b2 * vi + (1 - b2) * g32 * g32
            upd = (mi / b1t) / (torch.sqrt(vi / b2t) + eps)
            p32 = p.float()
            p32 = p32 - lr * (upd + wd * p32)
            new_p.append(p32.to(p.dtype))
            new_m.append(mi)
            new_v.append(vi)
        return new_p, {**slots, "m": new_m, "v": new_v, "step": step}
    raise NotImplementedError(
        f"static-mode minimize: optimizer {kind} has no functional update "
        "rule yet (supported: SGD, Momentum, Adam, AdamW)")


# -- mode + default programs -------------------------------------------------

_programs = []  # stack: (main, startup)


def _fresh():
    return (Program(), Program())


def _current():
    if not _programs:
        _programs.append(_fresh())
    return _programs[-1]


def default_main_program():
    return _current()[0]


def default_startup_program():
    return _current()[1]


class program_guard:
    def __init__(self, main_program=None, startup_program=None):
        self.main = main_program or Program()
        self.startup = startup_program or Program()

    def __enter__(self):
        _programs.append((self.main, self.startup))
        _sync_tape()
        return self

    def __exit__(self, *exc):
        _programs.pop()
        _sync_tape()


def enable_static_graph():
    _tc._static_tape = _Recorder()


def disable_static_graph():
    _tc._static_tape = None


def in_static_graph_mode():
    return _tc._static_tape is not None


def _sync_tape():
    if _tc._static_tape is not None:
        _tc._static_tape = _Recorder()


class _Recorder:
    """The waist hook object: routes op recording to the CURRENT default
    main program (so program_guard redirects building)."""

    @staticmethod
    def record(fn, tensors, name):
        return default_main_program().record(fn, tensors, name)


def data(name, shape, dtype="float32", lod_level=0):
    if not in_static_graph_mode():
        raise RuntimeError("static.data requires paddle.enable_static()")
    return default_main_program().add_feed(name, shape, dtype)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None,
              name=None):
    return default_main_program().record_gradients(targets, inputs)
