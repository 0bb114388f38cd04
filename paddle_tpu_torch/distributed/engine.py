"""The model-generic training engine on one card (`paddle_tpu/distributed/
engine.py`; reference auto-parallel `Engine`,
`python/paddle/distributed/auto_parallel/static/engine.py:99`).

`Engine(model, loss, optimizer, ...)` trains any `nn.Layer` with the JAX
engine's semantics, without a compiler: it keeps its own copy of the
parameters, the optimizer slots and the buffers (`state`), and the model's
own tensors change only at `sync_to_model`. A step points each
`Parameter`'s data at a leaf over the engine's copy for the forward, runs
the layer's ordinary eager forward and the loss layer (under `amp.auto_cast`
when `amp_level` is set, the loss in f32), takes the gradients with torch's
autograd, restores the model's data, and applies the functional update
rules of the JAX engine (`_fn_sgd`, `_fn_momentum`, `_fn_adam`, with
`apply_optimizer_updates` and `_functional_grad_clip`): f32 moments, L2 decay
in the gradient for Adam, decoupled for AdamW with the per-parameter mask
of `apply_decay_param_fun`. They are not the eager optimizers: a
`multi_precision` Adam and an AdamW `lr_ratio` raise. A batch-norm layer's
running statistics come back from the forward as new buffers, which the
engine keeps. `accumulate_steps` splits the batch into chunks whose
gradients add up in f32 (averaged under `accumulate_avg`), `remat` reruns
the forward in backward (`torch.utils.checkpoint`, the dropout redrawn
from the same generator state), and dropout draws from a generator seeded
by `seed`. The LR scheduler steps after each `train_batch`.

The attention of an `nn.MultiHeadAttention` with no mask and no dropout in
training (or in `eval_batch` / `predict_batch`, which put the model in
`eval()`) runs kernels B1-B3 on the card, as in eager training.

One card only: `dp > 1`, `mp > 1`, a `mesh`, `devices` of more than one
card, an `mp_spec_fn` and a fleet `strategy` raise, naming ROADMAP A9.
`sharding_stage` 0-3 is accepted: at dp 1 the JAX engine's shardings
degenerate to replication, so the steps are the same.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.nn.layer.layers import _set_data
from paddle_tpu_torch.ops._common import waits_for

__all__ = ["Engine"]


# --------------------------------------------------------------------------
# functional optimizers (the JAX engine's update rules, :45-110)
# --------------------------------------------------------------------------


def _fn_sgd(hp):
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32)}

    def update(p, g, s, lr):
        g = g.float()
        if hp["weight_decay"]:
            g = g + hp["weight_decay"] * p.float()
        return (p.float() - lr * g).to(p.dtype), ()

    return init, update, ()


def _fn_momentum(hp):
    def init(params):
        return {"velocity": {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32)}

    def update(p, g, s, lr):
        (v,) = s
        g = g.float()
        if hp["weight_decay"]:
            g = g + hp["weight_decay"] * p.float()
        v = hp["momentum"] * v + g
        step = hp["momentum"] * v + g if hp["nesterov"] else v
        return (p.float() - lr * step).to(p.dtype), (v,)

    return init, update, ("velocity",)


def _fn_adam(hp, decoupled_wd):
    b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
    wd = hp["weight_decay"]

    def init(params):
        def z():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}

        return {"m": z(), "v": z(), "step": torch.zeros((), dtype=torch.int32)}

    def update(p, g, s, lr, *, step, decay=True):
        m, v = s
        g32 = g.float()
        p32 = p.float()
        wd_p = wd if decay else 0.0
        if wd_p and not decoupled_wd:  # Adam's L2: the decay in the grad
            g32 = g32 + wd_p * p32
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * (g32 * g32)
        t = step.to(device=p.device, dtype=torch.float32)
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        upd = mhat / (torch.sqrt(vhat) + eps)
        if wd_p and decoupled_wd:  # AdamW
            upd = upd + wd_p * p32
        return (p32 - lr * upd).to(p.dtype), (m, v)

    return init, update, ("m", "v")


def _functionalize_optimizer(opt):
    """(init, update, slot names) of a port optimizer: SGD, Momentum, Adam
    or AdamW (`engine.py:113` of the JAX package)."""
    from paddle_tpu_torch.optimizer import SGD, Adam, AdamW, Momentum

    def hp(**kw):
        return kw

    if isinstance(opt, (Adam, AdamW)) and getattr(opt, "_multi_precision",
                                                  False):
        raise NotImplementedError(
            "Engine keeps moments in fp32 already; multi_precision master "
            "weights are not supported in the compiled step")
    if isinstance(opt, AdamW):
        if opt._lr_ratio is not None:
            raise NotImplementedError(
                "AdamW lr_ratio is not supported in the compiled Engine step")
        return _fn_adam(hp(beta1=opt._beta1, beta2=opt._beta2,
                           epsilon=opt._epsilon,
                           weight_decay=opt._wd or 0.0), True)
    if isinstance(opt, Adam):
        return _fn_adam(hp(beta1=opt._beta1, beta2=opt._beta2,
                           epsilon=opt._epsilon,
                           weight_decay=opt._weight_decay or 0.0), False)
    if isinstance(opt, Momentum):
        return _fn_momentum(hp(momentum=opt._momentum,
                               weight_decay=opt._weight_decay or 0.0,
                               nesterov=getattr(opt, "_nesterov", False)))
    if isinstance(opt, SGD):
        return _fn_sgd(hp(weight_decay=opt._weight_decay or 0.0))
    raise TypeError(
        f"Engine supports SGD/Momentum/Adam/AdamW, got {type(opt).__name__}")


def apply_optimizer_updates(params, grads, opt_state, opt_update, slots, lr,
                            decay_mask=None):
    """One functional optimizer step over a flat {name: tensor} tree:
    (new params, new optimizer state)."""
    step = opt_state["step"] + 1
    new_params, new_slots = {}, {name: {} for name in slots}
    for k, p in params.items():
        s = tuple(opt_state[name][k] for name in slots)
        kw = ({"step": step, "decay": (decay_mask or {}).get(k, True)}
              if "m" in slots else {})
        np_, ns = opt_update(p, grads[k], s, lr, **kw)
        new_params[k] = np_
        for name, val in zip(slots, ns):
            new_slots[name][k] = val
    new_opt = dict(new_slots)
    new_opt["step"] = step
    return new_params, new_opt


def _functional_grad_clip(clip, clipable):
    """The eager `Optimizer._apply_grad_clip` over a {name: grad} tree;
    `clipable` maps a parameter's name to its need_clip (a parameter with
    need_clip=False is left out, as in the eager path)."""
    if clip is None:
        return None
    from paddle_tpu_torch import nn

    def keep(k):
        return clipable.get(k, True)

    if isinstance(clip, nn.ClipGradByGlobalNorm):
        def by_global_norm(grads):
            parts = [torch.sum(torch.square(g.float()))
                     for k, g in grads.items() if keep(k)]
            if not parts:
                return grads
            total = torch.sqrt(sum(parts))
            coef = torch.clamp(clip.clip_norm / torch.clamp(total, min=1e-6),
                               max=1.0)
            return {k: (g * coef.to(g.dtype)) if keep(k) else g
                    for k, g in grads.items()}

        return by_global_norm
    if isinstance(clip, nn.ClipGradByNorm):
        def by_norm(grads):
            out = {}
            for k, g in grads.items():
                if keep(k):
                    n = torch.sqrt(torch.sum(torch.square(g.float())))
                    coef = torch.clamp(
                        clip.clip_norm / torch.clamp(n, min=1e-6), max=1.0)
                    g = g * coef.to(g.dtype)
                out[k] = g
            return out

        return by_norm
    if isinstance(clip, nn.ClipGradByValue):
        return lambda grads: {
            k: torch.clamp(g, clip.min, clip.max) if keep(k) else g
            for k, g in grads.items()}
    raise TypeError(f"unsupported grad_clip for Engine: {type(clip).__name__}")


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


def _one_card(name, why):
    return waits_for(f"distributed.Engine({name})", "A9", why)


class Engine:
    """Training and evaluation of any Layer on one card.

    Example (BASELINE config 3's one-card part)::

        engine = Engine(bert_base(), loss=BertPretrainingLoss(),
                        optimizer=AdamW(5e-5, parameters=...), dp=1,
                        sharding_stage=2)
        loss = engine.train_batch([ids, token_type_ids], [mlm, nsp])
    """

    def __init__(self, model, loss=None, optimizer=None, strategy=None,
                 dp=None, mp=1, sharding_stage=0, mesh=None, devices=None,
                 mp_spec_fn=None, seed=0, amp_level=None, amp_dtype="bfloat16",
                 remat=False, accumulate_steps=1, accumulate_avg=True):
        if strategy is not None:
            raise _one_card("strategy=", "fleet's hybrid strategies")
        if dp not in (None, 1):
            raise _one_card(f"dp={dp}", "data parallelism across cards")
        if mp != 1:
            raise _one_card(f"mp={mp}", "tensor parallelism across cards")
        if mesh is not None:
            raise _one_card("mesh=", "a device mesh")
        if devices is not None and len(devices) > 1:
            raise _one_card("devices=", f"{len(devices)} cards")
        if mp_spec_fn is not None:
            raise _one_card("mp_spec_fn=", "tensor-parallel weight specs")
        if amp_level not in (None, "O1", "O2", "o1", "o2"):
            raise ValueError("amp_level must be None, 'O1' or 'O2'")
        if accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        self.model = model
        self.loss_layer = loss
        self.optimizer = optimizer
        self.amp_level = amp_level.upper() if amp_level else None
        self.amp_dtype = amp_dtype
        self.remat = bool(remat)
        self.accumulate_steps = int(accumulate_steps)
        self.accumulate_avg = bool(accumulate_avg)
        self.sharding_stage = sharding_stage
        self.dp, self.mp = 1, 1

        self._named_params = dict(model.named_parameters())
        self._named_buffers = dict(model.named_buffers())
        first = next(iter(self._named_params.values()), None)
        self.device = (first._data.device if first is not None
                       else _device.place())
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if optimizer is not None:
            self._opt_init, self._opt_update, self._slots = \
                _functionalize_optimizer(optimizer)
            clipable = {k: getattr(p, "need_clip", True)
                        for k, p in self._named_params.items()}
            self._grad_clip = _functional_grad_clip(optimizer._grad_clip,
                                                    clipable)
            fn = getattr(optimizer, "_apply_decay_param_fun", None)
            self._decay_mask = {
                k: (fn(p.name) if fn is not None else True)
                for k, p in self._named_params.items()}
        self._state = None  # [params, opt_state, buffers] once made

    # -- state ---------------------------------------------------------------
    def _ensure_state(self):
        if self._state is not None:
            return
        params = {k: p._data.detach()
                  for k, p in self._named_params.items()}
        buffers = {k: b._data.detach()
                   for k, b in self._named_buffers.items()}
        opt_state = None
        if self.optimizer is not None:
            opt_state = self._opt_init(params)
            opt_state["step"] = opt_state["step"].to(self.device)
        self._state = [params, opt_state, buffers]

    @property
    def state(self):
        """[params, optimizer state, buffers]: the engine's own tensors."""
        self._ensure_state()
        return self._state

    # -- the forward over the engine's tensors -------------------------------
    @contextlib.contextmanager
    def _swapped(self, params, buffers):
        """The model's parameters and buffers pointed at `params` /
        `buffers` inside the block; yields a dict that holds the buffers as
        the forward left them, and restores the model's own after."""
        saved_p = {k: p._data for k, p in self._named_params.items()}
        saved_b = {k: b._data for k, b in self._named_buffers.items()}
        out = {}
        try:
            for k, p in self._named_params.items():
                p._data = params[k]
            for k, b in self._named_buffers.items():
                if k in buffers:
                    b._data = buffers[k]
            yield out
            out.update({k: b._data.detach()
                        for k, b in self._named_buffers.items()})
        finally:
            for k, p in self._named_params.items():
                p._data = saved_p[k]
            for k, b in self._named_buffers.items():
                b._data = saved_b[k]

    def _loss_of(self, out, labels):
        if self.loss_layer is None:
            return out
        return self.loss_layer(out, *[Tensor(l) for l in labels])

    def _forward_loss(self, params, buffers, inputs, labels):
        """(f32 loss tensor, new buffers) of the model over the engine's
        tensors, dropout drawn from the engine's generator."""
        from paddle_tpu_torch import amp as _amp

        cast = (_amp.auto_cast(enable=True, level=self.amp_level,
                               dtype=self.amp_dtype) if self.amp_level
                else contextlib.nullcontext())
        with self._swapped(params, buffers) as new_buf, \
                _rng.use_generator(self._gen), cast:
            loss = self._loss_of(self.model(*[Tensor(a) for a in inputs]),
                                 labels)._data.float()
        return loss, new_buf

    def _chunk_grads(self, params, buffers, inputs, labels):
        """(loss, {name: grad}, new buffers) of one chunk."""
        names = list(params)
        leaves = [params[k].detach().requires_grad_(
            params[k].is_floating_point()) for k in names]
        if self.remat:
            state0 = self._gen.get_state()
            side = {}

            def run(*ls):
                # the recompute in backward draws the same dropout bits
                self._gen.set_state(state0)
                loss, nb = self._forward_loss(dict(zip(names, ls)), buffers,
                                              inputs, labels)
                side.setdefault("buf", nb)
                return loss

            from torch.utils.checkpoint import checkpoint

            with torch.enable_grad():
                loss = checkpoint(run, *leaves, use_reentrant=False)
            state1 = self._gen.get_state()
            new_buf = side["buf"]
        else:
            with torch.enable_grad():
                loss, new_buf = self._forward_loss(dict(zip(names, leaves)),
                                                   buffers, inputs, labels)
        want = [l for l in leaves if l.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True))
        grads = {}
        for k, l in zip(names, leaves):
            g = next(got) if l.requires_grad else None
            grads[k] = torch.zeros_like(l) if g is None else g
        if self.remat:
            self._gen.set_state(state1)
        return loss.detach(), grads, new_buf

    # -- steps ---------------------------------------------------------------
    def _place_batch(self, arrays, micro=1):
        """Host or device arrays -> tensors on the engine's card; micro > 1
        (gradient merge) splits the batch dim into `micro` chunks."""
        out = []
        for a in arrays:
            if isinstance(a, Tensor):
                t = a._data
            elif isinstance(a, torch.Tensor):
                t = a
            else:
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
            t = t.detach().to(self.device)
            if t.shape[0] % micro != 0:
                raise ValueError(
                    f"global batch {t.shape[0]} must divide "
                    f"dp*accumulate_steps={micro}")
            out.append(t.chunk(micro) if micro > 1 else t)
        return out

    def train_batch(self, inputs, labels):
        """One optimizer step on a batch; returns the loss (a 0-d f32
        Tensor)."""
        if self.optimizer is None:
            raise RuntimeError("Engine built without an optimizer")
        self._ensure_state()
        params, opt_state, buffers = self._state
        lr = float(self.optimizer.get_lr())
        K = self.accumulate_steps
        inputs = self._place_batch(inputs, micro=K)
        labels = self._place_batch(labels, micro=K)
        if K == 1:
            loss, grads, buffers = self._chunk_grads(params, buffers, inputs,
                                                     labels)
        else:
            # accumulate in f32: summing K bf16 chunk gradients in bf16
            # drops contributions below the running sum's ulp
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(K):
                loss, g, buffers = self._chunk_grads(
                    params, buffers, [a[i] for a in inputs],
                    [a[i] for a in labels])
                lsum = lsum + loss
                gsum = {k: gsum[k] + g[k].float() for k in gsum}
            inv = 1.0 / K
            loss = lsum * inv
            scale = inv if self.accumulate_avg else 1.0
            grads = {k: (gsum[k] * scale).to(params[k].dtype)
                     for k in params}
        with torch.no_grad():
            if self._grad_clip is not None:
                grads = self._grad_clip(grads)
            params, opt_state = apply_optimizer_updates(
                params, grads, opt_state, self._opt_update, self._slots, lr,
                self._decay_mask)
        self._state = [params, opt_state, buffers]
        sched = getattr(self.optimizer, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()
        return Tensor(loss)

    @contextlib.contextmanager
    def _evaluating(self):
        self._ensure_state()
        self.model.eval()
        try:
            with torch.no_grad():
                yield self._state[0], self._state[2]
        finally:
            self.model.train()

    def eval_batch(self, inputs, labels):
        """The loss of a batch with the model in eval() (0-d f32 Tensor);
        the engine's buffers stay as they are."""
        with self._evaluating() as (params, buffers):
            loss, _ = self._forward_loss(params, buffers,
                                         self._place_batch(inputs),
                                         self._place_batch(labels))
        return Tensor(loss)

    def predict_batch(self, inputs):
        """The model's outputs on a batch, in eval()."""
        with self._evaluating() as (params, buffers), \
                self._swapped(params, buffers), \
                _rng.use_generator(self._gen):
            return self.model(*[Tensor(a)
                                for a in self._place_batch(inputs)])

    # -- hapi-style loop -----------------------------------------------------
    def fit(self, loader, epochs=1, log_every=0):
        """loader yields (inputs..., label) batches (paddle.io.DataLoader);
        returns the losses as floats."""
        losses = []
        for _ in range(epochs):
            for batch in loader:
                *inputs, label = batch
                loss = self.train_batch(inputs, [label])
                losses.append(float(loss))
                if log_every and len(losses) % log_every == 0:
                    print(f"step {len(losses)}: loss {losses[-1]:.4f}")
        return losses

    def sync_to_model(self):
        """Write the engine's parameters and buffers into the Layer (copies:
        later steps leave the model as it is until the next sync)."""
        self._ensure_state()
        params, _, buffers = self._state
        for k, p in self._named_params.items():
            _set_data(p, params[k].clone())
        for k, b in self._named_buffers.items():
            if k in buffers:
                _set_data(b, buffers[k].clone())
