"""Llama training on one card (port of `paddle_tpu/distributed/
hybrid_engine.py`, its trivial-mesh path).

`HybridParallelEngine(config, dp=1, pp=1, mp=1, ...)` runs what the
reference runs on a 1x1x1 mesh: `_grads_trivial` (:1091; the loss and
grads of `llama_functional.forward_and_loss` for each micro-batch,
accumulated) and then `adamw_update` (:103). The reference compiles the
step into one XLA program and donates params and optimizer state to it;
here PyTorch runs it eagerly and updates both in place.

As in the reference, every step reports to a `TrainingMonitor` (a default
one with nan_action='none', which never waits for the card), and
`save_every` / `checkpoint` / `resume` commit {"params", "opt"} through a
`CheckpointManager` in the JAX package's on-disk format and resume from
the newest committed step (`maybe_resume`).

Not ported yet, and raising NotImplementedError: dp/pp/mp/cp > 1
(ROADMAP A9).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.core.numerics import stochastic_round_bf16
from paddle_tpu_torch.core.tree import leaves_like, tree_leaves, tree_map
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama_functional as lf
from paddle_tpu_torch.observability import hardware

__all__ = ["HybridParallelEngine", "adamw_init", "adamw_update", "MOMENTS"]

MOMENTS = ("f32", "bf16", "factored")


# --------------------------------------------------------------------------
# AdamW over a parameter tree
# --------------------------------------------------------------------------


def _factored_leaf(shape):
    return len(shape) >= 2


def adamw_init(params, moments="f32", master_weights=False):
    """AdamW state (`adamw_init` :64): {"m", "v", "step"[, "master"]}.

      - 'f32':      m and v in f32;
      - 'bf16':     m and v stored bf16, written back by stochastic rounding;
      - 'factored': m in bf16; v of each leaf of rank >= 2 an
                    Adafactor-style pair {"r": row EMA, "c": column EMA} of
                    g^2 in f32 over the last two axes, f32 v elsewhere.

    master_weights: an f32 copy of each param, to which the updates apply.
    "step" is a 0-d int64 tensor on the host, so that the bias corrections
    are read without waiting for the card."""
    if moments not in MOMENTS:
        raise ValueError(f"moments must be one of {MOMENTS}, got {moments!r}")
    mdt = torch.float32 if moments == "f32" else torch.bfloat16

    def zeros(shape, dtype, like):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    def mk_v(p):
        if moments == "factored" and _factored_leaf(p.shape):
            return {"r": zeros(p.shape[:-1], torch.float32, p),
                    "c": zeros(p.shape[:-2] + p.shape[-1:], torch.float32, p)}
        return zeros(p.shape, torch.bfloat16 if moments == "bf16"
                     else torch.float32, p)

    state = {"m": tree_map(lambda p: zeros(p.shape, mdt, p), params),
             "v": tree_map(mk_v, params),
             "step": torch.zeros((), dtype=torch.int64)}
    if master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _update_leaf(p, g, m, v, master, lr, beta1, beta2, eps, weight_decay,
                 b1t, b2t, gen):
    """One leaf of `adamw_update`, in place; every sum in f32."""
    g32 = g.float()
    m32 = m if m.dtype == torch.float32 else m.float()
    m32.mul_(beta1).add_(g32, alpha=1 - beta1)
    if isinstance(v, dict):   # factored second moment
        g2 = g32 * g32
        r, c = v["r"], v["c"]
        r.mul_(beta2).add_(g2.mean(dim=-1), alpha=1 - beta2)
        c.mul_(beta2).add_(g2.mean(dim=-2), alpha=1 - beta2)
        del g2
        # v_ij ~= r_i * c_j / mean(r): exact when g^2 is rank-1
        denom = r.mean(dim=-1, keepdim=True).clamp_(min=1e-30)
        vhat = (r / denom)[..., :, None].mul(c[..., None, :]).div_(b2t)
    else:
        v32 = v if v.dtype == torch.float32 else v.float()
        v32.mul_(beta2).addcmul_(g32, g32, value=1 - beta2)
        vhat = v32 / b2t
        if v32 is not v:
            v.copy_(stochastic_round_bf16(v32, gen))
    del g32
    upd = (m32 / b1t).div_(vhat.sqrt_().add_(eps))
    del vhat
    if m32 is not m:
        m.copy_(stochastic_round_bf16(m32, gen))
    p32 = master if master is not None else (
        p if p.dtype == torch.float32 else p.float())
    upd.add_(p32, alpha=weight_decay)
    p32.sub_(upd, alpha=lr)
    if p32 is not p:
        p.copy_(p32)


@torch.no_grad()
def adamw_update(params, grads, state, lr=3e-4, beta1=0.9, beta2=0.999,
                 eps=1e-8, weight_decay=0.01, moments="f32"):
    """One AdamW step (`adamw_update` :103), in place on params and state;
    returns them. All math runs in f32, one leaf at a time (the temporaries
    are one leaf's, not the tree's); `moments` selects only how m and v are
    stored. Weight decay applies to every leaf, norms and embedding too,
    as in the reference. The stochastic rounding of 'bf16'/'factored'
    draws from a generator seeded with the step, so a run is reproducible;
    its bits differ from the reference's (threefry). Runs inside the
    profiler range "adamw_update"."""
    if moments not in MOMENTS:
        raise ValueError(f"moments must be one of {MOMENTS}, got {moments!r}")
    with torch.profiler.record_function("adamw_update"):
        return _adamw_update(params, grads, state, lr, beta1, beta2, eps,
                             weight_decay, moments)


def _adamw_update(params, grads, state, lr, beta1, beta2, eps, weight_decay,
                  moments):
    step = int(state["step"]) + 1
    b1t = 1.0 - beta1 ** step
    b2t = 1.0 - beta2 ** step
    flat_p = tree_leaves(params)
    flat_g = leaves_like(params, grads)
    flat_m = leaves_like(params, state["m"])
    flat_v = leaves_like(params, state["v"])
    flat_w = (leaves_like(params, state["master"]) if "master" in state
              else [None] * len(flat_p))
    gens = {}
    for p, g, m, v, w in zip(flat_p, flat_g, flat_m, flat_v, flat_w):
        gen = None
        if moments != "f32":
            if p.device not in gens:
                gens[p.device] = torch.Generator(device=p.device) \
                    .manual_seed(step)
            gen = gens[p.device]
        _update_leaf(p, g, m, v, w, lr, beta1, beta2, eps, weight_decay,
                     b1t, b2t, gen)
    state["step"].fill_(step)
    return params, state


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


class HybridParallelEngine:
    """Llama training on one card: the reference engine on a 1x1x1 mesh.

    config: a `LlamaArgs`, or an object with the reference `LlamaConfig`'s
    attribute names. device: CUDA unless "cpu" is asked for. The step is
    `train_batch(params, opt_state, ids, labels)` -> (loss, params,
    opt_state), params and state updated in place and returned; the loss is
    a 0-d f32 tensor on the device, not read back (the step never waits for
    the card).

    monitor: a `TrainingMonitor` (default: one with nan_action='none',
    source 'hybrid_engine', on the engine's device). save_every=N commits
    {"params", "opt"} every N completed steps through `checkpoint_manager`
    (a `CheckpointManager` of `checkpoint`, a root dir or a manager; with
    neither, $PADDLE_CHECKPOINT_DIR), keeping the newest `keep_last_k`;
    resume=True makes `maybe_resume` restore the newest committed step."""

    def __init__(self, config, dp=1, pp=1, mp=1, micro_batches=None,
                 dtype=torch.float32, remat=True, lr=3e-4, loss_chunk=None,
                 moments="f32", cp=1, monitor=None, master_weights=False,
                 save_every=None, checkpoint=None, resume=False,
                 keep_last_k=3, device=None):
        for name, n in (("dp", dp), ("pp", pp), ("mp", mp), ("cp", cp)):
            if n != 1:
                raise NotImplementedError(
                    f"{name}={n}: multi-GPU training is not ported yet "
                    "(ROADMAP A9); the port trains on one card")
        if moments not in MOMENTS:
            raise ValueError(f"moments must be one of {MOMENTS}, got "
                             f"{moments!r}")
        if remat not in lf.REMAT_MODES:
            raise ValueError(f"remat must be one of {lf.REMAT_MODES}, got "
                             f"{remat!r}")
        self.args = (config if isinstance(config, lf.LlamaArgs)
                     else lf.LlamaArgs.from_config(config))
        self.device = resolve_device(device)
        self.micro_batches = micro_batches or 1
        self.dtype = dtype
        self.remat = remat
        self.lr = lr
        self.loss_chunk = loss_chunk
        self.moments = moments
        self.master_weights = bool(master_weights)

        # per-step telemetry. The default monitor's nan_action='none' keeps
        # train_batch free of any wait for the card, so its step times are
        # dispatch times; pass nan_action='raise'/'warn' for a loss-checked
        # (synchronised) loop.
        from paddle_tpu_torch.observability import TrainingMonitor

        if monitor is None:
            monitor = TrainingMonitor(source="hybrid_engine",
                                      nan_action="none", device=self.device)
        elif monitor.device is None:
            monitor.device = self.device
        self.monitor = monitor
        # the flops a token, refreshed when the sequence length changes,
        # unless the caller's monitor came with its own
        self._fpt_auto = monitor.flops_per_token is None
        self._fpt_seq = None

        # periodic atomic checkpoints and resume
        self._save_every = int(save_every) if save_every else None
        self._resume = bool(resume)
        self._global_step = 0   # completed train_batch calls, resume-aware
        self.checkpoint_manager = None
        if self._save_every or resume or checkpoint is not None:
            from paddle_tpu_torch.distributed.checkpoint import (
                CheckpointManager)

            self.checkpoint_manager = (
                checkpoint if isinstance(checkpoint, CheckpointManager)
                else CheckpointManager(root=checkpoint,
                                       keep_last_k=keep_last_k))

    def init_state(self, seed=0):
        """(params, opt_state): random params (`init_params`, from a
        generator seeded with `seed`, leaves requiring grad) and their
        AdamW state, on the engine's device. torch's generator gives other
        numbers than JAX's from one seed: carry a reference state over
        with `weights.tree_from_numpy` / `adamw_state_from_numpy`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = lf.init_params(self.args, gen, device=self.device,
                                dtype=self.dtype)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, adamw_init(params, self.moments, self.master_weights)

    def maybe_resume(self, params, opt_state):
        """(params, opt_state, start_step): restored in place from the
        newest committed checkpoint when resume=True was asked for and one
        exists, else passed through with start_step 0, so that a trainer
        loop is the same either way:

            params, opt = engine.init_state(seed)
            params, opt, start = engine.maybe_resume(params, opt)
            for step in range(start, total_steps): ...
        """
        if self.checkpoint_manager is None or not self._resume:
            return params, opt_state, 0
        extras = self.checkpoint_manager.resume(
            {"params": params, "opt": opt_state})
        if extras is None:
            return params, opt_state, 0
        self._global_step = int(extras.get("step", 0))
        return params, opt_state, self._global_step

    def _grads_trivial(self, params, ids, labels):
        """Loss and grads over the M micro-batches ids/labels [M, mb, s]
        (`_grads_trivial` :1091): each micro-batch's backward adds into
        the leaves' .grad in their own dtype; for M > 1 the sums are then
        scaled by 1/M in f32 and cast back, and the loss is the mean of
        the micro-batch losses. Returns (loss, grads tree)."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        M = ids.shape[0]
        total = None
        for i in range(M):
            loss = lf.forward_and_loss(params, ids[i], labels[i], self.args,
                                       remat=self.remat,
                                       loss_chunk=self.loss_chunk)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if M > 1:
            with torch.no_grad():
                for p in leaves:
                    if p.grad.dtype == torch.float32:
                        p.grad.mul_(1.0 / M)
                    else:
                        p.grad.copy_(p.grad.float() * (1.0 / M))
            total = total * (1.0 / M)
        return total, tree_map(lambda p: p.grad, params)

    def build_train_step(self):
        """The step function (`build_train_step` :1142): (params,
        opt_state, ids, labels) -> (loss, params, opt_state), ids/labels
        [M, mb, s] on the device, params and state updated in place."""
        return self._train_step

    def _train_step(self, params, opt_state, ids, labels):
        loss, grads = self._grads_trivial(params, ids, labels)
        adamw_update(params, grads, opt_state, lr=self.lr,
                     moments=self.moments)
        for p in tree_leaves(params):
            p.grad = None
        return loss, params, opt_state

    def shard_batch(self, ids, labels):
        """[B, s] host arrays -> [M, B/M, s] int64 tensors on the device.
        Tensors already placed as [M, mb, s] on the device pass through,
        so an input pipeline can stage the next batch ahead."""
        M = self.micro_batches

        def placed(a):
            return (isinstance(a, torch.Tensor) and a.dim() == 3
                    and a.shape[0] == M and a.device == self.device
                    and a.dtype == torch.int64)

        if placed(ids) and placed(labels):
            return ids, labels
        ids, labels = np.asarray(ids), np.asarray(labels)
        B = ids.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} must divide micro_batches={M}")

        def put(a):
            return torch.from_numpy(a.astype(np.int64).reshape(
                M, B // M, -1)).to(self.device)

        return put(ids), put(labels)

    def train_batch(self, params, opt_state, ids, labels):
        """One optimizer step over the batch (`train_batch` :1227):
        (loss, params, opt_state), updated in place. Reports the step to
        the monitor, commits a checkpoint every `save_every` steps (the
        state after the step, as step N of N completed) and passes the
        `step_end` fault point."""
        step = self.build_train_step()
        ids, labels = self.shard_batch(ids, labels)
        if self._fpt_auto and self._fpt_seq != ids.shape[-1]:
            self.monitor.flops_per_token = hardware.llama_flops_per_token(
                self.args, ids.shape[-1])
            self._fpt_seq = ids.shape[-1]
        self.monitor.start_step()
        out = step(params, opt_state, ids, labels)
        self.monitor.end_step(loss=out[0], tokens=ids.numel())
        self._global_step += 1
        if (self.checkpoint_manager is not None and self._save_every
                and self._global_step % self._save_every == 0):
            # the snapshot is on the host before save returns; the step
            # counter goes to disk as the int32 the JAX engine writes
            opt = dict(out[2], step=out[2]["step"].to(torch.int32))
            self.checkpoint_manager.save({"params": out[1], "opt": opt},
                                         self._global_step)
        if os.environ.get("PADDLE_CHAOS"):
            from paddle_tpu_torch.distributed.checkpoint.integrity import (
                chaos_point)

            chaos_point("step_end", step=self._global_step)
        return out
