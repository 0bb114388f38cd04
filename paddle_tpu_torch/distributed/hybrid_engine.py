"""Llama training on one card (port of `paddle_tpu/distributed/
hybrid_engine.py`, its trivial-mesh path).

`HybridParallelEngine(config, dp=1, pp=1, mp=1, ...)` runs what the
reference runs on a 1x1x1 mesh: `_grads_trivial` (:1091; the loss and
grads of `llama_functional.forward_and_loss` for each micro-batch,
accumulated) and then `adamw_update` (:103). The reference compiles the
step into one XLA program and donates params and optimizer state to it;
here PyTorch runs it eagerly and updates both in place.

Not ported yet, and raising NotImplementedError: dp/pp/mp/cp > 1 and
checkpointing (ROADMAP A9), the training monitor (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.numerics import stochastic_round_bf16
from paddle_tpu_torch.core.tree import leaves_like, tree_leaves, tree_map
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama_functional as lf

__all__ = ["HybridParallelEngine", "adamw_init", "adamw_update", "MOMENTS",
           "param_count", "flops_per_token"]

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
# model FLOPs (bench.py:77 `_param_count`, :86 `_flops_per_token`)
# --------------------------------------------------------------------------


def param_count(args):
    h, i, v, L = (args.hidden_size, args.intermediate_size, args.vocab_size,
                  args.num_layers)
    hd = h // args.num_heads
    per_layer = (h * args.num_heads * hd + 2 * h * args.num_kv_heads * hd
                 + args.num_heads * hd * h + 3 * h * i + 2 * h)
    return v * h * 2 + L * per_layer + h


def flops_per_token(args, seq):
    """Training FLOPs a token: 6·N for the matmuls plus causal attention,
    12·L·h·s/2 (model FLOPs: a remat recompute is not counted)."""
    return 6 * param_count(args) + 6 * args.num_layers * args.hidden_size \
        * seq


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
    the card)."""

    def __init__(self, config, dp=1, pp=1, mp=1, micro_batches=None,
                 dtype=torch.float32, remat=True, lr=3e-4, loss_chunk=None,
                 moments="f32", cp=1, monitor=None, master_weights=False,
                 save_every=None, checkpoint=None, resume=False, device=None):
        for name, n in (("dp", dp), ("pp", pp), ("mp", mp), ("cp", cp)):
            if n != 1:
                raise NotImplementedError(
                    f"{name}={n}: multi-GPU training is not ported yet "
                    "(ROADMAP A9); the port trains on one card")
        if save_every or checkpoint is not None or resume:
            raise NotImplementedError("checkpointing is not ported yet "
                                      "(ROADMAP A9)")
        if monitor is not None:
            raise NotImplementedError("the training monitor is not ported "
                                      "yet (ROADMAP A10)")
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
        (loss, params, opt_state), updated in place."""
        step = self.build_train_step()
        ids, labels = self.shard_batch(ids, labels)
        return step(params, opt_state, ids, labels)
