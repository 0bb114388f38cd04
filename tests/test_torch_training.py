"""The training slice of the PyTorch port against the JAX package, on the
CPU in f32: the fused linear + CE, one step's loss and full grad tree under
every remat mode, a 5-step engine trajectory, and the low-precision
moments.

Inputs and weights come from numpy seeds and the JAX trees, carried over
with `weights.tree_from_numpy` / `adamw_state_from_numpy`. The JAX side
runs as its own CPU tests run it (attention through `_sdpa_reference`,
the port's through the plain flash versions). Bars: loss rel 1e-5; a grad
leaf ||d - d_ref|| / ||d_ref|| <= 1e-5 (f32, sums in other orders); params
after 5 steps 1e-4 per leaf (Adam divides by sqrt(v), which amplifies the
grads' rounding on small-v elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.hybrid_engine import \
    HybridParallelEngine as JaxEngine
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu.models.llama import LlamaConfig
from paddle_tpu_torch.core.numerics import stochastic_round_bf16
from paddle_tpu_torch.core.tree import tree_leaves, tree_map
from paddle_tpu_torch.distributed import HybridParallelEngine, adamw_init
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (Llama, LlamaArgs, adamw_state_from_numpy,
                                     generate, params_from_numpy,
                                     tree_from_numpy, tree_to_numpy)
from paddle_tpu_torch.models import llama_functional as lf

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

CPU = "cpu"


def _cfg(kv_heads=None, layers=2):
    return LlamaConfig.tiny(num_hidden_layers=layers, hidden_size=64,
                            intermediate_size=128, num_attention_heads=2,
                            num_key_value_heads=kv_heads, vocab_size=256,
                            max_position_embeddings=64)


def _batch(B=2, s=24, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, s)).astype(np.int32),
            rng.integers(0, vocab, (B, s)).astype(np.int32))


def _jax_params(cfg, seed=0):
    return jlf.init_params(jlf.LlamaArgs.from_config(cfg),
                           jax.random.key(seed))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _assert_tree_close(got, ref, bar, what):
    for (path, g), r in zip(_items(got), [x for _, x in _items(ref)]):
        assert _rel(g, r) <= bar, (what, path, _rel(g, r))


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _items(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


# -- (b) fused linear + CE ----------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 8, 128])
def test_fused_ce_matches_jax_and_saves_no_logits(chunk):
    b, s, H, V = 2, 40, 32, 256       # 40 % 16 = 8: a remainder chunk
    rng = np.random.default_rng(1)
    h = rng.standard_normal((b, s, H)).astype(np.float32)
    head = (rng.standard_normal((H, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (b, s)).astype(np.int32)
    jargs = jlf.LlamaArgs.from_config(_cfg())
    loss_r, (dh_r, dhead_r) = jax.value_and_grad(
        lambda h, w: jlf.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels), jargs, None, 1, chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = lf.fused_linear_cross_entropy(
            th, tw, torch.from_numpy(labels).long(), chunk)
    (2.0 * loss).backward()            # a cotangent other than 1
    assert abs(loss.item() - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    assert _rel(th.grad, 2 * np.asarray(dh_r)) <= 1e-5
    assert _rel(tw.grad, 2 * np.asarray(dhead_r)) <= 1e-5
    # only d_h [b, s, H] and d_head [H, V] are saved: no [b, s, V] tensor
    assert sorted(saved) == sorted([(b, s, H), (H, V)])
    assert max(np.prod(x) for x in saved) < b * s * V
    # the unfused loss, and the loss alone when nothing is differentiated
    unfused = lf.parallel_cross_entropy(th.detach() @ tw.detach(),
                                        torch.from_numpy(labels))
    with torch.no_grad():
        alone = lf.fused_linear_cross_entropy(
            th, tw, torch.from_numpy(labels).long(), chunk)
    assert abs(unfused.item() - loss.item()) <= 1e-5 * loss.item()
    assert abs(alone.item() - loss.item()) <= 1e-5 * loss.item()


# -- (c) one step: loss and full grad tree per remat mode ---------------------


def _port_grads(jparams, args, ids, labels, remat, loss_chunk):
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU,
                             requires_grad=True)
    loss = lf.forward_and_loss(params, torch.from_numpy(ids).long(),
                               torch.from_numpy(labels).long(), args,
                               remat=remat, loss_chunk=loss_chunk)
    return loss, params


@pytest.fixture
def flash_calls(monkeypatch):
    """Calls of the plain flash forward (the wrappers count kernel
    launches only, and there are none on the CPU)."""
    calls = [0]
    plain = fa.flash_fwd_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd_plain", counted)
    return calls


STEP_CASES = {   # name: (kv heads, remat, loss_chunk, use_flash)
    "remat_false": (None, False, 16, True),
    "remat_true": (None, True, 16, True),
    "remat_half": (None, "half", 16, True),
    "remat_dots": (None, "dots", 16, True),
    "remat_lean": (None, "lean", 16, True),
    "gqa": (1, "dots", 16, True),
    "unfused_ce": (None, False, None, True),
    "sdpa": (None, False, 16, False),
}
# B1 runs in backward under each mode (2 layers): 'half' recomputes the
# second, True and 'dots' both, 'lean' keeps the forward's out and lse
BACKWARD_FORWARDS = {False: 0, True: 2, "half": 1, "dots": 2, "lean": 0}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_loss_and_grad_tree_match_jax(case, flash_calls):
    kv, remat, chunk, use_flash = STEP_CASES[case]
    cfg = _cfg(kv)
    cfg.use_flash_attention = use_flash
    jargs = jlf.LlamaArgs.from_config(cfg)
    args = LlamaArgs.from_config(cfg)
    assert args._asdict() == jargs._asdict()
    jparams = _jax_params(cfg)
    ids, labels = _batch()
    loss_r, grads_r = jax.jit(jax.value_and_grad(
        lambda p: jlf.forward_and_loss(p, jnp.asarray(ids),
                                       jnp.asarray(labels), jargs,
                                       remat=remat, loss_chunk=chunk)))(
        jparams)

    loss, params = _port_grads(jparams, args, ids, labels, remat, chunk)
    forwards = flash_calls[0]
    loss.backward()
    assert abs(loss.item() - float(loss_r)) <= 1e-5 * float(loss_r)
    grads = tree_map(lambda p: p.grad, params)
    _assert_tree_close(tree_to_numpy(grads),
                       jax.tree.map(np.asarray, grads_r), 1e-5, case)
    if use_flash:
        assert forwards == 2
        assert flash_calls[0] - forwards == BACKWARD_FORWARDS[remat]


def test_grads_equal_across_remat_modes():
    cfg = _cfg()
    args = LlamaArgs.from_config(cfg)
    jparams = _jax_params(cfg)
    ids, labels = _batch(seed=3)
    trees = {}
    for remat in (False, True, "half", "dots", "lean"):
        loss, params = _port_grads(jparams, args, ids, labels, remat, 16)
        loss.backward()
        trees[remat] = tree_to_numpy(tree_map(lambda p: p.grad, params))
    for remat, tree in trees.items():
        for (path, g), (_, r) in zip(_items(tree), _items(trees[False])):
            np.testing.assert_array_equal(g, r, err_msg=f"{remat} {path}")


def test_half_remat_odd_layer_count_goes_full(flash_calls):
    cfg = _cfg(layers=3)
    args = LlamaArgs.from_config(cfg)
    ids, labels = _batch()
    with pytest.warns(UserWarning, match="even layer count"):
        loss, _ = _port_grads(_jax_params(cfg), args, ids, labels, "half",
                              16)
    before = flash_calls[0]
    loss.backward()
    assert flash_calls[0] - before == 3
    with pytest.raises(ValueError, match="remat"):
        _port_grads(_jax_params(cfg), args, ids, labels, "some", 16)


# -- (d) five engine steps against the JAX engine -----------------------------


@pytest.mark.parametrize("master_weights", [False, True])
def test_five_step_trajectory_matches_jax_engine(master_weights):
    cfg = _cfg(kv_heads=1)
    kw = dict(micro_batches=2, loss_chunk=16, moments="f32",
              master_weights=master_weights, remat=False, lr=1e-3)
    jeng = JaxEngine(cfg, dp=1, pp=1, mp=1, **kw)
    jp, jo = jeng.init_state(0)
    eng = HybridParallelEngine(cfg, device=CPU, **kw)
    params = tree_from_numpy(jax.tree.map(np.asarray, jp), device=CPU,
                             requires_grad=True)
    opt = adamw_state_from_numpy(jax.tree.map(np.asarray, jo), device=CPU)
    assert set(opt) == ({"m", "v", "step", "master"} if master_weights
                        else {"m", "v", "step"})
    for step in range(5):
        ids, labels = _batch(B=4, seed=10 + step)
        loss_r, jp, jo = jeng.train_batch(jp, jo, ids, labels)
        loss, params2, opt2 = eng.train_batch(params, opt, ids, labels)
        assert params2 is params and opt2 is opt          # in place
        assert abs(loss.item() - float(loss_r)) <= 1e-5 * float(loss_r), step
    assert int(opt["step"]) == 5
    _assert_tree_close(tree_to_numpy(params), jax.tree.map(np.asarray, jp),
                       1e-4, "params")
    _assert_tree_close(tree_to_numpy(opt["m"]),
                       jax.tree.map(np.asarray, jo["m"]), 1e-4, "m")
    # a trained tree serves: detached, through Llama, as the numpy tree does
    args = eng.args
    model = Llama(args, tree_map(lambda p: p.detach(), params))
    prompt = np.array([[3, 1, 4, 1, 5]], np.int32)
    out = generate(model, prompt, max_new_tokens=4, device=CPU)
    ref = generate(params_from_numpy(tree_to_numpy(params), args,
                                     device=CPU), prompt, max_new_tokens=4,
                   device=CPU)
    assert torch.equal(out, ref)


def test_engine_rejects_what_is_not_ported(tmp_path):
    """dp/pp/mp/cp > 1 still raise (ROADMAP A9); checkpointing and the
    monitor are ported (ROADMAP A11): each option builds its part."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.observability import TrainingMonitor

    cfg = _cfg()
    for kw in (dict(dp=2), dict(pp=2), dict(mp=2), dict(cp=2)):
        with pytest.raises(NotImplementedError, match="A9"):
            HybridParallelEngine(cfg, device=CPU, **kw)
    for kw in (dict(save_every=10), dict(resume=True), dict()):
        eng = HybridParallelEngine(cfg, device=CPU,
                                   checkpoint=str(tmp_path / "ckpt"), **kw)
        assert isinstance(eng.checkpoint_manager, CheckpointManager)
    mon = TrainingMonitor(nan_action="none")
    assert HybridParallelEngine(cfg, device=CPU, monitor=mon).monitor is mon
    assert mon.device == torch.device(CPU)
    with pytest.raises(ValueError, match="moments"):
        HybridParallelEngine(cfg, device=CPU, moments="f16")
    eng = HybridParallelEngine(cfg, device=CPU, micro_batches=3)
    with pytest.raises(ValueError, match="micro_batches"):
        eng.shard_batch(*_batch(B=4))
    ids, labels = eng.shard_batch(*_batch(B=6))
    assert ids.shape == (3, 2, 24) and ids.dtype == torch.int64
    assert eng.shard_batch(ids, labels)[0] is ids     # already placed


# -- (e) stochastic rounding and low-precision moments ------------------------


def test_stochastic_round_bf16_unbiased_and_reproducible():
    x = torch.full((20000,), 1.001953125)
    r = stochastic_round_bf16(x, torch.Generator().manual_seed(0)).float()
    assert set(r.unique().tolist()) <= {1.0, 1.0078125}
    assert abs(r.mean().item() - 1.001953125) <= 2e-3 * 1.001953125
    # negative values and the wide range round to a neighbour, unbiased
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        200000).astype(np.float32) * 1e3)
    ry = stochastic_round_bf16(y, torch.Generator().manual_seed(1)).float()
    lo = y.to(torch.bfloat16).float()   # nearest; truncations lie beside it
    assert ((ry - y).abs() <= (y.abs() * 2.0 ** -7)).all()
    assert abs((ry - y).mean().item()) < 0.05 * (lo - y).abs().mean().item()
    again = stochastic_round_bf16(y, torch.Generator().manual_seed(1))
    other = stochastic_round_bf16(y, torch.Generator().manual_seed(2))
    assert torch.equal(again.float(), ry)
    assert not torch.equal(other.float(), ry)
    bad = torch.tensor([float("inf"), -float("inf"), float("nan"),
                        3.4e38])
    rb = stochastic_round_bf16(bad, torch.Generator().manual_seed(0)).float()
    assert rb[0] == float("inf") and rb[1] == -float("inf")
    # the largest finite values round down, or carry into inf as the
    # reference's uint32 sum does
    assert torch.isnan(rb[2]) and rb[3] >= 3.38e38


def _spec(tree):
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


@pytest.mark.parametrize("moments", ["f32", "bf16", "factored"])
def test_moments_state_stable_across_steps(moments):
    eng = HybridParallelEngine(_cfg(), device=CPU, dtype=torch.bfloat16,
                               moments=moments)
    params, opt = eng.init_state(0)
    before = _spec(opt)
    _, params, opt = eng.train_batch(params, opt, *_batch())
    assert _spec(opt) == before
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    if moments == "factored":
        assert set(opt["v"]["layers"]["wq"]) == {"r", "c"}
        assert opt["v"]["final_norm"].dtype == torch.float32


def test_factored_moments_memory_is_lean():
    cfg = LlamaConfig.tiny(num_hidden_layers=4, hidden_size=64,
                           intermediate_size=128, num_attention_heads=4,
                           vocab_size=128, max_position_embeddings=64)
    params = HybridParallelEngine(cfg, device=CPU,
                                  dtype=torch.bfloat16).init_state(0)[0]

    def nbytes(moments):
        return sum(t.numel() * t.element_size() for t in tree_leaves(
            adamw_init(params, moments)["v"]))

    # the reference's bar on this model (tests/test_hybrid_engine.py:673)
    assert nbytes("factored") < 0.05 * nbytes("f32")


@pytest.mark.parametrize("moments", ["bf16", "factored"])
def test_lean_moments_track_f32(moments):
    """The reference's bars (tests/test_hybrid_engine.py:677): 30 steps on
    its tiny model; bf16 moments stay on the f32 trajectory, factored ones
    in its ballpark."""
    cfg = LlamaConfig.tiny(num_hidden_layers=4, hidden_size=64,
                           intermediate_size=128, num_attention_heads=4,
                           vocab_size=128, max_position_embeddings=64)
    ids, labels = _batch(B=8, s=32, vocab=128)

    def run(mode, seed=0):
        eng = HybridParallelEngine(cfg, device=CPU, lr=3e-3, moments=mode)
        params, opt = eng.init_state(seed)
        return [eng.train_batch(params, opt, ids, labels)[0].item()
                for _ in range(30)]

    ref, got = run("f32"), run(moments)
    assert got[-1] < ref[0] * 0.7, "lean-moment run failed to descend"
    if moments == "bf16":
        assert abs(got[-1] - ref[-1]) / ref[-1] < 0.03, (ref[-1], got[-1])
        assert run(moments) == got          # reproducible: seeded by step
    else:
        assert abs(np.log(got[-1] / ref[-1])) < 0.6, (ref[-1], got[-1])
