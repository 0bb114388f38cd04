"""The port's program audits (`paddle_tpu_torch/analysis/`), rule by rule:
the FX graph walker and each rule over programs seeded with a violation.
Each seeded case asserts the rule id, the numbers in the message and a
provenance that names the seeding function (the first frame outside torch
that recorded the node). The collective census runs on FX graphs built by
hand, with no process group.

The reference's provenance is empty under jax 0.9 (`ref_departs`): its
seeded forbidden shape is flagged with provenance ''. The port's is held
to the seeding function instead.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.analysis import (buffer_audit, collective_audit,
                                       donation_audit, dtype_audit,
                                       graph_walk, host_sync_audit,
                                       jaxpr_walk, programs)
from paddle_tpu_torch.models import llama_functional as lf

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)


def _rand(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dtype)


def _fake_cuda(*shape):
    """A fake CUDA tensor: the CPU build traces a program "on the card"
    without one."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.empty(shape, device="cuda")


def _named(violations, rule):
    got = [v for v in violations if v.rule == rule]
    assert got, violations
    return got


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


def seeded_branchy(x):
    def bigger(x):
        return x * 2

    def smaller(x):
        return torch.cond(x.sum() > 1, lambda y: y + 1, lambda y: y - 1,
                          (x,))

    return torch.cond(x.sum() > 0, bigger, smaller, (x,))


def test_walker_descends_into_cond_subgraphs_with_breadcrumbs():
    """iter_eqns reaches the nodes of both branches of a torch.cond and of
    a cond nested in one; the path names the enclosing operators."""
    p = programs.trace("branchy", seeded_branchy, (_rand(4),))
    paths = {path for _, path in graph_walk.iter_eqns(p)}
    assert paths == {(), ("cond",), ("cond", "cond")}
    ops = {graph_walk.op_name(n) for n, path in graph_walk.iter_eqns(p)
           if path == ("cond",)}
    assert "aten.mul.Tensor" in ops and "cond" in ops


def test_walker_visits_a_shared_subgraph_once():
    """A GraphModule two nodes read is walked once."""
    p = programs.trace("branchy", seeded_branchy, (_rand(4),))
    gm = p.graph_module
    nodes = list(graph_walk.iter_eqns(gm))
    assert len(nodes) == len({id(n) for n, _ in nodes})


def test_provenance_names_user_code_and_jaxpr_walk_is_the_walker():
    """Every node of a traced program names the line of its recording
    frame; the reference's module name resolves to the walker, with its
    names."""
    p = programs.trace("branchy", seeded_branchy, (_rand(4),))
    provs = {graph_walk.provenance(n) for n, _ in graph_walk.iter_eqns(p)}
    assert all(pv.startswith("test_torch_analysis_rules.py:")
               for pv in provs), provs
    assert any("(seeded_branchy)" in pv for pv in provs)
    assert any("(bigger)" in pv for pv in provs)
    assert jaxpr_walk is graph_walk
    from paddle_tpu_torch.analysis.jaxpr_walk import (  # noqa: F401
        format_eqn, iter_eqns, iter_shaped_values, provenance, subjaxprs,
        user_frame)


# ---------------------------------------------------------------------------
# buffers
# ---------------------------------------------------------------------------


def seeded_full_logits(h, w):
    return (h @ w).logsumexp(-1).mean()


def test_seeded_forbidden_shape_flagged_with_provenance():
    p = programs.trace("seeded", seeded_full_logits,
                       (_rand(2, 16, 32), _rand(32, 64)))
    v = _named(buffer_audit.check_forbidden_shape(p, (2, 16, 64), "seeded",
                                                  "full-logits"),
               "buffer.forbidden-shape")
    assert "forbidden full-logits shape (2, 16, 64) (float32)" in \
        v[0].message
    assert "(seeded_full_logits)" in v[0].provenance
    assert buffer_audit.has_shape(p, (2, 16, 64))
    assert not buffer_audit.has_shape(p, (2, 16, 65))


def test_seeded_byte_ceiling_and_top_intermediates():
    """The [2, 16, 64] f32 logits are 8192 bytes: a 4096-byte ceiling is
    broken there; the report's top row names them, as the matmul writes
    them ([32, 64] rows; the reshape to [2, 16, 64] is no new buffer)."""
    p = programs.trace("seeded", seeded_full_logits,
                       (_rand(2, 16, 32), _rand(32, 64)))
    v = _named(buffer_audit.check_byte_ceiling(p, 4096, "seeded"),
               "buffer.byte-ceiling")
    assert "is 8192 bytes > ceiling 4096" in v[0].message
    assert "(seeded_full_logits)" in v[0].provenance
    assert buffer_audit.check_byte_ceiling(p, 8192, "seeded") == []
    top = buffer_audit.top_intermediates(p, k=1)[0]
    assert (top["nbytes"], top["shape"], top["dtype"]) == \
        (8192, (32, 64), "float32")
    assert top["op"].startswith("aten.mm.default")


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------


def seeded_f32_dot(a, b):
    return a.float() @ b.float()


def test_seeded_f32_matmul_under_bf16_flagged():
    args = (_rand(8, 16, dtype=torch.bfloat16),
            _rand(16, 4, dtype=torch.bfloat16))
    p = programs.trace("seeded", seeded_f32_dot, args)
    v = _named(dtype_audit.check_dtype_policy(p, "seeded"),
               "dtype.f32-dot-under-bf16")
    assert "f32 mm (8, 16) x (16, 4) under bf16 policy" in v[0].message
    assert "(seeded_f32_dot)" in v[0].provenance
    assert dtype_audit.check_dtype_policy(p, "seeded", policy="f32") == []
    bf16 = programs.trace("bf16", lambda a, b: a @ b, args)
    assert dtype_audit.check_dtype_policy(bf16, "bf16") == []


def test_the_same_call_inside_an_allowlisted_function_is_clean():
    """The fused CE's `_mm_f32` widens bf16 operands on the CPU by design:
    allowlisted by file and function. The seeding function passes once it
    is allowlisted itself."""
    args = (_rand(8, 16, dtype=torch.bfloat16),
            _rand(16, 4, dtype=torch.bfloat16))
    p = programs.trace("allowed", lf._mm_f32, args)
    assert [graph_walk.provenance(n) for n, _ in graph_walk.iter_eqns(p)
            if dtype_audit._product(n)][0].endswith("(_mm_f32)")
    assert dtype_audit.check_dtype_policy(p, "allowed") == []
    seeded = programs.trace("seeded", seeded_f32_dot, args)
    assert dtype_audit.check_dtype_policy(
        seeded, "seeded",
        allowlist=("test_torch_analysis_rules.py::seeded_f32_dot",)) == []


# ---------------------------------------------------------------------------
# host sync
# ---------------------------------------------------------------------------


def seeded_item(x):
    return x * x.sum().item()


def seeded_int(x):
    n = int(x.sum())
    return x * n


def seeded_to_host(x):
    return x.cpu() + 1


def seeded_value_branch(x):
    def scaled(x):
        return x * x.max().item()

    return torch.cond(x.sum() > 0, scaled, lambda y: y - 1, (x,))


@pytest.mark.parametrize("fn, arg, what, where", [
    (seeded_item, lambda: _rand(4), "_local_scalar_dense", "top level"),
    (seeded_int, lambda: _rand(4), "GuardOnDataDependentSymNode", None),
    (seeded_to_host, lambda: _fake_cuda(4), "copies a cuda value to the "
     "host", "top level"),
    (seeded_value_branch, lambda: _rand(4), "_local_scalar_dense",
     "(cond)"),
], ids=["item", "int", "cpu", "cond"])
def test_seeded_host_read_flagged_with_provenance(fn, arg, what, where):
    """`.item()` (a recorded read), `int(t)` (a read that stops the trace:
    the line is kept), `.cpu()` of a card value, and `.item()` inside a
    torch.cond branch, found in its subgraph."""
    p = programs.trace("seeded", fn, (arg(),))
    v = _named(host_sync_audit.check_host_sync(p, "seeded"),
               "host-sync.callback-in-step")
    assert len(v) == 1 and what in v[0].message, v
    if where is not None:
        assert where in v[0].message
    else:
        assert p.graph_module is None and p.host_reads
    name = "scaled" if fn is seeded_value_branch else fn.__name__
    assert f"({name})" in v[0].provenance, v[0].provenance


def test_host_sync_clean_program_and_host_value_kept_out():
    """A step reading only its traced inputs on the card is clean; a host
    value closed over (the optimizer's step counter) is no traced input
    and no finding."""
    counter = torch.zeros((), dtype=torch.int64)

    def step(x):
        return x * (1.0 - 0.9 ** (int(counter) + 1))

    p = programs.trace("clean", step, (_fake_cuda(4, 4),))
    assert host_sync_audit.check_host_sync(p, "clean") == []


# ---------------------------------------------------------------------------
# donation: state written in place
# ---------------------------------------------------------------------------


def seeded_adamw(params, grads):
    """AdamW's update written out of place: new tensors stand in for the
    donated params."""
    return {k: p - 0.01 * (g / (g.abs() + 1e-8) + 0.01 * p)
            for k, (p, g) in zip(params, zip(params.values(),
                                             grads.values()))}


def test_seeded_out_of_place_adamw_flagged():
    params = {"w": _rand(4, 8), "b": _rand(8, seed=1)}
    grads = {"w": _rand(4, 8, seed=2), "b": _rand(8, seed=3)}
    p = programs.trace("seeded", seeded_adamw, (params, grads),
                       donated=(0,), arg_names=("params", "grads"))
    v = _named(donation_audit.check_donation(p), "donation.not-aliased")
    assert len(v) == 2
    assert "donated input params['w'] (flat arg 0) is never written in " \
        "place" in v[0].message
    assert "returns a fresh (4, 8) float32 buffer instead" in v[0].message
    assert "(seeded_adamw)" in v[0].provenance


def test_in_place_state_through_views_is_clean():
    """Writes through select/slice/index_put_ reach the donated pool; the
    real AdamW update is clean."""
    from paddle_tpu_torch.distributed.hybrid_engine import (adamw_init,
                                                            adamw_update)

    def write_pool(pool, idx, new):
        pool[1][idx, :, 2] = new
        pool[0, 3:5].zero_()
        return pool

    pool = _rand(2, 6, 3, 4, 8)
    p = programs.trace("pool", write_pool,
                       (pool, torch.tensor([0, 4]), _rand(2, 3, 8)),
                       donated=(0,))
    assert donation_audit.check_donation(p) == []
    params = {"w": _rand(4, 8)}
    state = adamw_init(params)
    step = state.pop("step")
    q = programs.trace(
        "adamw", lambda ps, gs, st: adamw_update(ps, gs, dict(st, step=step)),
        (params, {"w": _rand(4, 8, seed=1)}, state), donated=(0, 2))
    assert donation_audit.check_donation(q) == []


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_TP_FP, _EMPTY_FP = "a91763b43edf", "da39a3ee5e6b"


def seeded_collectives(n, group="mp"):
    """A GraphModule with n all_reduce(sum) nodes on `group`, built by hand
    (no process group)."""
    g = torch.fx.Graph()
    with graph_walk.stamping():
        x = g.placeholder("x")
        x.meta["val"] = _fake_cuda(4, 4)
        for _ in range(n):
            x = g.call_function(
                torch.ops._c10d_functional.all_reduce.default,
                (x, "sum", group))
            x.meta["val"] = _fake_cuda(4, 4)
        g.output(x)
    return torch.fx.GraphModule(torch.nn.Module(), g)


def test_census_names_the_reference_primitives_and_goldens_match():
    """Two all_reduce(sum) nodes on "mp" are the reference's
    psum@mp;psum@mp, with its golden; an empty census is the empty
    golden; the group maps to a mesh axis."""
    census = collective_audit.collective_census(seeded_collectives(2))
    assert [(c["prim"], c["axes"], c["shape"]) for c in census] == \
        [("psum", ("mp",), (4, 4))] * 2
    assert collective_audit.fingerprint(census) == _TP_FP
    assert collective_audit.fingerprint(
        collective_audit.collective_census(seeded_collectives(0))) == \
        _EMPTY_FP
    mapped = collective_audit.collective_census(
        seeded_collectives(2, group="tp_group_7"),
        axes={"tp_group_7": "mp"})
    assert collective_audit.fingerprint(mapped) == _TP_FP
    assert collective_audit.check_collectives(
        seeded_collectives(2), "tp", expect_count=2,
        expect_fingerprint=_TP_FP) == []


@pytest.mark.parametrize("n, found", [(4, 4), (1, 1)],
                         ids=["doubled", "dropped"])
def test_seeded_doubled_or_dropped_all_reduce_flagged(n, found):
    v = collective_audit.check_collectives(
        seeded_collectives(n), "seeded", expect_count=2,
        expect_fingerprint=_TP_FP)
    assert {x.rule for x in v} == {"collective.count-mismatch",
                                   "collective.fingerprint-mismatch"}
    count = _named(v, "collective.count-mismatch")[0]
    assert f"expected 2 collectives, found {found}" in count.message
    assert all("(seeded_collectives)" in x.provenance for x in v)


# ---------------------------------------------------------------------------
# the reference departs
# ---------------------------------------------------------------------------


def test_ref_departs_jax_provenance_is_empty():
    """Under jax 0.9 the reference's audits return empty provenance for a
    seeded forbidden shape (so its dtype allowlist, matched by provenance,
    never matches); the port's names the seeding function (above)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.analysis import buffer_audit as ref_buffer

    jx = jax.make_jaxpr(lambda h, w: jax.nn.logsumexp(h @ w, -1).mean())(
        jnp.ones((2, 16, 32)), jnp.ones((32, 64)))
    v = ref_buffer.check_forbidden_shape(jx, (2, 16, 64), "seeded")
    assert v and v[0].rule == "buffer.forbidden-shape"
    assert v[0].provenance == ""
