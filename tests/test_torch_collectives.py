"""The port's collectives (`paddle_tpu_torch.distributed.communication`)
at 2 gloo ranks against the JAX package's in-trace collectives run under
`shard_map` on 2 of the 8 virtual CPU devices: rank r's result equals shard
r's (ROADMAP, expected differences: one process a rank). The ranks run
once for the file (`tests/torch_dist_ranks.py`, case `collectives`), each
writing its results; SUM, MAX, MIN and AVG are held exactly on the seeded
float32 inputs. Where the JAX package departs from Paddle (PROD, `reduce`
on ranks other than dst, `get_backend`; ROADMAP §C) the port is held
to numpy and a `ref_departs` case asserts the JAX package still departs.
Collectives the JAX package runs only eagerly on one controller (scatter,
point to point, the object collectives) are held to their definitions."""

import json

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as Pspec

import paddle_tpu.distributed as jdist
import paddle_tpu_torch.distributed as dist
import torch_dist_ranks as R
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

N = 2
X = [R.rank_input(r) for r in range(N)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    results = R.launch("collectives", N, out)
    for code, text in results:
        assert code == 0, text[-4000:]
    return out


def _got(out, name):
    return [np.load(out / f"{name}_r{r}.npy") for r in range(N)]


def _json(out, r):
    return json.loads((out / f"collectives_r{r}.json").read_text())


def _jax(body):
    """body over each shard of the ranks' stacked inputs, under shard_map
    on 2 devices: [shard r's result] for r in 0, 1."""
    mesh = jdist.ProcessMesh(np.arange(N), ["world"])
    g = jdist.new_group(list(range(N)), axis_name="world", mesh=mesh)
    fn = shard_map(lambda x: body(x, g), mesh=mesh.jax_mesh(),
                   in_specs=Pspec("world"), out_specs=Pspec("world"),
                   check_vma=False)
    out = np.asarray(fn(jnp.asarray(np.concatenate(X))))
    return np.split(out, N)


EXACT_OPS = {"sum": jdist.ReduceOp.SUM, "max": jdist.ReduceOp.MAX,
             "min": jdist.ReduceOp.MIN, "avg": jdist.ReduceOp.AVG}


@pytest.mark.parametrize("name", sorted(EXACT_OPS))
def test_all_reduce_equals_the_jax_shards_exactly(ranks, name):
    want = _jax(lambda x, g: jdist.all_reduce(
        x, op=EXACT_OPS[name], group=g).wait())
    for r, got in enumerate(_got(ranks, f"all_reduce_{name}")):
        np.testing.assert_array_equal(got, want[r])


def test_all_reduce_prod_is_the_product(ranks):
    want = X[0] * X[1]
    assert (want < 0).any()
    for got in _got(ranks, "all_reduce_prod"):
        np.testing.assert_array_equal(got, want)


def test_ref_departs_jax_prod_is_nan_on_a_negative_entry():
    got = _jax(lambda x, g: jdist.all_reduce(
        x, op=jdist.ReduceOp.PROD, group=g).wait())[0]
    negative = (X[0] < 0) | (X[1] < 0)
    assert negative.any() and np.isnan(got[negative]).all()


def test_async_all_reduce_lands_on_wait(ranks):
    want = _jax(lambda x, g: jdist.all_reduce(x, group=g).wait())
    for r, got in enumerate(_got(ranks, "all_reduce_async")):
        np.testing.assert_array_equal(got, want[r])
        assert _json(ranks, r)["async_value_is_input"]


def _gather_list(x, g):
    out = []
    jdist.all_gather(out, x, group=g)
    return jnp.stack(out)


@pytest.mark.parametrize("form", ["list", "tiled"])
def test_all_gather_equals_the_jax_shards(ranks, form):
    body = _gather_list if form == "list" else \
        (lambda x, g: jdist.all_gather(x, group=g, axis=0))
    want = _jax(body)
    for r, got in enumerate(_got(ranks, f"all_gather_{form}")):
        np.testing.assert_array_equal(got, want[r])


@pytest.mark.parametrize("form", ["tensor", "list"])
def test_reduce_scatter_equals_the_jax_shards(ranks, form):
    def body(x, g):
        inp = x if form == "tensor" else [x[:2], x[2:]]
        return jdist.reduce_scatter(jnp.zeros((2, 6), x.dtype), inp,
                                    group=g).wait()

    want = _jax(body)
    name = "reduce_scatter" if form == "tensor" else "reduce_scatter_list"
    for r, got in enumerate(_got(ranks, name)):
        np.testing.assert_array_equal(got, want[r])


def test_reduce_scatter_avg_is_the_sum_over_n(ranks):
    """gloo's AVG is the SUM divided by n, after it (the module's docs)."""
    total = X[0] + X[1]
    for r, got in enumerate(_got(ranks, "reduce_scatter_avg")):
        np.testing.assert_array_equal(got, total[2 * r:2 * r + 2] / N)


def test_broadcast_equals_the_jax_shards(ranks):
    want = _jax(lambda x, g: jdist.broadcast(x, src=1, group=g).wait())
    for r, got in enumerate(_got(ranks, "broadcast")):
        np.testing.assert_array_equal(got, want[r])
        np.testing.assert_array_equal(got, X[1])


def test_alltoall_equals_the_jax_shards(ranks):
    def body(x, g):
        out = []
        jdist.alltoall(out, [x[:2], x[2:]], group=g)
        return jnp.concatenate(out)

    want = _jax(body)
    for r, got in enumerate(_got(ranks, "alltoall")):
        np.testing.assert_array_equal(got, want[r])


def test_alltoall_single_equals_the_jax_shards(ranks):
    want = _jax(lambda x, g: jdist.alltoall_single(None, x, group=g).wait())
    for r, got in enumerate(_got(ranks, "alltoall_single")):
        np.testing.assert_array_equal(got, want[r])


def test_reduce_is_defined_on_dst_only(ranks):
    """dst holds the JAX shard's sum; the other rank keeps its input
    (Paddle's contract)."""
    want = _jax(lambda x, g: jdist.reduce(x, dst=0, group=g).wait())
    got = _got(ranks, "reduce")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], X[1])


def test_ref_departs_jax_reduce_gives_every_rank_the_result():
    want = _jax(lambda x, g: jdist.reduce(x, dst=0, group=g).wait())
    np.testing.assert_array_equal(want[1], X[0] + X[1])


def test_scatter_gives_rank_i_the_srcs_ith_tensor(ranks):
    got = _got(ranks, "scatter")
    np.testing.assert_array_equal(got[0], X[1])
    np.testing.assert_array_equal(got[1], 2 * X[1])


def test_send_recv_and_batch_isend_irecv_swap_the_ranks_tensors(ranks):
    p2p, batch = _got(ranks, "p2p"), _got(ranks, "batch_p2p")
    for r in range(N):
        np.testing.assert_array_equal(p2p[r], X[1 - r])
        np.testing.assert_array_equal(batch[r], 3 * X[1 - r])


def test_object_collectives_gather_and_barrier(ranks):
    res = [_json(ranks, r) for r in range(N)]
    for r in range(N):
        assert res[r]["all_gather_object"] == [
            {"rank": 0, "tag": "r0"}, {"rank": 1, "tag": "r1"}]
        assert res[r]["broadcast_object_list"] == ["from 1", 10]
        assert res[r]["scatter_object_list"] == [{"to": r}]
        assert res[r]["rank"] == r and res[r]["world"] == N
    assert [x["gather_len"] for x in res] == [0, N]
    np.testing.assert_array_equal(np.load(ranks / "gather_r1.npy"),
                                  np.stack(X))


def test_subgroups_reduce_over_their_members_only(ranks):
    for r in range(N):
        res = _json(ranks, r)
        assert res["subgroup_is_identity"] and not res["other_group_member"]


def test_get_backend_names_gloo(ranks):
    assert {_json(ranks, r)["backend"] for r in range(N)} == {"GLOO"}


def test_ref_departs_jax_backend_is_xla():
    assert jdist.get_backend() == "XLA"


def test_init_parallel_env_without_a_card_or_set_device_raises(monkeypatch):
    """No card and no set_device('cpu'): the device resolution raises
    before any process group is made; nothing falls back to the CPU."""
    monkeypatch.setattr(port_device, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_parallel_env()
    assert not dist.is_initialized()
    assert not torch.distributed.is_initialized()
