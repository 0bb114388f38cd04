"""The port's `geometric` (`paddle_tpu_torch/geometric`) and incubate's graph
ops against the JAX package's on the CPU, on seeded numpy inputs: the
segment reductions, `send_u_recv` / `send_ue_recv` / `send_uv` under every
reduce and message op in f32 (rtol 1e-5, atol 1e-6), integer segment sums
and every index output exactly; `reindex_graph` and `reindex_heter_graph`
exactly. The samplers: exactly the JAX package's output where every
node's degree is at most the sample size; otherwise every drawn neighbour
in its node's list without repeats, the counts right, and the same draw
again after `paddle.seed`. Two `ref_departs` cases assert on every run
that the JAX package still departs: its incubate `graph_khop_sampler`
raises TypeError (it passes `sorted_eids=` to a sampler with no such
parameter), and its samplers draw from an unseeded generator (two draws
after `paddle.seed(0)` differ)."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


def _np(t):
    return np.asarray(t.numpy())


def _graph(n=40, e=160, f=6, seed=0):
    """Node features [n, f], edge features [e, f] and [e, 1], and edges
    src -> dst in [0, n); node n - 1 receives no edge (an empty segment)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.standard_normal((e, f)).astype(np.float32)
    w = (rng.random((e, 1)) + 0.5).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n - 1, e).astype(np.int64)
    return x, y, w, src, dst


SEGMENT_OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min")


@pytest.mark.parametrize("op", SEGMENT_OPS)
def test_segment_ops_match(op):
    _, y, _, _, dst = _graph()
    ids = np.sort(dst)
    got, want = (getattr(M.geometric, op)(M.to_tensor(y), M.to_tensor(ids))
                 for M in (P, J))
    _close(_np(got), _np(want))
    # an empty segment (dst never reaches n - 1, and sorted ids skip some)
    # gives 0 in both


def test_integer_segment_sum_is_exact():
    rng = np.random.default_rng(1)
    data = rng.integers(-50, 50, (30, 3)).astype(np.int32)
    ids = np.sort(rng.integers(0, 8, 30)).astype(np.int64)
    got, want = (M.geometric.segment_sum(M.to_tensor(data), M.to_tensor(ids))
                 for M in (P, J))
    _exact(_np(got), _np(want))
    got, want = (M.incubate.segment_max(M.to_tensor(data), M.to_tensor(ids))
                 for M in (P, J))
    _exact(_np(got), _np(want))


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("out_size", [None, 45])
def test_send_u_recv_matches(reduce_op, out_size):
    x, _, _, src, dst = _graph(seed=2)
    got, want = (M.geometric.send_u_recv(
        M.to_tensor(x), M.to_tensor(src), M.to_tensor(dst), reduce_op,
        out_size=out_size) for M in (P, J))
    _close(_np(got), _np(want))
    got2 = P.incubate.graph_send_recv(P.to_tensor(x), P.to_tensor(src),
                                      P.to_tensor(dst), reduce_op,
                                      out_size=out_size)
    want2 = J.incubate.graph_send_recv(J.to_tensor(x), J.to_tensor(src),
                                       J.to_tensor(dst), reduce_op,
                                       out_size=out_size)
    _close(_np(got2), _np(want2))


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_ue_recv_matches(message_op, reduce_op):
    x, y, w, src, dst = _graph(seed=3)
    edge = w if message_op == "div" else y
    got, want = (M.geometric.send_ue_recv(
        M.to_tensor(x), M.to_tensor(edge), M.to_tensor(src),
        M.to_tensor(dst), message_op, reduce_op) for M in (P, J))
    _close(_np(got), _np(want))


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv_matches(message_op):
    x, _, _, src, dst = _graph(seed=4)
    y = np.abs(x) + 0.5
    got, want = (M.geometric.send_uv(M.to_tensor(x), M.to_tensor(y),
                                     M.to_tensor(src), M.to_tensor(dst),
                                     message_op) for M in (P, J))
    _close(_np(got), _np(want))


def test_reindex_graph_and_heter_graph_are_exact():
    x = np.asarray([10, 3, 7], np.int64)
    nb = np.asarray([3, 11, 10, 12, 11, 7, 20, 3], np.int64)
    count = np.asarray([3, 2, 3], np.int64)
    outs = [M.geometric.reindex_graph(M.to_tensor(x), M.to_tensor(nb),
                                      M.to_tensor(count)) for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))
    outs = [M.incubate.graph_reindex(M.to_tensor(x), M.to_tensor(nb),
                                     M.to_tensor(count)) for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))
    nb2 = np.asarray([30, 10, 3, 31], np.int64)
    c2 = np.asarray([1, 2, 1], np.int64)
    outs = [M.geometric.reindex_heter_graph(
        M.to_tensor(x), [M.to_tensor(nb), M.to_tensor(nb2)],
        [M.to_tensor(count), M.to_tensor(c2)]) for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))


def _csc(n=60, max_deg=9, seed=5):
    """A CSC graph: node i's neighbours are row[colptr[i]:colptr[i+1]],
    distinct, degrees 0..max_deg; edge ids 1000 + position."""
    rng = np.random.default_rng(seed)
    rows, colptr = [], [0]
    for _ in range(n):
        deg = int(rng.integers(0, max_deg + 1))
        rows.extend(rng.choice(n, deg, replace=False).tolist())
        colptr.append(len(rows))
    row = np.asarray(rows, np.int64)
    return row, np.asarray(colptr, np.int64), 1000 + np.arange(len(row))


def _lists(row, colptr):
    return {i: row[colptr[i]:colptr[i + 1]].tolist()
            for i in range(len(colptr) - 1)}


def test_sample_neighbors_exact_where_degree_fits():
    row, colptr, eids = _csc()
    nodes = np.asarray([0, 5, 17, 33, 59, 5], np.int64)
    outs = [M.geometric.sample_neighbors(
        M.to_tensor(row), M.to_tensor(colptr), M.to_tensor(nodes),
        eids=M.to_tensor(eids), sample_size=9, return_eids=True)
        for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))
    # sample_size -1: every neighbour
    outs = [M.incubate.graph_sample_neighbors(
        M.to_tensor(row), M.to_tensor(colptr), M.to_tensor(nodes))
        for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))


def _check_draw(out, count, nodes, lists, size, eids_out=None, eids=None,
                colptr=None):
    out, count = _np(out).tolist(), _np(count).tolist()
    at = 0
    for n, c in zip(nodes.tolist(), count):
        assert c == min(size, len(lists[n]))
        drawn = out[at:at + c]
        assert len(set(drawn)) == c
        assert set(drawn) <= set(lists[n])
        if eids_out is not None:
            pos = {v: colptr[n] + k for k, v in enumerate(lists[n])}
            assert _np(eids_out).tolist()[at:at + c] == [
                int(eids[pos[v]]) for v in drawn]
        at += c
    assert at == len(out)


@pytest.mark.parametrize("weighted", [False, True])
def test_samplers_draw_neighbours_and_repeat_under_seed(weighted):
    row, colptr, eids = _csc(n=80, max_deg=12, seed=6)
    lists = _lists(row, colptr)
    nodes = np.arange(80, dtype=np.int64)
    wts = np.random.default_rng(7).random(len(row)).astype(np.float32) + 0.1

    def draw():
        args = (P.to_tensor(row), P.to_tensor(colptr))
        if weighted:
            return P.geometric.weighted_sample_neighbors(
                *args, P.to_tensor(wts), P.to_tensor(nodes),
                eids=P.to_tensor(eids), sample_size=4, return_eids=True)
        return P.geometric.sample_neighbors(
            *args, P.to_tensor(nodes), eids=P.to_tensor(eids),
            sample_size=4, return_eids=True)

    P.seed(11)
    first = draw()
    _check_draw(first[0], first[1], nodes, lists, 4, first[2], eids, colptr)
    second = draw()
    P.seed(11)
    again = draw()
    for a, b in zip(first, again):
        _exact(_np(a), _np(b))
    assert not np.array_equal(_np(first[0]), _np(second[0]))


def test_khop_sampler_exact_where_degrees_fit_and_valid_otherwise():
    row, colptr, eids = _csc(n=50, max_deg=6, seed=8)
    lists = _lists(row, colptr)
    nodes = np.asarray([1, 7, 30], np.int64)
    outs = [M.geometric.khop_sampler(
        M.to_tensor(row), M.to_tensor(colptr), M.to_tensor(nodes),
        eids=M.to_tensor(eids), sample_sizes=[6, 6], return_eids=True)
        for M in (P, J)]
    for got, want in zip(*outs):
        _exact(_np(got), _np(want))

    def draw():
        return P.incubate.graph_khop_sampler(
            P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes),
            [3, 2], sorted_eids=P.to_tensor(eids), return_eids=True)

    P.seed(3)
    src, dst, index, rx, e = draw()
    index = _np(index).tolist()
    assert index[:3] == nodes.tolist() and _np(rx).tolist() == [0, 1, 2]
    assert len(set(index)) == len(index)
    for s, d, eid in zip(_np(src).tolist(), _np(dst).tolist(),
                         _np(e).tolist()):
        assert index[s] in lists[index[d]]
        assert row[eid - 1000] == index[s]
    P.seed(3)
    for a, b in zip((src, dst), draw()[:2]):
        _exact(_np(a), _np(b))


def test_ref_departs_incubate_khop_sampler_raises_typeerror():
    """The JAX package's incubate.graph_khop_sampler passes sorted_eids= to
    geometric.khop_sampler, whose parameter is eids: TypeError. The port
    passes it as eids (the test above runs it)."""
    row, colptr, _ = _csc()
    with pytest.raises(TypeError, match="sorted_eids"):
        J.incubate.graph_khop_sampler(
            J.to_tensor(row), J.to_tensor(colptr),
            J.to_tensor(np.asarray([0, 1], np.int64)), [2, 2])


def test_ref_departs_jax_samplers_ignore_the_seed():
    """200 nodes of degree 50, 5 drawn each: two equal draws have
    probability C(50, 5)^-200 < 1e-30 unless the generator is seeded. The
    JAX package's is not: two draws after paddle.seed(0) differ."""
    row = np.concatenate([np.arange(50) for _ in range(200)]).astype(
        np.int64)
    colptr = (50 * np.arange(201)).astype(np.int64)
    nodes = np.arange(200, dtype=np.int64)
    draws = []
    for _ in range(2):
        J.seed(0)
        draws.append(_np(J.geometric.sample_neighbors(
            J.to_tensor(row), J.to_tensor(colptr), J.to_tensor(nodes),
            sample_size=5)[0]))
    assert not np.array_equal(draws[0], draws[1])
    # the port's repeat
    port = []
    for _ in range(2):
        P.seed(0)
        port.append(_np(P.geometric.sample_neighbors(
            P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes),
            sample_size=5)[0]))
    np.testing.assert_array_equal(port[0], port[1])


def test_incubate_part_2_names_raise_naming_their_slice():
    for name in ("softmax_mask_fuse", "LookAhead", "ModelAverage"):
        with pytest.raises(AttributeError, match="A10g part 2"):
            getattr(P.incubate, name)
    assert P.incubate.identity_loss is P.nn.functional.identity_loss
    assert P.incubate.segment_sum is P.geometric.segment_sum
