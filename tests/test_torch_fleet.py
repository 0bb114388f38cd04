"""The port's `fleet` entry (`paddle_tpu_torch.distributed.fleet`) against
the JAX package's: `CommunicateTopology` at dp2 x mp2 x pp2 (ranks,
coordinates, `get_comm_list`) exactly; a 4-rank gloo run of `fleet.init`
at dp2 x mp2 (`tests/torch_dist_ranks.py`, case `fleet`) whose live dp and
mp groups are the JAX topology's lists and reduce over exactly their
members; at one rank on the CPU, `distributed_model` returns the model,
`distributed_optimizer` steps as the bare optimizer does, and the modes
that wait for the engines across ranks raise naming ROADMAP A9c. The
strategy, role makers, `UtilBase` and the `ProcessMesh` description
against the JAX package's."""

import itertools
import json

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu_torch as P
import paddle_tpu_torch.distributed as dist
import torch_dist_ranks as R
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ORDER = ["data", "pipe", "sharding", "sep", "model"]
DIMS = [2, 2, 1, 1, 2]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _topos(dims=DIMS):
    return (jfleet.CommunicateTopology(ORDER, dims),
            fleet.CommunicateTopology(ORDER, dims))


@pytest.mark.parametrize("axis", ORDER)
def test_topology_comm_lists_equal_the_jax_packages(axis):
    ref, port = _topos()
    assert port.get_comm_list(axis) == ref.get_comm_list(axis)
    for i in range(ref.get_dim(axis)):
        assert port.get_axis_list(axis, i) == ref.get_axis_list(axis, i)
    assert port.get_dim(axis) == ref.get_dim(axis)


def test_topology_ranks_and_coordinates_equal_the_jax_packages():
    ref, port = _topos()
    assert port.world_size() == ref.world_size() == 8
    assert port.get_hybrid_group_names() == ref.get_hybrid_group_names()
    for coord in itertools.product(*(range(d) for d in DIMS)):
        kw = dict(zip(ORDER, coord))
        assert port.get_rank(**kw) == ref.get_rank(**kw)
    for r in range(8):
        assert tuple(port.get_coord(r)) == tuple(ref.get_coord(r))
        for stage in range(2):
            assert port.get_rank_from_stage(r, pipe=stage) == \
                ref.get_rank_from_stage(r, pipe=stage)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    results = R.launch("fleet", 4, out)
    for code, text in results:
        assert code == 0, text[-4000:]
    return [json.loads((out / f"fleet_r{r}.json").read_text())
            for r in range(4)]


def _jax_lists():
    topo = jfleet.CommunicateTopology(ORDER, [2, 1, 1, 1, 2])
    return {"dp": topo.get_comm_list("data"),
            "mp": topo.get_comm_list("model"),
            "pp": topo.get_comm_list("pipe"),
            "sharding": topo.get_comm_list("sharding"),
            "sep": topo.get_comm_list("sep")}


@pytest.mark.parametrize("axis", ["dp", "mp", "pp", "sharding", "sep"])
def test_each_ranks_live_group_is_the_jax_topologys_and_reduces_over_it(
        four, axis):
    lists = _jax_lists()[axis]
    for r, res in enumerate(four):
        mine = [line for line in lists if r in line]
        assert res[axis]["ranks"] == mine[0]
        assert res[axis]["rank_in_group"] == mine[0].index(r)
        assert res[axis]["sum"] == [float(sum(q + 1 for q in mine[0]))] * 3


def test_dp2_mp2_is_tensor_parallel_and_its_model_waits_for_a9c(four):
    for r, res in enumerate(four):
        assert res["mode"] == "tensor_parallel"
        assert res["worker_index"] == r and res["worker_num"] == 4
        assert res["coord"] == [r // 2, r % 2]
        assert "A9c" in res["tensor_parallel_model"]


def test_inferred_dp4_gives_data_parallel_over_the_world(four):
    for res in four:
        assert res["dp4"] == {"mode": "data_parallel",
                              "model": "DataParallel",
                              "group": [0, 1, 2, 3]}


@pytest.fixture
def one_rank():
    """The test process as world size 1 on gloo; torn down after."""
    fleet.init(is_collective=True)
    yield fleet.get_hybrid_communicate_group()
    fleet._reset_for_tests()
    dist.destroy_process_group()


def test_one_rank_distributed_model_is_the_model_itself(one_rank):
    assert one_rank.get_parallel_mode() == "single"
    assert dist.get_backend() == "GLOO" and dist.get_world_size() == 1
    model = P.nn.Linear(4, 3)
    assert fleet.distributed_model(model) is model
    assert fleet.worker_index() == 0 and fleet.worker_num() == 1
    assert fleet.is_first_worker()
    fleet.barrier_worker()


def test_one_rank_distributed_optimizer_steps_as_the_bare_one(one_rank):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    x = P.to_tensor(rng.standard_normal((5, 4)).astype(np.float32))
    params = []
    for wrap in (False, True):
        model = P.nn.Linear(4, 3)
        model.weight.set_value(w)
        opt = P.optimizer.AdamW(1e-2, parameters=model.parameters())
        if wrap:
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
            assert type(opt).__name__ == "HybridParallelOptimizer"
        for _ in range(3):
            (model(x) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
        params.append(model.weight.numpy())
    np.testing.assert_array_equal(params[0], params[1])


def test_one_rank_distributed_engine_is_the_one_card_engine(one_rank):
    from paddle_tpu_torch.distributed.engine import Engine

    model = P.nn.Linear(4, 3)
    eng = fleet.distributed_engine(model, loss=P.nn.MSELoss(),
                                   optimizer=P.optimizer.SGD(
                                       0.1, parameters=model.parameters()))
    assert isinstance(eng, Engine)


class _Mode:
    def __init__(self, mode):
        self.mode = mode

    def get_parallel_mode(self):
        return self.mode


@pytest.mark.parametrize("mode", ["sharding_parallel", "segment_parallel",
                                  "pipeline_parallel", "tensor_parallel"])
def test_modes_across_ranks_raise_naming_a9c(mode):
    f = fleet.Fleet()
    f._hcg, f._strategy = _Mode(mode), fleet.DistributedStrategy()
    with pytest.raises(NotImplementedError, match="A9c"):
        f.distributed_model(P.nn.Linear(2, 2))


def test_strategy_has_the_jax_packages_defaults():
    ref, port = jfleet.DistributedStrategy(), fleet.DistributedStrategy()
    for name in ("hybrid_configs", "sharding_configs", "pipeline_configs",
                 "amp_configs", "recompute_configs"):
        assert getattr(port, name) == getattr(ref, name), name
    assert vars(port).keys() == vars(ref).keys()
    port.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
    assert repr(port) == "DistributedStrategy(dp=2, mp=4, pp=1, " \
        "sharding=1, sep=1)"
    with pytest.raises(ValueError, match="unknown hybrid config"):
        port.hybrid_configs = {"tp_degree": 2}


@pytest.mark.parametrize("collective", [True, False])
def test_role_makers_read_the_environment_as_the_jax_packages(
        monkeypatch, collective):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2,c:3")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "s:1,s:2")
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    out = []
    for mod in (jfleet, fleet):
        rm = mod.PaddleCloudRoleMaker(is_collective=collective)
        out.append((rm.is_worker(), rm.is_server(), rm.worker_index(),
                    rm.worker_num(), rm.server_num(),
                    rm.get_trainer_endpoints(), rm.get_pserver_endpoints(),
                    rm.is_first_worker()))
        util = mod.UtilBase()
        util._set_role_maker(rm)
        out[-1] += (util.get_file_shard([f"f{i}" for i in range(8)]),)
    assert out[0] == out[1]
    um = fleet.UserDefinedRoleMaker(current_id=2, worker_num=4,
                                    role=fleet.Role.SERVER)
    assert (um.worker_index(), um.worker_num(), um.is_server()) == \
        (2, 4, True)


def test_process_mesh_describes_as_the_jax_packages_and_waits_for_a9f():
    arr = np.arange(8).reshape(2, 4)
    ref = jdist.ProcessMesh(arr, ["dp", "mp"])
    port = dist.ProcessMesh(arr, ["dp", "mp"])
    assert (port.shape, port.ndim, port.dim_names, port.process_ids) == \
        (ref.shape, ref.ndim, ref.dim_names, ref.process_ids)
    for pid in range(8):
        assert port.get_rank_by_dim_and_process_id("mp", pid) == \
            ref.get_rank_by_dim_and_process_id("mp", pid)
    assert port.get_dim_size("mp") == 4
    assert port == dist.ProcessMesh(arr, ["dp", "mp"])
    with pytest.raises(NotImplementedError, match="A9f"):
        port.jax_mesh()
    with pytest.raises(NotImplementedError, match="A9f"):
        port.sharding([], 2)
    prev = dist.get_mesh()
    try:
        dist.set_mesh(port)
        assert dist.get_mesh() is port
    finally:
        dist.set_mesh(prev)
