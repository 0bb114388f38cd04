"""paddle.distributed.fleet of the port (`paddle_tpu/distributed/fleet/`;
reference `python/paddle/distributed/fleet/`).

    import paddle_tpu_torch.distributed.fleet as fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)

The entry, the topology with its live process groups, the strategy, the
role makers, `UtilBase`, the optimizer wrappers and `recompute`. The
meta-parallel layers, `data_generator`, `utils` and the sharding, segment,
pipeline and tensor modes of `distributed_model` wait for ROADMAP A9b and
A9c; `elastic` for A9e.
"""

from paddle_tpu_torch.distributed.fleet import base  # noqa: F401
from paddle_tpu_torch.distributed.fleet import layers  # noqa: F401
from paddle_tpu_torch.distributed.fleet import meta_optimizers  # noqa: F401
from paddle_tpu_torch.distributed.fleet import recompute as _recompute_mod  # noqa: F401
from paddle_tpu_torch.distributed.fleet.base.distributed_strategy import (  # noqa: F401
    DistributedStrategy)
from paddle_tpu_torch.distributed.fleet.base.role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)
from paddle_tpu_torch.distributed.fleet.base.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.distributed.fleet.base.util_factory import UtilBase  # noqa: F401
from paddle_tpu_torch.distributed.fleet.fleet import (  # noqa: F401
    Fleet, fleet as _fleet_singleton)
from paddle_tpu_torch.distributed.fleet.recompute import (  # noqa: F401
    recompute, recompute_sequential)

# the module-level singleton dispatch (reference fleet/__init__.py)
init = _fleet_singleton.init
distributed_model = _fleet_singleton.distributed_model
distributed_engine = _fleet_singleton.distributed_engine
distributed_optimizer = _fleet_singleton.distributed_optimizer
worker_index = _fleet_singleton.worker_index
worker_num = _fleet_singleton.worker_num
is_first_worker = _fleet_singleton.is_first_worker
barrier_worker = _fleet_singleton.barrier_worker


def get_hybrid_communicate_group():
    return _fleet_singleton.get_hybrid_communicate_group()


def _reset_for_tests():
    """Reset the singleton's state."""
    _fleet_singleton._is_initialized = False
    _fleet_singleton._hcg = None
    _fleet_singleton._strategy = None


__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "Fleet", "PaddleCloudRoleMaker", "Role",
           "UserDefinedRoleMaker", "UtilBase", "init", "distributed_model",
           "distributed_engine", "distributed_optimizer", "worker_index",
           "worker_num", "is_first_worker", "barrier_worker",
           "get_hybrid_communicate_group", "recompute",
           "recompute_sequential"]
