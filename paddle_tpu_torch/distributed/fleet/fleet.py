"""The fleet singleton: init / distributed_model / distributed_optimizer
(`paddle_tpu/distributed/fleet/fleet.py`; reference
`python/paddle/distributed/fleet/fleet.py:218` init, `:1448`
distributed_optimizer, model dispatch `fleet/model.py:33,143-188`).

`init` joins the ranks (`init_parallel_env`), takes the degrees of
`strategy.hybrid_configs` (one left at -1 is inferred from the world
size; their product must be the world size) and builds the
`HybridCommunicateGroup`. `distributed_model` returns the model itself at
one rank (mode "single") and `DataParallel` over the dp group under pure
data parallelism; the sharding, segment, pipeline and tensor modes wait
for the engines across ranks (ROADMAP A9c) and raise naming it.
"""

from __future__ import annotations

from paddle_tpu_torch.distributed.fleet.base.distributed_strategy import (
    DistributedStrategy)
from paddle_tpu_torch.distributed.fleet.base.topology import (
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.ops._common import waits_for

__all__ = ["Fleet", "fleet"]

_ORDER_TO_TOPO = {"dp": "data", "pp": "pipe", "sharding": "sharding",
                  "sep": "sep", "mp": "model"}


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._hcg = None
        self._strategy = None
        self._user_defined_strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        from paddle_tpu_torch.distributed.parallel import (get_world_size,
                                                           init_parallel_env)

        init_parallel_env()
        if strategy is None:
            strategy = DistributedStrategy()
        self._strategy = self._user_defined_strategy = strategy
        h = strategy.hybrid_configs
        n = get_world_size()
        degrees = {"dp": h["dp_degree"], "mp": h["mp_degree"],
                   "pp": h["pp_degree"], "sharding": h["sharding_degree"],
                   "sep": h["sep_degree"]}
        unset = [k for k, v in degrees.items() if v in (-1, None)]
        if len(unset) > 1:
            raise ValueError(f"fleet.init: at most one degree may be "
                             f"inferred, {unset} are unset")
        known = 1
        for k, v in degrees.items():
            if k not in unset:
                known *= v
        if unset:
            degrees[unset[0]] = max(1, n // known)
        total = 1
        for v in degrees.values():
            total *= v
        if total != n:
            raise ValueError(f"fleet.init: degrees {degrees} make {total} "
                             f"ranks, the world has {n}")
        order = h.get("order") or ["dp", "pp", "sharding", "sep", "mp"]
        topo = CommunicateTopology(
            hybrid_group_names=[_ORDER_TO_TOPO[o] for o in order],
            dims=[degrees[o] for o in order])
        self._hcg = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self

    # -- accessors (reference fleet.py) -------------------------------------
    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        from paddle_tpu_torch.distributed.parallel import get_rank

        return get_rank()

    def worker_num(self):
        from paddle_tpu_torch.distributed.parallel import get_world_size

        return get_world_size()

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_endpoints(self):
        import os

        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [""]

    def barrier_worker(self):
        from paddle_tpu_torch.distributed.communication import barrier

        barrier()

    # -- model / optimizer wrapping -----------------------------------------
    def distributed_model(self, model):
        """Reference fleet/model.py:143-188: dispatch by parallel mode."""
        if self._hcg is None:
            raise RuntimeError("call fleet.init() first")
        mode = self._hcg.get_parallel_mode()
        if mode == "single":
            return model
        if mode == "data_parallel":
            from paddle_tpu_torch.distributed.parallel import DataParallel

            return DataParallel(
                model,
                find_unused_parameters=self._strategy.find_unused_parameters,
                group=self._hcg.get_data_parallel_group())
        raise waits_for(f"distributed.fleet.distributed_model ({mode})",
                        "A9c", "the engines across ranks: sharding, "
                        "segment, pipeline and tensor parallelism")

    def distributed_engine(self, model, loss=None, optimizer=None, **kwargs):
        """The one-card `Engine` at one rank (reference auto-parallel
        `Engine`); across ranks it waits for ROADMAP A9c."""
        from paddle_tpu_torch.distributed.engine import Engine
        from paddle_tpu_torch.distributed.parallel import get_world_size

        if self._hcg is None:
            raise RuntimeError("call fleet.init() first")
        if get_world_size() > 1:
            raise waits_for("distributed.fleet.distributed_engine", "A9c",
                            "the Engine across ranks")
        return Engine(model, loss=loss, optimizer=optimizer, **kwargs)

    def distributed_optimizer(self, optimizer, strategy=None):
        """Reference fleet.py:1448 -> HybridParallelOptimizer."""
        if strategy is not None:
            self._strategy = strategy
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.dygraph_optimizer import (  # noqa: E501
            HybridParallelOptimizer)

        if self._hcg is not None:
            return HybridParallelOptimizer(optimizer, self._hcg,
                                           self._strategy)
        return optimizer


fleet = Fleet()
