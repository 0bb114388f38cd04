"""Hybrid-parallel topology (`paddle_tpu/distributed/fleet/base/
topology.py`; reference `python/paddle/distributed/fleet/base/
topology.py:189-229`).

`CommunicateTopology` is index arithmetic: ranks laid out row-major over
the axes, the JAX package's exactly. `HybridCommunicateGroup` builds the
real process groups: for each axis, every line of `get_comm_list` becomes
a group (each rank makes them all, in the same order, as torch requires),
and this rank keeps the line it is on (reference `topology.py:212`). It
also publishes `mesh`, a `ProcessMesh` description with one dim an axis.
"""

from __future__ import annotations

import itertools

import numpy as np

from paddle_tpu_torch.distributed.collective import new_group
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh, set_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = itertools.product(*(range(d) for d in dims))
        self._world = np.arange(int(np.prod(dims))).reshape(dims)
        self._coord_of = {}
        for coord, rank in np.ndenumerate(self._world):
            self._coord_of[int(rank)] = coord

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._world[coord])

    def get_coord(self, rank):
        return self._coord_of[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on `axis_name` equals index."""
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(int(r) for r in self._world[tuple(sl)].flatten())

    def get_comm_list(self, axis_name):
        """The rank lists of the groups along `axis_name`, one a line."""
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, axis, -1)
        return [list(map(int, line))
                for line in moved.reshape(-1, self._dims[axis])]

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = dict(zip(self._parallel_names, self.get_coord(global_rank)))
        coord.update(kwargs)
        return self.get_rank(**coord)


class HybridCommunicateGroup:
    """dp/mp/pp/sharding/sep groups of this rank over a topology whose size
    is the world's. Axis names: data -> 'dp', model -> 'mp', pipe -> 'pp',
    sharding -> 'sharding', sep -> 'sep'."""

    _AXIS_NAME = {"data": "dp", "model": "mp", "pipe": "pp",
                  "sharding": "sharding", "sep": "sep"}

    def __init__(self, topology):
        from paddle_tpu_torch.distributed.parallel import (get_rank,
                                                           get_world_size,
                                                           init_parallel_env)

        init_parallel_env()
        self._topo = topology
        self.global_rank = get_rank()
        self.nranks = topology.world_size()
        if self.nranks != get_world_size():
            raise ValueError(f"the topology's {self.nranks} ranks are not "
                             f"the world's {get_world_size()}")
        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("data")
        self._mp_degree = topology.get_dim("model")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1

        dims = [topology.get_dim(n) for n in names]
        self.mesh = ProcessMesh(np.arange(int(np.prod(dims))).reshape(dims),
                                [self._AXIS_NAME[n] for n in names])
        set_mesh(self.mesh)
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))

        self._dp_group = self._make_group("data")
        self._mp_group = self._make_group("model")
        self._pp_group = self._make_group("pipe")
        self._sharding_group = self._make_group("sharding")
        self._sep_group = self._make_group("sep") if "sep" in names else None
        self._pp_comm_group = self._pp_group

    def _make_group(self, axis):
        """Every line along `axis` becomes a group; this rank's is kept."""
        mine = None
        for ranks in self._topo.get_comm_list(axis):
            g = new_group(ranks)
            if self.global_rank in ranks:
                mine = g
        return mine

    def get_parallel_mode(self):
        # reference topology.py ParallelMode resolution order
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._sep_degree == 1:
            return "data_parallel" if self._dp_degree > 1 else "single"
        if self._sharding_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1:
            return "sharding_parallel"
        if self._sep_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1:
            return "segment_parallel"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        return "tensor_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._coord["pipe"]

    def get_pipe_parallel_rank(self):
        return self._coord["pipe"]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_p2p_groups(self):
        return None

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # sep
    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self, sharding=False):
        return self._sharding_group if sharding else self._mp_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(
            self.global_rank, pipe=stage_id, **kwargs)
