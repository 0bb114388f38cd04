"""ProcessMesh, the description (`paddle_tpu/distributed/process_mesh.py`;
reference `python/paddle/distributed/auto_parallel/process_mesh.py`): a
shape, its `dim_names` and the process ids (global ranks) laid out on it,
and the global mesh of `set_mesh`/`get_mesh`/`init_mesh`. What builds a
device sharding from it (the JAX package's `jax_mesh` and `sharding`) waits
for the auto-parallel API (ROADMAP A9f) and raises naming it.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.ops._common import waits_for

__all__ = ["ProcessMesh", "get_mesh", "set_mesh", "init_mesh"]

_global_mesh = None


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None):
        if mesh is not None:
            arr = np.asarray(mesh, dtype=np.int64)
        else:
            arr = np.asarray(process_ids, dtype=np.int64).reshape(shape)
        self._mesh = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh ndim {arr.ndim}")
        self._dim_names = list(dim_names)

    @property
    def shape(self):
        return list(self._mesh.shape)

    @property
    def ndim(self):
        return self._mesh.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return self._mesh.flatten().tolist()

    @property
    def mesh(self):
        return self._mesh

    def get_dim_size(self, dim_name):
        return self._mesh.shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        axis = self._dim_names.index(dim_name)
        coords = np.argwhere(self._mesh == process_id)
        return int(coords[0][axis]) if len(coords) else -1

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._mesh, other._mesh)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._mesh.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"

    def __deepcopy__(self, memo):
        return ProcessMesh(self._mesh.copy(), list(self._dim_names))

    def jax_mesh(self):
        raise waits_for("distributed.ProcessMesh.jax_mesh", "A9f",
                        "a device mesh for sharded tensors")

    def sharding(self, placements, ndim):
        raise waits_for("distributed.ProcessMesh.sharding", "A9f",
                        "placements and sharded tensors")


def set_mesh(mesh):
    """Set the global mesh (reference `auto_parallel/api.py` set_mesh)."""
    global _global_mesh
    _global_mesh = mesh


def get_mesh():
    return _global_mesh


def init_mesh(dim_names, shape=None):
    """A ProcessMesh over every rank of the world (`get_world_size()`),
    set as the global mesh."""
    from paddle_tpu_torch.distributed.parallel import get_world_size

    n = get_world_size()
    if shape is None:
        shape = [n]
    size = int(np.prod(shape))
    if size != n and -1 not in shape:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    mesh = ProcessMesh(np.arange(n).reshape(shape), dim_names)
    set_mesh(mesh)
    return mesh
