"""paddle.distributed of the port (`paddle_tpu/distributed/__init__.py`;
reference `python/paddle/distributed/`).

One process per rank, over `torch.distributed`: NCCL on the card, gloo on
the CPU.
  collective / communication   process groups and the collectives
  comm_monitor                 heartbeats and each collective's deadline
  parallel                     init_parallel_env, DataParallel
  api_extras                   object collectives, gather, wait, spawn,
                               the gloo trio
  process_mesh                 the ProcessMesh description
  fleet                        the fleet entry, its topology and groups
  checkpoint / io              checkpoints and persistables
  engine / hybrid_engine       the one-card Engine and the Llama trainer
                               with its AdamW
The sharding API, placements and auto-parallel wait for ROADMAP A9c/A9f,
the engines across ranks for A9c, elastic and the non-finite guard for
A9e.
"""

from paddle_tpu_torch.distributed.process_mesh import (  # noqa: F401
    ProcessMesh, get_mesh, init_mesh, set_mesh)
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    Group, destroy_process_group, get_group, is_initialized, new_group)
from paddle_tpu_torch.distributed.communication import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    alltoall_single, barrier, batch_isend_irecv, broadcast, get_backend,
    irecv, isend, recv, reduce, reduce_scatter, scatter, send)
from paddle_tpu_torch.distributed.parallel import (  # noqa: F401
    DataParallel, ParallelEnv, get_rank, get_world_size, init_parallel_env)
from paddle_tpu_torch.distributed.api_extras import (  # noqa: F401
    broadcast_object_list, gather, gloo_barrier, gloo_init_parallel_env,
    gloo_release, is_available, scatter_object_list, spawn, wait)
from paddle_tpu_torch.distributed import comm_monitor  # noqa: F401
from paddle_tpu_torch.distributed import io  # noqa: F401
from paddle_tpu_torch.distributed.checkpoint import (  # noqa: F401
    CheckpointManager, load_state_dict, save_state_dict)
from paddle_tpu_torch.distributed.engine import Engine
from paddle_tpu_torch.distributed.hybrid_engine import (HybridParallelEngine,
                                                        adamw_init,
                                                        adamw_update)
from paddle_tpu_torch.distributed import fleet  # noqa: F401

__all__ = ["Engine", "HybridParallelEngine", "adamw_init", "adamw_update",
           "ProcessMesh", "get_mesh", "set_mesh", "init_mesh", "Group",
           "new_group", "get_group", "is_initialized",
           "destroy_process_group", "ReduceOp", "all_reduce", "all_gather",
           "all_gather_object", "reduce", "broadcast", "scatter",
           "reduce_scatter", "alltoall", "alltoall_single", "send", "recv",
           "isend", "irecv", "barrier", "get_backend", "P2POp",
           "batch_isend_irecv", "init_parallel_env", "get_rank",
           "get_world_size", "ParallelEnv", "DataParallel",
           "broadcast_object_list", "gather", "scatter_object_list", "wait",
           "is_available", "spawn", "gloo_init_parallel_env", "gloo_barrier",
           "gloo_release", "CheckpointManager", "save_state_dict",
           "load_state_dict"]
