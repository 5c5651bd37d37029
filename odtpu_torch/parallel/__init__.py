"""Parallelism across processes (``odtpu/parallel/mesh.py`` and
``multihost.py``): the process group and the ``(data, model, spatial)``
mesh, the collectives the train step, batch norm, the sharded convs and
the evaluators use, the spatial slabs and their row exchanges
(``spatial``), and the host-row gather."""

from . import spatial
from .mesh import (Mesh, all_gather, all_reduce_grads,
                   all_reduce_sum, axis_size, axis_sum, barrier,
                   block_optimizer_state, block_state_dict, broadcast_state,
                   current, data_rank, data_sum, data_world, distributed,
                   full_optimizer_state, full_shapes, full_state_dict,
                   gather_model_group, global_sum, init_distributed,
                   initialized, is_data_leader, is_main, local_rows,
                   make_mesh, mesh_sizes, rank, sharded_params, shutdown,
                   sync_replicated_buffers, to_model_group, tp_keys,
                   world)
from .multihost import allgather_host_rows, sum_over_ranks

__all__ = ["Mesh", "all_gather", "all_reduce_grads",
           "all_reduce_sum", "allgather_host_rows", "axis_size", "axis_sum",
           "barrier", "block_optimizer_state", "block_state_dict",
           "broadcast_state", "current", "data_rank", "data_sum",
           "data_world", "distributed", "full_optimizer_state",
           "full_shapes", "full_state_dict", "gather_model_group",
           "global_sum", "init_distributed", "initialized",
           "is_data_leader", "is_main", "local_rows", "make_mesh",
           "mesh_sizes", "rank", "sharded_params", "shutdown", "spatial",
           "sum_over_ranks", "sync_replicated_buffers", "to_model_group",
           "tp_keys", "world"]
