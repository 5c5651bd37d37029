"""Data parallelism across processes (``odtpu/parallel/mesh.py`` and
``multihost.py``): the process group, the layout, the collectives the
train step, batch norm and the evaluators use, and the host-row gather."""

from .mesh import (Mesh, all_reduce_grads, all_reduce_sum, barrier,
                   broadcast_state, global_sum, init_distributed,
                   initialized, is_main, local_rows, make_mesh, rank,
                   shutdown, world)
from .multihost import allgather_host_rows, sum_over_ranks

__all__ = ["Mesh", "all_reduce_grads", "all_reduce_sum",
           "allgather_host_rows", "barrier", "broadcast_state",
           "global_sum", "init_distributed", "initialized", "is_main",
           "local_rows", "make_mesh", "rank", "shutdown", "sum_over_ranks",
           "world"]
