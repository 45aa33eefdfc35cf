"""Data parallelism over episodes (torch.distributed): one process per card."""

from .mesh import (active, all_reduce_grads, all_reduce_sum, barrier, broadcast_module,
                   check_mesh, check_replicas, distributed_init, gather_rows, is_main_process,
                   rank_world, shutdown, to_host)

__all__ = ["active", "all_reduce_grads", "all_reduce_sum", "barrier", "broadcast_module",
           "check_mesh", "check_replicas", "distributed_init", "gather_rows",
           "is_main_process", "rank_world", "shutdown", "to_host"]
