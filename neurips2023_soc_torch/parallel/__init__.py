from .multihost import (all_reduce_mean, all_reduce_sum, barrier, broadcast_object,
                        dist_backend, distributed, gather_objects, initialize_distributed,
                        is_main_process, process_index_and_count, world_size)
from .zero import opt_state_bytes_per_rank, zero1_adamw

__all__ = ["all_reduce_mean", "all_reduce_sum", "barrier", "broadcast_object", "dist_backend",
           "distributed", "gather_objects", "initialize_distributed", "is_main_process",
           "opt_state_bytes_per_rank", "process_index_and_count", "world_size", "zero1_adamw"]
