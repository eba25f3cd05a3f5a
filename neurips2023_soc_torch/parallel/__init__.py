from .multihost import (barrier, broadcast_object, gather_objects, initialize_distributed,
                        is_main_process, process_index_and_count)

__all__ = ["barrier", "broadcast_object", "gather_objects", "initialize_distributed",
           "is_main_process", "process_index_and_count"]
