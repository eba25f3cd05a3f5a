from .multihost import (barrier, broadcast_object, gather_objects, initialize_distributed,
                        is_main_process)

__all__ = ["barrier", "broadcast_object", "gather_objects", "initialize_distributed",
           "is_main_process"]
