from .multihost import barrier, initialize_distributed, is_main_process

__all__ = ["barrier", "initialize_distributed", "is_main_process"]
