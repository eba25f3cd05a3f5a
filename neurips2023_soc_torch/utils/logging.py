"""Telemetry (the metric helpers are a copy of
neurips2023_soc_tpu/utils/logging.py's): window-smoothed values, a logger that
formats them, a torch.profiler trace of a span of steps or videos, the named
spans the program opens inside such a trace, and the print gate of the ranks
other than 0."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


class SmoothedValue:
    """A series of values with window-smoothed statistics."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], enabled: bool = True):
    """A torch.profiler trace of the enclosed code (host ops, and the card's
    kernels when CUDA is available) written as a Chrome trace under
    `log_dir`; a no-op when disabled or without a directory. A profiler that
    fails raises: no trace is ever missing in silence."""
    if not enabled or not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{time.time_ns()}.json"))


def span(name: str):
    """A context that names the enclosed code in a running torch.profiler
    trace: a `record_function` range, kept by the profiler beside the kernels
    the code launches, on the trace's clock, and written out when the
    profiler stops. With no profiler recording it is a shared no-op context,
    one flag read. The program's span names start with `soc.`."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def setup_for_distributed(is_main: Optional[bool] = None) -> None:
    """Silences `print` on ranks other than 0 unless called with
    `force=True` (reference misc.py:163-175); `is_main` None asks the
    running process group. Rank 0, and a single process, print as before."""
    import builtins

    if is_main is None:
        from ..parallel.multihost import is_main_process

        is_main = is_main_process()
    if is_main:
        return
    orig_print = builtins.print

    def print_main_only(*args, force: bool = False, **kwargs):
        if force:
            orig_print(*args, **kwargs)

    builtins.print = print_main_only
