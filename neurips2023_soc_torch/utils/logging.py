"""Training telemetry (copy of the metric helpers of
neurips2023_soc_tpu/utils/logging.py): window-smoothed values, a logger that
formats them, a step timer, and a torch.profiler trace of a span of steps
(torch is imported only by the trace)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def step_timer(metrics: MetricLogger, name: str = "step_time"):
    """Host seconds of the enclosed code into `metrics` under `name`."""
    t0 = time.perf_counter()
    yield
    metrics.update(**{name: time.perf_counter() - t0})
