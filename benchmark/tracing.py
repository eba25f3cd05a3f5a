"""The traced run's instruments: host spans the benchmark puts around calls
into the program, the profiler over the traced window, and the trace read back
as kernels and ranges.

Spans are `torch.profiler.record_function` ranges that also keep their host
durations in memory. A kernel belongs to a range when the host call that
launched it (the runtime event with the kernel's correlation id) lies inside
the range's interval, on whatever thread (the backward launches from the
autograd engine's thread while the caller waits inside its range).
"""
from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Spans:
    """Host durations (seconds) per span name, and what the benchmark recorded
    about the calls (shapes, work)."""
    durations: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    calls: Dict[str, List[dict]] = field(default_factory=lambda: defaultdict(list))


class Tracer:
    """Installs wrappers and runs the profiler over the traced window."""

    def __init__(self):
        self.spans = Spans()
        self._restore: List[Callable[[], None]] = []
        self.prof = None

    def wrap(self, owner, attr: str, name: str,
             record: Optional[Callable[..., dict]] = None) -> None:
        """Replace owner.attr (a module function, a bound method) by a wrapper
        that opens span `name`; `record(*args, **kwargs)` adds a call record."""
        original = getattr(owner, attr)
        had_own = attr in getattr(owner, "__dict__", {})
        spans = self.spans

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            if record is not None:
                spans.calls[name].append(record(*args, **kwargs))
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = original(*args, **kwargs)
            spans.durations[name].append(time.perf_counter() - t0)
            return out

        setattr(owner, attr, wrapper)

        def restore():
            if had_own:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)
        self._restore.append(restore)

    def unwrap(self) -> None:
        while self._restore:
            self._restore.pop()()

    @contextmanager
    def profile(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                yield
            if cuda:
                torch.cuda.synchronize()
        self.prof = prof

    def trace(self) -> "Trace":
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return Trace.from_chrome(json.load(f))


@dataclass
class Trace:
    """Kernels (name, start, duration, launch time) in seconds on one clock,
    and host ranges (name, start, end)."""
    kernels: List[Tuple[str, float, float, float]]
    ranges: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @classmethod
    def from_chrome(cls, doc: dict) -> "Trace":
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        launch_at: Dict[int, float] = {}
        raw, ranges, window = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            if cat in KERNEL_CATS:
                raw.append((e["name"], ts, dur, e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = ts
            elif cat == "user_annotation":
                if e["name"] == "bench.window":
                    window = (ts, ts + dur)
                else:
                    ranges.append((e["name"], ts, ts + dur))
        kernels = [(n, ts, dur, launch_at.get(corr, ts)) for n, ts, dur, corr in raw]
        kernels.sort(key=lambda k: k[1])
        if window is None:
            raise ValueError("the trace has no bench.window range")
        return cls(kernels, ranges, window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some kernel ran (the union)."""
        busy, end = 0.0, self.window[0]
        for _, ts, dur, _ in self.kernels:
            a, b = max(ts, end), min(ts + dur, self.window[1])
            if b > a:
                busy += b - a
            end = max(end, ts + dur)
        return busy

    def kernel_s(self, pattern: Optional[str] = None, within: Optional[str] = None) -> float:
        """Device seconds of the kernels whose name contains `pattern`, and
        whose launch lies inside a range named `within`."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == within) if within else None
        starts = [a for a, _ in spans] if spans else None
        total = 0.0
        for name, _, dur, at in self.kernels:
            if pattern is not None and pattern not in name:
                continue
            if spans is not None:
                i = bisect.bisect_right(starts, at) - 1
                if i < 0 or at > spans[i][1]:
                    continue
            total += dur
        return total

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, _, dur, _ in self.kernels:
            by[name] += dur
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the device by the innermost host range open at each
        gap's middle ("host outside the spans" where none is)."""
        by = defaultdict(float)
        end = self.window[0]
        gaps = []
        for _, ts, dur, _ in self.kernels:
            if ts > end:
                gaps.append((end, min(ts, self.window[1])))
            end = max(end, ts + dur)
        if end < self.window[1]:
            gaps.append((end, self.window[1]))
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [(e - s, name) for name, s, e in self.ranges if s <= mid <= e]
            by[min(inner)[1] if inner else "host outside the spans"] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
