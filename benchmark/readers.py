"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from typing import Callable, Optional

from .work import kernels

PEAK_FLOPS = kernels.BF16_TC_FLOPS  # bf16 dense, H100 SXM


def roofline(ctx, call: str, pattern: str, least: Callable[..., float]) -> Optional[float]:
    """100 x (sum of the least times of the recorded calls) / (device time of
    the kernels whose name holds `pattern`), or None where nothing ran."""
    if ctx.trace is None:
        return None
    calls = ctx.spans.calls.get(call, [])
    t = ctx.trace.kernel_s(pattern)
    if not calls or t <= 0.0:
        return None
    return 100.0 * sum(least(**c) for c in calls) / t


def idle(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.info.get("model_flops"):
        return None
    return 100.0 * ctx.info["model_flops"] / (ctx.window_s * PEAK_FLOPS)


def kernel_ms_per(ctx, ranges, per: float) -> Optional[float]:
    """Device ms of the kernels launched inside the named ranges, over `per`."""
    if ctx.trace is None or not per:
        return None
    t = sum(ctx.trace.kernel_s(within=r) for r in ranges)
    return 1e3 * t / per if t > 0 else None
