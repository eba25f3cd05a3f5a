"""Runs one cell of BENCHMARK.json and prints one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(exits 3 without them, printing no result). With --trace 0 the line holds the
cell's end-to-end metrics; with --trace 1 its per-layer metrics, read from a
profiler trace of a window of fixed work (`trace_passes` passes through the
cell's pool of videos, whatever --seconds says). Either way the
window's outputs are then compared with the plain reference, and `correct`
says whether every compared number is within its limit; the numbers and
limits are the line's last key, `checks`, and the last lines on stderr.
"""
from __future__ import annotations

import os
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from .spec import (ROOT, load_benchmark, load_cell, metrics_for, read_metrics,  # noqa: E402
                   workload_entry)

FORBIDDEN = ("jax", "jaxlib", "flax", "neurips2023_soc_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - T_IMPORT


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a per-layer reader gets: the trace (None off the card), the
    benchmark's spans and call records, the window and the work done."""
    trace: object
    spans: object
    window_s: float
    busy_s: float
    info: Dict = field(default_factory=dict)


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def per_layer_context(drv, st, result, tracer, cuda: bool) -> Context:
    trace = tracer.trace() if cuda else None
    window_s = trace.window_s if trace is not None else result["seconds"]
    busy_s = trace.busy_s() if trace is not None else 0.0
    info = {"model_flops": drv.model_flops(st, result["in_window"])}
    return Context(trace, tracer.spans, window_s, busy_s, info)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             root: Path = ROOT, t_start: Optional[float] = None) -> Dict:
    """The result line of one run (without the card checks)."""
    import torch

    from . import correct
    from .spec import driver
    from .tracing import Tracer

    t_start = time.time() - process_age_s() if t_start is None else t_start
    spec = load_benchmark(root)
    entry = workload_entry(spec, name)
    cell = load_cell(name, root)
    drv = driver(cell["driver"])
    cuda = torch.device(device).type == "cuda"
    st = drv.setup(cell, seed, device)
    setup_s = time.time() - t_start
    tracer = Tracer() if trace else None
    result = drv.window(st, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        ctx = per_layer_context(drv, st, result, tracer, cuda)
        metrics = read_metrics(metrics_for(spec, name, True), ctx, root)
    else:
        ctx = None
        values = dict(result["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in metrics_for(spec, name, False) if m["name"] in values}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not use: {found}")
    numbers = drv.check(st)
    checks = correct.verdict(numbers, cell["limits"])
    line = {"correct": correct.passed(checks), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": entry["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        line["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        if ctx.trace is not None:
            line["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                                 "idle_gaps": ctx.trace.idle_gaps(10)}
    line["info"] = {"seed": seed, "seconds": seconds, "window_s": result["seconds"],
                    "setup_s": setup_s, "card": card_line() if cuda else None,
                    **{k: v for k, v in result["e2e"].items() if k not in metrics},
                    "videos": result["videos"],
                    **{k: v for k, v in numbers.items() if k not in cell["limits"]}}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    chips = workload_entry(load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 3
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port may not use: {found}", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
