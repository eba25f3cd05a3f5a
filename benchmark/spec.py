"""BENCHMARK.json, and the files it names, found by name."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    pass


def check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{kind} name {name!r}: 1-64 of A-Z a-z 0-9 _ . -, not starting "
                        "with . or -")
    return name


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def load_benchmark(root: Path = ROOT) -> dict:
    spec = load_json(root / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec.get(key, []):
            check_name(key, entry["name"])
    for entry in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(entry["unit"]):
            raise SpecError(f"unit {entry['unit']!r} of {entry['name']}")
    return spec


def workload_entry(spec: Mapping, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                    f"(has {[w['name'] for w in spec['workloads']]})")


def metrics_for(spec: Mapping, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on): those that list the cell, or list no cells."""
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def load_cell(name: str, root: Path = ROOT) -> dict:
    """workloads/<cell>.json with its config and traffic files read in."""
    check_name("workload", name)
    cell = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    cell["name"] = name
    for kind, key in (("configs", "config"), ("traffic", "traffic")):
        name_of = check_name(key, cell[key])
        cell[f"{key}_data"] = load_json(root / "benchmark" / kind / f"{name_of}.json")
    return cell


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """drivers/<kind>.py of the benchmark package."""
    return importlib.import_module(f"benchmark.drivers.{check_name('driver', kind)}")


def generator(name: str):
    """traffic/<name>.py of the benchmark package."""
    return importlib.import_module(f"benchmark.traffic.{check_name('generator', name)}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """metrics/<name>.py's read(ctx)."""
    path = root / "benchmark" / "metrics" / f"{check_name('metric', name)}.py"
    if not path.exists():
        raise SpecError(f"no reader {path} for per-layer metric {name}")
    return load_module(path, "benchmark_metric_" + name.replace(".", "_").replace("-", "_")).read


def read_metrics(spec_metrics: List[dict], ctx, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {value, unit}} of every reader that found something to read."""
    out = {}
    for m in spec_metrics:
        value: Optional[float] = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
