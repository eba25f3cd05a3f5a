"""A checkout-like root for the CPU tests: BENCHMARK.json with a tiny cell
(configs/tiny_synthetic.yaml's widths) and the repository's metric readers,
the cell's files written beside them. Only data files: no harness code."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
ENGINE = "tiny.engine"


def make_root(tmp: Path, engine_limits=None) -> Path:
    """tmp as a root holding BENCHMARK.json and benchmark/{configs, traffic,
    workloads, metrics}."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (b / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "benchmark" / "metrics", b / "metrics")
    fx = HERE / "fixtures"
    shutil.copy(fx / "tiny-soc.json", b / "configs" / "tiny-soc.json")
    shutil.copy(fx / "tiny_videos.json", b / "traffic" / "tiny_videos.json")
    cell = {"config": "tiny-soc", "traffic": "tiny_videos", "driver": "engine",
            "trace_passes": 1,
            "limits": engine_limits or {"mask_mismatch_vs_bf16": 1.0, "query_gap_vs_bf16": 1.0}}
    (b / "workloads" / f"{ENGINE}.json").write_text(json.dumps(cell))
    bench["workloads"] = [{"name": ENGINE, "config": "tiny-soc", "traffic": "tiny_videos",
                           "chips": 1, "why": "CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [ENGINE]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
