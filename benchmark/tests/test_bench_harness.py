"""The harness found by file name: BENCHMARK.json's names and files, the
traffic per seed, a fixture cell and metric added as files alone, and a run
on a machine with no card."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import spec
from benchmark.traffic import videos

from .fixture_root import ENGINE, make_root

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in ends for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_names_files_that_exist():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert (REPO / "benchmark" / "drivers" / f"{cell['driver']}.py").exists()
        assert (REPO / "benchmark" / "traffic" / f"{cell['traffic_data']['generator']}.py").exists()
        assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []


def test_video_traffic_is_the_seeds_own_and_the_same_work():
    mix = json.loads((REPO / "benchmark/traffic/ytvos_mix.json").read_text())
    mix = dict(mix, frame_size=[8, 12])
    a, b, c = (videos.Videos(mix, s, "cpu") for s in (2 ** 31 + 3, 2 ** 31 + 3, 7))
    assert all(np.array_equal(x.frames, y.frames) and x.texts == y.texts
               for x, y in zip(a.pool, b.pool))
    assert not all(np.array_equal(x.frames, y.frames) for x, y in zip(a.pool, c.pool))

    def work(v):
        return sorted((p.frames.shape[0], len(p.texts)) for p in v.pool)

    assert work(a) == work(c) == sorted(map(tuple, mix["pool"]))

    def cycle(v):
        seq = [(p.frames.shape[0], len(p.texts)) for p in v.pool]
        k = seq.index(tuple(mix["pool"][0]))
        return seq[k:] + seq[:k]

    # one cycle for every seed, entered at the seed's own point: each video
    # follows the same predecessor
    assert cycle(a) == cycle(c) == cycle(videos.Videos(mix, 11, "cpu"))
    starts = {(v.pool[0].frames.shape[0], len(v.pool[0].texts))
              for v in (videos.Videos(mix, s, "cpu") for s in range(8))}
    assert len(starts) > 1
    uses = [a.next() for _ in range(len(a.pool) + 1)]
    assert uses[0][0] == uses[-1][0] and not np.array_equal(uses[0][2]["frames"],
                                                            uses[-1][2]["frames"])
    assert a.sample(5, 2) == b.sample(5, 2)


def test_a_fixture_cell_and_metric_are_found_by_file_name(tmp_path):
    from benchmark.run import run_cell

    root = make_root(tmp_path)
    (root / "benchmark/metrics/fixture.dispatches.py").write_text(
        "def read(ctx):\n    return float(len(ctx.spans.durations.get('engine.dispatch', [])))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "fixture.dispatches", "unit": "videos", "better": "higher",
                               "source": "program_span", "layer": "engine",
                               "moves": "masks_per_s", "workloads": [ENGINE]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_cell(ENGINE, 3, 3.0, True, "cpu", root=root)
    # the traced window is one pass through the pool, whatever --seconds says
    pool = json.loads((root / "benchmark/traffic/tiny_videos.json").read_text())["pool"]
    assert line["metrics"]["fixture.dispatches"]["value"] == line["attempted"] == len(pool)
    assert line["info"]["videos"] == len(pool)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]


def test_no_card_exits_nonzero_and_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 9),
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    from benchmark.run import run_cell

    line = run_cell(BENCH["workloads"][0]["name"], 2 ** 31 + 17, 5.0, False, str(card))
    assert line["correct"], line["checks"]
