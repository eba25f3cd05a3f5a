"""The port (neurips2023_soc_torch) and chip_smoke.py import neither JAX, flax
nor the JAX package: checked in a fresh interpreter that imports every module
of the port (the CLIs, data, evaluators and parallel modules included) and by
a scan of the sources for import statements. Also the test harness's share of
the cores for torch under pytest-xdist."""
import re
import subprocess
import sys
from pathlib import Path

import torch

from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)
from torch_port_helpers import worker_share_of_cores

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "neurips2023_soc_tpu")

_PROBE = """
import importlib, pkgutil, sys
import neurips2023_soc_torch
for m in pkgutil.walk_packages(neurips2023_soc_torch.__path__, "neurips2023_soc_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("LOADED", bad)
print("PORT", sorted(m for m in sys.modules if m.startswith("neurips2023_soc_torch.")))
"""
NEW_IN_SLICE_3 = ("cli.infer_refytb", "cli.demo_video", "cli.predict", "evaluators",
                  "parallel.multihost", "data.transforms", "data.refer_youtube_vos",
                  "data.a2d_sentences", "utils.colormap", "utils.visualize",
                  "ops.window_attention")
NEW_IN_SLICE_6 = ("evaluation", "evaluation.rle", "evaluation.coco_eval",
                  "evaluation.refexp_eval", "evaluation.davis", "models.postprocessing",
                  "data.davis", "data.prepare_davis", "data.coco_ref", "cli.infer_davis",
                  "cli.eval_davis")
TRAINING_ENTRY_POINTS = ("cli.main", "cli.main_pretrain", "cli.main_joint", "data.sampler",
                  "data.jhmdb_sentences")


def test_fresh_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    loaded = out.stdout.split("PORT", 1)[1]
    for name in NEW_IN_SLICE_3 + NEW_IN_SLICE_6 + TRAINING_ENTRY_POINTS:
        assert f"'neurips2023_soc_torch.{name}'" in loaded, name


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    files = sorted((ROOT / "neurips2023_soc_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_file_readers_are_imported_where_they_read():
    """cv2, h5py, pandas and PIL are not on every machine the port runs on:
    the data and CLI modules import them inside the functions that read
    files, so every module imports without them."""
    pattern = re.compile(r"^(import|from)\s+(cv2|h5py|pandas|PIL)\b", re.M)
    files = sorted((ROOT / "neurips2023_soc_torch").rglob("*.py"))
    assert [str(f) for f in files if pattern.search(f.read_text())] == []


def test_torch_gets_the_workers_share_of_the_cores(monkeypatch):
    """Under pytest-xdist each port test module runs torch on cpu_count //
    workers threads: a full pool per worker oversubscribed the CPU and slowed
    the port's tests 5-10 fold (the trainer test took 145 s under 6 workers,
    6 s alone)."""
    share = worker_share_of_cores()
    if share is not None:
        assert torch.get_num_threads() == share
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    assert worker_share_of_cores() == 1
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
    assert worker_share_of_cores() == 4
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    assert worker_share_of_cores() is None
