"""The port (neurips2023_soc_torch) and chip_smoke.py import neither JAX, flax
nor the JAX package: checked in a fresh interpreter and by a scan of the
sources for import statements."""
import re
import subprocess
import sys
from pathlib import Path

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
"""


def test_fresh_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    files = sorted((ROOT / "neurips2023_soc_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
