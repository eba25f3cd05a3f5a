"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "neurips2023_soc_tpu", "bench", "bench_torch", "chip_smoke"}


def imported_top_names(path: Path):
    """(top-level name, relative level) of every import in a file."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        for name, level in imported_top_names(f):
            if level == 0:
                assert name not in NEVER, f"{f} imports {name}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for name, level in imported_top_names(f):
            assert level <= 1, f"{f}: relative import leaves benchmark/reference"
            assert name not in NEVER | {"neurips2023_soc_torch", "benchmark"}, \
                f"{f} imports {name}"


def test_the_name_check_compares_whole_top_level_names():
    # the port's name begins with the JAX package's stem; neither contains the other whole
    assert "neurips2023_soc_torch".split(".")[0] not in NEVER
    assert "neurips2023_soc_tpu.ops".split(".")[0] in NEVER


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; import benchmark.run, benchmark.calibrate, benchmark.drivers.engine, "
            "benchmark.work.model, benchmark.readers; "
            "import neurips2023_soc_torch.inference; "
            "from benchmark.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
