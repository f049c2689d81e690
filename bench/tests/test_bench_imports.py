"""What the benchmark loads: no JAX and no JAX package anywhere under
``bench/`` (compared by whole top-level name: the port is ``repro_torch``,
the JAX package ``repro``), nothing of the port in the reference, and
nothing read from the JAX package's benchmarks."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench.cell import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = [p for p in SOURCES
             if p.parent.name in ("reference", "models")]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "contextlib", "dataclasses", "importlib",
                     "math", "typing", "numpy", "torch", "bench"}, names
    assert "repro_torch" not in path.read_text()


def test_reference_package_imports_only_itself():
    for path in REFERENCE:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench"):
                assert node.module.startswith(("bench.reference",
                                               "bench.models")), path


def test_nothing_reads_the_jax_benchmarks():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size, in a fresh interpreter: the
    modules it leaves loaded have none of the forbidden top-level names."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, "
        f"{str(BENCH / 'tests')!r}]\n"
        "import bench_tiny\n"
        "from bench import cell\n"
        "from run import loaded_forbidden\n"
        "out = cell.run(bench_tiny.spec('mlp', 'fedbwo'), 7, 0.1, False,\n"
        "               time.perf_counter(), 'cpu', 'batched')\n"
        "assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(loaded_forbidden())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(BENCH), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded, forbidden = proc.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'repro_torch'" in loaded and "'jax'" not in loaded


def test_loaded_forbidden_compares_whole_names():
    sys.path.insert(0, str(BENCH))
    from run import loaded_forbidden
    assert loaded_forbidden(["repro_torch", "repro_torch.core", "reprox",
                             "jaxtyping", "numpy"]) == []
    assert loaded_forbidden(["repro.core.api", "numpy"]) == ["repro"]
    assert loaded_forbidden(["flax.linen", "jax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib"]
