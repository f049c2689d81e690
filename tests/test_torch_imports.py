"""The port stands alone: nothing in ``src/repro_torch``, ``chip_smoke.py``,
``tools/`` or the port's examples imports JAX or the JAX package, the kernel module
imports (and builds nothing) where there is no ``nvcc``, and the modules
the port copies from the reference stay copies."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    assert ROOT / "examples" / "distributed_fedx_pods_torch.py" in files
    assert PORT / "sharding" / "rules.py" in files
    assert PORT / "analysis" / "audit.py" in files
    assert PORT / "launch" / "graph_analysis.py" in files
    assert PORT / "launch" / "dryrun.py" in files
    assert PORT / "launch" / "analysis.py" in files
    for name in ("quickstart", "fl_cifar_comparison", "serve_llm",
                 "continuous_batching"):
        assert ROOT / "examples" / f"{name}_torch.py" in files
    bad = [(str(f.relative_to(ROOT)), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("kernel", ["bwo_evolve", "flash_attention",
                                    "ssm_scan"])
def test_kernel_module_imports_without_nvcc(kernel):
    """The build is lazy: importing the ops module compiles nothing and
    needs no CUDA toolkit."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(ROOT / "no-cuda-here"),
               PYTHONPATH=str(ROOT / "src"))
    code = (f"import repro_torch.kernels.{kernel}.ops as ops, sys\n"
            f"from repro_torch.kernels.{kernel} import {kernel} as k\n"
            "assert k._lib is None and k.launches == 0\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("package,name", [
    pytest.param("core", "comm", id="comm"),
    pytest.param("core", "knobs", id="knobs"),
    pytest.param("analysis", "report", id="report")])
def test_copied_modules_match_the_reference(package, name):
    """``core/comm.py``, ``core/knobs.py`` and ``analysis/report.py`` are
    the reference's pure-Python modules, copied below a two-line header;
    only the docstrings :data:`OWN_DOCSTRINGS` names are the port's own
    (``BlockTiming``'s describes the port's capture and fetch)."""
    port = (PORT / package / f"{name}.py").read_text().splitlines()
    ref = (ROOT / "src" / "repro" / package / f"{name}.py").read_text()
    assert port[0].startswith(f"# A copy of repro/{package}/")
    port = "\n".join(port[2:]) + "\n"
    for cls in OWN_DOCSTRINGS.get(name, ()):
        assert _docstring(port, cls) != _docstring(ref, cls)
        port, ref = _without_docstring(port, cls), _without_docstring(ref, cls)
    assert port == ref


# classes of the copied modules whose docstrings the port rewrites
OWN_DOCSTRINGS = {"comm": ("BlockTiming",)}


def _class(text: str, cls: str) -> ast.ClassDef:
    (node,) = [n for n in ast.parse(text).body
               if isinstance(n, ast.ClassDef) and n.name == cls]
    return node


def _docstring(text: str, cls: str) -> str:
    return ast.get_docstring(_class(text, cls))


def _without_docstring(text: str, cls: str) -> str:
    """``text`` less the lines of ``cls``'s docstring."""
    doc = _class(text, cls).body[0]
    lines = text.splitlines()
    del lines[doc.lineno - 1:doc.end_lineno]
    return "\n".join(lines) + "\n"
