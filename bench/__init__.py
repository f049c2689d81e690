"""The port's benchmark (``BENCHMARK.json``; ``bench/README.md``).  The
port's package lives under ``src/``; it is put on the path here, so that
the harness and its tests import it from a checkout as it is."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.append(_SRC)
