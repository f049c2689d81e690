"""Building the port's CUDA kernels.

Each kernel is one source in ``repro_torch/csrc`` with a plain C entry
point, compiled with ``nvcc`` for ``sm_90a`` into a shared library that is
loaded with ``ctypes``.  The build runs at first use (never at import),
into ``build/kernels/`` at the root of the checkout, under a name keyed by
the source and the flags, so an edited source builds anew.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if nvcc is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        nvcc = os.path.join(home, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return nvcc


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns the
    library's path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
