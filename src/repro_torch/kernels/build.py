"""Build hand-written CUDA kernels at first use and load them with ctypes.

Each kernel is a ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` (Hopper) into a shared library. Libraries go to
``build/kernels/<name>-<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import time: this module must import on machines with no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> (library, nvcc/ptxas log of the build, or "" when loaded cached)
_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc() -> str:
    cands = ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in cands:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[Path],
                 rebuild: bool = False) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>.so`` unless an up-to-date build
    exists (or ``rebuild``), then load it. Raises on a failed build."""
    if name in _LOADED and not rebuild:
        return _LOADED[name][0]
    sources = [Path(s) for s in sources]
    out_dir = BUILD_ROOT / f"{name}-{_digest(sources)}"
    lib_path = out_dir / f"lib{name}.so"
    log = ""
    if rebuild or not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}:\n{log}")
            os.replace(tmp, lib_path)     # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, log)
    return lib


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/spill report) for ``name``,
    empty if this process loaded an existing build."""
    return _LOADED[name][1] if name in _LOADED else ""
