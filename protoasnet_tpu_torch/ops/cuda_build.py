"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` beside the
package (listed in ``.gitignore``). The library's name carries a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built when a module is imported; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc",
           "build_library", "load_library", "build_logs"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# ptxas output (registers, shared memory, spills) of each library built by
# this process, by source name
build_logs: Dict[str, str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates: List[str] = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library; returns its path."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{proc.stdout}\n{proc.stderr}")
    build_logs[source] = (proc.stdout + proc.stderr).strip()
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial
    return lib


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build_library(source)))
        return _loaded[source]
