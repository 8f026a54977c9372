"""ctypes bindings to the native host data-loader core
(``native/cinestore.cpp``: the threaded spatial resize that packs the
CineStore, and the batched padded window gather), the port's own copy of
the JAX package's ``data/native.py``.

The library is built from the repository's C++ source with the host
compiler, at first use, into the package's ``_build/`` directory (listed in
``.gitignore``), its name keyed by the source's hash; a machine without a
compiler gets ``None`` from every entry point and the callers fall back
(NumPy for the gather, OpenCV for the resize). This is host code, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["get_lib", "resize_video_u8", "gather_windows",
           "native_available", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "cinestore.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native",
              "-pthread"]  # native/Makefile's

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[Path]:
    if not SOURCE.exists():
        logging.warning(f"native source {SOURCE} missing; using fallbacks")
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logging.warning("no C++ compiler; native cinestore unavailable, "
                        "using fallbacks")
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"cinestore_{digest}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        logging.warning(f"native cinestore build failed: {proc.stderr}; "
                        f"using fallbacks")
        return None
    os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building it if needed) the native core; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logging.warning(f"could not load {so} ({e}); using fallbacks")
            return None
        u8p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
        lib.resize_video_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.resize_video_u8.restype = None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gather_windows.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64), i32p, i32p, i32p, i, i,
            ctypes.c_int64, u8p]
        lib.gather_windows.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_video_u8(video: np.ndarray, size: int,
                    num_threads: int = 0) -> Optional[np.ndarray]:
    """(T, H, W) uint8 -> (T, size, size) (area average down, bilinear
    up); None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    video = np.ascontiguousarray(video, dtype=np.uint8)
    t, h, w = video.shape
    out = np.empty((t, size, size), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    lib.resize_video_u8(_u8p(video), t, h, w, _u8p(out), size, num_threads)
    return out


def gather_windows(store: np.ndarray, offsets: np.ndarray,
                   video_idx: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray, t_max: int) -> Optional[np.ndarray]:
    """Batched zero-padded window gather from the packed (total, S, S)
    store; None if the library is unavailable. ``store`` must be a
    contiguous array or memmap."""
    lib = get_lib()
    if lib is None:
        return None
    total, s1, s2 = store.shape
    b = len(video_idx)
    out = np.empty((b, t_max, s1, s2), dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    video_idx = np.ascontiguousarray(video_idx, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    ends = np.ascontiguousarray(ends, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gather_windows(
        _u8p(store), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        video_idx.ctypes.data_as(i32p), starts.ctypes.data_as(i32p),
        ends.ctypes.data_as(i32p), b, t_max, s1 * s2, _u8p(out))
    return out
