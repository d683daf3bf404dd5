"""ctypes bindings for the native C++ frontend (cvo_slam_tpu/native/).

Builds `_selector.so` (gitignored) with g++ from the committed source on
first use, cached next to the source, and falls back to the NumPy
implementation, with a logged warning, if no toolchain is available or
CVO_SLAM_NATIVE=0 is set. Parity with the NumPy path is enforced by
tests/test_native.py (bitwise-equal status maps).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from functools import lru_cache
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "selector.cpp")
_SO = os.path.join(_NATIVE_DIR, "_selector.so")

log = logging.getLogger(__name__)


def _build() -> bool:
    tmp = f"{_SO}.{os.getpid()}.tmp"     # concurrent builders do not collide
    try:
        src_mtime = os.path.getmtime(_SRC)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime:
            return True
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        log.warning("native selector build failed (%s); using the NumPy "
                    "selector", exc)
        return False


@lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("CVO_SLAM_NATIVE", "1") == "0":
        log.info("CVO_SLAM_NATIVE=0: using the NumPy selector")
        return None
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as exc:
        log.warning("cannot load %s (%s); using the NumPy selector", _SO, exc)
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dso_make_hists.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.dso_make_hists.restype = None
    lib.dso_select.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_float, u8p, i32p]
    lib.dso_select.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def make_hists(absgrad0: np.ndarray) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    h, w = absgrad0.shape
    out = np.empty((h // 32, w // 32), np.float32)
    lib.dso_make_hists(np.ascontiguousarray(absgrad0, np.float32), w, h, out)
    return out


def select(absgrads, ths_smoothed: np.ndarray, pot: int,
           th_factor: float = 1.0):
    lib = _lib()
    if lib is None:
        return None
    ag0, ag1, ag2 = [np.ascontiguousarray(a, np.float32) for a in absgrads]
    h, w = ag0.shape
    status = np.empty((h, w), np.uint8)
    counts = np.zeros(3, np.int32)
    lib.dso_select(ag0, w, h, ag1, ag1.shape[1], ag1.shape[0],
                   ag2, ag2.shape[1], ag2.shape[0],
                   np.ascontiguousarray(ths_smoothed, np.float32),
                   pot, th_factor, status, counts)
    return status, (int(counts[0]), int(counts[1]), int(counts[2]))
