"""ctypes loader for the native C++ host helpers (native/vstar_native.cpp
at the repository root).

Builds the shared library with g++ on first use into the port's
`_build/` directory (gitignored), never beside the source; every entry
point has a pure-python fallback so the package works without a
toolchain. Use `get_lib()` to force/compile-check.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "vstar_native.cpp")
_SO = os.path.join(_PKG, "_build", "vstar_native.so")


def _build(src: str, out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)   # atomic: concurrent builders never see half
        return True
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        so_path = _SO
        if not os.path.exists(so_path) or (os.path.getmtime(so_path)
                                           < os.path.getmtime(_SRC)):
            ok = _build(_SRC, so_path)
            if not ok:
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.hungarian_solve.restype = ctypes.c_int
        lib.hungarian_solve.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.rle_decode_counts.restype = ctypes.c_int
        lib.rle_decode_counts.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.bilinear_resize.restype = ctypes.c_int
        lib.bilinear_resize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return _LIB


def _ptr(arr: np.ndarray, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def hungarian_native(cost: np.ndarray) -> Optional[np.ndarray]:
    """cost [Q, T] f32 (Q >= T) -> row index per column [T], or None."""
    lib = get_lib()
    if lib is None:
        return None
    cost = np.ascontiguousarray(cost, np.float32)
    q, t = cost.shape
    out = np.zeros(t, np.int32)
    rc = lib.hungarian_solve(_ptr(cost, ctypes.c_float), q, t,
                             _ptr(out, ctypes.c_int))
    return out if rc == 0 else None


def rle_decode_native(counts: np.ndarray, h: int, w: int
                      ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros(h * w, np.uint8)
    rc = lib.rle_decode_counts(_ptr(counts, ctypes.c_int64), len(counts),
                               h, w, _ptr(out, ctypes.c_uint8))
    return out.reshape(h, w) if rc == 0 else None


def bilinear_resize_native(x: np.ndarray, oh: int, ow: int
                           ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    ih, iw = x.shape
    out = np.zeros((oh, ow), np.float32)
    rc = lib.bilinear_resize(_ptr(x, ctypes.c_float), ih, iw,
                             _ptr(out, ctypes.c_float), oh, ow)
    return out if rc == 0 else None
