"""ctypes bindings for the native IO codec (native/ssrlcv_native.cpp).

The reference's host IO layer is C++ (tinyply, the Unity checkpoint codec);
this module loads this package's C++ equivalent, building it on first use
with the in-tree Makefile.  Every entry point has a pure-Python fallback so
the library remains optional.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libssrlcv_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.ply_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.ply_write.restype = ctypes.c_int
            lib.uty_write.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ]
            lib.uty_write.restype = ctypes.c_int
            lib.uty_read_header.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.uty_read_header.restype = ctypes.c_int
            lib.uty_read_body.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
            ]
            lib.uty_read_body.restype = ctypes.c_int
            lib.log_append.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ]
            lib.log_append.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def ply_write_native(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
) -> bool:
    """Binary PLY via the C++ codec; returns False if unavailable (caller
    falls back to the Python writer)."""
    lib = _load()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    cols = None if colors is None else np.ascontiguousarray(colors, np.uint8)
    fcs = None if faces is None else np.ascontiguousarray(faces, np.int32)
    rc = lib.ply_write(
        path.encode(),
        pts.ctypes.data_as(ctypes.c_void_p), len(pts),
        None if cols is None else cols.ctypes.data_as(ctypes.c_void_p),
        None if fcs is None else fcs.ctypes.data_as(ctypes.c_void_p),
        0 if fcs is None else len(fcs),
    )
    return rc == 0


def uty_write_native(path: str, type_name: str, hash_code: int, state: int, data: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    d = np.ascontiguousarray(data)
    rc = lib.uty_write(
        path.encode(), type_name.encode(), hash_code, state,
        d.ctypes.data_as(ctypes.c_void_p), d.shape[0] if d.ndim else 1,
        d.dtype.itemsize * (int(np.prod(d.shape[1:])) if d.ndim > 1 else 1),
    )
    return rc == 0


def uty_read_native(path: str, dtype: np.dtype) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    name = ctypes.create_string_buffer(256)
    hash_out = ctypes.c_uint64()
    state_out = ctypes.c_int32()
    count_out = ctypes.c_uint64()
    off_out = ctypes.c_uint64()
    rc = lib.uty_read_header(
        path.encode(), name, 256,
        ctypes.byref(hash_out), ctypes.byref(state_out),
        ctypes.byref(count_out), ctypes.byref(off_out),
    )
    if rc != 0:
        return None
    dt = np.dtype(dtype)
    out = np.empty(count_out.value, dt)
    rc = lib.uty_read_body(
        path.encode(), off_out.value,
        out.ctypes.data_as(ctypes.c_void_p), count_out.value * dt.itemsize,
    )
    return out if rc == 0 else None
