"""ctypes bindings for the native host runtime (librdst_host.so).

Runs ``make`` on first use, so the loaded library is always built from
the committed ``rdst_host.cpp`` (a no-op when it is up to date); falls back
to numpy implementations when the toolchain is missing (tests assert
behavioral equivalence between both paths).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "host_radix_sort",
    "host_histogram",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "librdst_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            subprocess.run(
                ["make", "-C", _DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        i64 = ctypes.c_int64
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.host_radix_sort_u32.argtypes = [u32p, i64]
        lib.host_radix_sort_u64.argtypes = [u64p, i64]
        lib.host_radix_sort_u32_pairs.argtypes = [u32p, u32p, i64]
        lib.host_radix_sort_u64_pairs.argtypes = [u64p, u32p, i64]
        lib.histogram_u32.argtypes = [u32p, i64, ctypes.c_int, i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def host_radix_sort(keys: np.ndarray, payload: np.ndarray | None = None):
    """Stable LSD radix sort of host arrays (in place). u32/u64 keys,
    optional u32 payload. Falls back to numpy argsort when the native
    library is unavailable."""
    lib = _load()
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    if payload is not None:
        payload = np.ascontiguousarray(payload, dtype=np.uint32)
        assert len(payload) == n
    if lib is None:
        order = np.argsort(keys, kind="stable")
        keys[:] = keys[order]
        if payload is not None:
            payload[:] = payload[order]
        return keys, payload
    if keys.dtype == np.uint32:
        p = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if payload is None:
            lib.host_radix_sort_u32(p, n)
        else:
            lib.host_radix_sort_u32_pairs(
                p, payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n
            )
    elif keys.dtype == np.uint64:
        p = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        if payload is None:
            lib.host_radix_sort_u64(p, n)
        else:
            lib.host_radix_sort_u64_pairs(
                p, payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n
            )
    else:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    return keys, payload


def host_histogram(keys: np.ndarray, level: int) -> np.ndarray:
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    if lib is None:
        return np.bincount((keys >> np.uint32(level * 8)) & 0xFF,
                           minlength=256).astype(np.int64)
    out = np.zeros(256, dtype=np.int64)
    lib.histogram_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        level,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out
