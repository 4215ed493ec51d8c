"""ctypes bindings of the native Euroc parser (built at first use by
``native/build.py``)."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from mixedprecisionblockqr_tpu_torch.native.build import build

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        path = build()
        if path is None:
            raise OSError("native euroc parser unavailable")
        lib = ctypes.CDLL(path)
        lib.euroc_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.euroc_dims.restype = ctypes.c_int
        lib.euroc_fill.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.euroc_fill.restype = ctypes.c_int64
        lib.euroc_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.euroc_write.restype = ctypes.c_int64
        _lib = lib
    return _lib


def parse_file(path: str) -> Tuple[int, int, np.ndarray]:
    """``(rows, cols, matrix)`` of a Jacobian file, the matrix dense fp32
    (each value parsed as a double and rounded to fp32 once)."""
    lib = _get_lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.euroc_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"euroc_dims({path}) failed: {rc}")
    a = np.empty((rows.value, cols.value), np.float32)
    n = lib.euroc_fill(
        path.encode(),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value,
        cols.value,
    )
    if n < 0:
        raise IOError(f"euroc_fill({path}) failed: {n}")
    return rows.value, cols.value, a


def write_file(path: str, a: np.ndarray) -> int:
    """Write ``a`` in the sparse-triplet format (its nonzeros, ``%.9g``);
    returns the number of triplets."""
    lib = _get_lib()
    a = np.ascontiguousarray(a, np.float32)
    n = lib.euroc_write(
        path.encode(),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a.shape[0],
        a.shape[1],
    )
    if n < 0:
        raise IOError(f"euroc_write({path}) failed: {n}")
    return int(n)
