"""Linear assignment: native C++ solver with a scipy fallback (port's copy of
gomatching_tpu/ops/hungarian.py).

The tracker solves its LSAPs on the host, as the reference does
(gom_lstmatcher.py:447). The default is the repository's C++
Hungarian-with-potentials solver (``native/lap.cpp``), compiled with g++ at first
use into ``build/gomatching_tpu_torch/`` (``_build.build``) and loaded through
ctypes; scipy solves instead only when no C++ compiler is on PATH.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from ._build import REPO_ROOT, build

_SRC = REPO_ROOT / "native" / "lap.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _load_native():
    """The built solver, or None when there is no C++ compiler (scipy then solves).
    A source that fails to build or a library that fails to load raises."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            gxx = shutil.which("g++")
            if gxx is not None:
                lib = ctypes.CDLL(str(build(_SRC, gxx, GXX_FLAGS)))
                lib.lap_solve.restype = ctypes.c_int
                lib.lap_solve.argtypes = [
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                ]
                _lib = lib
        return _lib


def solve(cost: np.ndarray):
    """Min-cost assignment -> (row_idx, col_idx), scipy-compatible output."""
    cost = np.asarray(cost)
    if cost.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lib = _load_native()
    if lib is None:
        from scipy.optimize import linear_sum_assignment

        return linear_sum_assignment(cost)
    n, m = cost.shape
    c = np.ascontiguousarray(cost, np.float64)
    # the potentials formulation needs finite entries
    if not np.isfinite(c).all():
        c = np.nan_to_num(c, nan=1e15, posinf=1e15, neginf=-1e15)
    out = np.empty(n, np.int32)
    lib.lap_solve(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    rows = np.nonzero(out >= 0)[0]
    return rows.astype(np.int64), out[rows].astype(np.int64)
