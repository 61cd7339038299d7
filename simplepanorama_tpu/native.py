"""Native (C++) host kernels: build-on-first-use ctypes bindings.

The reference's runtime has one hard native kernel — the vendored BK
max-flow (/root/reference/src/max_flow/). The rebuild keeps the native
slot: native/mincut.cpp is a from-scratch Dinic grid max-flow used as
(a) the host-side seam backend when no accelerator is attached and
(b) the exact oracle the device push-relabel solver is validated against.

The shared object is compiled with g++ on first use (no pip; the image is
zero-egress) and cached beside the source.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO = _ROOT / "libspt_native.so"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    src = _ROOT / "mincut.cpp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           str(src), "-o", str(_SO)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeUnavailable(f"native build failed:\n{proc.stderr}")


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not _SO.exists() or _SO.stat().st_mtime < (
                _ROOT / "mincut.cpp").stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.grid_mincut.restype = ctypes.c_float
        lib.grid_mincut.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
        return lib


def grid_mincut_native(cap_h: np.ndarray, cap_v: np.ndarray,
                       excess: np.ndarray, node: np.ndarray
                       ) -> Tuple[np.ndarray, float]:
    """Exact min cut (Dinic). Returns (source_side bool (H, W), flow)."""
    H, W = cap_h.shape
    out = np.zeros(H * W, np.uint8)
    flow = _lib().grid_mincut(
        H, W,
        np.ascontiguousarray(cap_h, np.float32),
        np.ascontiguousarray(cap_v, np.float32),
        np.ascontiguousarray(excess, np.float32),
        np.ascontiguousarray(node, np.uint8),
        out)
    return out.reshape(H, W).astype(bool), float(flow)
