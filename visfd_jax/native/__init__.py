"""Native (C++) host runtime loader.

The sequential priority-flood algorithms (watershed, LabelConnected)
are ordered computations that stay on the host; the reference runs
them as compiled C++ (``segmentation.hpp``, ``connect.hpp``).  This
package provides the same: ``visfd_native.cpp`` is compiled on first
use with the system ``g++`` into a shared library loaded via ctypes.

``load()`` returns the ctypes library or ``None`` when unavailable
(no compiler, compile failure, or ``VISFD_NATIVE=0``); callers fall
back to the bit-identical pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "visfd_native.cpp")

_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, f"_visfd_native_{h}.so")


def _compile(so: str) -> bool:
    # atomic: build to a temp name, rename into place
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            print(f"visfd_jax.native: compile failed:\n{r.stderr}",
                  file=sys.stderr)
            os.unlink(tmp)
            return False
        os.replace(tmp, so)
        return True
    except Exception as e:  # g++ missing, timeout, ...
        print(f"visfd_jax.native: compile error: {e}", file=sys.stderr)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    pf = ctypes.POINTER(ctypes.c_float)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.visfd_watershed_flood.restype = i64
    lib.visfd_watershed_flood.argtypes = [
        pf, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, i32, pi64]
    lib.visfd_connect_flood.restype = i64
    lib.visfd_connect_flood.argtypes = [
        pf, pu8, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, pf, pf, f64, f64, i32,
        pf, pi64, pi64, pi8]
    lib.visfd_connect_flood_compact.restype = i64
    lib.visfd_connect_flood_compact.argtypes = [
        pi32, pf, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, pf, pf, f64, f64, i32,
        pf, pi64, pi64, pi8]
    pf64 = ctypes.POINTER(ctypes.c_double)
    lib.visfd_nms.restype = i64
    lib.visfd_nms.argtypes = [
        pf64, pf64, pf64, pi64, pi64,
        i64, i64, f64, f64, f64,
        pu8]
    return lib


def load():
    """Return the bound ctypes library, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("VISFD_NATIVE", "1") == "0":
        return None
    so = _so_path()
    if not os.path.exists(so) and not _compile(so):
        return None
    try:
        _lib = _bind(ctypes.CDLL(so))
    except OSError as e:
        print(f"visfd_jax.native: load failed: {e}", file=sys.stderr)
        _lib = None
    return _lib


def ptr(arr, ctype):
    """C pointer for a C-contiguous numpy array (None -> NULL)."""
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
