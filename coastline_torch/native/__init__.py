"""The native contour tracer (the port's copy of `coastline/native/`),
loaded with ctypes.

Contour tracing is sequential pointer chasing and stays on the host. With
cv2 installed `infer/contours.py` uses cv2.findContours; without it (the
card's machine has no cv2) the pure-Python Moore tracer takes minutes on a
granule's band. This module compiles `contours.cpp` with the host's `g++`
at first use into `build/coastline_torch/contours-<hash>.so` (the hash of
the source and the flags, as `kernels/_build.py` names the CUDA libraries)
and exposes bit-identical replacements for the Python tracer and RDP.

No g++, a failed compile or a failed load give `load_native() -> None`,
and `extract_contours(backend="auto")` keeps the Python path;
`backend="native"` raises instead.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from coastline_torch.kernels._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "contours.cpp")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_load_attempted = False


def owned_dir(d) -> Optional[str]:
    """`d`, created if missing, when the current user owns it, else None.

    A shared library is loaded only from a directory this user owns: one
    that someone else could write to would let them run code here."""
    d = str(d)
    try:
        os.makedirs(d, mode=0o700, exist_ok=True)
        if hasattr(os, "getuid") and os.stat(d).st_uid != os.getuid():
            return None
    except OSError:
        return None
    return d


def build_library(verbose: bool = False) -> Optional[str]:
    """Compile contours.cpp into the build directory (once per source and
    flags); the library's path, or None."""
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    cache = owned_dir(BUILD_DIR)
    if cache is None:
        return None
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(cache, f"contours-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        if verbose:
            print("native build failed:", proc.stderr.decode(errors="replace"))
        return None
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return out


def load_native():
    """ctypes handle to the contour library, or None if unavailable."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        path = build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.trace_new.restype = ctypes.c_void_p
        lib.trace_new.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.trace_ncontours.restype = ctypes.c_int
        lib.trace_ncontours.argtypes = [ctypes.c_void_p]
        lib.trace_len.restype = ctypes.c_int64
        lib.trace_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.trace_copy.restype = None
        lib.trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.trace_free.restype = None
        lib.trace_free.argtypes = [ctypes.c_void_p]
        lib.rdp_keep.restype = None
        lib.rdp_keep.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                                 ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def moore_trace(mask: np.ndarray) -> Optional[List[np.ndarray]]:
    """External boundary of each 4-connected component, as (n, 2) int32
    [x, y] arrays, bit-identical to `contours._moore_trace`; None without
    the library."""
    lib = load_native()
    if lib is None:
        return None
    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    h, w = m.shape
    handle = lib.trace_new(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    try:
        out = []
        for i in range(lib.trace_ncontours(handle)):
            buf = np.empty((lib.trace_len(handle, i), 2), np.int32)
            lib.trace_copy(handle, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            out.append(buf)
        return out
    finally:
        lib.trace_free(handle)


def rdp(points: np.ndarray, eps: float) -> Optional[np.ndarray]:
    """RDP-simplified points, bit-identical to `contours._rdp`; None
    without the library."""
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(np.asarray(points, np.int32))
    n = pts.shape[0]
    if n < 3:
        return pts
    keep = np.zeros(n, np.uint8)
    lib.rdp_keep(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, float(eps),
                 keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return pts[keep.astype(bool)]
