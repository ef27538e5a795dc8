"""ctypes bindings for the native runtime components.

Port of ``cpp_fluid_particles_tpu/runtime/native.py``. Builds gifenc.cpp
with the system C++ toolchain on first use into the package's ``_build/``
(ignored by git); the CPython-free C ABI + ctypes keeps the binding
dependency-free. All entry points degrade gracefully: if the toolchain or
the .so is unavailable, callers fall back to pure Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gifenc.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "_build", "_cfp_native.so")
_HASH = _SO + ".srchash"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120,
        )
        with open(_HASH, "w") as f:
            f.write(_src_hash())
        return True
    except Exception:
        return False


def _stale() -> bool:
    """Rebuild unless the .so was built from the current source — a
    source-hash check, not mtime (git checkouts do not preserve mtimes,
    and a stale/unauditable binary must never be silently loaded)."""
    if not os.path.exists(_SO) or not os.path.exists(_HASH):
        return True
    try:
        with open(_HASH) as f:
            return f.read().strip() != _src_hash()
    except OSError:
        return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale():
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.cfp_write_gif_pal.restype = ctypes.c_int
            lib.cfp_write_gif_pal.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float,
              palette: Optional[np.ndarray] = None) -> None:
    """palette: optional (256, 3) uint8 custom palette; None uses the
    builtin 6x7x6 cube."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native gif encoder unavailable")
    stack = np.ascontiguousarray(np.stack(frames).astype(np.uint8))
    n, h, w, _ = stack.shape
    delay = max(2, int(round(100.0 / fps)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if palette is None:
        pal_ptr = ctypes.cast(None, u8p)
        pal_keepalive = None
    else:
        pal_keepalive = np.ascontiguousarray(
            np.asarray(palette, np.uint8).reshape(256, 3))
        pal_ptr = pal_keepalive.ctypes.data_as(u8p)
    rc = lib.cfp_write_gif_pal(
        path.encode(), stack.ctypes.data_as(u8p), n, h, w, delay, pal_ptr,
    )
    del pal_keepalive
    if rc != 0:
        raise RuntimeError(f"cfp_write_gif failed with code {rc}")
