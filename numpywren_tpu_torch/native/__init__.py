"""Native (C++) schedule core: build, load, and call _schedule_core.so.

The compiler uses this automatically for large programs (see
compiler/schedule.py); everything falls back to the pure-Python passes when
the shared library is missing or the program uses constructs the bytecode
serializer does not cover.

Build explicitly with `python -m numpywren_tpu_torch.native.build`; the loader
also attempts one lazy build on first use (g++ is in the image).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "schedule_core.cpp")
_SO = os.path.join(_DIR, "_schedule_core.so")

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False, so: str = _SO) -> bool:
    """Compile schedule_core.cpp -> `so` (by default _schedule_core.so).
    Returns success. g++ writes a file of its own beside `so`, which then
    replaces `so` at once: a concurrent loader (another process, an xdist
    worker) sees no library or a whole one, never half a file."""
    if os.path.exists(so) and not force:
        if os.path.getmtime(so) >= os.path.getmtime(_SRC):
            return True
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=240,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The ctypes library handle, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.npw_build.restype = i64
        lib.npw_build.argtypes = [p64, i64, p64, p64, i64, p64, i64, p64, i64, p64, i64]
        lib.npw_error.restype = i64
        lib.npw_error.argtypes = [i64, ctypes.c_char_p, i64]
        lib.npw_num_nodes.restype = i64
        lib.npw_num_nodes.argtypes = [i64]
        lib.npw_num_levels.restype = i64
        lib.npw_num_levels.argtypes = [i64]
        lib.npw_num_initial_reads.restype = i64
        lib.npw_num_initial_reads.argtypes = [i64]
        lib.npw_sizes.restype = None
        lib.npw_sizes.argtypes = [i64, p64]
        lib.npw_nodes.restype = None
        lib.npw_nodes.argtypes = [i64] + [p64] * 10
        lib.npw_edges.restype = None
        lib.npw_edges.argtypes = [i64, p64, p64, p64]
        lib.npw_initial_reads.restype = None
        lib.npw_initial_reads.argtypes = [i64, p64]
        lib.npw_free.restype = None
        lib.npw_free.argtypes = [i64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
