"""Build the CUDA sources under ``numpywren_tpu_torch/csrc`` at first use.

All ``csrc/*.cu`` files compile, in one ``nvcc`` call, into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/libnpw_<hash>.so csrc/*.cu

The library's name carries a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads at once. The output goes to
``numpywren_tpu_torch/_build/`` (git-ignored); ``ptxas``'s report of each
kernel's registers, shared memory and spills lands beside it as
``libnpw_<hash>.log``. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of this process's nvcc call (None: loaded as built)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"libnpw_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists already."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.npw_error_string.argtypes = [ctypes.c_int]
            lib.npw_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().npw_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
