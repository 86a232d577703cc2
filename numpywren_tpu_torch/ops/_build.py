"""Build the CUDA sources under ``numpywren_tpu_torch/csrc`` at first use.

Each ``csrc/*.cu`` file compiles to an object in its own ``nvcc`` process,
all started together, and one more ``nvcc`` links the objects into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<hash>/<file>.o csrc/<file>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libnpw_<hash>.so *.o

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
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of this process's nvcc calls (None: loaded as built)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS + LINK_FLAGS).encode())
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
    """Compile csrc/*.cu into the hashed library unless it exists already:
    one nvcc per source, in parallel, then one link."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    objdir = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in cu:
        cmd = [nvcc, *FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out[-8000:]}")
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(objdir / f"{s.stem}.o") for s in cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{proc.stderr[-8000:]}")
    BUILD_SECONDS = time.perf_counter() - t0
    shutil.rmtree(objdir, ignore_errors=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
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
