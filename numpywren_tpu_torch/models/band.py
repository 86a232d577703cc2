"""Host-side banded SVD finish: LAPACK band->bidiagonal + bidiagonal sigma.

The port's own copy of numpywren_tpu/models/band.py (host code, no JAX;
the port imports nothing of the JAX package), unchanged but for this
paragraph and the wording of two sentences below.

Stage 2 of the two-stage SVD (stage 1 = the device BDFAC,
compiler.lower.fused_bdfac, which reduces A to a block-bidiagonal /
banded B whose singular values equal A's — the reference stops exactly
there, upstream:numpywren/algs.py::bdfac). Extracting sigma(B) is host
work; this module does it the LAPACK way:

    dgbbrd  (banded -> bidiagonal, Givens chasing, O(n^2 * ku) flops)
    dbdsdc  (bidiagonal sigma, divide & conquer, O(n^2))

via ctypes against the system reference LAPACK — scipy's wrappers don't
expose the band routines. Measured by the JAX package on a single-core host (fp64):
n=8192 ku=32 -> 7.6 s, ku=64 -> 18 s, ~linear in ku; the previous
finish (perfect-shuffle Golub-Kahan symmetric band eigensolve,
scipy.eig_banded on a 2n matrix of double bandwidth) measures ~35x
slower at the same band and size. Accuracy is bidiagonal-grade: no Gram
squaring anywhere, small singular values keep full relative accuracy.

Falls back to the GK eigensolve when no LAPACK shared library is found.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

__all__ = ["band_sigma_lapack", "band_sigma_packed", "lapack_available"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_CANDIDATES = (
    "liblapack.so.3",
    "liblapack.so",
    "/usr/lib/x86_64-linux-gnu/liblapack.so.3",
)


def _is_lp64(lib: ctypes.CDLL) -> bool:
    """Reject ILP64 builds (the ctypes calls below hardcode 32-bit ints;
    against an 8-byte-integer LAPACK they would corrupt memory, not fail
    cleanly). Probe via ilaver_ — it writes ONLY integers (no arrays), so
    the probe itself is safe under either ABI: seed three 8-byte buffers
    with -1; an LP64 write touches the low 4 bytes (int64 view stays
    huge/negative on little-endian), an ILP64 write fills all 8 (small
    positive version numbers)."""
    try:
        ilaver = lib.ilaver_
    except AttributeError:
        return True  # ancient LAPACK without ilaver: assume LP64 (the norm)
    bufs = [ctypes.c_int64(-1) for _ in range(3)]
    try:
        ilaver(*[ctypes.byref(b) for b in bufs])
    except Exception:  # noqa: BLE001 — any probe fault: refuse the library
        return False
    vals = [b.value for b in bufs]
    if all(0 <= v < 1 << 16 for v in vals):
        return False  # full 8-byte writes: ILP64
    # low-dword small positives under the -1 sentinel high dword = LP64
    return all((v & 0xFFFFFFFF) < 1 << 16 for v in vals)


def _lapack() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    names = list(_CANDIDATES)
    found = ctypes.util.find_library("lapack")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            lib.dgbbrd_  # noqa: B018 — probe the symbols we need
            lib.dbdsdc_
            if not _is_lp64(lib):
                continue  # ILP64 build: callers fall back to the GK path
            _LIB = lib
            break
        except (OSError, AttributeError):
            continue
    return _LIB


def lapack_available() -> bool:
    return _lapack() is not None


def _pack_band(a: np.ndarray, kl: int, ku: int) -> np.ndarray:
    """LAPACK general-band storage: AB[ku + i - j, j] = a[i, j], Fortran
    order (column-major) as dgbbrd expects."""
    m, n = a.shape
    ldab = kl + ku + 1
    ab = np.zeros((ldab, n), dtype=np.float64, order="F")
    for j in range(n):
        i0, i1 = max(0, j - ku), min(m, j + kl + 1)
        ab[ku + i0 - j : ku + i1 - j, j] = a[i0:i1, j]
    return ab


def band_sigma_lapack(a: np.ndarray, ku: int, kl: int = 0) -> np.ndarray:
    """All singular values (descending, fp64) of a banded matrix with
    `ku` superdiagonals and `kl` subdiagonals. `a` is the dense (m, n)
    array; only the band is read. Raises RuntimeError when no LAPACK
    library is reachable (callers fall back to the GK eigensolve)."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    ku = min(ku, n - 1) if n > 1 else 0
    kl = min(kl, m - 1) if m > 1 else 0
    return band_sigma_packed(_pack_band(a, kl, ku), m, n, kl, ku)


def band_sigma_packed(ab: np.ndarray, m: int, n: int, kl: int, ku: int
                      ) -> np.ndarray:
    """Same as band_sigma_lapack on an already-packed Fortran-order band
    array AB ((kl+ku+1, n), AB[ku + i - j, j] = a[i, j]) — the entry point
    for tiled matrices whose band is assembled block by block without a
    dense square ever existing."""
    lib = _lapack()
    if lib is None:
        raise RuntimeError("no LAPACK shared library with dgbbrd/dbdsdc")
    ab = np.asfortranarray(ab, dtype=np.float64)
    mn = min(m, n)
    d = np.zeros(mn)
    e = np.zeros(max(mn - 1, 1))
    work = np.zeros(2 * max(m, n))
    dummy = np.zeros(1)
    one = ctypes.c_int(1)
    info = ctypes.c_int(0)
    lib.dgbbrd_(
        b"N",
        ctypes.byref(ctypes.c_int(m)), ctypes.byref(ctypes.c_int(n)),
        ctypes.byref(ctypes.c_int(0)),           # NCC: no C matrix
        ctypes.byref(ctypes.c_int(kl)), ctypes.byref(ctypes.c_int(ku)),
        ab.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(ctypes.c_int(ab.shape[0])),
        d.ctypes.data_as(ctypes.c_void_p),
        e.ctypes.data_as(ctypes.c_void_p),
        dummy.ctypes.data_as(ctypes.c_void_p), ctypes.byref(one),  # Q
        dummy.ctypes.data_as(ctypes.c_void_p), ctypes.byref(one),  # PT
        dummy.ctypes.data_as(ctypes.c_void_p), ctypes.byref(one),  # C
        work.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(info),
        1,  # VECT string length (Fortran hidden arg)
    )
    if info.value != 0:
        raise RuntimeError(f"dgbbrd failed: info={info.value}")
    work2 = np.zeros(4 * mn)
    iwork = np.zeros(8 * mn, dtype=np.int32)
    info2 = ctypes.c_int(0)
    lib.dbdsdc_(
        b"U", b"N",
        ctypes.byref(ctypes.c_int(mn)),
        d.ctypes.data_as(ctypes.c_void_p),
        e.ctypes.data_as(ctypes.c_void_p),
        dummy.ctypes.data_as(ctypes.c_void_p), ctypes.byref(one),  # U
        dummy.ctypes.data_as(ctypes.c_void_p), ctypes.byref(one),  # VT
        dummy.ctypes.data_as(ctypes.c_void_p),                      # Q
        iwork.ctypes.data_as(ctypes.c_void_p),                      # IQ
        work2.ctypes.data_as(ctypes.c_void_p),
        iwork.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(info2),
        1, 1,  # UPLO/COMPQ string lengths
    )
    if info2.value != 0:
        raise RuntimeError(f"dbdsdc failed: info={info2.value}")
    return np.sort(d)[::-1]
