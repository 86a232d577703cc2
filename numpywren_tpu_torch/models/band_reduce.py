"""Band reduction on the device: upper-banded (bandwidth d) -> block
bidiagonal with w-blocks (bandwidth <= 2w - 1), singular values preserved.

Counterpart of numpywren_tpu/models/band_reduce.py, stage 1.5 of the
two-stage SVD: `svd._band_sigma` runs it on the BDFAC's band (about one
tile wide) before the host LAPACK finish, which is fast only for narrow
bands. Pairwise BLOCK transforms chase each annihilated block's bulge
down the band (the two-stage SVD of Grosser & Lang):

    for each block row I (w rows), annihilate its band blocks
    (I, I+D) .. (I, I+2) right-to-left; each annihilation is an LQ of a
    (w x 2w) column pair that zeroes the right block, whose transform
    bulges the (pi, pi-1) sub-diagonal block, which a (2w x w) QR kills,
    whose transform fills (pi-1, pi+D): the bulge chases down the band
    with stride D blocks until it falls off into the zero padding.

The reference's jitted `fori_loop`s are Python loops here, eager torch on
the input's device: each hop is a view of one (D+2)w-square window, two
QRs (torch.linalg.qr, complete) and two products (torch.matmul, true FP32:
the reference's HIGHEST), written in place. The window starts are clamped
to the operand as JAX's dynamic_slice clamps them; the zero padding makes
any clamped tail window all zero. The chase runs in float32, as the
reference's does without jax x64.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, to_numpy

__all__ = ["band_reduce", "band_reduce_packed", "band_reduce_sigma_prep"]


def _geometry(n: int, ku: int, w: int):
    """(D, p0, nr, m, hmax): block bandwidth, leading zero pad (blocks),
    real block rows, padded side, the hop bound of one chase."""
    D = -(-ku // w)
    p0 = D
    nr = -(-n // w)
    pad1 = 2 * (D + 2)              # trailing zero pad (blocks)
    m = (p0 + nr + pad1) * w
    hmax = (p0 + nr + pad1) // D + 1
    return D, p0, nr, m, hmax


def _hops(D: int, p0: int, nr: int, hmax: int) -> Iterator[Tuple[int, int]]:
    """The (rho, pi) of every hop of the chase, in order: block row rho's
    pivot and the column pair (pi - 1, pi)."""
    content_end = p0 + nr + 2       # last possibly-nonzero block
    for g in range(nr):
        i_blk = p0 + g
        for j in range(D - 1):
            c = i_blk + D - j       # windows right-to-left
            h_end = min(max((content_end - c + D - 1) // D + 1, 1), hmax)
            rho, pi = i_blk, c
            for _ in range(h_end):
                yield rho, pi
                rho, pi = pi - 1, pi + D


def chase_hops(n: int, ku: int, w: int) -> int:
    """The number of hops `band_reduce` runs on an (n, n) band of width ku
    (0 when ku <= 2w - 1: no reduction)."""
    if ku <= 2 * w - 1:
        return 0
    D, p0, nr, _, hmax = _geometry(n, ku, w)
    return sum(1 for _ in _hops(D, p0, nr, hmax))


def _chase(a: torch.Tensor, w: int, D: int, p0: int, nr: int, hmax: int) -> None:
    """The chase, in place on the padded (m, m) operand. Both half-hops of
    a hop live in one window S = a[(pi-1-D)w : (pi+1)w, (pi-1)w : (pi+1+D)w]:
    the right transform's rows are S[:, :2w], the left transform's columns
    S[Dw:, :]."""
    m = a.shape[0]
    two_w, win = 2 * w, (D + 2) * w
    for rho, pi in _hops(D, p0, nr, hmax):
        r0, c0 = (pi - 1 - D) * w, (pi - 1) * w
        r0c, c0c = min(max(r0, 0), m - win), min(max(c0, 0), m - win)
        s = a[r0c:r0c + win, c0c:c0c + win]
        # right transform: LQ of the pivot row block's column pair zeroes
        # block (rho, pi); it mixes the pair's columns for all of S's rows
        sr = min(max(rho * w - r0, 0), win - w)
        qf, _ = torch.linalg.qr(s[sr:sr + w, :two_w].T, mode="complete")   # (2w, 2w)
        s[:, :two_w] = s[:, :two_w] @ qf
        # left transform: QR of the (2w, w) [diagonal block; bulge] pair
        # zeroes the bulge (pi, pi-1); the fill lands at (pi-1, pi+D)
        q2, _ = torch.linalg.qr(s[D * w:, :w], mode="complete")
        s[D * w:, :] = q2.T @ s[D * w:, :]


def _reduce_on_device(bd, ku: int, w: int, device=None):
    """Pad on the device (the input is the only host-to-device copy) and
    chase. Returns (out, m)."""
    x = as_tensor(bd, device, dtype=torch.float32)
    n = x.shape[0]
    D, p0, nr, m, hmax = _geometry(n, ku, w)
    a = torch.zeros((m, m), dtype=torch.float32, device=x.device)
    a[p0 * w:p0 * w + n, p0 * w:p0 * w + n] = x
    _chase(a, w, D, p0, nr, hmax)
    return a, m


def _pack(a: torch.Tensor, ku2: int):
    """The packed band AB[r, j] = a[j - ku2 + r, j] (dgbbrd storage, kl=0)
    as one gather on the device, with the max |below-diagonal| /
    |beyond-band| leak and max |a|: (ab, leak, scale) as tensors."""
    m = a.shape[0]
    cols = torch.arange(m, device=a.device)[None, :]
    rows = cols - (ku2 - torch.arange(ku2 + 1, device=a.device)[:, None])
    ab = torch.where(rows >= 0, a[rows.clamp(0, m - 1), cols.expand_as(rows)],
                     torch.zeros((), dtype=a.dtype, device=a.device))
    leak = torch.maximum(torch.abs(torch.tril(a, -1)).max(),
                         torch.abs(torch.triu(a, ku2 + 1)).max())
    return ab, leak, torch.abs(a).max()


def band_reduce_packed(bd, ku: int, w: int = 32, device=None):
    """band_reduce returning the LAPACK packed band, everything heavy on
    the device: (ab, ku2, m) with ab a host (ku2+1, m) array in dgbbrd
    storage (AB[ku2 + i - j, j] = A[i, j], kl = 0), ku2 = 2w - 1, and
    sigma(A_packed) = sigma(bd) plus exact zeros. The band leak is checked
    on the device; the host reads ab and two scalars. Raises
    FloatingPointError on a leak. `device` as in band_reduce."""
    n = np.shape(bd)[0]
    if ku <= 2 * w - 1:
        # no reduction needed: pack the input as-is (host-side, cheap)
        a = to_numpy(bd)
        ab = np.zeros((ku + 1, n), dtype=a.dtype)
        for r in range(ku + 1):
            d = ku - r
            ab[r, d:] = np.diagonal(a, offset=d)
        return ab, ku, n
    out, m = _reduce_on_device(bd, ku, w, device)
    ku2 = 2 * w - 1
    ab_dev, leak_dev, scale_dev = _pack(out, ku2)
    leak, scale = (float(v) for v in torch.stack([leak_dev, scale_dev]).cpu())
    scale = scale or 1.0
    if leak > 1e-4 * scale:
        raise FloatingPointError(
            f"band_reduce leaked {leak:.2e} (rel {leak / scale:.2e}) "
            f"outside band {ku2} at m={m} — chase indexing bug; falling "
            "back is the caller's job"
        )
    return to_numpy(ab_dev), ku2, m


def band_reduce(bd, ku: int, w: int = 32, device=None) -> Tuple[np.ndarray, int]:
    """Reduce an upper-banded square matrix to bandwidth <= 2w - 1.

    bd: (n, n) ndarray or tensor with nonzeros only in diagonals [0, ku].
    Returns (reduced, new_ku): `reduced` is a LARGER zero-padded host
    array whose singular values are sigma(bd) plus exact zeros; new_ku =
    2w - 1. Callers take the top n values of the banded finish. The chase
    runs in float32 on bd's device (a tensor stays where it is; an ndarray
    goes to `device`, else the current CUDA device). When ku <= 2w - 1
    nothing runs and bd comes back as a host array."""
    shape = tuple(bd.shape)
    if len(shape) != 2 or shape[1] != shape[0]:
        raise ValueError(f"band_reduce expects a square matrix, got {shape}")
    if ku <= 2 * w - 1:
        return to_numpy(bd), ku
    out, _ = _reduce_on_device(bd, ku, w, device)
    return to_numpy(out), 2 * w - 1


def band_reduce_sigma_prep(bd, ku: int, w: int = 32, device=None):
    """band_reduce + a check that the reduced matrix really is within the
    promised band (a chase-indexing fault would leak nonzeros outside it
    and corrupt sigma). Returns (reduced, new_ku, n_real)."""
    n = bd.shape[0]
    red, new_ku = band_reduce(bd, ku, w=w, device=device)
    if new_ku != ku:  # a reduction actually ran
        m = red.shape[0]
        scale = float(np.abs(red).max()) or 1.0
        low = np.tril(red, -1)
        high = np.triu(red, new_ku + 1)
        leak = max(np.abs(low).max(initial=0.0), np.abs(high).max(initial=0.0))
        if leak > 1e-4 * scale:
            raise FloatingPointError(
                f"band_reduce leaked {leak:.2e} (rel) outside band {new_ku} "
                f"at m={m} — chase indexing bug; falling back is the "
                "caller's job"
            )
    return red, new_ku, n
