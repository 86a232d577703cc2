"""Out-of-core Cholesky and BDFAC: host-tier matrices streamed through the
device (counterpart of numpywren_tpu/runtime/spill.py).

The matrix lives on the host tier (TiledMatrix storage="host": CPU tiles,
pinned when the tier computes on a CUDA device), as the reference's matrices
live in S3.

- `out_of_core_cholesky`: a LEFT-LOOKING panel algorithm streams column
  super-panels through the device: each panel is updated by every factored
  panel before it (one GEMM per predecessor strip), factored on the device
  and written back. Host <-> device traffic is O(N^2 * S) for S
  super-panels, the out-of-core trade the reference pays to S3 on every
  task.
- `out_of_core_bdfac` (and `out_of_core_singular_values` on it): a
  right-looking block bidiagonalization, SVD stage 1 beyond the device: per
  panel step the trailing matrix streams through the device twice, once for
  the column panel's reflector and once for the row panel's. Traffic is
  O(N^3 / W).

On a CUDA device the copies run on streams of their own: uploads on one,
downloads on another, each ordered against the compute stream (the caller's
current stream) by events, so the copies ride under the products. On the
CPU the same control flow runs with plain copies.

Checkpoints keep the JAX package's on-disk format (``panel_<s>.npy`` and an
atomically replaced ``manifest.json``), so a run stopped by either package
can be finished by the other.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import json
import os
from typing import Optional

import numpy as np
import torch

from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.ops.common import check_precision, default_precision, leading_dim
from numpywren_tpu_torch.tiled import TiledMatrix
from numpywren_tpu_torch.utils import LRUCache, cdiv

# host-loaded L strips on the device at once: one feeding the running
# update, one arriving for the next
_STRIPS_IN_FLIGHT = 2
_HOST_TO_DEVICE, _DEVICE_TO_HOST = 1, 2  # cudaMemcpyKind


def _copy_2d(device, dsts, dpitch: int, srcs, spitch: int, width: int, rows: int,
             kind: int) -> None:
    """Enqueue on the current stream one 2-D copy of `rows` rows of `width`
    bytes from each address of `srcs` (rows `spitch` bytes apart) to the
    matching one of `dsts` (`dpitch` apart): csrc/copy.cu's npw_copy_tiles,
    one call for the whole list. Pinned host memory must outlive the
    copies; from pageable memory CUDA stages each copy before the
    call returns."""
    from numpywren_tpu_torch.ops import _build

    lib = _build.library()
    if not getattr(lib, "_npw_copy_typed", False):
        p, size, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        lib.npw_copy_tiles.argtypes = [i, p, size, p, size, size, size, i, p]
        lib.npw_copy_tiles.restype = i
        lib._npw_copy_typed = True
    n = len(dsts)
    with torch.cuda.device(device):
        rc = lib.npw_copy_tiles(n, (ctypes.c_void_p * n)(*dsts), dpitch,
                                (ctypes.c_void_p * n)(*srcs), spitch, width, rows, kind,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "tile copies between host and device")


def _copy_tile(dst: torch.Tensor, blk: torch.Tensor) -> None:
    """dst := blk, for a CPU tile blk and a (possibly strided) view dst on
    any device. A transposed tile (the mirror of a lower-triangle store)
    crosses as its contiguous self and is transposed on the device."""
    if dst.device.type == "cpu":
        dst.copy_(blk)
        return
    if blk.is_contiguous() or not blk.T.is_contiguous():
        dst.copy_(blk, non_blocking=True)
        return
    tmp = torch.empty(blk.T.shape, dtype=dst.dtype, device=dst.device)
    tmp.copy_(blk.T, non_blocking=True)
    dst.copy_(tmp.T)


def _panel_from_host(m: TiledMatrix, row0_t: int, col0_t: int, rows_t: int, cols_t: int,
                     lower_mirror: bool = False,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tiles [row0_t, row0_t + rows_t) x [col0_t, col0_t + cols_t) of the host
    store, written tile by tile into `out` (its leading rows_t x cols_t
    tiles; a new CPU tensor when None) and returned. lower_mirror reads
    (j, i) transposed when i < j (an SPD input stored lower-triangle only,
    TiledSymmetricMatrix semantics). On a CUDA `out` (unit column stride)
    the copies are enqueued on the current stream: the contiguous tiles as
    2-D copies by one call (asynchronous from the host tier's pinned tiles),
    the transposed ones one by one."""
    tm, tn = m.tile
    if out is None:
        out = torch.zeros((rows_t * tm, cols_t * tn), dtype=m.dtype)
    on_card = out.device.type == "cuda"
    item, ld = out.element_size(), out.stride(0)
    dsts, tiles = [], []
    for i in range(rows_t):
        for j in range(cols_t):
            gi, gj = row0_t + i, col0_t + j
            if lower_mirror and gi < gj:
                blk = m.get_block(gj, gi).T
            else:
                blk = m.get_block(gi, gj)
            if on_card and blk.is_contiguous():
                dsts.append(out.data_ptr() + (i * tm * ld + j * tn) * item)
                tiles.append(blk)
            else:
                _copy_tile(out[i * tm:(i + 1) * tm, j * tn:(j + 1) * tn], blk)
    if tiles:
        _copy_2d(out.device, dsts, ld * item, [blk.data_ptr() for blk in tiles], tn * item,
                 tn * item, tm, _HOST_TO_DEVICE)
    return out


def _panel_to_host(m: TiledMatrix, arr, row0_t: int, col0_t: int):
    """Store the CPU panel `arr` (a tensor or an ndarray) as tiles of `m`
    from (row0_t, col0_t)."""
    tm, tn = m.tile
    rows_t, cols_t = arr.shape[0] // tm, arr.shape[1] // tn
    for i in range(rows_t):
        for j in range(cols_t):
            m.put_block(arr[i * tm:(i + 1) * tm, j * tn:(j + 1) * tn], row0_t + i, col0_t + j)


def _tiles_to_host(src: torch.Tensor, dst: torch.Tensor) -> None:
    """dst, a (rows_t, cols_t, t, t) view of a slab of host tiles, := the
    leading rows_t x cols_t tiles of `src`. From a CUDA `src` (unit column
    stride) the 2-D copies are enqueued on the current stream by one call,
    into pinned tiles; on the CPU it is one copy."""
    rows_t, cols_t, t, _ = dst.shape
    if src.device.type == "cpu":
        dst.copy_(src[:rows_t * t, :cols_t * t].reshape(rows_t, t, cols_t, t).transpose(1, 2))
        return
    item = src.element_size()
    _copy_2d(src.device, [dst[i, j].data_ptr() for i in range(rows_t) for j in range(cols_t)],
             t * item, [src[i * t:, j * t:].data_ptr() for i in range(rows_t)
                        for j in range(cols_t)], src.stride(0) * item, t * item, t,
             _DEVICE_TO_HOST)


class SpillCheckpoint:
    """Panel-granular checkpoint manifest: completed L panels live in
    `dir/panel_<s>.npy` plus a manifest.json step counter (the JAX
    package's format)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(path, exist_ok=True)

    @property
    def manifest_file(self):
        return os.path.join(self.path, "manifest.json")

    def completed(self, expect_meta: Optional[dict] = None) -> int:
        """Panels already done. When expect_meta is given, the saved manifest
        must match it (same n/tile/panel_tiles): resuming a checkpoint_dir
        left over from a DIFFERENT factorization would silently skip panels
        and return a wrong factor, so a mismatch raises instead."""
        if not self.path or not os.path.exists(self.manifest_file):
            return 0
        with open(self.manifest_file) as f:
            manifest = json.load(f)
        if expect_meta:
            mismatched = {
                k: (manifest.get(k), v)
                for k, v in expect_meta.items()
                if manifest.get(k) != v
            }
            if mismatched:
                raise ValueError(
                    f"checkpoint at {self.path} belongs to a different run: "
                    f"{{saved vs current}} {mismatched}; delete the directory "
                    "or pass a fresh checkpoint_dir"
                )
        return manifest.get("panels_done", 0)

    def load_panel(self, s: int) -> np.ndarray:
        return np.load(os.path.join(self.path, f"panel_{s}.npy"))

    def save_panel(self, s: int, arr: np.ndarray, meta: dict):
        if not self.path:
            return
        np.save(os.path.join(self.path, f"panel_{s}.npy"), arr)
        tmp = self.manifest_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"panels_done": s + 1, **meta}, f)
        os.replace(tmp, self.manifest_file)  # atomic commit


def _bucket_tiles(rows_t: int, g: int, mode: str) -> int:
    """Padded row count (in tiles) for one panel/strip under a shape-
    bucketing mode: 'exact' = no padding, 'pow2' = pad to the next power of
    two (O(log g) distinct shapes, <= 2x padded flops, ~1.33x average),
    'full' = always the full height (one shape, 2x total update flops).
    The JAX package buckets to bound its XLA compiles; here the buckets bound
    the distinct operand shapes the kernels see."""
    if mode == "exact":
        return rows_t
    if mode == "full":
        return g
    if mode == "pow2":
        return min(g, 1 << max(rows_t - 1, 0).bit_length())
    raise ValueError(f"unknown shape_mode {mode!r} "
                     "(expected exact|pow2|full)")


class _Streams:
    """The copy streams of one run on a CUDA device: uploads on `h2d`,
    downloads on `d2h`, ordered against `compute` (the caller's current
    stream) by events. On the CPU there are none: `on` is a null context,
    `mark` returns None and `wait` does nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.compute = self.h2d = self.d2h = None
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def on(self, stream):
        return torch.cuda.stream(stream) if self.cuda else contextlib.nullcontext()

    def mark(self, stream):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def wait(self, stream, ev, *tensors) -> None:
        """Order `stream` after `ev`, and tell the allocator that `tensors`
        (made on another stream) are used on it."""
        if ev is None:
            return
        stream.wait_event(ev)
        for t in tensors:
            t.record_stream(stream)


def _check_update(panel: torch.Tensor, l_strip: torch.Tensor, l_top: torch.Tensor,
                  k: int) -> None:
    """The trailing update's operands against the GEMM kernels' envelope
    (any M, N, K; row-strided views with unit column stride, which they read
    and write in place), before the launch."""
    rows, w = panel.shape
    if (tuple(l_strip.shape) != (rows, k) or tuple(l_top.shape) != (w, k)
            or any(leading_dim(x) is None for x in (panel, l_strip, l_top))):
        raise ShapeError(
            f"trailing update outside the kernels' envelope: panel {tuple(panel.shape)} "
            f"{panel.stride()}, strip {tuple(l_strip.shape)} {l_strip.stride()}, "
            f"top {tuple(l_top.shape)} {l_top.stride()}, K {k}")


def _join_mesh(mesh, dtype, dev):
    """(rank count, this rank's flat index) of `mesh`, (1, 0) for None,
    after a barrier over it; anything but a DeviceMesh raises TypeError."""
    if mesh is None:
        return 1, 0
    from torch.distributed.device_mesh import DeviceMesh

    from numpywren_tpu_torch.parallel.mesh import flat_index, sum_over_mesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    float(sum_over_mesh(torch.zeros(1, dtype=dtype, device=dev), mesh)[0])
    return mesh.size(), flat_index(mesh)


def out_of_core_cholesky(
    a: TiledMatrix,
    panel_tiles: int = 4,
    precision=None,
    checkpoint_dir: Optional[str] = None,
    out: Optional[TiledMatrix] = None,
    cache_bytes: int = 0,
    pipeline_width: Optional[int] = None,
    on_event=None,
    mesh=None,
    stop_panels: Optional[int] = None,
    shape_mode: str = "pow2",
) -> TiledMatrix:
    """Left-looking blocked Cholesky of a host-tier SPD TiledMatrix; returns
    a host-tier L. The steps run on `a.device` (where the host tier
    computes): the card, or the CPU when the tier was made with
    device="cpu".

    Each trailing update ``panel -= l_strip @ l_topᵀ`` goes through
    `compiler.lower._sub_matmul`: the matmul3 kernel in compensated mode,
    the matmul kernel at "highest", ``addmm`` in true FP32 at plain "high".
    The W x W top of a panel factors through `compiler.lower.fused_cholesky`,
    the rows below by one triangular solve; a non-SPD block raises
    torch.linalg.LinAlgError before that panel is written back.

    pipeline_width >= 2 (default: NpwConfig.pipeline_width) pipelines the
    panel stream (the reference worker's I/O-compute overlap):

    - a prefetch thread assembles and uploads input panels up to
      pipeline_width - 1 ahead of the factor loop;
    - the factored panel's download, host writeback and checkpoint run in a
      writer thread, at most pipeline_width outstanding;
    - the most recent factored panel stays on the device and serves the
      next panel's newest (tallest) strip without waiting for its download.

    pipeline_width 1 is serial: each writeback ends before the next panel.
    Older strips come from the `cache_bytes` LRU of uploaded strips or from
    the host (after that panel's writeback has landed; `a.load_count`
    counts these loads). `on_event(kind, s)` is a test/trace hook (kinds:
    prefetch_issue/upload/factor/strip_hit_device/strip_load/download); it
    may fire from the prefetch and writer threads, and "download" fires in
    the writer before the host writeback.

    Device memory (W = panel_tiles * tile, n_pad the padded size, P the
    GEMM's bf16 planes: 2 compensated, 3 at "highest", 0 otherwise) stays
    within ``2 * pipeline_width`` panel buffers of ``(n_pad + W) x W``
    (the live panel, the prefetched ones, the writeback-pinned ones, which
    include the serve copy), two strips of ``n_pad x W``, the GEMM's packed
    planes ``2 * P * (n_pad + W) * W`` bytes, `cache_bytes` and the W x W
    factor's workspace: 3.64 GiB at N = 65536, W = 2048, width 2.

    stop_panels factors only the first so-many super-panels; the checkpoint
    manifest records the prefix, and a later call with the same
    checkpoint_dir continues where it stopped. shape_mode ('exact' | 'pow2'
    | 'full', default 'pow2') pads every device panel and strip to its
    row bucket (`_bucket_tiles`); the padded rows are zeros and stay zeros
    through the updates and the solve, and writebacks carry the real rows
    only.

    mesh (a DeviceMesh; every rank of it calls this with its own host tier
    holding the same matrix): each device panel and host-loaded strip is
    ROW-SHARDED over the mesh flattened row-major where its row count
    divides the rank count (rank f holds rows [f h, (f + 1) h) of it), and
    whole on every rank otherwise. The update is local to each rank (its
    rows of the strip by the strip's W rows at the panel's columns, loaded
    whole); the factor step sums the W x W top whole onto every rank (one
    all_reduce of the rows each holds), factors it redundantly, and each
    rank solves its own rows below it. Each rank has its own host memory,
    and a later panel's strips need rows that other ranks factored, so the
    factored panel is gathered whole onto every rank (one all_reduce of
    the zero-masked shares): it serves the next panel's newest strip and is
    written back to every rank's host tier. Checkpoints are written by the
    mesh's first rank; every call starts with a barrier over the mesh, so
    a resume reads them on every rank (checkpoint_dir must be one directory
    that every rank sees). Collective over the mesh.

    `l.spill_stats` reports the distinct operand shapes each step saw
    (`update_compiles`, `factor_compiles`: what the JAX package's jit cache
    sizes count), the host strip loads and the panels run.
    """
    from numpywren_tpu_torch.compiler.lower import _raise_if_not_spd, _sub_matmul, fused_cholesky
    from numpywren_tpu_torch.config import default_config

    if a.shape[0] != a.shape[1] or a.tile[0] != a.tile[1]:
        raise ShapeError("out_of_core_cholesky needs a square matrix / square tiles")
    g = a.grid[0]
    t = a.tile[0]
    precision = check_precision(precision or default_precision(a.dtype))
    lower_mirror = type(a).__name__ == "TiledSymmetricMatrix" or getattr(a, "_lower_only", False)
    dev = a.device
    streams = _Streams(dev)
    # the barrier: the first rank has finished any earlier call (and its
    # checkpoint writes) before any rank reads the manifest below
    n_dev, me = _join_mesh(mesh, a.dtype, dev)
    if mesh is not None:
        from numpywren_tpu_torch.parallel.mesh import sum_over_mesh

    def share(rows: int):
        """This rank's rows [lo, hi) of a device panel or strip of `rows`
        rows: a 1/n_dev share where it divides, else all of them."""
        if n_dev > 1 and rows % n_dev == 0:
            h = rows // n_dev
            return me * h, (me + 1) * h
        return 0, rows

    l_out = out or TiledMatrix(
        key=a.key + ":ooc_L", shape=a.shape, tile=a.tile, dtype=a.dtype, storage="host",
        parent_fn=lambda m, i, j: torch.zeros(m.tile, dtype=m.dtype), device=dev,
    )

    meta = {"n": int(a.shape[0]), "tile": int(t), "panel_tiles": int(panel_tiles)}
    ckpt = SpillCheckpoint(checkpoint_dir)
    n_panels = cdiv(g, panel_tiles)
    if stop_panels is not None:
        n_panels = min(n_panels, max(0, int(stop_panels)))
    start_panel = ckpt.completed(expect_meta=meta)
    # resume: reload completed panels into the output store
    for s in range(start_panel):
        _panel_to_host(l_out, torch.from_numpy(ckpt.load_panel(s)), s * panel_tiles,
                       s * panel_tiles)

    update_shapes, factor_shapes = set(), set()

    def update(panel, l_strip, l_top):
        # panel -= L[rows, prev] @ L[cols, prev]ᵀ (the left-looking GEMM)
        _check_update(panel, l_strip, l_top, l_strip.shape[1])
        update_shapes.add((tuple(panel.shape), tuple(l_strip.shape), tuple(l_top.shape)))
        _sub_matmul(panel, l_strip, l_top, tb=True, precision=precision, out=panel)

    def factor_panel(panel, lo=None):
        """panel = [D; B]: D := chol(D); B := B D⁻ᵀ, in place. With `lo`,
        `panel` is this rank's rows [lo, lo + h) of it: D is summed whole
        onto every rank from the rows each holds (one all_reduce) and
        factored on every rank, and each rank solves its own rows below it.
        Returns the diagonal blocks' factor statuses, which the writer
        checks before the panel is written back: the factor loop never
        waits for them."""
        factor_shapes.add(tuple(panel.shape))
        h, w_cols = panel.shape
        if lo is None:
            top, k = panel[:w_cols], w_cols
        else:
            k = min(h, max(w_cols - lo, 0))  # this rank's rows inside D
            top = torch.zeros((w_cols, w_cols), dtype=panel.dtype, device=dev)
            top[lo:lo + k] = panel[:k]
            sum_over_mesh(top, mesh)
        infos = []
        fused_cholesky(top, t, precision=precision, infos=infos)
        if lo is not None:
            panel[:k] = top[lo:lo + k]
        rest = panel[k:]
        if rest.shape[0]:
            torch.linalg.solve_triangular(top.T, rest, upper=True, left=False, out=rest)
        return infos

    # device-side LRU of uploaded L strips, keyed by source panel q; each
    # strip is cached at its first (tallest) use, later panels slice a suffix
    cache = (
        LRUCache(cache_bytes, size_fn=lambda v: v[1].numel() * v[1].element_size())
        if cache_bytes > 0
        else None
    )
    a.load_count = getattr(a, "load_count", 0)

    if pipeline_width is None:
        pipeline_width = default_config().pipeline_width
    event = on_event or (lambda kind, s: None)

    writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    writer_futures = {}
    # the device copy of the most recent factored panel, (its first row, buffer)
    recent = {}
    # compute-stream events after each update fed by a host-loaded strip
    strip_done = collections.deque()

    def serve_rows_t(s: int, rows_bt: int) -> int:
        """Rows (in tiles) of panel s's device buffer: its bucket, grown so
        that, once factored, it also covers the NEXT panel's tallest-strip
        request, which starts panel_tiles below this panel's top and is
        itself bucket-padded (the extra rows are zeros, what the request's
        padding must hold)."""
        if s + 1 < n_panels and shape_mode != "exact":
            nxt_bt = _bucket_tiles(g - (s + 1) * panel_tiles, g, shape_mode)
            return max(rows_bt, panel_tiles + nxt_bt)
        return rows_bt

    def rows_of(hit, r0: int, rows: int):
        """Rows [r0, r0 + rows) of a device copy (its first row, buffer), or
        None where it does not hold them all."""
        row0, arr = hit
        if row0 <= r0 and r0 - row0 + rows <= arr.shape[0]:
            return arr[r0 - row0:r0 - row0 + rows]
        return None

    def load_strip(q: int, r0: int, rows: int, q_w: int):
        """Rows [r0, r0 + rows) of panel q's L, possibly bucket-padded past
        the grid: the padding rows are zeros. Returns (strip, whether it was
        loaded from the host); a host load covers whole tiles."""
        hit = recent.get(q)
        if hit is not None:
            arr = rows_of(hit, r0, rows)
            if arr is not None:
                event("strip_hit_device", q)
                return arr, False
        if cache is not None:
            hit = cache.get(q)
            if hit is not None:
                arr = rows_of(hit, r0, rows)
                if arr is not None:
                    return arr, False
        # host path: panel q's writeback must have landed first
        fut = writer_futures.get(q)
        if fut is not None:
            fut.result()
        a.load_count += 1
        event("strip_load", q)
        while len(strip_done) >= _STRIPS_IN_FLIGHT:
            strip_done.popleft().synchronize()
        t0, t1 = r0 // t, cdiv(r0 + rows, t)
        real_t = max(0, min(t1, g) - t0)
        with streams.on(streams.h2d):
            arr = torch.empty(((t1 - t0) * t, q_w * t), dtype=a.dtype, device=dev)
            arr[real_t * t:].zero_()
            _panel_from_host(l_out, t0, q * panel_tiles, real_t, q_w, out=arr)
            ready = streams.mark(streams.h2d)
        streams.wait(streams.compute, ready, arr)
        if cache is not None:
            cache.put(q, (t0 * t, arr))
        return arr[r0 - t0 * t:r0 - t0 * t + rows], True

    def upload_panel(s: int):
        """Input panel s in a device buffer of serve_rows_t rows (the rows
        past the real ones zero), its copies issued on the upload stream;
        where its bucket is shared over a mesh (`share`), this rank's rows
        alone, a view of a buffer of the whole tiles covering them. Returns
        (buffer, the event the copies end at)."""
        c0 = s * panel_tiles
        w_t = min(panel_tiles, g - c0)
        rows_t = g - c0
        rows_bt = _bucket_tiles(rows_t, g, shape_mode)
        lo, hi = share(rows_bt * t)
        shared = hi - lo < rows_bt * t
        t0, t1 = (lo // t, cdiv(hi, t)) if shared else (0, serve_rows_t(s, rows_bt))
        real_t = max(0, min(t1, rows_t) - t0)
        with streams.on(streams.h2d):
            buf = torch.empty(((t1 - t0) * t, w_t * t), dtype=a.dtype, device=dev)
            buf[real_t * t:].zero_()
            _panel_from_host(a, c0 + t0, c0, real_t, w_t, lower_mirror=lower_mirror, out=buf)
            ready = streams.mark(streams.h2d)
        event("upload", s)
        return (buf[lo - t0 * t:hi - t0 * t] if shared else buf), ready

    def write_back(s: int, c0: int, buf, real_rows: int, factored, infos):
        # the manifest counts panels: never commit past a failed writeback
        prev = writer_futures.get(s - 1)
        if prev is not None and prev.exception() is not None:
            raise RuntimeError(f"panel {s - 1}'s writeback failed; panel {s} is not written")
        # only the real rows cross to the host, into one slab of tiles
        # (pinned on a CUDA tier) that the output store adopts tile by tile
        rows_t, w_t = real_rows // t, buf.shape[1] // t
        slab = torch.empty((rows_t, w_t, t, t), dtype=buf.dtype, pin_memory=streams.cuda)
        with streams.on(streams.d2h):
            streams.wait(streams.d2h, factored, buf)
            _raise_if_not_spd(infos, f"out_of_core_cholesky panel {s}")
            _tiles_to_host(buf, slab)
            landed = streams.mark(streams.d2h)
        if landed is not None:
            landed.synchronize()
        event("download", s)
        for i in range(rows_t):
            for j in range(w_t):
                l_out.adopt_block(slab[i, j], c0 + i, c0 + j)
        if ckpt.path and me == 0:
            ckpt.save_panel(s, slab.permute(0, 2, 1, 3).reshape(real_rows, -1).numpy(), meta)

    # prefetch thread: input panels up to pipeline_width - 1 ahead
    depth = max(0, int(pipeline_width) - 1)
    prefetcher = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    prefetched = {}
    issued = set()

    def ensure_prefetched(upto: int):
        for s2 in range(start_panel, min(upto + 1, n_panels)):
            if s2 not in issued:
                issued.add(s2)
                event("prefetch_issue", s2)
                prefetched[s2] = prefetcher.submit(upload_panel, s2)

    try:
        for s in range(start_panel, n_panels):
            c0 = s * panel_tiles
            w_t = min(panel_tiles, g - c0)       # panel width in tiles
            rows_t = g - c0                      # rows from the diagonal down
            rows_bt = _bucket_tiles(rows_t, g, shape_mode)
            ensure_prefetched(s + depth)
            fut = prefetched.pop(s, None)
            buf, ready = fut.result() if fut is not None else upload_panel(s)
            streams.wait(streams.compute, ready, buf)
            lo, hi = share(rows_bt * t)
            shared = hi - lo < rows_bt * t
            panel = buf if shared else buf[:rows_bt * t]
            # stream updates from previously factored panels
            for q in range(s):
                q_w = min(panel_tiles, g - q * panel_tiles)
                if shared:  # this rank's rows of the strip, and its top whole
                    l_strip, from_host = load_strip(q, c0 * t + lo, hi - lo, q_w)
                    l_top, top_from_host = load_strip(q, c0 * t, w_t * t, q_w)
                    from_host = from_host or top_from_host
                else:
                    l_strip, from_host = load_strip(q, c0 * t, rows_bt * t, q_w)
                    l_top = l_strip[:w_t * t]
                update(panel, l_strip, l_top)
                if from_host and streams.cuda:
                    strip_done.append(streams.mark(streams.compute))
                del l_strip, l_top  # freed before the next strip is allocated
            if shared:
                infos = factor_panel(panel, lo)
                # the factored panel whole on every rank: one all_reduce
                buf = torch.zeros((serve_rows_t(s, rows_bt) * t, w_t * t), dtype=a.dtype,
                                  device=dev)
                buf[lo:hi] = panel
                sum_over_mesh(buf, mesh)
                del panel
            else:
                infos = factor_panel(panel)
            factored = streams.mark(streams.compute)
            event("factor", s)
            recent.clear()
            recent[s] = (c0 * t, buf)
            # backpressure: each queued writeback pins a device panel, so
            # cap outstanding jobs at pipeline_width before submitting
            pending = [s2 for s2, f in writer_futures.items() if not f.done()]
            for s2 in sorted(pending)[: max(0, len(pending) - max(1, int(pipeline_width)) + 1)]:
                writer_futures[s2].result()
            writer_futures[s] = writer.submit(write_back, s, c0, buf, rows_t * t, factored,
                                              infos)
            if pipeline_width <= 1:
                writer_futures[s].result()
    finally:
        prefetcher.shutdown(wait=True, cancel_futures=True)
        writer.shutdown(wait=True)
    # surface any writeback failure
    for fut in writer_futures.values():
        fut.result()

    l_out.spill_stats = {
        "update_compiles": len(update_shapes),
        "factor_compiles": len(factor_shapes),
        "host_strip_loads": a.load_count,
        "panels": n_panels - start_panel,
        "shape_mode": shape_mode,
    }
    return l_out


def out_of_core_bdfac(
    a: TiledMatrix,
    panel_tiles: int = 4,
    precision=None,
    mesh=None,
    stop_panels: Optional[int] = None,
    shape_mode: str = "pow2",
    out: Optional[TiledMatrix] = None,
) -> TiledMatrix:
    """Right-looking out-of-core block bidiagonalization of a host-tier
    square TiledMatrix: SVD stage 1 for a matrix larger than the device
    (the in-device counterpart is compiler.lower.fused_bdfac). The steps
    run on `a.device`.

    Per W-wide panel step (W = panel_tiles * tile): the column panel is
    QR-factored on the device (the shifted CholeskyQR chain and a Yamamoto
    reflector, `_yamamoto_reflector`, conv_tol 1e-5, Sᵀ folded once a
    panel by the normal equations); the trailing column panels stream
    through the device, each taking Hᵀ chunk = chunk - W (Sᵀ (Wᵀ chunk));
    while two or more superdiagonal panels remain, the row panel is
    LQ-factored (the row form of the same) and the row panels below it
    stream through once more, each taking chunk H. The final square panel
    keeps its R only. The large products go through
    `compiler.lower._matmul` / `_sub_matmul` at `precision` (compensated
    "high": matmul3, where the left operand is not transposed; "highest":
    the matmul kernel; plain "high": torch.matmul in true FP32); the b x b
    algebra is true FP32.

    Returns B on the host tier, block bidiagonal with sigma(B) = sigma(a)
    (the sweeps are orthogonal), band ku = 2W - 1: diagonal panel blocks
    upper triangular, superdiagonal ones lower triangular but the last,
    which lands as it is (the fused path's shape).

    The working copy is one slab of host tiles (pinned on a CUDA tier),
    adopted by a host-tier TiledMatrix tile by tile, and B's band blocks
    land in another. On a CUDA device the uploads run on a copy stream
    (`_panel_from_host`, 2-D copies), the downloads on another straight
    into the slabs' tiles, both ordered against the compute stream by
    events: chunk q + 1 uploads while chunk q is applied, an upload waits
    for the downloads of the phase before it (a step's row panel reads
    what the column stream wrote, the next step what the row stream
    wrote) and for the download that last read its buffer. There is one
    host synchronization at the end, beside the chains' own reads.

    Device memory: the panel, two chunk buffers, the reflector, the chain's
    temporaries and the GEMM's packed planes, within 8 * n_pad * W * 4
    bytes (n_pad = grid * tile). Host<->device traffic: the trailing
    matrix twice each way per step, O(N³ / W) in all.

    shape_mode ('exact' | 'pow2' | 'full'): the panel heights and row
    widths are zero-padded to their `_bucket_tiles` bucket. The padding is
    invariant: padded rows of a column panel are zero, so the Gram, the
    reflector (zero rows in W) and every apply leave them zero; padded
    columns of a row panel likewise give zero reflector columns. Every
    upload zeroes its buffer's padding. stop_panels factors only the first
    so-many panel steps.

    mesh (a DeviceMesh; every rank of it calls this with its own host tier
    holding the same matrix): the QR side's panel and chunks are
    ROW-sharded over the mesh flattened row-major, the LQ side's
    COLUMN-sharded, where their bucketed height (width) divides the rank
    count (rank f holds the f-th share and uploads the tiles covering it),
    and whole on every rank otherwise. The chains all_reduce their Grams
    (`_cholqr_adaptive(psum_mesh=)`), Wᵀ·chunk and chunk·W_rᵀ are one
    all_reduce each, and the updates are local; the W x W reflector algebra
    is replicated (the panel's top block summed whole onto every rank).
    Each rank has its own host memory, so each updated chunk is gathered
    whole onto every rank (one all_reduce of the zero-masked shares) and
    written to every rank's working copy, and B's blocks come from the
    mesh's first rank (one broadcast each): B is the same on every rank.
    Every call starts with a barrier over the mesh. Collective over the
    mesh."""
    from numpywren_tpu_torch.compiler.lower import (
        _cholqr_adaptive,
        _matmul,
        _sub_matmul,
        _yamamoto_reflector,
    )
    from numpywren_tpu_torch.parallel.mesh import broadcast_flat, sum_over_mesh

    if a.shape[0] != a.shape[1] or a.tile[0] != a.tile[1]:
        raise ShapeError("out_of_core_bdfac needs a square matrix / square tiles")
    g = a.grid[0]
    t = a.tile[0]
    if g % panel_tiles:
        raise ShapeError(f"grid {g} not a multiple of panel_tiles {panel_tiles}")
    precision = check_precision(precision or default_precision(a.dtype))
    pt = panel_tiles
    w = pt * t
    n_panels = g // pt
    n_run = n_panels if stop_panels is None else min(n_panels, max(0, int(stop_panels)))
    dev = a.device
    streams = _Streams(dev)
    n_dev, me = _join_mesh(mesh, a.dtype, dev)

    def zeros(m, i, j):
        return torch.zeros(m.tile, dtype=m.dtype)

    b_out = out or TiledMatrix(key=a.key + ":ooc_B", shape=a.shape, tile=a.tile, dtype=a.dtype,
                               storage="host", parent_fn=zeros, device=dev)
    # the working copy, mutated panel by panel: one slab of tiles
    work = TiledMatrix(key=a.key + ":ooc_work", shape=a.shape, tile=a.tile, dtype=a.dtype,
                       storage="host", parent_fn=zeros, device=dev)
    slab = torch.empty((g, g, t, t), dtype=a.dtype, pin_memory=streams.cuda)
    for i in range(g):
        for j in range(g):
            slab[i, j].copy_(a.get_block(i, j))
            work.adopt_block(slab[i, j], i, j)
    # B's diagonal and superdiagonal panel blocks, step by step
    band = torch.empty((n_run, 2, pt, pt, t, t), dtype=a.dtype, pin_memory=streams.cuda)

    def share(size: int):
        """This rank's [lo, hi) of a sharded dimension of `size`: a 1/n_dev
        share where it divides, else all of it."""
        if n_dev > 1 and size % n_dev == 0:
            h = size // n_dev
            return me * h, (me + 1) * h
        return 0, size

    def upload(r0_t, c0_t, rows_t, cols_t, rows_bt, cols_bt, axis=0, buf=None, after=()):
        """Tiles [r0_t, r0_t + rows_t) x [c0_t, c0_t + cols_t) of the
        working copy in a device buffer of rows_bt x cols_bt tiles, its
        padding zeroed, on the upload stream after the events `after`;
        where `axis` (0: rows, 1: columns) is shared over a mesh, only the
        tiles covering this rank's share of it. Returns (this rank's part:
        the share, or the buffer; the buffer; the event its copies end at)."""
        size = (rows_bt if axis == 0 else cols_bt) * t
        lo, hi = share(size)
        t0, t1 = lo // t, cdiv(hi, t)
        if axis == 0:
            r0_t, rows_t, rows_bt = r0_t + t0, max(0, min(t1, rows_t) - t0), t1 - t0
        else:
            c0_t, cols_t, cols_bt = c0_t + t0, max(0, min(t1, cols_t) - t0), t1 - t0
        with streams.on(streams.h2d):
            for ev in after:
                if ev is not None:
                    streams.h2d.wait_event(ev)
            if buf is None:
                buf = torch.empty((rows_bt * t, cols_bt * t), dtype=a.dtype, device=dev)
            buf[rows_t * t:].zero_()
            buf[:rows_t * t, cols_t * t:].zero_()
            _panel_from_host(work, r0_t, c0_t, rows_t, cols_t, out=buf)
            ready = streams.mark(streams.h2d)
        part = slice(lo - t0 * t, hi - t0 * t)
        return (buf[part] if axis == 0 else buf[:, part]), buf, ready

    def whole(part, size: int, axis: int) -> torch.Tensor:
        """`part`, this rank's share along `axis` of a dimension of `size`,
        as the whole tensor on every rank: one all_reduce of the
        zero-masked shares (an exact sum), or `part` itself where it is
        whole."""
        lo, hi = share(size)
        if hi - lo == size:
            return part
        out = torch.zeros((size, part.shape[1]) if axis == 0 else (part.shape[0], size),
                          dtype=part.dtype, device=dev)
        (out[lo:hi] if axis == 0 else out[:, lo:hi]).copy_(part)
        return sum_over_mesh(out, mesh)

    def sharded(size: int) -> bool:
        return share(size) != (0, size)

    def top_block(q, size: int) -> torch.Tensor:
        """The W x W block of the first W rows of the panel factor whose
        share of `size` rows is `q`, on every rank (an all_reduce of the
        pieces each holds)."""
        lo, hi = share(size)
        if hi - lo == size:
            return q[:w]
        out = torch.zeros((w, w), dtype=q.dtype, device=dev)
        k = min(max(w - lo, 0), hi - lo)   # this rank's rows inside it
        out[lo:lo + k] = q[:k]
        return sum_over_mesh(out, mesh)

    def first_rank(x) -> torch.Tensor:
        """x as the mesh's first rank has it, on every rank."""
        return broadcast_flat(x.contiguous(), 0, mesh) if n_dev > 1 else x

    def factor(part, size: int, axis: int):
        """The chain (conv_tol 1e-5, its Grams summed over the mesh where
        `part` is a share) and the Yamamoto reflector (Sᵀ by the normal
        equations) of the column panel (axis 0) whose share of `size` rows
        is `part`, or of the row panel (axis 1) whose share of `size`
        columns it is. Returns (Sigma R, or L Sigma_r, as the mesh's first
        rank has it; this rank's share of W, or of W_r; Sᵀ, or S)."""
        rows = axis == 1
        q, r_ = _cholqr_adaptive(part, rows=rows, precision=precision, conv_tol=1e-5,
                                 psum_mesh=mesh if sharded(size) else None, global_m=size)
        q = q.T if rows else q
        lo, hi = share(size)
        sigma, wv, _, s = _yamamoto_reflector(q, top_block(q, size), fast_s=True,
                                              e_rows=slice(0, min(max(w - lo, 0), hi - lo)),
                                              e_from=lo)
        if rows:
            return first_rank(r_ * sigma[None, :]), wv.T, s
        return first_rank(sigma[:, None] * r_), wv, s.T

    def download(src, dst) -> object:
        """dst (slab tiles) := src, on the download stream after the compute
        stream's work so far. Returns the event the copies end at."""
        done = streams.mark(streams.compute)
        with streams.on(streams.d2h):
            streams.wait(streams.d2h, done, src)
            _tiles_to_host(src, dst)
            return streams.mark(streams.d2h)

    def stream(specs, axis, apply, fence, top=None):
        """Each chunk of `specs` (upload's first six arguments) through the
        device: uploaded (this rank's share along `axis`) into one of two
        buffers while the chunk before it is applied, `apply`-ed in place,
        made whole on every rank and stored back into the working copy (its
        first W rows also into `top` when given, for the first chunk).
        Returns the event of the last download."""
        bufs, freed = [None, None], [None, None]
        pending = upload(*specs[0], axis=axis, after=(fence,))
        last = None
        for k, (r0_t, c0_t, rows_t, cols_t, rows_bt, cols_bt) in enumerate(specs):
            part, buf, ready = pending
            bufs[k % 2] = buf
            if k + 1 < len(specs):
                j = (k + 1) % 2
                pending = upload(*specs[k + 1], axis=axis, buf=bufs[j], after=(fence, freed[j]))
            streams.wait(streams.compute, ready, buf)
            apply(part)
            full = whole(part, (rows_bt if axis == 0 else cols_bt) * t, axis)
            if top is not None and k == 0:
                download(full[:w], top)
            last = freed[k % 2] = download(
                full, slab[r0_t:r0_t + rows_t, c0_t:c0_t + cols_t])
        return last

    fence = None  # the last download of the phase before: what an upload reads
    for s in range(n_run):
        c0_t = s * pt
        c1_t = c0_t + pt
        rows_t = g - c0_t
        if rows_t == pt:  # final square panel: R only
            panel, _, ready = upload(c0_t, c0_t, pt, pt, pt, pt, after=(fence,))
            streams.wait(streams.compute, ready, panel)
            r, _, _ = factor(panel, w, 0)
            download(r, band[s, 0])
            break
        # 1. the column panel's QR and its reflector
        rows_bt = _bucket_tiles(rows_t, g, shape_mode)
        height = rows_bt * t
        panel, _, ready = upload(c0_t, c0_t, rows_t, pt, rows_bt, pt, after=(fence,))
        streams.wait(streams.compute, ready, panel)
        r, wv, st = factor(panel, height, 0)
        del panel
        download(r, band[s, 0])

        def apply_qt(chunk):  # Hᵀ chunk = chunk - W (Sᵀ (Wᵀ chunk))
            w1 = _matmul(wv, chunk, ta=True, precision=precision)
            if sharded(height):
                sum_over_mesh(w1, mesh)
            _sub_matmul(chunk, wv, _matmul(st, w1, precision=precision), precision=precision,
                        out=chunk)

        # 2. Hᵀ over the trailing column panels; with one left, its first W
        #    rows are B's last superdiagonal block as they are
        remaining = n_panels - s - 1
        fence = stream([(c0_t, q * pt, rows_t, pt, rows_bt, pt) for q in range(s + 1, n_panels)],
                       0, apply_qt, fence, top=band[s, 1] if remaining == 1 else None)
        del wv, st
        if remaining < 2:
            continue
        # 3. the row panel's LQ and its reflector, streamed over the rows below
        cols_t = g - c1_t
        cols_bt = _bucket_tiles(cols_t, g, shape_mode)
        width = cols_bt * t
        row_pan, _, ready = upload(c0_t, c1_t, pt, cols_t, pt, cols_bt, axis=1, after=(fence,))
        streams.wait(streams.compute, ready, row_pan)
        l_blk, wr, s_row = factor(row_pan, width, 1)
        del row_pan
        download(l_blk, band[s, 1])

        def apply_h_right(chunk):  # chunk H = chunk - ((chunk Wrᵀ) S) Wr
            u1 = _matmul(chunk, wr, tb=True, precision=precision)
            if sharded(width):
                sum_over_mesh(u1, mesh)
            _sub_matmul(chunk, _matmul(u1, s_row, precision=precision), wr,
                        precision=precision, out=chunk)

        fence = stream([(i, c1_t, pt, cols_t, pt, cols_bt) for i in range(c1_t, g, pt)],
                       1, apply_h_right, fence)
        del wr, s_row
    if streams.cuda:
        torch.cuda.synchronize(dev)
    for s in range(n_run):
        c0_t = s * pt
        for k in range(2 if s + 1 < n_panels else 1):
            for i in range(pt):
                for j in range(pt):
                    b_out.adopt_block(band[s, k, i, j], c0_t + i, c0_t + k * pt + j)
    return b_out


def out_of_core_singular_values(
    a: TiledMatrix,
    panel_tiles: int = 4,
    precision=None,
    mesh=None,
) -> np.ndarray:
    """All singular values (fp64, descending) of a host-tier square
    TiledMatrix larger than the device: `out_of_core_bdfac` streams the
    reduction to block bidiagonal B (band ku = 2 * panel_tiles * tile - 1,
    the last superdiagonal panel untightened), then only the band
    (O(n W) floats) is packed for the host LAPACK dgbbrd + dbdsdc finish
    (models.band). Raises RuntimeError where no LAPACK library is found:
    the JAX package has no other finish here."""
    from numpywren_tpu_torch.models.band import band_sigma_packed

    b_mat = out_of_core_bdfac(a, panel_tiles=panel_tiles, precision=precision, mesh=mesh)
    n = a.shape[0]
    t = a.tile[0]
    ku = min(2 * panel_tiles * t - 1, n - 1)
    ab = np.zeros((ku + 1, n), dtype=np.float64, order="F")
    off_max = cdiv(ku, t)
    for i_t in range(b_mat.grid[0]):
        for j_t in range(i_t, min(i_t + off_max + 1, b_mat.grid[1])):
            blk = b_mat.get_block(i_t, j_t).double().numpy()
            r0, c0 = i_t * t, j_t * t
            for jj in range(blk.shape[1]):
                j = c0 + jj
                if j >= n:
                    break
                i0 = max(r0, j - ku)
                i1 = min(r0 + blk.shape[0], j + 1, n)
                if i1 > i0:
                    ab[ku + i0 - j:ku + i1 - j, j] += blk[i0 - r0:i1 - r0, jj]
    return band_sigma_packed(ab, n, n, 0, ku)[:n]
