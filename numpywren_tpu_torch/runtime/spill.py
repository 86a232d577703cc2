"""Out-of-core Cholesky: host-tier matrices streamed through the device
(counterpart of numpywren_tpu/runtime/spill.py's out_of_core_cholesky).

The matrix lives on the host tier (TiledMatrix storage="host": CPU tiles,
pinned when the tier computes on a CUDA device), as the reference's matrices
live in S3. A LEFT-LOOKING panel algorithm streams column super-panels
through the device: each panel is updated by every factored panel before it
(one GEMM per predecessor strip), factored on the device and written back.
Host <-> device traffic is O(N^2 * S) for S super-panels, the out-of-core
trade the reference pays to S3 on every task.

On a CUDA device the copies run on streams of their own: uploads (the input
panels and the L strips) on one, downloads on another, each ordered against
the compute stream (the caller's current stream) by events, so the copies
ride under the trailing updates. On the CPU the same control flow runs with
plain copies.

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
    only. `mesh` (a mesh of devices sharding the panels) is not ported yet:
    anything but None raises (ROADMAP Queue 1 #6).

    `l.spill_stats` reports the distinct operand shapes each step saw
    (`update_compiles`, `factor_compiles`: what the JAX package's jit cache
    sizes count), the host strip loads and the panels run.
    """
    from numpywren_tpu_torch.compiler.lower import _raise_if_not_spd, _sub_matmul, fused_cholesky
    from numpywren_tpu_torch.config import default_config

    if mesh is not None:
        raise NotImplementedError(
            "out_of_core_cholesky over a device mesh is not ported yet (ROADMAP Queue 1 #6)")
    if a.shape[0] != a.shape[1] or a.tile[0] != a.tile[1]:
        raise ShapeError("out_of_core_cholesky needs a square matrix / square tiles")
    g = a.grid[0]
    t = a.tile[0]
    precision = check_precision(precision or default_precision(a.dtype))
    lower_mirror = type(a).__name__ == "TiledSymmetricMatrix" or getattr(a, "_lower_only", False)
    dev = a.device
    streams = _Streams(dev)

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

    def factor_panel(panel):
        """panel = [D; B]: D := chol(D); B := B D⁻ᵀ, in place. Returns the
        diagonal blocks' factor statuses, which the writer checks before
        the panel is written back: the factor loop never waits for them."""
        factor_shapes.add(tuple(panel.shape))
        w_cols = panel.shape[1]
        top = panel[:w_cols]
        infos = []
        fused_cholesky(top, t, precision=precision, infos=infos)
        rest = panel[w_cols:]
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
    # the device copy of the most recent factored panel, (row0_t, buffer)
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

    def suffix(hit, c0_t: int, rows_t: int):
        row0_t, arr = hit
        if row0_t <= c0_t and (c0_t - row0_t + rows_t) * t <= arr.shape[0]:
            return arr[(c0_t - row0_t) * t:(c0_t - row0_t + rows_t) * t]
        return None

    def load_strip(q: int, c0_t: int, rows_t: int, q_w: int):
        """L strip rows [c0_t, c0_t + rows_t) of panel q, rows_t possibly
        bucket-padded past the grid: the padding rows are zeros. Returns
        (strip, whether it was loaded from the host)."""
        real_t = min(rows_t, g - c0_t)
        hit = recent.get(q)
        if hit is not None:
            arr = suffix(hit, c0_t, rows_t)
            if arr is not None:
                event("strip_hit_device", q)
                return arr, False
        if cache is not None:
            hit = cache.get(q)
            if hit is not None:
                arr = suffix(hit, c0_t, rows_t)
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
        with streams.on(streams.h2d):
            arr = torch.empty((rows_t * t, q_w * t), dtype=a.dtype, device=dev)
            arr[real_t * t:].zero_()
            _panel_from_host(l_out, c0_t, q * panel_tiles, real_t, q_w, out=arr)
            ready = streams.mark(streams.h2d)
        streams.wait(streams.compute, ready, arr)
        if cache is not None:
            cache.put(q, (c0_t, arr))
        return arr, True

    def upload_panel(s: int):
        """Input panel s in a device buffer of serve_rows_t rows (the rows
        past the real ones zero), its copies issued on the upload stream.
        Returns (buffer, the event the copies end at)."""
        c0 = s * panel_tiles
        w_t = min(panel_tiles, g - c0)
        rows_t = g - c0
        alloc_t = serve_rows_t(s, _bucket_tiles(rows_t, g, shape_mode))
        with streams.on(streams.h2d):
            buf = torch.empty((alloc_t * t, w_t * t), dtype=a.dtype, device=dev)
            buf[rows_t * t:].zero_()
            _panel_from_host(a, c0, c0, rows_t, w_t, lower_mirror=lower_mirror, out=buf)
            ready = streams.mark(streams.h2d)
        event("upload", s)
        return buf, ready

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
            if streams.cuda:
                item = buf.element_size()
                _copy_2d(dev, [slab[i, j].data_ptr() for i in range(rows_t) for j in range(w_t)],
                         t * item,
                         [buf[i * t:, j * t:].data_ptr() for i in range(rows_t)
                          for j in range(w_t)], buf.stride(0) * item, t * item, t,
                         _DEVICE_TO_HOST)
            else:
                slab.copy_(buf[:real_rows].view(rows_t, t, w_t, t).permute(0, 2, 1, 3))
            landed = streams.mark(streams.d2h)
        if landed is not None:
            landed.synchronize()
        event("download", s)
        for i in range(rows_t):
            for j in range(w_t):
                l_out.adopt_block(slab[i, j], c0 + i, c0 + j)
        if ckpt.path:
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
            panel = buf[:rows_bt * t]
            # stream updates from previously factored panels
            for q in range(s):
                q_w = min(panel_tiles, g - q * panel_tiles)
                l_strip, from_host = load_strip(q, c0, rows_bt, q_w)
                update(panel, l_strip, l_strip[:w_t * t])
                if from_host and streams.cuda:
                    strip_done.append(streams.mark(streams.compute))
                del l_strip  # freed before the next strip is allocated
            infos = factor_panel(panel)
            factored = streams.mark(streams.compute)
            event("factor", s)
            recent.clear()
            recent[s] = (c0, buf)
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
