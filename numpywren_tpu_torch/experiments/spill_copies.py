#!/usr/bin/env python3
"""How a strip of pinned host tiles reaches the card, measured: the ways the
out-of-core Cholesky (runtime/spill.py) could move one L strip of 1 MiB
tiles into its row-major device panel, and what pinning host tiles costs.

    python3 numpywren_tpu_torch/experiments/spill_copies.py [--rows 65536]   # with a GPU

A strip is rows x 2048 fp32 (tile 512, four tiles wide). Each way is timed
on a side stream with CUDA events (device ms, the mean of three after a
warm-up) beside the host seconds it takes to issue:

- contiguous: one pinned copy of the strip's bytes (the link's yardstick);
- copy2d: one cudaMemcpy2DAsync a tile into its strided slice
  (csrc/copy.cu's npw_copy_tiles, what spill.py ships);
- tile_major: one contiguous copy a tile into a tile-major device buffer,
  then one permuting copy kernel into the row-major strip;
- torch_strided: `dst_slice.copy_(tile, non_blocking=True)` a tile (PyTorch
  stages each through a device temporary and a copy kernel).

Then the host side of a writeback: a fresh pinned tile per tile (what
put_block allocates) against one pinned slab of the same bytes (what the
writer adopts tiles from). Prints one JSON line a
measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root

TILE, WIDTH_TILES = 512, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, stream, iters: int = 3) -> float:
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            fn()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_s(fn, stream) -> float:
    with torch.cuda.stream(stream):
        stream.synchronize()
        t0 = time.perf_counter()
        fn()
        issued = time.perf_counter() - t0
        stream.synchronize()
    return issued


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from numpywren_tpu_torch.ops import _build
    from numpywren_tpu_torch.runtime.spill import _HOST_TO_DEVICE, _copy_2d, _copy_tile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=65536, help="the strip's rows")
    args = ap.parse_args()
    _build.build()
    t, wt = TILE, WIDTH_TILES
    rt = args.rows // t
    nbytes = rt * wt * t * t * 4
    tiles = [torch.randn(t, t).pin_memory() for _ in range(rt * wt)]
    flat = torch.empty(nbytes // 4, pin_memory=True)
    dst = torch.empty(rt * t, wt * t, device="cuda")
    dst_flat = torch.empty(nbytes // 4, device="cuda")
    major = torch.empty(rt * wt, t, t, device="cuda")
    side = torch.cuda.Stream()
    slices = [(i, j) for i in range(rt) for j in range(wt)]

    def view(i, j):
        return dst[i * t:(i + 1) * t, j * t:(j + 1) * t]

    def copy2d():
        _copy_2d(dst.device, [view(i, j).data_ptr() for i, j in slices], dst.stride(0) * 4,
                 [tile.data_ptr() for tile in tiles], t * 4, t * 4, t, _HOST_TO_DEVICE)

    def tile_major():
        for k in range(len(tiles)):
            major[k].copy_(tiles[k], non_blocking=True)
        dst.view(rt, t, wt, t).copy_(major.view(rt, wt, t, t).permute(0, 2, 1, 3))

    def torch_strided():
        for k, (i, j) in enumerate(slices):
            _copy_tile(view(i, j), tiles[k])

    ways = {"contiguous": lambda: dst_flat.copy_(flat, non_blocking=True), "copy2d": copy2d,
            "tile_major": tile_major, "torch_strided": torch_strided}
    want = torch.cat([torch.cat(tiles[i * wt:(i + 1) * wt], dim=1) for i in range(rt)])
    for name, fn in ways.items():
        ms = device_ms(fn, side)
        issue = host_s(fn, side)
        ok = True if name == "contiguous" else bool(torch.equal(dst.cpu(), want))
        emit({"way": name, "rows": args.rows, "bytes": nbytes, "device_ms": ms,
              "GBps": nbytes / ms / 1e6, "host_issue_s": issue, "correct": ok})
        dst.zero_()

    count = 256  # one 32768 x 2048 panel's tiles
    t0 = time.perf_counter()
    fresh = [torch.empty(t, t, pin_memory=True) for _ in range(count)]
    fresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slab = torch.empty(count * t * t, pin_memory=True)
    slab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(count):
        fresh[k].copy_(tiles[k % len(tiles)])
    copy_s = time.perf_counter() - t0
    emit({"pinning": {"tiles": count, "bytes": count * t * t * 4, "fresh_tiles_s": fresh_s,
                      "one_slab_s": slab_s, "copy_into_pinned_s": copy_s}})
    del slab
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
