"""Matrix + program checkpointing (counterpart of numpywren_tpu/checkpoint.py).

The reference's checkpointing is implicit: every completed tile is an S3
object, so a crashed program resumes by scanning block_idxs_exist
(numpywren/matrix.py) and re-enqueueing the frontier. The explicit
equivalents:

- save_matrix/load_matrix: a TiledMatrix to/from one .npz (tiles + a JSON
  manifest), either tier.
- program_frontier: which nodes of a compiled TiledProgram still need to run
  given which output blocks exist, the reference's resume scan.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from numpywren_tpu_torch.ops.common import np_dtype, to_numpy
from numpywren_tpu_torch.tiled import TiledMatrix, TiledSymmetricMatrix

FORMAT_VERSION = 1


def save_matrix(m, path: str):
    """Serialize a TiledMatrix (any tier) to one .npz with a JSON manifest.
    Only existing blocks are stored (sparse host tiers stay sparse)."""
    manifest = {
        "format": FORMAT_VERSION,
        "key": m.key,
        "shape": list(m.shape),
        "tile": list(m.tile),
        "dtype": np_dtype(m.dtype).name,
        "storage": getattr(m, "storage", "host"),
        "symmetric": isinstance(m, TiledSymmetricMatrix),
    }
    arrays = {"__manifest__": np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)}
    for (i, j) in m.block_idxs_exist:
        arrays[f"t_{i}_{j}"] = to_numpy(m.get_block(i, j))
    np.savez(path, **arrays)


def load_matrix(path: str, storage: str = "host", device=None) -> TiledMatrix:
    """The matrix save_matrix wrote, on `storage` of `device` (default: the
    current CUDA device; a host without one raises, so pass device="cpu")."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        cls = TiledSymmetricMatrix if manifest.get("symmetric") else TiledMatrix
        m = cls(key=manifest["key"], shape=tuple(manifest["shape"]),
                tile=tuple(manifest["tile"]), dtype=np.dtype(manifest["dtype"]),
                storage=storage, fill=None, device=device)
        for name in z.files:
            if name.startswith("t_"):
                _, i, j = name.split("_")
                m.put_block(z[name], int(i), int(j))
    return m


def program_frontier(program) -> Dict[str, List]:
    """The resume scan (reference: block_idxs_exist over outputs): nodes whose
    every output block already exists are 'done'; the rest are 'pending',
    and 'ready' are pending nodes whose parents are all done.

    Versioned scratch matrices alias every version onto one physical tile
    (the reference gives each version its own S3 key), so for those the scan
    consults the BoundArg's written-version map instead of bare existence:
    a write of version v counts as done only once version >= v landed."""
    from numpywren_tpu_torch.runtime.program import PS

    if program.program_status == PS.SUCCESS:
        all_ids = list(range(program.num_nodes))
        return {"done": all_ids, "pending": [], "ready": []}

    def _write_done(ba, i, j, ver):
        if ba.versioned and ver is not None:
            return ba.matrix.block_exists(i, j) and ba.version_of((i, j)) >= ver
        return ba.matrix.block_exists(i, j)

    done, pending = [], []
    for node in program.dag.nodes:
        wvers = node.write_versions or (None,) * len(node.writes)
        outputs_exist = all(
            _write_done(program.matrices[name], i, j, ver)
            for (name, i, j), ver in zip(node.writes, wvers)
        )
        (done if outputs_exist else pending).append(node.node_id)
    done_set = set(done)
    ready = [nid for nid in pending if all(p in done_set for p in program.dag.parents[nid])]
    return {"done": done, "pending": pending, "ready": ready}
