"""Framework configuration (analog of numpywren/config.py + default_config.yaml).

The reference carries cloud plumbing (bucket, region, SQS queue names, Redis
endpoint). The TPU rebuild has no cloud plumbing; the config is one dataclass
holding the mesh / tile / dtype / spill policy, overridable via environment
variables prefixed ``NPW_`` (the analog of the reference's env overrides).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class NpwConfig:
    # -- tiling --------------------------------------------------------
    tile: Tuple[int, int] = (512, 512)  # default shard_sizes analog
    # -- dtype policy ---------------------------------------------------
    storage_dtype: str = "float32"  # dtype tiles are stored in
    accum_dtype: str = "float32"    # MXU accumulation dtype
    compensated: bool = False        # compensated (error-free) accumulation
    # -- mesh -----------------------------------------------------------
    mesh_shape: Optional[Tuple[int, int]] = None  # None => most-square over all devices
    mesh_axis_names: Tuple[str, str] = ("rows", "cols")
    # -- memory ----------------------------------------------------------
    hbm_budget_bytes: Optional[int] = None  # None => autodetect
    spill_threshold: float = 0.85  # fraction of HBM before spilling to host
    # -- runtime ----------------------------------------------------------
    pipeline_width: int = 2   # parity with job_runner's pipeline_width
    max_workers: int = 8      # local executor thread pool size
    # -- checkpointing -----------------------------------------------------
    checkpoint_dir: Optional[str] = None

    @staticmethod
    def from_env() -> "NpwConfig":
        cfg = NpwConfig()
        if "NPW_TILE" in os.environ:
            t = int(os.environ["NPW_TILE"])
            cfg.tile = (t, t)
        if "NPW_STORAGE_DTYPE" in os.environ:
            cfg.storage_dtype = os.environ["NPW_STORAGE_DTYPE"]
        if "NPW_ACCUM_DTYPE" in os.environ:
            cfg.accum_dtype = os.environ["NPW_ACCUM_DTYPE"]
        if "NPW_COMPENSATED" in os.environ:
            cfg.compensated = os.environ["NPW_COMPENSATED"] not in ("0", "false", "")
        if "NPW_MAX_WORKERS" in os.environ:
            cfg.max_workers = int(os.environ["NPW_MAX_WORKERS"])
        if "NPW_PIPELINE_WIDTH" in os.environ:
            cfg.pipeline_width = int(os.environ["NPW_PIPELINE_WIDTH"])
        if "NPW_MESH_SHAPE" in os.environ:  # e.g. NPW_MESH_SHAPE=2x4
            r, c = os.environ["NPW_MESH_SHAPE"].lower().split("x")
            cfg.mesh_shape = (int(r), int(c))
        if "NPW_CHECKPOINT_DIR" in os.environ:
            cfg.checkpoint_dir = os.environ["NPW_CHECKPOINT_DIR"]
        return cfg


_default: Optional[NpwConfig] = None


def default_config() -> NpwConfig:
    """Layered default: dataclass defaults <- env overrides (cached)."""
    global _default
    if _default is None:
        _default = NpwConfig.from_env()
    return _default
