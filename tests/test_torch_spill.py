"""The port's out-of-core Cholesky (numpywren_tpu_torch/runtime/spill.py)
against the JAX package's (numpywren_tpu/runtime/spill.py), on the CPU.

Both packages get the same numpy inputs (random_spd, tile 32). Factors
agree within rtol 1e-4, atol 1e-5 (as tests/test_torch_entry.py: the
compensated route is an exact bf16x3 emulation here, where JAX's CPU path is
plain fp32), with ||A - L Lᵀ||_F / ||A||_F < 1e-5. What both packages count
(spill_stats, load_count, the width-1 event sequence) is equal. Checkpoints
written by either package are resumed by the other.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from numpywren_tpu import config
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.matrix_init import shard_matrix as jshard
from numpywren_tpu.runtime import spill as jspill
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.runtime import out_of_core_cholesky
from numpywren_tpu_torch.runtime import spill
from numpywren_tpu_torch.utils import LRUCache

RTOL, ATOL = 1e-4, 1e-5
TILE = (32, 32)


@pytest.fixture(params=[False, True], ids=["high", "compensated"])
def compensated(request, monkeypatch):  # each package has its own config: set both
    monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=request.param))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=request.param))
    return request.param


def _host(a, symmetric=False):
    """The same numpy input on both packages' host tiers."""
    return (shard_matrix(a, tile=TILE, storage="host", symmetric=symmetric, device="cpu"),
            jshard(a, tile=TILE, storage="host", symmetric=symmetric))


def _check(a, l, jl=None):
    got = np.tril(l.numpy())
    assert l.storage == "host"
    assert np.linalg.norm(a - got @ got.T) / np.linalg.norm(a) < 1e-5
    if jl is not None:
        np.testing.assert_allclose(got, np.tril(jl.numpy()), rtol=RTOL, atol=ATOL)
    return got


# ---------------------------------------------------------------------------
# Parity with the JAX package's out_of_core_cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("panel_tiles", [1, 2, 3])
def test_matches_jax(compensated, panel_tiles):
    a = random_spd(256, seed=0)
    at, jt = _host(a)
    l = out_of_core_cholesky(at, panel_tiles=panel_tiles)
    jl = jspill.out_of_core_cholesky(jt, panel_tiles=panel_tiles)
    _check(a, l, jl)
    assert l.spill_stats == jl.spill_stats
    assert at.load_count == jt.load_count


def test_symmetric_store_matches_jax():
    """Lower-triangle-only input (TiledSymmetricMatrix host tier): the
    diagonal blocks' upper tiles are read as mirrors."""
    a = random_spd(192, seed=1)
    at, jt = _host(a, symmetric=True)
    l = out_of_core_cholesky(at, panel_tiles=2)
    _check(a, l, jspill.out_of_core_cholesky(jt, panel_tiles=2))


@pytest.mark.parametrize("mode", ["exact", "pow2", "full"])
def test_shape_modes_match_jax(mode):
    """A ragged 5-tile grid with a ragged last panel: every mode gives the
    JAX factor, and the distinct operand shapes each step saw equal JAX's
    jit cache sizes."""
    a = random_spd(160, seed=7)
    at, jt = _host(a)
    l = out_of_core_cholesky(at, panel_tiles=2, shape_mode=mode, cache_bytes=1 << 20)
    jl = jspill.out_of_core_cholesky(jt, panel_tiles=2, shape_mode=mode, cache_bytes=1 << 20)
    _check(a, l, jl)
    assert l.spill_stats == jl.spill_stats
    assert l.spill_stats["shape_mode"] == mode and l.spill_stats["panels"] == 3


def test_panel_from_host_matches_jax():
    """The panel assembly, mirrored reads included, against the JAX
    package's numpy assembly."""
    a = random_spd(160, seed=3)
    at, jt = _host(a, symmetric=True)
    for args in ((1, 1, 4, 2), (0, 2, 5, 3)):
        got = spill._panel_from_host(at, *args, lower_mirror=True)
        want = jspill._panel_from_host(jt, *args, lower_mirror=True)
        np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full((7 * 32, 2 * 32), 5.0)
    spill._panel_from_host(at, 2, 2, 3, 2, lower_mirror=True, out=out)
    np.testing.assert_array_equal(out[:96].numpy(), a[64:160, 64:128])
    assert bool((out[96:] == 5.0).all())


# ---------------------------------------------------------------------------
# Strip traffic and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_bytes", [0, 40_000, 1 << 30])
def test_load_count_matches_jax(cache_bytes):
    """Host strip loads with no cache, a cache that evicts (40 kB holds one
    of the 32 KiB strips) and one that holds every strip: the same count as
    the JAX package's, fewer with the cache, the same factor."""
    a = random_spd(256, seed=4)
    at, jt = _host(a)
    l = out_of_core_cholesky(at, panel_tiles=1, cache_bytes=cache_bytes)
    jl = jspill.out_of_core_cholesky(jt, panel_tiles=1, cache_bytes=cache_bytes)
    _check(a, l, jl)
    assert at.load_count == jt.load_count
    assert l.spill_stats["host_strip_loads"] == at.load_count
    if cache_bytes:
        a0, _ = _host(a)
        out_of_core_cholesky(a0, panel_tiles=1)
        assert at.load_count < a0.load_count


def test_strip_cache_evicts_under_cap():
    """The strip cache holds (row0, tensor) entries; its byte accounting
    must see the tensor (a zero-size default would retain everything)."""
    cache = LRUCache(1000, size_fn=lambda v: v[1].numel() * v[1].element_size())
    for q in range(5):
        cache.put(q, (0, torch.zeros(10, 10)))  # 400 B each
    assert len(cache) == 2 and cache.nbytes == 800
    assert cache.get(0) is None and cache.get(4) is not None


def test_checkpoint_resume_after_truncated_manifest(tmp_path):
    """A run cut after two panels (manifest truncated, later panels gone)
    resumes to the full factor and skips the finished panels."""
    a = random_spd(256, seed=2)
    ck = str(tmp_path / "ck")
    full = _check(a, out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck))
    with open(os.path.join(ck, "manifest.json")) as f:
        m = json.load(f)
    assert m == {"panels_done": 4, "n": 256, "tile": 32, "panel_tiles": 2}
    m["panels_done"] = 2
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        json.dump(m, f)
    for s in (2, 3):
        os.remove(os.path.join(ck, f"panel_{s}.npy"))
    assert spill.SpillCheckpoint(ck).completed() == 2
    events = []
    l = out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck,
                             on_event=lambda kind, s: events.append((kind, s)))
    np.testing.assert_array_equal(_check(a, l), full)
    assert [s for kind, s in events if kind == "factor"] == [2, 3]
    assert l.spill_stats["panels"] == 2
    assert spill.SpillCheckpoint(ck).completed() == 4


def test_checkpoint_meta_mismatch_raises(tmp_path):
    """A checkpoint_dir left by a different factorization is refused."""
    ck = str(tmp_path / "ck")
    a = random_spd(128, seed=5)
    out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        out_of_core_cholesky(_host(random_spd(192, seed=6))[0], panel_tiles=2,
                             checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        out_of_core_cholesky(_host(a)[0], panel_tiles=1, checkpoint_dir=ck)


def test_stop_panels_prefix_then_continue(tmp_path):
    """stop_panels runs a prefix; the same checkpoint_dir continues it to
    the uninterrupted factor, bit for bit."""
    a = random_spd(256, seed=29)
    ck = str(tmp_path / "ck")
    l1 = out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck, stop_panels=2)
    assert l1.block_exists(3, 3) and not l1.block_exists(5, 5)
    assert l1.spill_stats["panels"] == 2
    l2 = out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck)
    assert l2.spill_stats["panels"] == 2
    whole = out_of_core_cholesky(_host(a)[0], panel_tiles=2)
    np.testing.assert_array_equal(_check(a, l2), np.tril(whole.numpy()))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_across_packages(tmp_path, first):
    """A run stopped after two panels by one package and finished by the
    other gives the JAX package's full factor: the two packages share the
    checkpoint format."""
    a = random_spd(256, seed=31)
    ck = str(tmp_path / "ck")
    at, jt = _host(a)
    if first == "jax":
        jspill.out_of_core_cholesky(jt, panel_tiles=2, checkpoint_dir=ck, stop_panels=2)
        l = out_of_core_cholesky(at, panel_tiles=2, checkpoint_dir=ck)
        assert l.spill_stats["panels"] == 2
    else:
        out_of_core_cholesky(at, panel_tiles=2, checkpoint_dir=ck, stop_panels=2)
        l = jspill.out_of_core_cholesky(jt, panel_tiles=2, checkpoint_dir=ck)
    assert jspill.SpillCheckpoint(ck).completed() == spill.SpillCheckpoint(ck).completed() == 4
    jfull = jspill.out_of_core_cholesky(_host(a)[1], panel_tiles=2)
    _check(a, l, jfull)


# ---------------------------------------------------------------------------
# Pipelining
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "pow2"])
def test_width1_event_sequence_matches_jax(mode):
    """Serial mode: the same events in the same order as the JAX package's
    (each upload after the previous download, the newest strip a device
    hit, older strips host loads)."""
    a = random_spd(224, seed=8)
    at, jt = _host(a)
    events, jevents = [], []
    l = out_of_core_cholesky(at, panel_tiles=2, pipeline_width=1, shape_mode=mode,
                             on_event=lambda kind, s: events.append((kind, s)))
    jl = jspill.out_of_core_cholesky(jt, panel_tiles=2, pipeline_width=1, shape_mode=mode,
                                     on_event=lambda kind, s: jevents.append((kind, s)))
    _check(a, l, jl)
    assert events == jevents
    idx = {e: i for i, e in enumerate(events)}
    for s in range(3):
        assert idx[("upload", s + 1)] > idx[("download", s)], events


def test_width2_prefetches_and_serves_the_newest_strip():
    """Width 2: panel s+1's prefetch is issued before panel s is factored,
    and the newest strip's first use is a device hit, never a host load."""
    a = random_spd(256, seed=7)
    at, _ = _host(a)
    events = []
    _check(a, out_of_core_cholesky(at, panel_tiles=2, pipeline_width=2,
                                   on_event=lambda kind, s: events.append((kind, s))))
    idx = {e: i for i, e in enumerate(events)}
    for s in range(3):
        assert idx[("prefetch_issue", s + 1)] < idx[("factor", s)], events
    for s in range(1, 4):
        first_hit = idx.get(("strip_hit_device", s - 1))
        first_load = idx.get(("strip_load", s - 1))
        assert first_hit is not None, events
        assert first_load is None or first_hit < first_load, events


def test_width3_prefetches_two_ahead():
    a = random_spd(320, seed=9)
    at, _ = _host(a)
    events = []
    _check(a, out_of_core_cholesky(at, panel_tiles=2, pipeline_width=3,
                                   on_event=lambda kind, s: events.append((kind, s))))
    idx = {e: i for i, e in enumerate(events)}
    for s in range(3):
        assert idx[("prefetch_issue", s + 2)] < idx[("factor", s)], events


def test_download_never_blocks_next_factor():
    """Each download is held (in the writer thread) until the test sees the
    NEXT panel's factor: if the factor loop waited on the download, this
    would deadlock (bounded by the gates' timeouts)."""
    a = random_spd(256, seed=11)
    at, _ = _host(a)
    n_panels = 4
    gates = {s: threading.Event() for s in range(n_panels)}
    gates[n_panels - 1].set()  # the last download has no later factor
    log = []

    def hook(kind, s):
        log.append((kind, s))
        if kind == "factor" and s - 1 in gates:
            gates[s - 1].set()
        if kind == "download":
            assert gates[s].wait(timeout=60), f"download {s} never released"
            log.append(("download_done", s))

    _check(a, out_of_core_cholesky(at, panel_tiles=2, pipeline_width=2, on_event=hook))
    idx = {e: i for i, e in enumerate(log)}
    for s in range(n_panels - 1):
        assert idx[("factor", s + 1)] < idx[("download_done", s)], log


# ---------------------------------------------------------------------------
# Units and errors
# ---------------------------------------------------------------------------

def test_bucket_tiles_matches_jax():
    for g in (1, 5, 13, 64):
        for r in range(1, g + 1):
            for mode in ("exact", "pow2", "full"):
                assert spill._bucket_tiles(r, g, mode) == jspill._bucket_tiles(r, g, mode)
    assert [spill._bucket_tiles(r, 13, "pow2") for r in (1, 2, 3, 5, 8, 9, 13)] == \
        [1, 2, 4, 8, 8, 13, 13]
    assert len({spill._bucket_tiles(r, 64, "pow2") for r in range(1, 65)}) <= 7
    with pytest.raises(ValueError, match="unknown shape_mode"):
        spill._bucket_tiles(3, 13, "nope")


def test_mesh_raises_naming_its_roadmap_item():
    at, _ = _host(random_spd(64, seed=0))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #6"):
        out_of_core_cholesky(at, mesh=object())


def test_non_spd_raises_with_no_manifest_entry(tmp_path):
    """A diagonal block that is not positive-definite (panel 2's) raises
    LinAlgError; panels 0-1 are committed, the failed panel never is."""
    a = random_spd(256, seed=12)
    a[150, 150] = -1000.0  # tile 4: panel 2 at panel_tiles 2
    ck = str(tmp_path / "ck")
    with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite"):
        out_of_core_cholesky(_host(a)[0], panel_tiles=2, checkpoint_dir=ck)
    assert spill.SpillCheckpoint(ck).completed() == 2
    assert sorted(os.listdir(ck)) == ["manifest.json", "panel_0.npy", "panel_1.npy"]


def test_update_outside_the_envelope_raises():
    """The update's operands are checked by shape before any launch: a
    top that is not a row slice of the strip (a transposed view) or a K
    that is not the strip's."""
    panel, strip = torch.zeros(96, 64), torch.zeros(96, 32)
    spill._check_update(panel, strip, strip[:64], 32)
    with pytest.raises(ShapeError, match="envelope"):
        spill._check_update(panel, strip, torch.zeros(32, 64).T, 32)
    with pytest.raises(ShapeError, match="envelope"):
        spill._check_update(panel, strip, strip[:64], 64)


def test_adopt_block_keeps_the_tile_without_a_copy():
    """The writer's host side: a slab's tile views become the store's tiles
    as they are; a wrong shape, dtype or layout is refused, and an upper
    tile of a lower-triangle store lands transposed (a copy)."""
    from numpywren_tpu_torch.tiled import TiledMatrix, TiledSymmetricMatrix

    slab = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    m = TiledMatrix(shape=(8, 12), tile=(4, 4), storage="host", device="cpu")
    m.adopt_block(slab[1, 2], 1, 2)
    assert m.get_block(1, 2).data_ptr() == slab[1, 2].data_ptr()
    for bad in (torch.zeros(4, 3), slab[0, 0].double(), slab[0, 0].T):
        with pytest.raises(ShapeError, match="adopt_block"):
            m.adopt_block(bad, 0, 0)
    s = TiledSymmetricMatrix(shape=(8, 8), tile=(4, 4), storage="host", device="cpu")
    s.adopt_block(slab[0, 1], 0, 1)
    assert torch.equal(s.get_block(1, 0), slab[0, 1].T)
    assert s.get_block(1, 0).data_ptr() != slab[0, 1].data_ptr()
