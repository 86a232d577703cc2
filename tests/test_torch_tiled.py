"""The port's block store (numpywren_tpu_torch/tiled.py and the trapezoid
tier's block API) against the JAX package's, on the CPU: the same puts,
reads, deletes and views give the same blocks and the same computed-block
masks (exact: no arithmetic happens)."""

import numpy as np
import pytest

from numpywren_tpu import tiled as jtiled
from numpywren_tpu import trapezoid as jtrap
from numpywren_tpu_torch.exceptions import BlockNotFoundError, ShapeError
from numpywren_tpu_torch import convert
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.tiled import TiledMatrix
from numpywren_tpu_torch.trapezoid import TiledTrapezoidMatrix, TrapezoidMatrix


def _pair(shape, tile, **kw):
    return (TiledMatrix(shape=shape, tile=tile, device="cpu", **kw),
            jtiled.TiledMatrix(shape=shape, tile=tile, **kw))


@pytest.mark.parametrize("fill", [0.0, None])
def test_put_get_delete_match_jax(rng, fill):
    m, jm = _pair((100, 70), (32, 32), fill=fill)
    for (i, j) in [(0, 0), (3, 2), (1, 2)]:
        blk = rng.standard_normal(m.true_block_shape(i, j)).astype(np.float32)
        m.put_block(blk, i, j)
        jm.put_block(blk, i, j)
    m.delete_block(1, 2)
    jm.delete_block(1, 2)
    assert m.block_idxs_exist == jm.block_idxs_exist
    for (i, j) in m.block_idxs:
        if fill is None and not jm.block_exists(i, j):
            with pytest.raises(BlockNotFoundError):
                m.get_block(i, j)
            continue
        np.testing.assert_array_equal(m.get_block(i, j).numpy(), np.asarray(jm.get_block(i, j)))
    with pytest.raises(ShapeError):
        m.put_block(np.zeros((5, 5), np.float32), 0, 0)
    with pytest.raises(ShapeError):
        m.get_block(4, 0)


def test_parent_fn_and_views_match_jax(rng):
    a = rng.standard_normal((96, 64)).astype(np.float32)
    parent = lambda mat, i, j: a[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]  # noqa: E731
    m, jm = _pair((96, 64), (32, 32), parent_fn=parent, fill=None)
    np.testing.assert_array_equal(m.numpy(), jm.numpy())
    assert m.block_idxs_exist == jm.block_idxs_exist == []  # reads are not writes
    for view, jview in [(m.T, jm.T), (m.submatrix((1, 3), 1), jm.submatrix((1, 3), 1))]:
        assert view.shape == jview.shape
        np.testing.assert_array_equal(view.numpy(), jview.numpy())
    m.T.put_block(np.ones((32, 32), np.float32), 1, 2)
    assert m.block_exists(2, 1)


def test_shard_matrix_owns_its_buffer(rng):
    a = rng.standard_normal((64, 64)).astype(np.float32)
    m = shard_matrix(a, tile=(32, 32), device="cpu")
    m.put_block(np.zeros((32, 32), np.float32), 0, 0)
    assert a[0, 0] != 0  # the store copied the input
    np.testing.assert_array_equal(convert.to_numpy(shard_matrix(a, tile=(48, 48), device="cpu")), a)
    sym = shard_matrix(a + a.T, tile=(48, 48), symmetric=True, device="cpu")
    assert type(sym).__name__ == "TiledSymmetricMatrix"
    np.testing.assert_array_equal(sym.get_block(0, 1).numpy(), sym.get_block(1, 0).numpy().T)


@pytest.mark.parametrize("symmetric", [True, False])
def test_trapezoid_block_api_matches_jax(rng, symmetric):
    n, panel, tile = 160, 64, 32
    t = TiledTrapezoidMatrix(n=n, tile=tile, panel=panel, symmetric=symmetric, device="cpu")
    jt = jtrap.TiledTrapezoidMatrix(n=n, tile=tile, panel=panel, symmetric=symmetric)
    for (i, j) in [(0, 0), (4, 1), (3, 3), (2, 4)]:
        blk = rng.standard_normal(t.true_block_shape(i, j)).astype(np.float32)
        if i < j and not symmetric:
            with pytest.raises(ShapeError):
                t.put_block(blk, i, j)
            continue
        t.put_block(blk, i, j)
        jt.put_block(blk, i, j)
    assert t.block_idxs_exist == jt.block_idxs_exist
    np.testing.assert_array_equal(t.numpy(), jt.numpy())
    np.testing.assert_array_equal(t.to_hbm().array.numpy(), np.asarray(jt.to_hbm().array))
    assert t.nbytes == jt.nbytes
    t.free()
    assert t.block_idxs_exist == []


def test_trapezoid_adopt_checks_geometry():
    t = TiledTrapezoidMatrix(n=128, tile=32, panel=64, device="cpu")
    other = TrapezoidMatrix.from_array(np.eye(96, dtype=np.float32), panel=32, device="cpu")
    with pytest.raises(ShapeError, match="geometry"):
        t.adopt(other)
    t.adopt(TrapezoidMatrix.from_array(np.eye(128, dtype=np.float32), panel=64, device="cpu"),
            written_tile_cols=2)
    assert t.block_exists(3, 1) and not t.block_exists(3, 2)
