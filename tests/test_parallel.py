"""Multi-device sharded query == single-device engine, bit-exact.

Runs on the 8-device virtual CPU mesh (conftest.py) — the hermetic stand-in
for a multi-GPU host (SURVEY §4 point 4)."""

import jax
import numpy as np
import pytest

from memo_tpu.index.builder import store_from_ms
from memo_tpu.parallel import ShardedQuery, make_mesh
from memo_tpu.query.engine import QueryEngine


def _random_store(rng, n_records=2, n_docs=5, rec_len=400, kind="conservation"):
    ms = [
        rng.integers(0, 40, size=(rec_len, n_docs - 1)).astype(np.int32)
        for _ in range(n_records)
    ]
    names = [f"chr{i}" for i in range(n_records)]
    return store_from_ms(ms, names, [rec_len] * n_records, n_docs, kind)


@pytest.fixture(scope="module")
def store():
    return _random_store(np.random.default_rng(7))


@pytest.fixture(scope="module")
def memb_store():
    return _random_store(np.random.default_rng(8), kind="membership")


WINDOWS = [("chr0", 0, 400), ("chr0", 37, 229), ("chr1", 100, 400), ("chr1", 0, 64)]


@pytest.mark.parametrize("strategy", ["position", "interval"])
@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("k", [1, 3, 31])
def test_conservation_matches_engine(store, strategy, dp, sp, k):
    mesh = make_mesh(dp=dp, sp=sp)
    sq = ShardedQuery(store, mesh, strategy=strategy)
    engine = QueryEngine(store, backend="numpy")
    got = sq.conservation(WINDOWS, k)
    for (rec, qs, qe), g in zip(WINDOWS, got):
        want = engine.conservation(rec, qs, qe, k)
        np.testing.assert_array_equal(np.asarray(g), want, err_msg=f"{rec}:{qs}-{qe}")


@pytest.mark.parametrize("strategy", ["position", "interval"])
def test_membership_matches_engine(memb_store, strategy):
    mesh = make_mesh(dp=2, sp=4)
    sq = ShardedQuery(memb_store, mesh, strategy=strategy)
    engine = QueryEngine(memb_store, backend="numpy")
    got = sq.membership(WINDOWS, 5)
    for (rec, qs, qe), g in zip(WINDOWS, got):
        want = engine.membership(rec, qs, qe, 5)
        np.testing.assert_array_equal(np.asarray(g), want, err_msg=f"{rec}:{qs}-{qe}")


def test_single_device_mesh(store):
    mesh = make_mesh(dp=1, sp=1, devices=jax.devices()[:1])
    sq = ShardedQuery(store, mesh)
    engine = QueryEngine(store, backend="numpy")
    (got,) = sq.conservation([("chr0", 10, 200)], 7)
    np.testing.assert_array_equal(got, engine.conservation("chr0", 10, 200, 7))


def test_make_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=3)  # 9 != 8 devices


def test_make_global_mesh_single_process(store):
    """On one process, the global mesh is (1, n_local) and queries work."""
    from memo_tpu.parallel.distributed import make_global_mesh

    mesh = make_global_mesh()
    assert mesh.shape["dp"] == 1 and mesh.shape["sp"] == 8
    sq = ShardedQuery(store, mesh)
    engine = QueryEngine(store, backend="numpy")
    (got,) = sq.conservation([("chr0", 5, 105)], 9)
    np.testing.assert_array_equal(got, engine.conservation("chr0", 5, 105, 9))


@pytest.mark.parametrize("strategy", ["position", "interval"])
def test_skewed_batch_buckets(strategy):
    """Windows with wildly different candidate counts land in different
    pow2 buckets (one dense window must not inflate every window's padding
    to the batch max) and stay bit-exact across buckets."""
    rng = np.random.default_rng(11)
    # chr0 densely covered, chr1 nearly empty: candidate counts differ ~100x.
    dense = rng.integers(0, 60, size=(512, 4)).astype(np.int32)
    sparse = np.zeros((512, 4), np.int32)
    sparse[::97] = 3
    store = store_from_ms([dense, sparse], ["chr0", "chr1"], [512, 512], 5, "conservation")
    mesh = make_mesh(dp=2, sp=4)
    sq = ShardedQuery(store, mesh, strategy=strategy)
    windows = [("chr0", 0, 512), ("chr1", 0, 512), ("chr1", 64, 256), ("chr0", 8, 136)]
    rows = sq._window_rows(windows, 3)
    ms = {max(1 if hi - lo <= 1 else 1 << (hi - lo - 1).bit_length(), 4) for lo, hi in rows}
    assert len(ms) > 1, f"expected multiple buckets, counts={[h-l for l, h in rows]}"
    engine = QueryEngine(store, backend="numpy")
    got = sq.conservation(windows, 3)
    for (rec, qs, qe), g in zip(windows, got):
        np.testing.assert_array_equal(np.asarray(g), engine.conservation(rec, qs, qe, 3))
