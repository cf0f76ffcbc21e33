"""XLA engine == numpy oracle, bit-exact, over a matrix of store shapes:
monotone and random stores, k from 1 to 101, membership, column counts past
128, dense stores (tens of intervals per position), the length-stratified
engine, the batch API and position chunking."""

import numpy as np
import pytest

from memo_tpu.index.builder import store_from_ms
from memo_tpu.query.engine import QueryEngine
from tests.ms_stores import lipschitz, random_store

WINDOWS = [("chr0", 0, 700), ("chr0", 123, 456), ("chr1", 600, 700), ("chr1", 0, 1)]


@pytest.fixture(scope="module", params=[True, False], ids=["monotone", "random"])
def stores(request):
    return random_store(np.random.default_rng(3), request.param)


@pytest.mark.parametrize("k", [1, 2, 3, 31, 101])
def test_conservation_matches_numpy(stores, k):
    engine = QueryEngine(stores, backend="jax")
    oracle = QueryEngine(stores, backend="numpy")
    for rec, qs, qe in WINDOWS:
        np.testing.assert_array_equal(
            engine.conservation(rec, qs, qe, k),
            oracle.conservation(rec, qs, qe, k),
            err_msg=f"{rec}:{qs}-{qe} k={k}",
        )


@pytest.mark.parametrize("k", [3, 31])
def test_membership_matches_numpy(k):
    store = random_store(np.random.default_rng(11), monotone=True, kind="membership")
    engine = QueryEngine(store, backend="jax")
    oracle = QueryEngine(store, backend="numpy")
    for rec, qs, qe in WINDOWS:
        np.testing.assert_array_equal(
            engine.membership(rec, qs, qe, k),
            oracle.membership(rec, qs, qe, k),
            err_msg=f"{rec}:{qs}-{qe} k={k}",
        )


@pytest.mark.parametrize("n_docs", [129, 160, 257])
def test_wide_pangenome(n_docs):
    """Deeper-than-HPRC pangenomes: column counts past 128."""
    store = random_store(
        np.random.default_rng(n_docs), monotone=True, n_records=1, n_docs=n_docs, rec_len=300
    )
    engine = QueryEngine(store, backend="jax")
    oracle = QueryEngine(store, backend="numpy")
    for qs, qe, k in [(0, 300, 31), (77, 204, 3)]:
        np.testing.assert_array_equal(
            engine.conservation("chr0", qs, qe, k),
            oracle.conservation("chr0", qs, qe, k),
            err_msg=f"C={n_docs} {qs}-{qe} k={k}",
        )


@pytest.mark.parametrize("n_docs,rec_len", [(60, 256), (90, 300)])
def test_dense_regime(n_docs, rec_len):
    """HPRC-density stores (tens of intervals per position), bit-exact
    across k and at one-position windows."""
    store = random_store(
        np.random.default_rng(n_docs * 7),
        monotone=True,
        n_records=1,
        n_docs=n_docs,
        rec_len=rec_len,
    )
    assert store.num_intervals > 20 * rec_len  # genuinely dense
    engine = QueryEngine(store, backend="jax")
    oracle = QueryEngine(store, backend="numpy")
    for qs, qe in [(0, rec_len), (13, rec_len - 17), (rec_len // 2, rec_len // 2 + 1)]:
        for k in (2, 31, 101):
            np.testing.assert_array_equal(
                engine.conservation("chr0", qs, qe, k),
                oracle.conservation("chr0", qs, qe, k),
                err_msg=f"C={n_docs} {qs}-{qe} k={k}",
            )


def test_stratified_engine_matches_numpy():
    """Length-stratified engine (per-bucket sub-engines, min-combined, only
    buckets with min length < k-1 dispatched) is bit-exact across k values
    on either side of every bucket edge — including k so small that NO
    bucket dispatches (sentinel output) and k beyond the longest interval."""
    rng = np.random.default_rng(13)
    mix = np.where(
        rng.random((900, 8)) < 0.5,
        rng.integers(0, 40, (900, 8)),
        rng.integers(100, 3000, (900, 8)),
    ).astype(np.int32)
    ms = [lipschitz(mix)]
    store = store_from_ms(ms, ["c0"], [900], 9, "conservation")
    strat = QueryEngine(store, backend="jax", stratify=True)
    assert strat._children is not None and len(strat._children) >= 3
    oracle = QueryEngine(store, backend="numpy")
    for qs, qe in [(0, 900), (111, 700), (899, 900)]:
        for k in (1, 2, 31, 33, 101, 130, 600, 2100, 5000):
            np.testing.assert_array_equal(
                strat.conservation("c0", qs, qe, k),
                oracle.conservation("c0", qs, qe, k),
                err_msg=f"{qs}-{qe} k={k}",
            )
    # bucket pruning actually happens: k=31 must touch only bucket 0
    strat.conservation("c0", 0, 900, 31)
    assert strat.last_stats.candidate_intervals <= strat._children[0][1].store.num_intervals

    memb = store_from_ms(ms, ["c0"], [900], 9, "membership")
    sm = QueryEngine(memb, backend="jax", stratify=True)
    om = QueryEngine(memb, backend="numpy")
    for k in (2, 31, 600):
        np.testing.assert_array_equal(
            sm.membership("c0", 0, 900, k), om.membership("c0", 0, 900, k)
        )


def test_batch_matches_per_window():
    """conservation_batch/membership_batch == per-window queries, including
    ragged lengths, a window at the record tail and a one-position window."""
    rng = np.random.default_rng(21)
    store = random_store(rng, monotone=True, n_records=1, n_docs=6, rec_len=800)
    eng = QueryEngine(store, backend="jax", stratify=False)
    oracle = QueryEngine(store, backend="numpy")
    wins = [(0, 200), (150, 420), (555, 800), (790, 800), (300, 301)]
    for (qs, qe), got in zip(wins, eng.conservation_batch("chr0", wins, 31)):
        np.testing.assert_array_equal(
            got, oracle.conservation("chr0", qs, qe, 31), err_msg=f"{qs}-{qe}"
        )
    memb = random_store(
        rng, monotone=True, n_records=1, n_docs=6, rec_len=800, kind="membership"
    )
    em = QueryEngine(memb, backend="jax", stratify=False)
    om = QueryEngine(memb, backend="numpy")
    for (qs, qe), got in zip(wins, em.membership_batch("chr0", wins, 7)):
        np.testing.assert_array_equal(
            got, om.membership("chr0", qs, qe, 7), err_msg=f"memb {qs}-{qe}"
        )


def test_chunked_equals_unchunked():
    store = random_store(np.random.default_rng(5), monotone=True)
    small = QueryEngine(store, backend="jax", chunk_positions=128)
    big = QueryEngine(store, backend="jax")
    np.testing.assert_array_equal(
        small.conservation("chr0", 0, 700, 31), big.conservation("chr0", 0, 700, 31)
    )
    assert small.last_stats.chunks > 1
