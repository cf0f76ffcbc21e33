"""Query engine: numpy/jax backend equivalence, chunking invariance, and the
golden query vectors from SURVEY.md (verified against the live reference in
test_oracle_parity.py)."""

import numpy as np
import pytest

from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore
from memo_tpu.ops import query_ops as Q
from memo_tpu.query.engine import QueryEngine, parse_region

GOLDEN_DAP = np.array(
    [[3, 2, 1], [2, 1, 5], [1, 4, 4], [5, 3, 3], [4, 2, 2]], np.int32
)


def _store(kind):
    return store_from_ms([GOLDEN_DAP], ["chrA"], [5], n_docs=4, kind=kind)


def test_conservation_golden_numpy():
    eng = QueryEngine(_store("conservation"), backend="numpy")
    assert eng.conservation("chrA", 0, 5, 3).tolist() == [2, 2, 3, 4, 2]
    assert eng.conservation("chrA", 0, 5, 2).tolist() == [3, 3, 3, 4, 4]


def test_membership_golden_numpy():
    eng = QueryEngine(_store("membership"), backend="numpy")
    got = eng.membership("chrA", 0, 5, 3)
    assert got.tolist() == [
        [1, 1, 0, 0], [1, 0, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]
    ]


def test_jax_matches_numpy():
    s = _store("conservation")
    a = QueryEngine(s, backend="numpy")
    b = QueryEngine(s, backend="jax")
    for k in (1, 2, 3, 5, 31):
        for qs, qe in [(0, 5), (1, 4), (2, 3), (0, 1), (3, 5)]:
            assert np.array_equal(
                a.conservation("chrA", qs, qe, k), b.conservation("chrA", qs, qe, k)
            ), (k, qs, qe)


def test_jax_membership_matches_numpy():
    s = _store("membership")
    a = QueryEngine(s, backend="numpy")
    b = QueryEngine(s, backend="jax")
    for k in (1, 2, 3, 7):
        assert np.array_equal(a.membership("chrA", 0, 5, k), b.membership("chrA", 0, 5, k))


def test_chunked_positions_equal_unchunked():
    rng = np.random.default_rng(3)
    ms = rng.integers(0, 30, size=(300, 5)).astype(np.int32)
    store = store_from_ms([ms], ["c"], [300], n_docs=6, kind="conservation")
    whole = QueryEngine(store, backend="jax", chunk_positions=1 << 17)
    tiny = QueryEngine(store, backend="jax", chunk_positions=17)
    for k in (1, 5, 31):
        w = whole.conservation("c", 0, 300, k)
        t = tiny.conservation("c", 0, 300, k)
        assert np.array_equal(w, t), k


def test_multirecord_no_bleed():
    # two records; intervals of record 1 must not affect record 0's window
    ms0 = np.array([[4], [3], [2], [1]], np.int32)
    ms1 = np.array([[4], [4], [4], [4]], np.int32)
    store = store_from_ms([ms0, ms1], ["r0", "r1"], [4, 4], n_docs=2, kind="conservation")
    a = QueryEngine(store, backend="numpy")
    b = QueryEngine(store, backend="jax")
    for rec in ("r0", "r1"):
        for k in (1, 2, 3):
            assert np.array_equal(
                a.conservation(rec, 0, 4, k), b.conservation(rec, 0, 4, k)
            ), (rec, k)


def test_k_sweep_one_index():
    # MEMO's core feature: one index answers every k (SURVEY §Algorithm)
    rng = np.random.default_rng(11)
    ms = rng.integers(0, 40, size=(200, 8)).astype(np.int32)
    store = store_from_ms([ms], ["c"], [200], n_docs=9, kind="conservation")
    a = QueryEngine(store, backend="numpy")
    b = QueryEngine(store, backend="jax")
    for k in (1, 2, 21, 31, 51, 101, 199):
        assert np.array_equal(a.conservation("c", 0, 200, k), b.conservation("c", 0, 200, k)), k


def test_window_beyond_record_end():
    # positions past the record end have no intervals -> conservation n
    eng = QueryEngine(_store("conservation"), backend="numpy")
    out = eng.conservation("chrA", 0, 8, 3)
    assert out.shape == (8,)
    assert out[:5].tolist() == [2, 2, 3, 4, 2]


def test_parse_region():
    assert parse_region("chr1:0-20") == ("chr1", 0, 20)
    assert parse_region("weird:name:5-7") == ("weird:name", 5, 7)
    with pytest.raises(ValueError):
        parse_region("no-colon")


def test_unknown_record_raises():
    eng = QueryEngine(_store("conservation"), backend="numpy")
    with pytest.raises(KeyError):
        eng.conservation("nope", 0, 5, 3)


def test_stats_populated():
    eng = QueryEngine(_store("conservation"), backend="numpy")
    eng.conservation("chrA", 0, 5, 3)
    st = eng.last_stats.as_dict()
    assert st["positions"] == 5 and st["chunks"] == 1


def test_interval_bucket_overflow_accumulates():
    """A single position covered by more intervals than the bucket cap must
    accumulate over interval pieces (min-combine), not crash (was a
    RuntimeError). The device path, both modes."""
    rng = np.random.default_rng(0)
    n_iv, L, n = 64, 32, 4
    starts = np.sort(rng.integers(0, L, n_iv)).astype(np.int64)
    ends = starts + rng.integers(0, 40, n_iv)  # heavy overlap on every position
    orders = rng.integers(1, n, n_iv).astype(np.int64)
    for kind in ("conservation", "membership"):
        st = IntervalStore(
            record_names=["chrA"],
            record_lens=[L],
            n_docs=n,
            kind=kind,
            rec_id=np.zeros(n_iv, np.int32),
            start=starts,
            end=ends,
            order=orders,
        )
        ref = QueryEngine(st, backend="numpy")
        for backend in ("jax",):
            eng = QueryEngine(st, backend=backend, max_intervals_per_chunk=8)
            for k in (1, 3, 9):
                q = eng.membership if kind == "membership" else eng.conservation
                r = ref.membership if kind == "membership" else ref.conservation
                assert np.array_equal(q("chrA", 0, L, k), r("chrA", 0, L, k)), (
                    kind, backend, k,
                )


def test_prefix_counts_vectorized_matches_scan():
    """Composite-key prefix_counts == the brute-force definition."""
    rng = np.random.default_rng(1)
    n_iv, n = 200, 7
    st = IntervalStore(
        record_names=["a", "b"],
        record_lens=[50, 60],
        n_docs=n,
        kind="conservation",
        rec_id=np.sort(rng.integers(0, 2, n_iv)).astype(np.int32),
        start=np.zeros(n_iv, np.int64),
        end=np.zeros(n_iv, np.int64),
        order=rng.integers(1, n, n_iv).astype(np.int64),
    )
    # per-record sorted starts; constant lengths make per-segment ends
    # nondecreasing, i.e. the monotone fast-path regime
    for r in (0, 1):
        m = st.rec_id == r
        s = np.sort(rng.integers(0, 50, m.sum()))
        st.start[m] = s
        st.end[m] = s + 5
    st = IntervalStore(  # re-sort through the constructor invariants
        record_names=st.record_names, record_lens=st.record_lens, n_docs=n,
        kind=st.kind, rec_id=st.rec_id, start=st.start, end=st.end, order=st.order,
    )
    lay = st.query_layout()
    assert lay.monotone  # otherwise this test exercises nothing
    for r in (0, 1):
        for qs in (0, 3, 17, 49):
            for k in (1, 4, 31, 1000):
                got = lay.prefix_counts(st, r, qs, k)
                lo, hi = st.rec_offsets[r], st.rec_offsets[r + 1]
                mask = (st.end[lo:hi] <= qs + k - 1) & (st.start[lo:hi] > qs)
                want = np.bincount(st.order[lo:hi][mask], minlength=n)[:n]
                assert got.tolist() == want.tolist(), (r, qs, k)


def test_coverage_marks_superset_safety():
    # extra intervals fully left/right of the window must be no-ops
    starts = np.array([2, 100, 0], np.int64)
    ends = np.array([1, 150, 0], np.int64)  # [1,2) valid-ish; others out
    orders = np.array([1, 1, 1], np.int64)
    m_all = Q.coverage_marks_np(starts, ends, orders, 0, 2, 10, 3)
    m_one = Q.coverage_marks_np(starts[:1], ends[:1], orders[:1], 0, 2, 10, 3)
    assert np.array_equal(m_all, m_one)
