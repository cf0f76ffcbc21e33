import io

import numpy as np
import pytest

from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore
from memo_tpu.io import compat
from tests.ms_stores import random_store


def _store():
    rng = np.random.default_rng(5)
    ms0 = rng.integers(0, 20, size=(50, 3)).astype(np.int32)
    ms1 = rng.integers(0, 20, size=(30, 3)).astype(np.int32)
    return store_from_ms([ms0, ms1], ["a", "b"], [50, 30], n_docs=4, kind="conservation")


def test_sorted_by_start_within_record():
    s = _store()
    for r in range(s.num_records):
        lo, hi = s.rec_offsets[r], s.rec_offsets[r + 1]
        seg = s.start[lo:hi]
        assert (np.diff(seg) >= 0).all()


def test_save_load_roundtrip(tmp_path):
    s = _store()
    p = tmp_path / "idx.npz"
    s.save(p)
    t = IntervalStore.load(p)
    assert t.record_names == s.record_names
    assert t.n_docs == s.n_docs and t.kind == s.kind
    for f in ("rec_id", "start", "end", "order", "rec_offsets", "max_interval_len"):
        assert np.array_equal(getattr(t, f), getattr(s, f)), f


def test_window_bounds_superset_of_reference_filters():
    s = _store()
    for qs, qe, k in [(0, 50, 3), (10, 20, 5), (49, 50, 31), (0, 1, 1), (25, 40, 101)]:
        lo, hi = s.window_bounds("a", qs, qe, k)
        r0, r1 = s.rec_offsets[0], s.rec_offsets[1]
        f1 = s.start[r0:r1]
        f2 = s.end[r0:r1]
        # the reference's two pushdown filters (memo_query.py:22-28)
        need = ((f1 <= qs) & (f2 > qs)) | ((f1 > qs) & (f1 < qe + k))
        idx = np.nonzero(need)[0] + r0
        if idx.size:
            assert lo <= idx.min() and idx.max() < hi


def test_bed_text_roundtrip(tmp_path):
    s = _store()
    buf = io.BytesIO()
    compat.write_bed(s, buf)
    bed_path = tmp_path / "x.bed"
    bed_path.write_bytes(buf.getvalue())
    t = compat.read_bed(bed_path, n_docs=4, kind="conservation")
    assert np.array_equal(t.start, s.start)
    assert np.array_equal(t.end, s.end)
    assert np.array_equal(t.order, s.order)
    assert t.record_names == s.record_names


def test_parquet_roundtrip(tmp_path):
    pytest.importorskip("pyarrow")
    s = _store()
    p = tmp_path / "x.parquet"
    compat.write_parquet(s, p)
    t = compat.read_parquet(p, n_docs=4, kind="conservation")
    assert np.array_equal(t.start, s.start)
    assert np.array_equal(t.end, s.end)
    assert np.array_equal(t.order, s.order)


def test_parquet_streaming_blocks_equal_one_shot(tmp_path):
    """Block-streamed Parquet (reference parquet_compress_bed.py:16-39) is
    table-equal to the one-shot write (-a flag) and splits into row groups."""
    pq = pytest.importorskip("pyarrow.parquet")
    s = _store()
    blocked = tmp_path / "b.parquet"
    oneshot = tmp_path / "a.parquet"
    compat.write_parquet(s, blocked, block_bytes=64)  # ~4 rows per group
    compat.write_parquet(s, oneshot, one_shot=True)
    fb, fa = pq.ParquetFile(blocked), pq.ParquetFile(oneshot)
    assert fb.metadata.num_row_groups > 1
    assert fa.metadata.num_row_groups == 1
    assert fb.read().equals(fa.read())
    t = compat.read_parquet(blocked, n_docs=4, kind="conservation")
    assert np.array_equal(t.start, s.start)
    assert np.array_equal(t.end, s.end)


def test_parquet_record_filter(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    s = _store()
    p = tmp_path / "x.parquet"
    compat.write_parquet(s, p)
    rec = s.record_names[0]
    t = compat.read_parquet(p, n_docs=4, kind="conservation", record=rec)
    want = s.rec_id == 0
    assert np.array_equal(t.start, s.start[want])
    assert t.record_names == [rec]


def test_extract_window_edge_bookends():
    """tabix excludes [qe, qe) bookends (htslib rec_beg < reg_end); interior
    and window-start bookends are kept (compat.extract_window docstring)."""
    st = IntervalStore(
        record_names=["c"],
        record_lens=[10],
        n_docs=3,
        kind="conservation",
        rec_id=np.zeros(5, np.int32),
        start=np.array([2, 2, 4, 6, 6], np.int64),
        end=np.array([2, 5, 4, 6, 8], np.int64),
        order=np.array([1, 2, 1, 2, 1], np.int64),
    )
    s, e, o = compat.extract_window(st, "c", 2, 6)
    # [6,6) bookend at qe excluded; [2,2) at qs kept; [4,4) interior kept;
    # [6,8) starts inside but ends past qe -> excluded by -f 1 containment.
    assert list(zip(s.tolist(), e.tolist(), o.tolist())) == [
        (2, 2, 1), (2, 5, 2), (4, 4, 1)
    ]


def test_stats():
    s = _store()
    st = s.stats()
    assert st["records"] == 2 and st["n_docs"] == 4 and st["intervals"] == s.num_intervals


@pytest.fixture(scope="module", params=[True, False], ids=["monotone", "random"])
def ms_store(request):
    return random_store(np.random.default_rng(3), request.param), request.param


def test_query_layout_monotone_flag(ms_store):
    store, monotone = ms_store
    lay = store.query_layout()
    if monotone:
        # True-MS stores must take the fast searchsorted prefix path.
        assert lay.monotone


def test_prefix_counts_match_bruteforce(ms_store):
    store, _ = ms_store
    lay = store.query_layout()
    for r in range(store.num_records):
        lo, hi = store.rec_offsets[r], store.rec_offsets[r + 1]
        s, e, o = store.start[lo:hi], store.end[lo:hi], store.order[lo:hi]
        for qs, k in [(0, 3), (100, 31), (350, 1), (699, 101)]:
            want = np.zeros(store.n_docs, np.int64)
            m = (e <= qs + k - 1) & (s > qs)
            for c in o[m]:
                want[c] += 1
            got = lay.prefix_counts(store, r, qs, k)
            np.testing.assert_array_equal(got, want, err_msg=f"r={r} qs={qs} k={k}")
