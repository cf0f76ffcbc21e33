"""Query orchestration: interval store -> device -> conservation/membership.

Replaces the reference's single-process CPU stack (memo_query.py main,
filter_pq -> memo_init -> numba memo_query -> print_res) with:

1. host-side binary search for a candidate row range (store.window_bounds —
   the Parquet predicate-pushdown replacement),
2. a jitted device program per (window-length, interval-bucket) shape:
   dynamic-slice the device-resident store, cast/clip/shadow-cast, dense
   difference-array coverage, conservation/membership reduction
   (memo_tpu.ops.query_ops),
3. bit-exact text formatting (memo_tpu.query.output).

Large windows are processed in fixed-size position chunks: marking of a
position depends only on intervals covering it (proof in ops/query_ops.py),
so chunked results concatenate exactly — the same property the multi-chip
position sharding relies on (memo_tpu/parallel).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from memo_tpu.index.store import IntervalStore
from memo_tpu.utils.device import describe_device, max_chunk_positions, query_sizes
from memo_tpu.utils.logging import get_logger

log = get_logger(__name__)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _elementwise_min(a, b):
    import jax.numpy as jnp

    return jnp.minimum(a, b)


@dataclasses.dataclass
class QueryStats:
    """Per-query observability counters (the reference has none; SURVEY §5)."""

    candidate_intervals: int = 0
    chunks: int = 0
    positions: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class QueryEngine:
    """Arbitrary-k membership/conservation queries over an IntervalStore.

    backend:
      - "jax": the XLA coverage program on JAX's default device
      - "numpy": host reference / cross-check
      - "auto": "jax"
    """

    def __init__(
        self,
        store: IntervalStore,
        backend: str = "auto",
        chunk_positions: int | None = None,
        max_intervals_per_chunk: int | None = None,
        device_output: bool = False,
        stratify: bool | str = "auto",
    ):
        """``device_output=True`` keeps results on device (jax arrays, no
        host transfer) — for pipelines that feed them onward (binning, another
        kernel) or benchmarks that time device throughput.

        Unset sizes come from ``utils.device.query_sizes``: derived from the
        device's memory limit, or the small host sizes where the backend
        reports none. The chunk is capped so the int32 scatter index of
        ``ops.query_ops.coverage_counts`` stays in range.
        """
        if store.kind not in ("conservation", "membership"):
            raise ValueError(f"bad store kind {store.kind!r}")
        if backend == "auto":
            backend = "jax"
        if backend not in ("jax", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.store = store
        self.backend = backend
        if chunk_positions is None or max_intervals_per_chunk is None:
            info = describe_device() if backend == "jax" else None
            default_chunk, default_rows = query_sizes(info, store.n_docs)
            chunk_positions = chunk_positions or default_chunk
            max_intervals_per_chunk = max_intervals_per_chunk or default_rows
        self.chunk_positions = min(int(chunk_positions), max_chunk_positions(store.n_docs))
        self.max_intervals = int(max_intervals_per_chunk)
        self.device_output = bool(device_output) and backend == "jax"
        self.n_docs = store.n_docs
        self.last_stats = QueryStats()

        # Length stratification: an interval only marks positions when its
        # length < k-1 (reference memo_query.py:49), yet the device program
        # pays for every candidate row. Dense HPRC-like stores are ~92%
        # invalid at the default k=31 (the bench large-store class), so the
        # engine partitions such stores into length buckets — each a fully
        # independent sub-engine over a sub-store — and a query only
        # dispatches buckets whose length range can contain valid intervals
        # at its k. Piece outputs combine with elementwise MIN (mark-union;
        # the _query_interval_pieces proof). Sparse stores (mostly-valid at
        # k=31) skip stratification: extra dispatches would cost more than
        # the few dead rows.
        self._children: list[tuple[int, "QueryEngine"]] | None = None
        if stratify == "auto":
            stratify = (
                backend == "jax"
                and store.num_intervals >= (1 << 20)
                and float(np.mean((store.end - store.start) < 30)) < 0.5
            )
        if stratify and backend == "jax":
            self._init_stratified(store)
            return

        if backend == "jax":
            import jax.numpy as jnp

            # Device-resident store, padded with sentinel rows (order=-1 is
            # dropped by the device program) so dynamic_slice never
            # clamps/shifts. The pad only needs to cover the largest slice
            # bucket, which is bounded by the store size.
            pad = min(self.max_intervals, _next_pow2(max(store.num_intervals, 1)))

            def dev(a, fill):
                # Transfer the exact int32 array and pad on DEVICE: the host
                # transient is n*4 bytes, not (n+pad)*8 — a 39M-interval store
                # no longer doubles host memory per engine instance.
                return jnp.concatenate(
                    [jnp.asarray(a.astype(np.int32)), jnp.full((pad,), fill, jnp.int32)]
                )

            self._d_start = dev(store.start, 0)
            self._d_end = dev(store.end, 0)
            self._d_order = dev(store.order, -1)

    # Bucket edges: upper length bounds (exclusive). Chosen so the default
    # k=31 touches ONLY bucket 0 (len < 32 covers len < 30 exactly plus the
    # thin 30..31 shell), the k-sweep 51/101 adds one bucket, and huge-k
    # queries still prune nothing worse than the unstratified engine.
    STRATA_EDGES = (32, 128, 512, 2048)

    def _init_stratified(self, store) -> None:
        from memo_tpu.index.store import IntervalStore

        ln = np.asarray(store.end - store.start)
        b_id = np.searchsorted(np.asarray(self.STRATA_EDGES, np.int64), ln, side="right")
        children: list[tuple[int, QueryEngine]] = []
        for b in range(len(self.STRATA_EDGES) + 1):
            rows = np.flatnonzero(b_id == b)
            if rows.size == 0:
                continue
            sub = IntervalStore(
                record_names=store.record_names,
                record_lens=store.record_lens,
                n_docs=store.n_docs,
                kind=store.kind,
                rec_id=store.rec_id[rows],  # stable subset: (rec, start) order kept
                start=store.start[rows],
                end=store.end[rows],
                order=store.order[rows],
            )
            lb = 0 if b == 0 else self.STRATA_EDGES[b - 1]
            children.append(
                (
                    lb,
                    QueryEngine(
                        sub,
                        backend=self.backend,
                        chunk_positions=self.chunk_positions,
                        max_intervals_per_chunk=self.max_intervals,
                        device_output=True,
                        stratify=False,
                    ),
                )
            )
        self._children = children

    def _query_stratified(self, record, qs, qe, k, membership):
        """Union of per-bucket marks == elementwise MIN of per-bucket
        outputs (same argument as _query_interval_pieces); buckets whose
        minimum length >= k-1 hold no valid interval and are skipped."""
        L = qe - qs
        n = self.n_docs
        stats = QueryStats(positions=L)
        acc = None
        for lb, child in self._children:
            if lb >= k - 1:
                continue  # every interval in this bucket is too long at this k
            out = child._query(record, qs, qe, k, membership)
            stats.candidate_intervals += child.last_stats.candidate_intervals
            stats.chunks += child.last_stats.chunks
            acc = out if acc is None else _elementwise_min(acc, out)
        self.last_stats = stats
        if acc is None:  # k too small for ANY stored interval: nothing marks
            import jax.numpy as jnp

            if membership:
                acc = jnp.ones((L, n), jnp.int8)
            else:
                acc = jnp.full((L,), n, jnp.int32)
        return acc if self.device_output else np.asarray(acc)

    # ------------------------------------------------------------------ public
    def conservation(self, record: str, qs: int, qe: int, k: int) -> np.ndarray:
        """int array [qe-qs] of per-position conservation values in [0, n]."""
        return self._query(record, qs, qe, k, membership=False)

    def membership(self, record: str, qs: int, qe: int, k: int) -> np.ndarray:
        """int8 array [qe-qs, n] presence/absence matrix (col 0 = pivot = 1)."""
        return self._query(record, qs, qe, k, membership=True)

    def query_region(self, region: str, k: int, membership: bool = False) -> np.ndarray:
        record, qs, qe = parse_region(region)
        return self._query(record, qs, qe, k, membership=membership)

    def conservation_batch(self, record: str, windows, k: int) -> list[np.ndarray]:
        """Conservation of N windows of one record, in window order. Each
        window is an ordinary query (chunked, stratified), so outputs equal
        N calls of :meth:`conservation`."""
        return self._query_batch(record, windows, k, membership=False)

    def membership_batch(self, record: str, windows, k: int) -> list[np.ndarray]:
        return self._query_batch(record, windows, k, membership=True)

    # ----------------------------------------------------------------- internals
    def _query_batch(self, record: str, windows, k: int, membership: bool):
        return [self._query(record, int(qs), int(qe), k, membership) for qs, qe in windows]

    def _query(self, record: str, qs: int, qe: int, k: int, membership: bool) -> np.ndarray:
        if qe < qs:
            raise ValueError(f"empty/negative region {record}:{qs}-{qe}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self._children is not None:
            return self._query_stratified(record, qs, qe, k, membership)
        L_total = qe - qs
        n = self.n_docs
        stats = QueryStats(positions=L_total)
        outputs: list[np.ndarray] = []
        for c_qs in range(qs, qe, self.chunk_positions):
            c_qe = min(c_qs + self.chunk_positions, qe)
            outputs.append(self._query_chunk(record, c_qs, c_qe, k, membership, stats))
            stats.chunks += 1
        self.last_stats = stats
        if self.device_output:
            import jax.numpy as jnp

            if not outputs:
                return jnp.zeros((0, n), jnp.int8) if membership else jnp.zeros(0, jnp.int32)
            return jnp.concatenate(outputs, axis=0) if len(outputs) > 1 else outputs[0]
        if membership:
            return (
                np.concatenate(outputs, axis=0)
                if outputs
                else np.zeros((0, n), np.int8)
            )
        return np.concatenate(outputs) if outputs else np.zeros(0, np.int64)

    def _cat(self, left, right):
        if self.device_output:
            import jax.numpy as jnp

            return jnp.concatenate([left, right], axis=0)
        return np.concatenate([left, right], axis=0)

    def _query_chunk(
        self, record: str, qs: int, qe: int, k: int, membership: bool, stats: QueryStats
    ) -> np.ndarray:
        lo, hi = self.store.window_bounds(record, qs, qe, k)
        count = hi - lo
        L = qe - qs
        n = self.n_docs

        if self.backend == "numpy":
            from memo_tpu.ops import query_ops as Q

            stats.candidate_intervals += count
            s = self.store.start[lo:hi]
            e = self.store.end[lo:hi]
            o = self.store.order[lo:hi]
            marks = Q.coverage_marks_np(s, e, o, qs, k, L, n)
            return Q.membership_np(marks) if membership else Q.conservation_np(marks, n)

        # jax path: pad candidate count to a bucket for jit reuse.
        M = min(_next_pow2(max(count, 1)), self.max_intervals)
        if count > M:
            # More candidates than the bucket cap: fall back to smaller
            # position chunks (halving preserves exactness). Candidates are
            # counted at dispatch points only (the recursion re-derives them).
            mid = (qs + qe) // 2
            if mid == qs:
                return self._query_interval_pieces(
                    record, qs, qe, k, membership, lo, hi, stats
                )
            left = self._query_chunk(record, qs, mid, k, membership, stats)
            right = self._query_chunk(record, mid, qe, k, membership, stats)
            return self._cat(left, right)

        stats.candidate_intervals += count
        return self._run_device_range(record, qs, k, membership, lo, M, L)

    def _run_device_range(
        self, record: str, qs: int, k: int, membership: bool, lo: int, M: int, L: int
    ):
        r = self.store.record_index(record)
        rec_end = int(self.store.rec_offsets[r + 1])
        import jax.numpy as jnp

        run = _device_query_fn(M, L, self.n_docs, membership)
        out = run(
            self._d_start,
            self._d_end,
            self._d_order,
            jnp.int32(lo),
            jnp.int32(rec_end),
            jnp.int32(qs),
            jnp.int32(k),
        )
        return out if self.device_output else np.asarray(out)

    def _query_interval_pieces(
        self,
        record: str,
        qs: int,
        qe: int,
        k: int,
        membership: bool,
        lo: int,
        hi: int,
        stats: QueryStats,
    ):
        """Pathological fallback: more covering intervals on a single position
        than the bucket cap. Coverage is additive over interval subsets (each
        subset's diff-array counts are non-negative), so marks distribute as a
        union — combine per-piece outputs with elementwise MIN (conservation:
        min marked order; membership: AND of presence)."""
        L = qe - qs
        M = self.max_intervals
        acc = None
        for piece_lo in range(lo, hi, M):
            # Keep --stats honest on exactly the pathological queries where
            # observability matters most: each piece is a real dispatch.
            stats.candidate_intervals += min(piece_lo + M, hi) - piece_lo
            stats.chunks += 1
            out = self._run_device_range(record, qs, k, membership, piece_lo, M, L)
            if acc is None:
                acc = out
            elif self.device_output:
                import jax.numpy as jnp

                acc = jnp.minimum(acc, out)
            else:
                acc = np.minimum(acc, out)
        return acc


@functools.lru_cache(maxsize=256)
def _device_query_fn(M: int, L: int, n: int, membership: bool):
    """One compiled device program per (bucket, window, mode) shape."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from memo_tpu.ops import query_ops as Q

    @jax.jit
    def run(d_start, d_end, d_order, lo, rec_end, qs, k):
        s = lax.dynamic_slice(d_start, (lo,), (M,))
        e = lax.dynamic_slice(d_end, (lo,), (M,))
        o = lax.dynamic_slice(d_order, (lo,), (M,))
        # Rows past the record boundary belong to another record's coordinate
        # space; mask them out (rows past `hi` but before the boundary clip to
        # empty and are harmless — see query_ops).
        idx = lo + jnp.arange(M, dtype=jnp.int32)
        o = jnp.where(idx < rec_end, o, -1)
        marks = Q.coverage_marks(s, e, o, qs, k, L=L, C=n)
        if membership:
            return Q.membership_from_marks(marks)
        return Q.conservation_from_marks(marks, n)

    return run


def parse_region(region: str) -> tuple[str, int, int]:
    """Parse ``chr:start-end`` (0-indexed half-open, reference query.sh:24)."""
    record, _, start_end = region.rpartition(":")
    if not record:
        raise ValueError(f"bad region {region!r}, expected chr:start-end")
    start_s, _, end_s = start_end.partition("-")
    return record, int(start_s), int(end_s)
