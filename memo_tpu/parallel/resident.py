"""Device-resident, coordinate-sharded interval store (SURVEY §7 flagship
distribution design; BASELINE config 5: whole-chromosome index sharded by
pivot coordinate across devices/hosts).

The batched :class:`~memo_tpu.parallel.sharded.ShardedQuery` shards
*computation*: it re-extracts candidate rows host-side per call and uploads
padded ``[W, M]`` arrays every time. This module inverts that — the
reference's own scale story turned inside out (reference memo_query.py:19-36
does Parquet predicate pushdown precisely so the index is never fully
materialized; here the index IS materialized, once, straight into sharded
device HBM, and queries route to the shards):

- **Placement (once):** the pivot coordinate axis is split into ``n_sp``
  contiguous slabs of ``B`` positions. Shard d holds exactly the store rows
  that can mark a position in its slab at any ``k <= k_max`` — a contiguous
  run of the (record, start)-sorted store found by the same binary search the
  single-device engine uses (store.window_bounds). Boundary-straddling
  intervals land in BOTH neighboring shards and are clipped by the coverage
  kernel (idempotent boolean fill — SURVEY §7's dedupe-free duplication).
  Rows are padded to a shared static width and placed with one
  ``jax.device_put`` under ``NamedSharding(P('sp', None))``: each device
  keeps only its ~1/n_sp of the index resident in HBM.
- **Query (per call):** one jitted ``shard_map`` program; shard d computes
  the difference-array coverage of its own slab from its own resident rows
  (``ops.query_ops.coverage_counts``) — no collectives at all for either
  output (the k-1 shadow reach is already folded into the per-shard row
  ranges, so slabs are halo-free) — and the outputs concatenate along
  ``sp``. Any window [qs, qe) is a host-side slice of the slab outputs.

Exactness: an interval (start, end, c) marks position p iff
``end - (k-1) <= p < start`` (reference memo_query.py:57-63). Stored overlap
intervals satisfy ``end >= start`` (bookends allowed, dap_to_bed.py:97), so
every marked position lies in ``[start - (k-1), start)`` — shard d's row
range ``window_bounds(d*B, (d+1)*B, k_max)`` covers all markers of its slab
for any k <= k_max, and rows outside a slab clip to no-ops
(ops/query_ops.py). Bit-exactness vs the single-device engine is pinned by
tests/test_resident.py on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from memo_tpu.ops.query_ops import (
    conservation_from_marks,
    coverage_counts,
    membership_from_marks,
)
from memo_tpu.parallel.sharded import make_mesh


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=64)
def _resident_fn_multi(
    mesh: Mesh, n_batch: int, B: int, M: int, C: int, n_docs: int, membership: bool
):
    """Multi-record SPMD program: the ``dp`` mesh axis serves DISTINCT
    records (replicas used to idle there), and ``n_batch``
    stacks further records per dp rank when records > n_dp.

    Global inputs: int32[n_batch, n_dp, n_sp, M] sharded P(None,'dp','sp',∅).
    Global output: [n_batch, n_dp, n_sp*B(, C)] — record slot (b, d) is an
    independent coordinate-sharded store; one dispatch answers every
    record's whole-coverage at this k.
    """

    def local(starts, ends, orders, k):
        base = jax.lax.axis_index("sp") * B
        outs = []
        for b in range(n_batch):
            counts = coverage_counts(
                starts[b, 0, 0], ends[b, 0, 0], orders[b, 0, 0], base, k, L=B, C=C
            )
            marks = counts > 0
            outs.append(
                membership_from_marks(marks)
                if membership
                else conservation_from_marks(marks, n_docs)
            )
        out = jnp.stack(outs)  # (n_batch, B[, C])
        return out[:, None, None]

    in_specs = (P(None, "dp", "sp", None),) * 3 + (P(),)
    out_specs = (
        P(None, "dp", "sp", None, None) if membership else P(None, "dp", "sp", None)
    )

    def outer(starts, ends, orders, k):
        out = jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(
            starts, ends, orders, k
        )
        # (n_batch, n_dp, n_sp*B[, C])
        return out.reshape(out.shape[:2] + (-1,) + out.shape[4:])

    return jax.jit(outer)


@functools.lru_cache(maxsize=64)
def _resident_fn(mesh: Mesh, B: int, M: int, C: int, n_docs: int, membership: bool):
    """One compiled SPMD program per (mesh, slab, rows, mode) shape.

    Global inputs: starts/ends/orders int32[n_sp, M] sharded over ``sp``,
    k int32. Global output: int8[n_sp*B, C] or int32[n_sp*B] — shard d's
    rows produce slab d's positions, concatenated by the out_spec.
    """

    def local(starts, ends, orders, k):
        base = jax.lax.axis_index("sp") * B
        counts = coverage_counts(starts[0], ends[0], orders[0], base, k, L=B, C=C)
        marks = counts > 0
        if membership:
            return membership_from_marks(marks)[None]
        return conservation_from_marks(marks, n_docs)[None]

    in_specs = (P("sp", None), P("sp", None), P("sp", None), P())
    out_specs = P("sp", None, None) if membership else P("sp", None)

    def outer(starts, ends, orders, k):
        out = jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(
            starts, ends, orders, k
        )
        return out.reshape((-1,) + out.shape[2:])

    return jax.jit(outer)


class ResidentShardedQuery:
    """Arbitrary-k queries against a coordinate-sharded HBM-resident store.

    One instance serves one pivot record (the whole-chromosome case; build
    one per record for multi-record pivots). The store arrays are placed on
    the mesh ONCE at construction; every query is a single SPMD dispatch with
    zero host->device index traffic.
    """

    def __init__(
        self,
        store,
        mesh: Mesh | None = None,
        record: str | None = None,
        k_max: int = 1024,
        device_output: bool = False,
        records: list[str] | None = None,
    ):
        """``records`` places SEVERAL records in one multi-record placement:
        record i goes to dp rank ``i % n_dp`` (batch slot ``i // n_dp``), so
        the ``dp`` mesh axis serves distinct records instead of idle
        replicas, and ONE SPMD dispatch per (k, mode)
        answers all of them. ``record=`` keeps the single-record placement
        (arrays [n_sp, M], no batch dims)."""
        if store.kind not in ("conservation", "membership"):
            raise ValueError(f"bad store kind {store.kind!r}")
        if records is not None and record is not None:
            raise ValueError("pass record= or records=, not both")
        if records is None and record is None:
            if store.num_records == 1:
                record = store.record_names[0]
            else:
                records = list(store.record_names)
        self.store = store
        self.mesh = mesh if mesh is not None else make_mesh()
        self.k_max = int(k_max)
        self.n_docs = store.n_docs
        self.device_output = bool(device_output)
        n_sp = self.mesh.shape["sp"]

        self._multi = records is not None
        self.records = list(records) if self._multi else [record]
        self.record = self.records[0]
        self._slot = {name: i for i, name in enumerate(self.records)}
        if len(self._slot) != len(self.records):
            raise ValueError("duplicate records in placement")
        rec_idx = [store.record_index(name) for name in self.records]
        self._rec_lens = {
            name: int(store.record_lens[r]) for name, r in zip(self.records, rec_idx)
        }
        self.record_len = self._rec_lens[self.record]
        self.B = _round_up(max(max(self._rec_lens.values()), 1), n_sp) // n_sp

        # Defensive: the exactness argument (module docstring) needs
        # end >= start, which every MEM-overlap store satisfies.
        for r in rec_idx:
            seg = slice(int(store.rec_offsets[r]), int(store.rec_offsets[r + 1]))
            if seg.stop > seg.start and int((store.end[seg] - store.start[seg]).min()) < 0:
                raise ValueError("store has end < start rows; cannot shard by coordinate")

        # Placement-time length filter (exact): an interval marks positions
        # only when its length < k-1 (reference memo_query.py:49), so rows
        # with length >= k_max-1 can never mark at ANY k this placement
        # serves — drop them before they cost resident HBM and scan work
        # (the engine's query-time stratification, applied once at
        # placement; at HPRC-density stores most rows go).
        all_rows = []  # [record][shard] -> index array into the store
        for name, r in zip(self.records, rec_idx):
            rec_end = int(store.rec_offsets[r + 1])
            rows_per_shard = []
            for d in range(n_sp):
                lo, hi = store.window_bounds(
                    name,
                    d * self.B,
                    min((d + 1) * self.B, self._rec_lens[name]),
                    self.k_max,
                )
                hi = min(hi, rec_end)
                idx = np.arange(lo, hi)
                if hi > lo:
                    ln = store.end[lo:hi] - store.start[lo:hi]
                    idx = idx[ln < self.k_max - 1]
                rows_per_shard.append(idx)
            all_rows.append(rows_per_shard)
        M = _round_up(max(1, max(len(ix) for b in all_rows for ix in b)), 8)
        if self._multi:
            n_dp = self.mesh.shape.get("dp", 1)
            self.n_dp = n_dp
            self.n_batch = (len(self.records) + n_dp - 1) // n_dp
            shape = (self.n_batch, n_dp, n_sp, M)
            starts = np.zeros(shape, np.int32)
            ends = np.zeros(shape, np.int32)
            orders = np.full(shape, -1, np.int32)  # order<0 rows are dropped
            for i, rows_per_shard in enumerate(all_rows):
                b, dpi = i // n_dp, i % n_dp
                for d, ix in enumerate(rows_per_shard):
                    m = len(ix)
                    starts[b, dpi, d, :m] = store.start[ix]
                    ends[b, dpi, d, :m] = store.end[ix]
                    orders[b, dpi, d, :m] = store.order[ix]
            sh = NamedSharding(self.mesh, P(None, "dp", "sp", None))
        else:
            starts = np.zeros((n_sp, M), np.int32)
            ends = np.zeros((n_sp, M), np.int32)
            orders = np.full((n_sp, M), -1, np.int32)
            for d, ix in enumerate(all_rows[0]):
                m = len(ix)
                starts[d, :m] = store.start[ix]
                ends[d, :m] = store.end[ix]
                orders[d, :m] = store.order[ix]
            sh = NamedSharding(self.mesh, P("sp", None))
        self.rows_per_shard = M
        self._d_start = jax.device_put(starts, sh)
        self._d_end = jax.device_put(ends, sh)
        self._d_order = jax.device_put(orders, sh)
        # Whole-record outputs are memoized per (k, mode): every window of a
        # (record, k) batch is a slice of ONE SPMD dispatch (the CLI's
        # N-window regions file must not pay N full-record dispatches).
        # Bounded LRU: a k sweep cannot accumulate stale HBM.
        self._full_cache: dict[tuple[int, bool], object] = {}
        self._full_cache_cap = 4
        self.dispatch_count = 0  # test survey point: == #distinct (k, mode)

    def stats(self) -> dict:
        n_sp = self.mesh.shape["sp"]
        return {
            "record": self.record,
            "records": self.records,
            "record_len": self.record_len,
            "shards": n_sp,
            "dp_slots": getattr(self, "n_dp", 1) * getattr(self, "n_batch", 1),
            "slab_positions": self.B,
            "rows_per_shard": self.rows_per_shard,
            "resident_bytes_per_shard": self.rows_per_shard * 12
            * (getattr(self, "n_batch", 1) if self._multi else 1),
            "k_max": self.k_max,
        }

    def _pick(self, record: str | None) -> str:
        if record is None:
            if len(self.records) > 1:
                raise ValueError("multi-record placement: pass record=")
            return self.record
        if record not in self._slot:
            raise KeyError(f"record {record!r} not in this placement")
        return record

    # ------------------------------------------------------------------ public
    def conservation_full(self, k: int, record: str | None = None):
        """int32[record_len] conservation of the whole record (device array,
        sharded over sp) — sliced out of the one dispatch that served every
        record of the placement."""
        record = self._pick(record)
        out = self._full(k, membership=False)
        if self._multi:
            i = self._slot[record]
            out = out[i // self.n_dp, i % self.n_dp]
        return out[: self._rec_lens[record]]

    def membership_full(self, k: int, record: str | None = None):
        record = self._pick(record)
        out = self._full(k, membership=True)
        if self._multi:
            i = self._slot[record]
            out = out[i // self.n_dp, i % self.n_dp]
        return out[: self._rec_lens[record]]

    def conservation(self, qs: int, qe: int, k: int, record: str | None = None):
        out = self.conservation_full(k, record)[qs:qe]
        return out if self.device_output else np.asarray(out)

    def membership(self, qs: int, qe: int, k: int, record: str | None = None):
        out = self.membership_full(k, record)[qs:qe]
        return out if self.device_output else np.asarray(out)

    def conservation_windows(self, windows, k: int, record: str | None = None):
        """Batched windows served from ONE full-record dispatch per k —
        replaces per-window host gathers for dense window batches."""
        full = self.conservation_full(k, record)
        outs = [full[qs:qe] for qs, qe in windows]
        return outs if self.device_output else [np.asarray(o) for o in outs]

    def membership_windows(self, windows, k: int, record: str | None = None):
        """Membership twin of :meth:`conservation_windows`."""
        full = self.membership_full(k, record)
        outs = [full[qs:qe] for qs, qe in windows]
        return outs if self.device_output else [np.asarray(o) for o in outs]

    # ---------------------------------------------------------------- internals
    def _full(self, k: int, membership: bool):
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside this store's placement (k_max={self.k_max})")
        key = (int(k), bool(membership))
        hit = self._full_cache.pop(key, None)
        if hit is not None:
            self._full_cache[key] = hit  # refresh LRU position
            return hit
        if self._multi:
            fn = _resident_fn_multi(
                self.mesh,
                self.n_batch,
                self.B,
                self.rows_per_shard,
                self.n_docs,
                self.n_docs,
                membership,
            )
        else:
            fn = _resident_fn(
                self.mesh, self.B, self.rows_per_shard, self.n_docs, self.n_docs,
                membership,
            )
        out = fn(self._d_start, self._d_end, self._d_order, jnp.int32(k))
        self.dispatch_count += 1
        if len(self._full_cache) >= self._full_cache_cap:
            self._full_cache.pop(next(iter(self._full_cache)))
        self._full_cache[key] = out
        return out
