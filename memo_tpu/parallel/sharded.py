"""Multi-device SPMD query execution over a ``jax.sharding.Mesh``.

The reference is a single-process CPU tool (SURVEY §5: no distributed layer).
This module is the engine's scale-out story: query batches run SPMD over a
2-D device mesh; XLA lowers the one collective to NCCL over NVLink — no
hand-written communication code, just shardings.

Mesh axes and what they shard:

- ``dp`` (data parallel): the batch of query windows. Windows are
  independent, so this axis needs no communication at all.
- ``sp`` (sequence parallel), one of two exact strategies:

  * ``position``: each window's position axis is split into contiguous slabs.
    Whether position p is marked depends only on intervals whose shadow-cast
    span covers p (ops/query_ops.py), so each slab computes independently
    from the replicated candidate set — halo-free context parallelism: the
    k−1 shadow reach is already folded into the stored interval arithmetic.
    No collectives; outputs concatenate exactly.
  * ``interval``: the candidate interval set is split across devices; each
    device builds partial coverage counts for the full window and a single
    ``psum`` over NVLink combines them (coverage counts are additive over any
    partition of the interval set — query_ops.coverage_counts).

``position`` is this class's default (zero communication, HBM-local
cumsums); use ``interval`` when the candidate set per window is enormous
relative to the window (deep pangenomes, tiny windows). Note both gather
candidates host-side per call — the CLI's ``--strategy auto`` prefers the
device-resident store (parallel/resident.py) for dense/many-window batches,
which the recorded scaling data favors at every mesh size.

Multi-host: the same code runs under ``jax.distributed.initialize`` with a
``(hosts × cards)`` mesh — ``dp`` laid out across hosts (the network) and
``sp`` within a host (NVLink), so the only collective (interval-strategy
psum) stays on NVLink. Hermetic multi-process testing uses the 8-device virtual CPU mesh
(tests/conftest.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from memo_tpu.ops.query_ops import (
    conservation_from_marks,
    coverage_counts,
    membership_from_marks,
)


def make_mesh(dp: int | None = None, sp: int | None = None, devices=None) -> Mesh:
    """A ('dp', 'sp') mesh over the available devices.

    Defaults put every device on the position axis (``sp``) — the right call
    for few large windows; pass dp>1 for many-window batches.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


# --------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=64)
def _batch_fn(mesh: Mesh, L: int, C: int, n_docs: int, membership: bool, strategy: str):
    """One compiled SPMD program per (mesh, window, mode, strategy) shape.

    Input shapes (global): starts/ends/orders int32[W, M], qs int32[W],
    k int32 scalar. Output: int8[W, L, C] (membership) or int32[W, L]
    (conservation).
    """
    n_sp = mesh.shape["sp"]
    if L % n_sp != 0:
        raise ValueError(f"window length {L} not divisible by sp={n_sp}")
    L_loc = L // n_sp

    def _reduce(marks):
        if membership:
            return membership_from_marks(marks)
        return conservation_from_marks(marks, n_docs)

    if strategy == "position":
        # Intervals replicated; each sp shard owns a contiguous position slab.
        def local(starts, ends, orders, qs, k):
            base = qs + jax.lax.axis_index("sp") * L_loc

            def one(s, e, o, b):
                return _reduce(coverage_counts(s, e, o, b, k, L=L_loc, C=C) > 0)

            return jax.vmap(one)(starts, ends, orders, base)

        in_specs = (P("dp", None), P("dp", None), P("dp", None), P("dp"), P())
        out_specs = P("dp", "sp", None) if membership else P("dp", "sp")
    elif strategy == "interval":
        # Intervals sharded; partial coverage counts combined over NCCL with
        # psum_scatter along the position axis (half the ring traffic of a
        # full psum, and the C-wide count tensor is never all-gathered —
        # each shard reduces its own L/n_sp slab to marks/conservation and
        # only the final outputs concatenate via the out_spec).
        def local(starts, ends, orders, qs, k):
            def one(s, e, o, b):
                return coverage_counts(s, e, o, b, k, L=L, C=C)

            part = jax.vmap(one)(starts, ends, orders, qs)  # [W_loc, L, C]
            slab = jax.lax.psum_scatter(
                part, "sp", scatter_dimension=1, tiled=True
            )  # [W_loc, L/n_sp, C], summed over sp
            return jax.vmap(_reduce)(slab > 0)

        in_specs = (P("dp", "sp"), P("dp", "sp"), P("dp", "sp"), P("dp"), P())
        out_specs = P("dp", "sp", None) if membership else P("dp", "sp")
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    fn = jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    return jax.jit(fn)


def conservation_batch(mesh, starts, ends, orders, qs, k, *, L, n_docs, strategy="position"):
    """int32[W, L] conservation values for a batch of windows on a mesh."""
    fn = _batch_fn(mesh, L, n_docs, n_docs, False, strategy)
    return fn(starts, ends, orders, qs, jnp.int32(k))


def membership_batch(mesh, starts, ends, orders, qs, k, *, L, n_docs, strategy="position"):
    """int8[W, L, n_docs] presence matrices for a batch of windows."""
    fn = _batch_fn(mesh, L, n_docs, n_docs, True, strategy)
    return fn(starts, ends, orders, qs, jnp.int32(k))


# ----------------------------------------------------------------- orchestrator
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ShardedQuery:
    """Batched multi-device queries over an :class:`IntervalStore`.

    Gathers per-window candidate rows host-side (store.window_bounds), pads
    them to a shared static bucket, and runs the SPMD batch program. Results
    are bit-identical to the single-device engine (tests/test_parallel.py).
    """

    def __init__(self, store, mesh: Mesh | None = None, strategy: str = "position"):
        self.store = store
        self.mesh = mesh if mesh is not None else make_mesh()
        self.strategy = strategy
        self.n_docs = store.n_docs

    def _window_rows(self, windows: list[tuple[str, int, int]], k: int):
        """Candidate row range (lo, hi) per (record, qs, qe) window."""
        st = self.store
        rows = []
        for record, qs, qe in windows:
            lo, hi = st.window_bounds(record, qs, qe, k)
            r = st.record_index(record)
            rec_end = int(st.rec_offsets[r + 1])
            hi = min(hi, rec_end)  # rows past the record are another record's space
            rows.append((lo, hi))
        return rows

    def _gather(self, rows: list[tuple[int, int]], M: int):
        """Padded [W, M] candidate arrays for pre-computed row ranges."""
        st = self.store
        W = len(rows)
        starts = np.zeros((W, M), np.int32)
        ends = np.zeros((W, M), np.int32)
        orders = np.full((W, M), -1, np.int32)  # order<0 rows are dropped
        for i, (lo, hi) in enumerate(rows):
            m = hi - lo
            starts[i, :m] = st.start[lo:hi]
            ends[i, :m] = st.end[lo:hi]
            orders[i, :m] = st.order[lo:hi]
        return starts, ends, orders

    def _run(self, windows, k: int, membership: bool):
        if not windows:
            return []
        lens = [qe - qs for _, qs, qe in windows]
        n_sp = self.mesh.shape["sp"]
        dp = self.mesh.shape["dp"]
        L = _round_up(max(max(lens), 1), n_sp)
        rows = self._window_rows(windows, k)
        # Bucket windows by next-pow2 candidate count: one dense window no
        # longer inflates every window's padding to the batch max (host
        # memory and transfer stay O(sum m_i), not O(W * max m_i)), while
        # pow2 bucketing keeps the set of compiled (W, M) shapes bounded.
        buckets: dict[int, list[int]] = {}
        for i, (lo, hi) in enumerate(rows):
            M = _round_up(max(_next_pow2(hi - lo), n_sp), n_sp)
            buckets.setdefault(M, []).append(i)
        fn = membership_batch if membership else conservation_batch
        results: list[np.ndarray | None] = [None] * len(windows)
        for M, idxs in sorted(buckets.items()):
            W = _round_up(len(idxs), dp)
            sel = idxs + [idxs[0]] * (W - len(idxs))  # pad with a repeat row
            starts, ends, orders = self._gather([rows[i] for i in sel], M)
            qs = np.asarray([windows[i][1] for i in sel], np.int32)
            out = np.asarray(
                fn(
                    self.mesh,
                    starts,
                    ends,
                    orders,
                    qs,
                    k,
                    L=L,
                    n_docs=self.n_docs,
                    strategy=self.strategy,
                )
            )
            for j, i in enumerate(idxs):
                results[i] = out[j, : lens[i]]
        return results

    def conservation(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int32 conservation arrays (reference memo_query.py:70)."""
        return self._run(windows, k, membership=False)

    def membership(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int8 [len, n] presence matrices (memo_query.py:67-68)."""
        return self._run(windows, k, membership=True)
