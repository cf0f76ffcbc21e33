"""Dense device formulation of the MEMO query.

The reference's hot kernel is a ragged per-interval slice write
(reference memo_query.py:57-63, numba):

    for start, casted_end, order in mem_arr:
        rec[casted_end:start, order] = set_bit

a ragged write of data-dependent length. The device formulation turns it
into a difference array + prefix sum, fully dense and static-shaped:

    coverage[p, c] = #{intervals i: order_i == c and ce_i <= p < st_i}
                   = cumsum_p( +1 at ce_i, -1 at st_i )
    marked = coverage > 0        # "k-mer at p absent from column c"

Semantics proven equal to the reference's loop: a position p in window
[qs, qe) is marked for column c iff some stored interval of column c
satisfies end - (k-1) <= p + qs < start — shadow casting is pure arithmetic
on the stored arrays (memo_query.py:46-49), so any k reuses one index.
Out-of-window intervals clip to empty and become no-ops, which lets the
caller pass a padded SUPERSET of candidate intervals with static shape.

Conservation output = argmax over the first marked column with sentinel n
(memo_query.py:70) == min(marked order, n). Membership = NOT marked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def cast_and_clip(starts, ends, qs, L, k):
    """Recenter to the window, shadow-cast by k-1, clip to [0, L]
    (reference memo_init, memo_query.py:42-49). Returns (st, ce, valid)."""
    st = jnp.clip(starts - qs, 0, L)
    ce = jnp.clip(ends - qs - (k - 1), 0, L)
    return st, ce, ce < st


def coverage_counts(starts, ends, orders, qs, k, *, L: int, C: int) -> jax.Array:
    """int32[L, C] interval-coverage counts for one window.

    ``counts[p, c]`` = number of stored intervals of column c whose shadow-cast
    span covers window position p. Additive over any partition of the interval
    set — the property the interval-sharded multi-device path's ``psum`` relies
    on (memo_tpu/parallel/sharded.py).

    Args:
      starts/ends/orders: int32[M] padded candidate intervals (absolute pivot
        coordinates; padding rows may hold anything outside the window).
      qs: window start (traced scalar); k: k-mer size (traced scalar).
      L: static window length; C: static column count (= n_docs).
    """
    st, ce, valid = cast_and_clip(starts, ends, qs, L, k)
    order = orders.astype(jnp.int32)
    in_range = (order >= 0) & (order < C)
    ok = valid & in_range
    flat_size = (L + 1) * C
    idx_plus = jnp.where(ok, ce * C + order, flat_size)
    idx_minus = jnp.where(ok, st * C + order, flat_size)
    diff = (
        jnp.zeros((flat_size + 1,), jnp.int32)
        .at[idx_plus].add(1, mode="drop")
        .at[idx_minus].add(-1, mode="drop")
    )
    return jnp.cumsum(diff[: L * C].reshape(L, C), axis=0)


@functools.partial(jax.jit, static_argnames=("L", "C"))
def coverage_marks(starts, ends, orders, qs, k, *, L: int, C: int) -> jax.Array:
    """bool[L, C] absence marks for one window (counts > 0)."""
    return coverage_counts(starts, ends, orders, qs, k, L=L, C=C) > 0


def conservation_from_marks(marks: jax.Array, n_docs: int) -> jax.Array:
    """int32[L] conservation values: first marked order, else n
    (== reference argmax with sentinel column, memo_query.py:52-54,70)."""
    L, C = marks.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (L, C), 1)
    vals = jnp.where(marks, cols, jnp.int32(n_docs))
    return jnp.minimum(jnp.min(vals, axis=1), jnp.int32(n_docs))


def membership_from_marks(marks: jax.Array) -> jax.Array:
    """int8[L, C] presence matrix; column 0 (pivot) is always 1
    (memo_query.py:50-51 — orders start at 1)."""
    return (~marks).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("L", "C", "n_docs"))
def conservation_window(starts, ends, orders, qs, k, *, L: int, C: int, n_docs: int):
    return conservation_from_marks(
        coverage_marks(starts, ends, orders, qs, k, L=L, C=C), n_docs
    )


@functools.partial(jax.jit, static_argnames=("L", "C"))
def membership_window(starts, ends, orders, qs, k, *, L: int, C: int):
    return membership_from_marks(coverage_marks(starts, ends, orders, qs, k, L=L, C=C))


# ----------------------------------------------------------------- numpy path
def coverage_marks_np(starts, ends, orders, qs: int, k: int, L: int, C: int) -> np.ndarray:
    """Reference-free numpy twin of :func:`coverage_marks` (CPU fallback and
    cross-check for the device paths)."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    orders = np.asarray(orders, np.int64)
    st = np.clip(starts - qs, 0, L)
    ce = np.clip(ends - qs - (k - 1), 0, L)
    ok = (ce < st) & (orders >= 0) & (orders < C)
    diff = np.zeros((L + 1, C), np.int32)
    np.add.at(diff, (ce[ok], orders[ok]), 1)
    np.add.at(diff, (st[ok], orders[ok]), -1)
    cov = np.cumsum(diff[:L], axis=0)
    return cov > 0


def conservation_np(marks: np.ndarray, n_docs: int) -> np.ndarray:
    L, C = marks.shape
    vals = np.where(marks, np.arange(C, dtype=np.int64)[None, :], n_docs)
    return np.minimum(vals.min(axis=1), n_docs).astype(np.int64)


def membership_np(marks: np.ndarray) -> np.ndarray:
    return (~marks).astype(np.int8)
