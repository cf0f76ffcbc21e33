"""Seeded interval stores built from random matching-statistics columns,
shared by the store and engine test matrices."""

import numpy as np

from memo_tpu.index.builder import store_from_ms


def lipschitz(ms: np.ndarray) -> np.ndarray:
    """Make random MS columns satisfy ms[p] <= ms[p+1] + 1 — a match starting
    at p implies one of length-1 shorter at p+1, so true matching statistics
    never drop by more than 1. out[p] = min_{q>=p} (ms[q] + q) - p."""
    P = ms.shape[0]
    key = ms.astype(np.int64) + np.arange(P)[:, None]
    suffix_min = np.minimum.accumulate(key[::-1])[::-1]
    return (suffix_min - np.arange(P)[:, None]).astype(np.int32)


def random_store(rng, monotone, kind="conservation", n_records=2, n_docs=6, rec_len=700):
    ms = [
        rng.integers(0, 50, size=(rec_len, n_docs - 1)).astype(np.int32)
        for _ in range(n_records)
    ]
    if monotone:
        ms = [lipschitz(m) for m in ms]
    names = [f"chr{i}" for i in range(n_records)]
    return store_from_ms(ms, names, [rec_len] * n_records, n_docs, kind)
