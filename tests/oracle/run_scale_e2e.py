#!/usr/bin/env python3
"""Chromosome/HPRC-scale end-to-end artifact runs: synthesize a pivot
chromosome + (n_docs-1) documents at ~1% divergence as real FASTA files, run
the FULL index pipeline (memo_tpu.index.builder.build_index — partitioned
SA-IS matching statistics, vectorized order-MEM overlap extraction, sorted
interval store), then time conservation queries on the default device plus
the text-format and view-binning stages. Writes the JSON artifact to stdout;
run from the repo root:

    python tests/oracle/run_scale_e2e.py [pivot_mbp] [n_docs] > SCALE_e2e.json

Two BASELINE.md configs:
- whole-chromosome: pivot_mbp=128 n_docs=5 (~45 min on the 2-core dev VM)
- HPRC HLA-like width: pivot_mbp=5 n_docs=90 — exercises order-sort at
  C=89 and the kernel's C_pad=128 boundary on BUILT (not synthetic) data.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import tempfile
import time

import numpy as np


def write_genome(path: str, name: str, seq_codes: np.ndarray, lut: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(lut[seq_codes].tobytes())
        fh.write(b"\n")


def main() -> int:
    pivot_mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n_docs_total = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    P = pivot_mbp * 1000 * 1000
    rng = np.random.default_rng(20260820)
    lut = np.frombuffer(b"ACGT", np.uint8)

    from memo_tpu.index.builder import BuildConfig, build_index

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        base = rng.integers(0, 4, P, dtype=np.uint8)
        write_genome(os.path.join(td, "pivot.fa"), "chr1", base, lut)
        for j in range(n_docs_total - 1):
            mut = base.copy()
            flips = rng.random(P) < 0.01
            mut[flips] = rng.integers(0, 4, int(flips.sum()), dtype=np.uint8)
            write_genome(os.path.join(td, f"g{j+2}.fa"), "chr1", mut, lut)
        del base, mut, flips
        glist = os.path.join(td, "genomes.txt")
        with open(glist, "w") as fh:
            fh.write("pivot.fa\n" + "".join(f"g{j+2}.fa\n" for j in range(n_docs_total - 1)))

        t0 = time.perf_counter()
        store = build_index(
            glist,
            BuildConfig(kind="conservation", backend="sa", workdir=None, jobs=2),
        )
        build_s = time.perf_counter() - t0

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    import jax

    from memo_tpu.query.engine import QueryEngine

    sync = jax.block_until_ready

    engine = QueryEngine(
        store,
        backend="auto",
        chunk_positions=1 << 21,
        max_intervals_per_chunk=1 << 25,
        device_output=True,
    )
    k = 31
    win = 1 << 21
    # 8 windows spread across the chromosome
    starts = np.linspace(0, P - win, 8).astype(np.int64)
    for qs in starts[:2]:
        sync(engine.conservation("chr1", int(qs), int(qs) + win, k))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        for qs in starts[:-1]:
            engine.conservation("chr1", int(qs), int(qs) + win, k)
        sync(engine.conservation("chr1", int(starts[-1]), int(starts[-1]) + win, k))
        best = min(best, time.perf_counter() - t0)
    q_mbp_s = len(starts) * win / best / 1e6
    outs = [engine.conservation("chr1", int(qs), int(qs) + win, k) for qs in starts]

    # exactness spot check vs the independent numpy diff-array path
    sub_qs = int(starts[3])
    got = np.asarray(engine.conservation("chr1", sub_qs, sub_qs + (1 << 16), k))
    want = QueryEngine(store, backend="numpy").conservation(
        "chr1", sub_qs, sub_qs + (1 << 16), k
    )

    # Text formatting + binned view over one full window (the reference's
    # print_res and plot_conservation stages, BASELINE "binned view" config).
    from memo_tpu.query.output import format_conservation
    from memo_tpu.view.plot import save_conservation_plot

    full = np.asarray(outs[0])
    t0 = time.perf_counter()
    cons_bytes = format_conservation(full)
    fmt_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td2:
        cpath = os.path.join(td2, "cons.txt")
        with open(cpath, "wb") as fh:
            fh.write(cons_bytes)
        t0 = time.perf_counter()
        save_conservation_plot(
            cpath, os.path.join(td2, "v.png"), n_docs_total, 500, 100
        )
        view_s = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "config": "whole-chromosome index, end to end",
                "pivot_mbp": pivot_mbp,
                "n_docs": n_docs_total,
                "divergence": 0.01,
                "index_build_s": round(build_s, 1),
                "build_mbp_s_per_doc": round(
                    (n_docs_total - 1) * pivot_mbp / build_s, 3
                ),
                "intervals": store.num_intervals,
                "store_mb": round(store.stats()["bytes"] / 1e6, 1),
                "peak_rss_gb": round(peak_gb, 2),
                "query_device": jax.devices()[0].platform,
                "query_k31_mbp_s": round(q_mbp_s, 1),
                "query_exact_vs_numpy": bool(np.array_equal(got, want)),
                "format_mbp_s": round(win / fmt_s / 1e6, 1),
                "view_500bins_s": round(view_s, 2),
                "wall_s": round(time.perf_counter() - t_all, 1),
                "host_cores": os.cpu_count(),
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
