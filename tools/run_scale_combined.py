#!/usr/bin/env python3
"""Combined chromosome-width x pangenome-width end-to-end run: a 128 Mbp
pivot chromosome against 89
synthesized haplotypes of the SAME width, full FASTA -> pooled-GSA build ->
device query pipeline — the shape of the reference's HPRC whole-locus figure
(reference README.md:74-77) at whole-chromosome scale.

Divergence defaults to 0.1% — the human haplotype SNP rate the HPRC
pangenome actually exhibits (~1 variant per kbp); 1% would yield ~23 overlap
intervals per position at C=90 order columns and a store of >80 GB at
128 Mbp — realistic divergence is what makes the combined scale a
single-card-servable index (~2 intervals/position).

Stages and their streaming design:
- build: memo_tpu.index.builder.build_index (pooled colored-GSA MS,
  budget-partitioned; the row-major DAP never materializes — the store is
  extracted from per-document columns in carry-chunked row blocks,
  builder.store_from_doc_columns).
- query: 8x 2 Mbp conservation windows at k=31 on the default device (the
  XLA path), exactness spot-checked against the independent numpy engine
  path.
- resident row: a coordinate slice of the store is served by the
  device-resident sharded strategy on the virtual 8-device CPU mesh in a
  subprocess (platforms cannot mix in-process).

    PYTHONPATH=. python tools/run_scale_combined.py \
        [pivot_mbp] [n_docs] [divergence] > scale.json
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np


def write_genome(path: str, name: str, seq_codes: np.ndarray, lut: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(lut[seq_codes].tobytes())
        fh.write(b"\n")


def resident_child(store_path: str) -> int:
    """CPU-mesh child: serve the sub-store with the resident strategy."""
    import jax

    from memo_tpu.index.store import IntervalStore
    from memo_tpu.parallel import ResidentShardedQuery, make_mesh
    from memo_tpu.query.engine import QueryEngine

    store = IntervalStore.load(store_path)
    mesh = make_mesh(dp=1, sp=len(jax.devices()))
    rq = ResidentShardedQuery(store, mesh, k_max=128, device_output=True)
    L = int(store.record_lens[0])
    t0 = time.perf_counter()
    out = rq.conservation_full(31)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    sub = (L // 3, L // 3 + (1 << 15))
    got = np.asarray(out)[sub[0] : sub[1]]
    want = QueryEngine(store, backend="numpy").conservation(
        store.record_names[0], sub[0], sub[1], 31
    )
    print(
        json.dumps(
            {
                "devices": len(jax.devices()),
                "slab_mbp": round(L / 1e6, 1),
                "full_record_dispatch_s": round(dt, 2),
                "mbp_s": round(L / dt / 1e6, 2),
                "exact_subwindow": bool(np.array_equal(got, want)),
            }
        )
    )
    return 0


def main() -> int:
    if "--resident-child" in sys.argv:
        return resident_child(sys.argv[sys.argv.index("--resident-child") + 1])
    pivot_mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n_docs_total = int(sys.argv[2]) if len(sys.argv) > 2 else 90
    divergence = float(sys.argv[3]) if len(sys.argv) > 3 else 0.001
    P = pivot_mbp * 1000 * 1000
    rng = np.random.default_rng(20260821)
    lut = np.frombuffer(b"ACGT", np.uint8)

    from memo_tpu.index.builder import BuildConfig, build_index

    t_all = time.perf_counter()
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        base = rng.integers(0, 4, P, dtype=np.uint8)
        write_genome(os.path.join(td, "pivot.fa"), "chr1", base, lut)
        n_flip = int(P * divergence)
        for j in range(n_docs_total - 1):
            mut = base.copy()
            flips = rng.choice(P, n_flip, replace=False)
            mut[flips] = rng.integers(0, 4, n_flip, dtype=np.uint8)
            write_genome(os.path.join(td, f"g{j+2}.fa"), "chr1", mut, lut)
        del base, mut, flips
        glist = os.path.join(td, "genomes.txt")
        with open(glist, "w") as fh:
            fh.write("pivot.fa\n" + "".join(f"g{j+2}.fa\n" for j in range(n_docs_total - 1)))
        gen_s = time.perf_counter() - t0
        log(f"[combined] FASTA generation: {gen_s:.0f}s")

        t0 = time.perf_counter()
        store = build_index(
            glist,
            BuildConfig(
                kind="conservation",
                backend="sa",
                workdir=None,
                jobs=2,
                pooled=True,
                ms_budget_bytes=16 << 30,
            ),
        )
        build_s = time.perf_counter() - t0
        log(f"[combined] build: {build_s:.0f}s, {store.num_intervals} intervals")

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    import jax

    from memo_tpu.query.engine import QueryEngine
    from memo_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    k = 31
    win = 1 << 21
    starts = np.linspace(0, P - win, 8).astype(np.int64)
    engine = QueryEngine(
        store,
        chunk_positions=1 << 21,
        max_intervals_per_chunk=1 << 25,
        device_output=True,
    )
    for qs in starts[:2]:
        jax.block_until_ready(engine.conservation("chr1", int(qs), int(qs) + win, k))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [
            engine.conservation("chr1", int(qs), int(qs) + win, k) for qs in starts
        ]
        jax.block_until_ready(outs)
        best = min(best, time.perf_counter() - t0)
    q_mbp_s = len(starts) * win / best / 1e6
    log(f"[combined] query: {q_mbp_s:.0f} Mbp/s on {jax.devices()[0].platform}")

    # Exactness spot checks vs the independent numpy diff-array path.
    exact = True
    for qs in (int(starts[2]), int(starts[6]) + 12345):
        got = np.asarray(engine.conservation("chr1", qs, qs + (1 << 16), k))
        want = QueryEngine(store, backend="numpy").conservation(
            "chr1", qs, qs + (1 << 16), k
        )
        exact = exact and bool(np.array_equal(got, want))

    # Resident virtual-mesh row over a 16 Mbp coordinate slice (a full-record
    # resident diff plane at 128 Mbp x 91 columns would be ~46 GB on the CPU
    # mesh host; the slice keeps the proof — placement, slab shard math,
    # whole-record dispatch, exactness — at a host-feasible size). The slice
    # is closed under query influence: rows with start < 16M + k_max.
    slab = 16 * 1000 * 1000
    lo, hi = store.window_bounds("chr1", 0, slab, 128)
    from memo_tpu.index.store import IntervalStore

    sub = IntervalStore(
        record_names=["chr1"],
        record_lens=[slab],
        n_docs=store.n_docs,
        kind=store.kind,
        rec_id=store.rec_id[lo:hi],
        start=store.start[lo:hi],
        end=store.end[lo:hi],
        order=store.order[lo:hi],
    )
    resident = {"error": "not run"}
    with tempfile.TemporaryDirectory() as td2:
        sp = os.path.join(td2, "sub.npz")
        sub.save(sp)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--resident-child", sp],
                capture_output=True,
                text=True,
                env=env,
                timeout=1800,
            )
            resident = json.loads(proc.stdout.strip().splitlines()[-1])
        except Exception as e:
            resident = {"error": f"{type(e).__name__}: {e}"}

    print(
        json.dumps(
            {
                "config": "combined chromosome x pangenome width, end to end",
                "pivot_mbp": pivot_mbp,
                "n_docs": n_docs_total,
                "divergence": divergence,
                "fasta_gen_s": round(gen_s, 1),
                "index_build_s": round(build_s, 1),
                "build_mbp_s_per_doc": round((n_docs_total - 1) * pivot_mbp / build_s, 3),
                "intervals": store.num_intervals,
                "store_gb": round(store.stats()["bytes"] / 1e9, 2),
                "peak_rss_gb": round(peak_gb, 2),
                "query_device": jax.devices()[0].platform,
                "query_device_kind": jax.devices()[0].device_kind,
                "query_backend": engine.backend,
                "query_k31_mbp_s": round(q_mbp_s, 1),
                "exact": exact,
                "resident_virtual_mesh_16mbp_slice": resident,
                "wall_s": round(time.perf_counter() - t_all, 1),
                "host_cores": os.cpu_count(),
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
