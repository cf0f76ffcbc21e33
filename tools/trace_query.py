#!/usr/bin/env python3
"""Where the time of one ``memo query`` goes on the card.

For each store shape — the bench's headline store (16 documents, 2 Mbp,
``bench.build_store``) and its 90-document large store
(``bench.build_large_store``) — this saves the store as .npz and runs
``memo query -r chr1:0-<len> -k 31`` three times in this process: once to
compile, once timed (the end-to-end wall: load, upload, query, format,
write), and once with ``--profile``. The trace is reduced to the device
time of the XLA programs the query ran, their share of the timed wall, the
busiest kernels, and the bytes XLA's cost analysis gives for the compiled
coverage programs, against the card's HBM peak. The same steps the CLI
takes are then timed one by one on the host clock.

    python tools/trace_query.py [--out DIR]

The summary goes to stdout as JSON lines; ``DIR/<shape>.json`` keeps the
per-line and per-kernel totals of each trace (the raw traces are dropped).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K = 31


def union_ns(spans: list[tuple[int, int]]) -> int:
    """Length of the union of [start, end) spans."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(trace_dir: str) -> dict:
    """Device planes of the newest trace under ``trace_dir``: busy time
    (union of the stream events), per-line and per-kernel totals."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    lines: dict[str, float] = {}
    kernels: dict[str, float] = {}
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            key = f"{plane.name} {line.name}"
            for ev in line.events:
                dur = int(ev.duration_ns)
                lines[key] = lines.get(key, 0.0) + dur / 1e6
                if line.name.startswith("Stream"):
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + dur / 1e6
                    spans.append((int(ev.start_ns), int(ev.start_ns) + dur))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])
    return {
        "trace": path,
        "kernel_busy_ms": union_ns(spans) / 1e6,
        "lines_ms": lines,
        "top_kernels_ms": top,
    }


def coverage_bytes(store, length: int) -> dict:
    """XLA's bytes for the compiled coverage programs one whole-record query
    dispatches at k=31, and the compulsory bytes (candidate rows in, int32
    output out)."""
    import jax
    import jax.numpy as jnp

    from memo_tpu.query.engine import QueryEngine, _device_query_fn, _next_pow2

    engine = QueryEngine(store)
    parts = [(0, engine)] if engine._children is None else engine._children
    xla, rows = 0, 0
    for lb, eng in parts:
        if lb >= K - 1:
            continue
        for qs in range(0, length, eng.chunk_positions):
            L = min(eng.chunk_positions, length - qs)
            lo, hi = eng.store.window_bounds("chr1", qs, qs + L, K)
            M = min(_next_pow2(max(hi - lo, 1)), eng.max_intervals)
            arr = jax.ShapeDtypeStruct(eng._d_start.shape, jnp.int32)
            scalar = jax.ShapeDtypeStruct((), jnp.int32)
            fn = _device_query_fn(M, L, store.n_docs, False)
            cost = fn.lower(arr, arr, arr, scalar, scalar, scalar, scalar).compile().cost_analysis()
            if isinstance(cost, (list, tuple)):
                cost = cost[0]
            xla += int(cost["bytes accessed"])
            rows += hi - lo
    return {
        "xla_cost_analysis_bytes": xla,
        "compulsory_bytes": 12 * rows + 4 * length,
        "chunk_positions": engine.chunk_positions,
        "max_intervals_per_chunk": engine.max_intervals,
        "stratified": engine._children is not None,
    }


def host_breakdown(npz: str, length: int, out: str) -> dict:
    """Seconds of each step ``memo query -r`` takes (cli.cmd_query): .npz
    load, engine set-up (stratification and upload), the query with its
    download, and text formatting with the write."""
    import jax

    from memo_tpu.index.store import IntervalStore
    from memo_tpu.query.engine import QueryEngine
    from memo_tpu.query.output import write_conservation

    steps = {}
    t0 = time.perf_counter()
    store = IntervalStore.load(npz)
    steps["load_npz_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = QueryEngine(store)
    jax.block_until_ready([c._d_order for _, c in engine._children or [(0, engine)]])
    steps["engine_init_upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = engine.conservation("chr1", 0, length, K)
    steps["query_and_download_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_conservation(res, out)
    steps["format_write_s"] = time.perf_counter() - t0
    return steps


def profile_shape(name: str, store, work: str, out_dir: str) -> dict:
    import jax

    import bench
    from memo_tpu.cli import main

    length = int(store.record_lens[0])
    npz = os.path.join(work, f"{name}.npz")
    store.save(npz)
    args = ["query", "-b", npz, "-k", str(K), "-r", f"chr1:0-{length}",
            "-o", os.path.join(work, f"{name}.txt")]
    t0 = time.perf_counter()
    main(args)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    main(args)
    wall = time.perf_counter() - t0
    trace_dir = os.path.join(work, f"trace_{name}")
    main(args + ["--profile", trace_dir])
    tr = reduce_trace(trace_dir)
    cov = coverage_bytes(store, length)
    host = host_breakdown(npz, length, os.path.join(work, f"{name}.host.txt"))
    peak = bench.hbm_peak(jax.devices()[0].device_kind)
    busy_s = tr["kernel_busy_ms"] / 1e3
    summary = {
        "shape": name,
        "n_docs": store.n_docs,
        "positions": length,
        "intervals": store.num_intervals,
        "first_query_wall_s": first,
        "query_wall_s": wall,
        "device_kernel_busy_s": busy_s,
        "device_share_of_wall": busy_s / wall,
        "host_steps": host,
        "top_kernels_ms": tr["top_kernels_ms"],
        **cov,
        "xla_bytes_per_busy_s": cov["xla_cost_analysis_bytes"] / busy_s if busy_s else None,
        "hbm_peak_bytes_s": peak,
    }
    with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
        json.dump({**summary, "lines_ms": tr["lines_ms"]}, fh, indent=1)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "trace_query"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import bench
    from memo_tpu.utils.device import (
        card_name_and_power_limit,
        describe_device,
        enable_compile_cache,
    )

    enable_compile_cache()
    print(json.dumps({"device": str(describe_device()), "card": card_name_and_power_limit()}))
    with tempfile.TemporaryDirectory() as work:
        for name, build in (("headline", bench.build_store), ("large", bench.build_large_store)):
            store = build(np.random.default_rng(12345))
            print(json.dumps(profile_shape(name, store, work, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
