#!/usr/bin/env python3
"""Smoke test of memo's index -> query path on the GPU.

    python chip_smoke.py               # one card: example, pangenome, hprc_width
    python chip_smoke.py --four-cards  # four cards, one process: sharded paths

Every phase drives the CLI in this process (``memo_tpu.cli.main``; one JAX
process per card) and fails unless JAX's default backend is the GPU. The
phases:

- ``example``: index -> query on tests/data/example at k=3, conservation
  and membership, on the device and on the host numpy backend; the output
  files must be byte-identical.
- ``pangenome``: a seeded 16 x 1 Mbp pangenome (1% substitutions per
  genome) indexed on the host; a 1 Mbp conservation window at k=31, a
  100 kbp membership window and an 8-window ``--regions-file`` batch, each
  byte-identical to the numpy backend.
- ``hprc_width``: a 90-document x 2 Mbp store (~75M intervals) saved as
  .npz and queried over the whole record at k in {21, 31, 51, 101} with the
  engine's default sizes, checked against the reference slice-write loop
  on two 32 kbp sub-windows per k; a 256 kbp membership window against the
  numpy backend.
- ``four_cards`` (only with ``--four-cards``): the same store on four
  cards — the resident store on a 1x4 and a 2x2 mesh (two records), the
  position and interval strategies, and a ``--regions-file --mesh 1,4``
  batch — each compared with the single-device engine and the numpy oracle.

Every comparison is exact, with tolerance 0: the device arithmetic on this
path is int32 scatter-add, cumsum, compare and min. There is no matrix
product, so TF32 never enters.

The last line of stdout is one JSON object, ``{"ok": true, "device": ...}``,
printed only when every phase passed; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 31


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def require_platform(platform: str) -> None:
    import jax

    got = jax.default_backend()
    if got != platform:
        raise SystemExit(f"chip_smoke: JAX's default backend is {got!r}, need {platform!r}")


def cli(*args) -> None:
    from memo_tpu.cli import main

    rc = main([str(a) for a in args])
    check(rc == 0, f"memo {' '.join(map(str, args))} returned {rc}")


def same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        check(fa.read() == fb.read(), f"{a} != {b}")


def query_both(index: str, region: str, k: int, out: str, *extra) -> None:
    """One region on the device and on the numpy backend; identical bytes."""
    for backend in ("jax", "numpy"):
        cli("query", "-b", index, "-k", k, "-r", region, "-o", f"{out}.{backend}.txt",
            "--backend", backend, *extra)
    same_bytes(f"{out}.jax.txt", f"{out}.numpy.txt")


def sizes(n_docs: int) -> dict:
    from memo_tpu.utils.device import describe_device, query_sizes

    chunk, rows = query_sizes(describe_device(), n_docs)
    return {"n_docs": n_docs, "chunk_positions": chunk, "max_intervals_per_chunk": rows}


def write_pangenome(work: str, n_genomes: int, length: int, seed: int) -> str:
    """Seeded genomes: a random pivot and copies with 1% substitutions."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, length, dtype=np.uint8)
    names = []
    for j in range(n_genomes):
        seq = base
        if j:
            seq = base.copy()
            flips = rng.random(length) < 0.01
            seq[flips] = rng.integers(0, 4, int(flips.sum()), dtype=np.uint8)
        names.append(f"g{j}.fa")
        with open(os.path.join(work, names[-1]), "wb") as fh:
            fh.write(b">chr1\n" + lut[seq].tobytes() + b"\n")
    glist = os.path.join(work, "genomes.txt")
    with open(glist, "w") as fh:
        fh.write("".join(n + "\n" for n in names))
    return glist


def synth_store(n_docs: int, length: int, seed: int, kind: str = "conservation", ms=None):
    """The bench's HPRC-density store (bench.synth_ms, gap=25)."""
    import bench
    from memo_tpu.index.builder import store_from_ms

    if ms is None:
        ms = bench.synth_ms(np.random.default_rng(seed), length, n_docs - 1, K, gap=25)
    return store_from_ms([ms], ["chr1"], [length], n_docs, kind), ms


def sub_windows(length: int) -> list[tuple[int, int]]:
    """Two reference-checked sub-windows: one inside, one at the record tail."""
    sub = min(1 << 15, length // 8)
    return [(length // 4, length // 4 + sub), (length - sub - 7, length - 7)]


# ----------------------------------------------------------------- phases
def phase_example(work: str) -> dict:
    src = os.path.join(REPO, "tests", "data", "example", "genome_list.txt")
    cli("index", "-g", src, "-o", work, "-p", "cons")
    cli("index", "-g", src, "-o", work, "-p", "memb", "-m")
    query_both(os.path.join(work, "cons.npz"), "piv_1:0-70", 3, os.path.join(work, "c"))
    query_both(os.path.join(work, "memb.npz"), "piv_1:0-70", 3, os.path.join(work, "m"), "-m")
    return sizes(5)


def phase_pangenome(work: str, n_genomes: int = 16, length: int = 1_000_000) -> dict:
    from memo_tpu.cli import pick_batch_strategy
    from memo_tpu.index.store import IntervalStore

    glist = write_pangenome(work, n_genomes, length, seed=16)
    jobs = min(os.cpu_count() or 1, 8)
    cli("index", "-g", glist, "-o", work, "-p", "cons", "--jobs", jobs)
    cli("index", "-g", glist, "-o", work, "-p", "memb", "-m", "--jobs", jobs)
    cons = os.path.join(work, "cons.npz")
    query_both(cons, f"chr1:0-{length}", K, os.path.join(work, "c"))
    mlo = length // 2 - length // 20
    query_both(os.path.join(work, "memb.npz"), f"chr1:{mlo}-{mlo + length // 10}", K,
               os.path.join(work, "m"), "-m")

    rng = np.random.default_rng(8)
    regions = []
    for _ in range(8):
        w = int(rng.integers(length // 200, length // 16))
        qs = int(rng.integers(0, length - w))
        regions.append(("chr1", qs, qs + w))
    rfile = os.path.join(work, "regions.txt")
    with open(rfile, "w") as fh:
        fh.write("".join(f"{r}:{a}-{b}\n" for r, a, b in regions))
    prefix = os.path.join(work, "batch")
    cli("query", "-b", cons, "-k", K, "--regions-file", rfile, "-o", prefix)
    for r, a, b in regions:
        want = os.path.join(work, f"want_{a}_{b}.txt")
        cli("query", "-b", cons, "-k", K, "-r", f"{r}:{a}-{b}", "-o", want, "--backend", "numpy")
        same_bytes(f"{prefix}.{r}_{a}_{b}.txt", want)
    store = IntervalStore.load(cons)
    return {
        **sizes(n_genomes),
        "intervals": store.num_intervals,
        "batch_strategy": pick_batch_strategy(store, regions),
    }


def phase_hprc_width(work: str, n_docs: int = 90, length: int = 2 << 20) -> dict:
    import bench

    store, ms = synth_store(n_docs, length, seed=90)
    cons = os.path.join(work, "hprc.npz")
    store.save(cons)
    for k in (21, 31, 51, 101):
        out = os.path.join(work, f"hprc_k{k}.txt")
        cli("query", "-b", cons, "-k", k, "-r", f"chr1:0-{length}", "-o", out)
        got = np.loadtxt(out, dtype=np.int64)
        check(got.shape == (length,), f"k={k}: {got.shape} values for {length} positions")
        for a, b in sub_windows(length):
            want = bench.reference_query_np(store, a, b, k)
            check(np.array_equal(got[a:b], want), f"k={k}: {a}-{b} differs from the reference loop")
    memb_store, _ = synth_store(n_docs, length, seed=90, kind="membership", ms=ms)
    memb = os.path.join(work, "hprc_memb.npz")
    memb_store.save(memb)
    mlo = length // 3
    query_both(memb, f"chr1:{mlo}-{mlo + min(1 << 18, length // 4)}", K,
               os.path.join(work, "hm"), "-m")
    return {
        **sizes(n_docs),
        "intervals": store.num_intervals,
        "int32_rows_mb": round(store.num_intervals * 12 / 1e6, 1),
    }


def phase_four_cards(work: str, devices, n_docs: int = 90, length: int = 2 << 20) -> dict:
    from memo_tpu.index.builder import store_from_ms
    from memo_tpu.parallel import ResidentShardedQuery, ShardedQuery, make_mesh
    from memo_tpu.query.engine import QueryEngine

    check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    store, ms = synth_store(n_docs, length, seed=90)
    engine = QueryEngine(store)
    oracle = QueryEngine(store, backend="numpy")

    def on_all_cards(arr, what):
        held = {s.device for s in arr.addressable_shards}
        check(held == set(devices), f"{what}: shards on {len(held)} of 4 devices")

    def rows_on_all_cards(rq, what):
        on_all_cards(rq._d_order, what)
        rows = [int((np.asarray(s.data) >= 0).sum()) for s in rq._d_order.addressable_shards]
        check(min(rows) > 0, f"{what}: a device holds no rows ({rows})")

    def exact(got, want, what):
        check(np.array_equal(np.asarray(got), np.asarray(want)), what)

    # Resident coordinate-sharded store, one record over four cards.
    rq = ResidentShardedQuery(store, make_mesh(dp=1, sp=4, devices=devices), k_max=128)
    rows_on_all_cards(rq, "resident 1x4 placement")
    for k in (31, 101):
        on_all_cards(rq._full(k, membership=False), f"resident 1x4 output k={k}")
        got = rq.conservation(0, length, k)
        exact(got, engine.conservation("chr1", 0, length, k), f"resident 1x4 k={k} vs engine")
        for a, b in sub_windows(length):
            exact(got[a:b], oracle.conservation("chr1", a, b, k), f"resident 1x4 k={k} {a}-{b}")

    # Two records on a 2x2 mesh: records ride dp, positions ride sp.
    la, lb = length // 4, length // 8
    idx = np.arange(la + lb, dtype=np.int64)[:, None]
    ms_a = np.minimum(ms[:la], la - idx[:la])
    ms_b = np.minimum(ms[la : la + lb], lb - idx[:lb])
    store2 = store_from_ms([ms_a, ms_b], ["chrA", "chrB"], [la, lb], n_docs, "conservation")
    rq2 = ResidentShardedQuery(
        store2, make_mesh(dp=2, sp=2, devices=devices), records=["chrA", "chrB"], k_max=128
    )
    rows_on_all_cards(rq2, "resident 2x2 placement")
    engine2 = QueryEngine(store2)
    oracle2 = QueryEngine(store2, backend="numpy")
    for rec, ln in (("chrA", la), ("chrB", lb)):
        got = rq2.conservation(0, ln, K, record=rec)
        exact(got, engine2.conservation(rec, 0, ln, K), f"resident 2x2 {rec} vs engine")
        a, b = sub_windows(ln)[1]
        exact(got[a:b], oracle2.conservation(rec, a, b, K), f"resident 2x2 {rec} {a}-{b}")
    check(rq2.dispatch_count == 1, "two records must share one dispatch")

    # Host-gather strategies: replicated rows (position) and the NCCL
    # psum_scatter of partial counts (interval).
    win = length // 16
    windows = [("chr1", s, s + win) for s in (0, length // 3, length - win)]
    mesh = make_mesh(dp=1, sp=4, devices=devices)
    for strategy in ("position", "interval"):
        got = ShardedQuery(store, mesh, strategy=strategy).conservation(windows, K)
        for (rec, a, b), g in zip(windows, got):
            exact(g, engine.conservation(rec, a, b, K), f"{strategy} {a}-{b} vs engine")
        a, b = sub_windows(win)[0]
        exact(got[0][a:b], oracle.conservation("chr1", a, b, K), f"{strategy} {a}-{b}")

    # The CLI's regions-file batch on the 1x4 mesh.
    cons = os.path.join(work, "hprc.npz")
    store.save(cons)
    regions = [("chr1", s, s + win // 4) for s in (7, length // 2, length - win // 4)]
    rfile = os.path.join(work, "regions.txt")
    with open(rfile, "w") as fh:
        fh.write("".join(f"{r}:{a}-{b}\n" for r, a, b in regions))
    prefix = os.path.join(work, "mesh")
    cli("query", "-b", cons, "-k", K, "--regions-file", rfile, "--mesh", "1,4", "-o", prefix)
    for r, a, b in regions:
        want = os.path.join(work, f"want_{a}_{b}.txt")
        cli("query", "-b", cons, "-k", K, "-r", f"{r}:{a}-{b}", "-o", want, "--backend", "numpy")
        same_bytes(f"{prefix}.{r}_{a}_{b}.txt", want)
    return {
        "n_docs": n_docs,
        "intervals": store.num_intervals,
        "resident_rows_per_shard": rq.rows_per_shard,
        "devices": [str(d) for d in devices],
    }


def run_phase(name: str, fn, platform: str, *args) -> None:
    require_platform(platform)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        info = fn(work, *args)
    print(f"phase {name}: wall_s={time.perf_counter() - t0:.3f} {json.dumps(info)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true", help="run only the four-card phase")
    args = ap.parse_args(argv)

    require_platform("gpu")
    import jax

    from memo_tpu.utils.device import (
        card_name_and_power_limit,
        describe_device,
        enable_compile_cache,
    )

    enable_compile_cache()
    print(f"device: {describe_device()}", flush=True)
    print(card_name_and_power_limit(), flush=True)
    if args.four_cards:
        run_phase("four_cards", phase_four_cards, "gpu", jax.devices())
    else:
        run_phase("example", phase_example, "gpu")
        run_phase("pangenome", phase_pangenome, "gpu")
        run_phase("hprc_width", phase_hprc_width, "gpu")
    d = jax.devices()[0]
    # The card's name and power limit as nvidia-smi prints them, just
    # before the result line.
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(jax.devices())}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
