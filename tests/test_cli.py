"""End-to-end CLI: index -> query -> view on the in-repo toy pangenome,
exercising the reference's flag contract (memo index|query|view)."""

import numpy as np
import pytest

from memo_tpu.cli import main


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, example_dir_module):
    out = tmp_path_factory.mktemp("idx")
    rc = main(
        [
            "index",
            "-g", str(example_dir_module / "genome_list.txt"),
            "-o", str(out),
            "-p", "test",
            "--ms-backend", "python",
            "--emit-compat",
        ]
    )
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def example_dir_module():
    import pathlib

    d = pathlib.Path(__file__).resolve().parent / "data" / "example"
    assert d.exists()
    return d


def test_index_outputs(built_index):
    assert (built_index / "test.npz").exists()
    assert (built_index / "test.bed").exists()
    assert (built_index / "test.parquet").exists()
    assert (built_index / "dap.txt").exists()
    assert (built_index / "test.manifest.json").exists()


def test_query_conservation(built_index, tmp_path):
    out = tmp_path / "cons.txt"
    rc = main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "-n", "5",
            "-r", "piv_1:0-40",
            "-o", str(out),
            "--backend", "jax",
        ]
    )
    assert rc == 0
    vals = np.loadtxt(out, dtype=int)
    assert vals.shape == (40,)
    assert vals.min() >= 1 and vals.max() <= 5


def test_query_parquet_equals_npz(built_index, tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    for idx, out in [(built_index / "test.npz", a), (built_index / "test.parquet", b)]:
        main(
            [
                "query",
                "-b", str(idx),
                "-k", "4",
                "-n", "5",
                "-r", "piv_1:5-60",
                "-o", str(out),
                "--backend", "numpy",
            ]
        )
    assert a.read_bytes() == b.read_bytes()


def test_membership_query(built_index, tmp_path, example_dir_module):
    # membership needs a membership index
    out_dir = tmp_path / "midx"
    main(
        [
            "index",
            "-g", str(example_dir_module / "genome_list.txt"),
            "-o", str(out_dir),
            "-p", "m",
            "-m",
            "--ms-backend", "python",
        ]
    )
    out = tmp_path / "memb.txt"
    rc = main(
        [
            "query",
            "-b", str(out_dir / "m.npz"),
            "-k", "3",
            "-n", "5",
            "-r", "piv_1:0-20",
            "-o", str(out),
            "-m",
            "--backend", "jax",
        ]
    )
    assert rc == 0
    mat = np.loadtxt(out, dtype=int)
    assert mat.shape == (20, 5)
    assert (mat[:, 0] == 1).all()  # pivot column always 1 (memo_query.py:50-51)
    assert set(np.unique(mat)) <= {0, 1}


def test_view(built_index, tmp_path):
    cons = tmp_path / "cons.txt"
    main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "-n", "5",
            "-r", "piv_1:0-70",
            "-o", str(cons),
            "--backend", "numpy",
        ]
    )
    png = tmp_path / "out.png"
    rc = main(["view", "-i", str(cons), "-o", str(png), "-n", "5", "-b", "4", "-d", "72"])
    assert rc == 0
    assert png.stat().st_size > 1000


def test_ms_cache_resume(built_index, example_dir_module, tmp_path, caplog):
    # second build in the same workdir hits the MS cache (resumable manifest)
    import logging

    rc = main(
        [
            "index",
            "-g", str(example_dir_module / "genome_list.txt"),
            "-o", str(built_index),
            "-p", "test2",
            "--ms-backend", "python",
        ]
    )
    assert rc == 0
    assert (built_index / "test2.npz").exists()
    caches = list(built_index.glob("ms-*.npz"))
    assert len(caches) == 4  # one per non-pivot document


def test_query_regions_file_batch(built_index, tmp_path):
    """--regions-file runs the mesh-parallel batch path and matches -r."""
    regions = tmp_path / "regions.txt"
    regions.write_text("piv_1:0-40\npiv_1:10-30\n")
    prefix = tmp_path / "batch"
    rc = main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "--regions-file", str(regions),
            "--mesh", "2,4",
            "-o", str(prefix),
        ]
    )
    assert rc == 0
    single = tmp_path / "single.txt"
    main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "-r", "piv_1:0-40",
            "-o", str(single),
            "--backend", "numpy",
        ]
    )
    got = (tmp_path / "batch.piv_1_0_40.txt").read_text()
    assert got == single.read_text()
    assert (tmp_path / "batch.piv_1_10_30.txt").exists()


def test_query_regions_file_resident_strategy(built_index, tmp_path):
    """--strategy resident serves the batch from the coordinate-sharded
    device-resident store, byte-identical to the single-device path."""
    regions = tmp_path / "regions.txt"
    regions.write_text("piv_1:0-40\npiv_1:10-30\n")
    prefix = tmp_path / "res"
    rc = main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "--regions-file", str(regions),
            "--mesh", "1,8",
            "--strategy", "resident",
            "-o", str(prefix),
        ]
    )
    assert rc == 0
    single = tmp_path / "s.txt"
    main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "-r", "piv_1:10-30",
            "-o", str(single),
            "--backend", "numpy",
        ]
    )
    assert (tmp_path / "res.piv_1_10_30.txt").read_text() == single.read_text()


def test_query_regions_file_batched_strategy(built_index, tmp_path):
    """--strategy batched answers a record's windows on one device through
    the engine's batch API, byte-identical to the single-device path."""
    regions = tmp_path / "regions.txt"
    regions.write_text("piv_1:0-40\npiv_1:10-30\n")
    prefix = tmp_path / "bat"
    rc = main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "--regions-file", str(regions),
            "--strategy", "batched",
            "-o", str(prefix),
        ]
    )
    assert rc == 0
    single = tmp_path / "s.txt"
    main(
        [
            "query",
            "-b", str(built_index / "test.npz"),
            "-k", "3",
            "-r", "piv_1:10-30",
            "-o", str(single),
            "--backend", "numpy",
        ]
    )
    assert (tmp_path / "bat.piv_1_10_30.txt").read_text() == single.read_text()


def test_pick_batch_strategy_auto():
    """--strategy auto: resident for dense/many-window batches, position for
    scattered small windows over huge records."""
    import numpy as np

    from memo_tpu.cli import pick_batch_strategy
    from memo_tpu.index.builder import store_from_ms

    rng = np.random.default_rng(5)
    big = store_from_ms(
        [rng.integers(0, 9, size=(100_000, 3)).astype(np.int32)],
        ["chr1"], [100_000], 4, "conservation",
    )
    # 2 tiny windows over a 100 kbp record: full-record dispatch is waste.
    assert pick_batch_strategy(big, [("chr1", 0, 50), ("chr1", 900, 950)]) == "position"
    # Dense coverage: one full-record dispatch serves everything.
    assert pick_batch_strategy(big, [("chr1", 0, 50_000)]) == "resident"
    # Many windows amortize the dispatch even when individually small.
    many = [("chr1", i * 10, i * 10 + 5) for i in range(16)]
    assert pick_batch_strategy(big, many) == "resident"


def test_query_requires_region_xor_regions_file(built_index, tmp_path):
    import pytest as _pytest

    with _pytest.raises(SystemExit):
        main(["query", "-b", str(built_index / "test.npz"), "-o", str(tmp_path / "x")])


def test_query_kind_mismatch_refused(built_index, tmp_path):
    """Querying a conservation index with -m is an error unless --force."""
    args = [
        "query",
        "-b", str(built_index / "test.npz"),
        "-k", "3",
        "-r", "piv_1:0-40",
        "-o", str(tmp_path / "m.txt"),
        "-m",
        "--backend", "numpy",
    ]
    with pytest.raises(SystemExit, match="mismatch"):
        main(args)
    assert main(args + ["--force"]) == 0  # explicit override still runs


def test_index_parallel_jobs(example_dir_module, tmp_path):
    """--jobs N builds the same index as serial."""
    serial = tmp_path / "s"
    par = tmp_path / "p"
    for out, jobs in ((serial, "1"), (par, "4")):
        rc = main(
            [
                "index",
                "-g", str(example_dir_module / "genome_list.txt"),
                "-o", str(out),
                "-p", "t",
                "--ms-backend", "python",
                "--no-cache",
                "--jobs", jobs,
            ]
        )
        assert rc == 0
    from memo_tpu.index.store import IntervalStore

    a = IntervalStore.load(serial / "t.npz")
    b = IntervalStore.load(par / "t.npz")
    np.testing.assert_array_equal(a.start, b.start)
    np.testing.assert_array_equal(a.end, b.end)
    np.testing.assert_array_equal(a.order, b.order)


def test_extract(built_index, tmp_path):
    """memo extract (legacy extract.sh): fully-contained rows of the window,
    byte-identical to filtering the compat BED by qs <= start and end <= qe."""
    rc = main(
        [
            "extract",
            "-b", str(built_index / "test.npz"),
            "-r", "piv_1:5-40",
            "-o", str(tmp_path),
        ]
    )
    assert rc == 0
    out = tmp_path / "omem_olaps_piv_1_5_40.bed"
    assert out.exists()
    want = []
    for line in (built_index / "test.bed").read_text().splitlines():
        c, s, e, o = line.split("\t")
        if c == "piv_1" and 5 <= int(s) and int(e) <= 40:
            want.append(line)
    assert out.read_text().splitlines() == want
    # parquet input path agrees
    rc = main(
        [
            "extract",
            "-b", str(built_index / "test.parquet"),
            "-r", "piv_1:5-40",
            "-o", str(tmp_path / "pq"),
        ]
    )
    assert rc == 0
    assert (tmp_path / "pq" / "omem_olaps_piv_1_5_40.bed").read_text().splitlines() == want
