"""Device description, the engine's dispatch sizes and the compilation
cache's placement."""

import os

import jax
import numpy as np
import pytest

from memo_tpu.index.store import IntervalStore
from memo_tpu.query import engine as engine_mod
from memo_tpu.query.engine import QueryEngine
from memo_tpu.utils import device
from tests.ms_stores import random_store

H100 = device.DeviceInfo("gpu", "NVIDIA H100 80GB HBM3", 1, 63_000_000_000)


def test_describe_device_on_cpu():
    info = device.describe_device()
    assert info.platform == "cpu"
    assert info.count == len(jax.devices())
    assert info.bytes_limit is None
    assert device.query_sizes(info, 16) == (
        device.HOST_CHUNK_POSITIONS,
        device.HOST_MAX_INTERVALS,
    )


@pytest.mark.parametrize("n_docs", [5, 16, 90, 160, 4096, 100_000])
def test_sizes_from_gpu_memory_limit(n_docs):
    chunk, rows = device.query_sizes(H100, n_docs)
    budget = H100.bytes_limit // device.DISPATCH_SHARE
    for size in (chunk, rows):
        assert size & (size - 1) == 0  # powers of two: few compiled shapes
    assert (chunk + 1) * n_docs < 2**31  # the flat scatter index is int32
    assert chunk * n_docs * device.PLANE_BYTES_PER_CELL <= budget
    assert rows * device.ROW_BYTES <= budget
    # The largest such chunk: doubling it breaks one of the two bounds.
    assert (2 * chunk + 1) * n_docs >= 2**31 or (
        2 * chunk * n_docs * device.PLANE_BYTES_PER_CELL > budget
    )


def test_sizes_grow_with_the_memory_limit():
    half = device.DeviceInfo("gpu", "half", 1, H100.bytes_limit // 2)
    assert device.query_sizes(half, 90)[0] * 2 == device.query_sizes(H100, 90)[0]


def test_engine_takes_gpu_sizes(monkeypatch):
    monkeypatch.setattr(engine_mod, "describe_device", lambda: H100)
    store = random_store(np.random.default_rng(2), monotone=True, n_records=1, rec_len=300)
    eng = QueryEngine(store, backend="jax")
    assert (eng.chunk_positions, eng.max_intervals) == device.query_sizes(H100, store.n_docs)
    oracle = QueryEngine(store, backend="numpy")
    np.testing.assert_array_equal(
        eng.conservation("chr0", 0, 300, 31), oracle.conservation("chr0", 0, 300, 31)
    )


def test_engine_caps_chunk_for_int32_index():
    """An explicit chunk larger than the int32 scatter index allows is cut
    to the largest one that fits."""
    n_docs = 1 << 20
    st = IntervalStore(
        record_names=["c"],
        record_lens=[10],
        n_docs=n_docs,
        kind="conservation",
        rec_id=np.zeros(1, np.int32),
        start=np.array([5], np.int64),
        end=np.array([5], np.int64),
        order=np.array([1], np.int64),
    )
    eng = QueryEngine(st, backend="numpy", chunk_positions=1 << 17)
    assert eng.chunk_positions == device.max_chunk_positions(n_docs) == 1024
    assert (eng.chunk_positions + 1) * n_docs < 2**31


@pytest.fixture
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_environment(monkeypatch, tmp_path, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the variable itself
