"""Test configuration: force an 8-device virtual CPU mesh so sharding tests
run hermetically without accelerator hardware (SURVEY §4: multi-host tests
without a cluster). The card itself is exercised by ``chip_smoke.py``."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("MEMO_TPU_TEST_REAL_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import pathlib

import jax
import pytest

# The suite writes no compilation cache: CLI calls inside tests would
# otherwise place one in the checkout (utils.device.enable_compile_cache).
jax.config.update("jax_enable_compilation_cache", False)

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def example_dir() -> pathlib.Path:
    d = REPO / "tests" / "data" / "example"
    assert d.exists(), "example FASTA fixtures missing"
    return d


def pytest_configure(config):
    config.addinivalue_line("markers", "oracle: needs the reference repo mounted read-only")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-program caches after each test module. The full suite
    compiles many hundreds of distinct CPU programs in one process (engine
    shape matrices, SPMD meshes); an earlier suite saw the XLA CPU compiler
    SEGFAULT late in the run at a moving test — an in-process accumulation
    effect, not any one program (each crashing test passes standalone).
    Everything recompiles on demand, so this only costs a little repeat
    compilation per module."""
    yield
    try:
        import jax

        jax.clear_caches()
    except Exception:
        pass
