"""What the query engine needs to know about the device, in one place.

``describe_device`` reads the platform, kind, count and memory limit of the
default device. ``query_sizes`` turns that description into the engine's
two dispatch sizes, and ``enable_compile_cache`` places JAX's persistent
compilation cache. Nothing else in the package tests which platform it runs
on.
"""

from __future__ import annotations

import dataclasses
import os

# The flat scatter index of ops/query_ops.coverage_counts is int32 and the
# padding slot sits at (L+1)*C, so (L+1)*C must stay below 2^31.
INT32_LIMIT = (1 << 31) - 1

# Sizes for a device with no reported memory limit (the CPU backend): small
# shapes compile fast and keep the hermetic test suite light.
HOST_CHUNK_POSITIONS = 1 << 17
HOST_MAX_INTERVALS = 1 << 22

# A device dispatch may take this fraction of the device's memory limit; the
# rest holds the resident store, its padding and the outputs.
DISPATCH_SHARE = 8
# Bytes per cell of the (L+1) x C coverage plane: the int32 difference
# array, its int32 cumsum and the reduction's input.
PLANE_BYTES_PER_CELL = 12
# Bytes per candidate row: three int32 slices, the record mask and the two
# int32 scatter indices, with slack for XLA's temporaries.
ROW_BYTES = 64

CACHE_DIR_NAME = ".jax_cache"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str
    kind: str
    count: int
    bytes_limit: int | None  # None where the backend reports no limit


def describe_device() -> DeviceInfo:
    """Platform, ``device_kind``, device count and memory limit of JAX's
    default device."""
    import jax

    devices = jax.devices()
    d = devices[0]
    stats = d.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return DeviceInfo(
        platform=d.platform,
        kind=d.device_kind,
        count=len(devices),
        bytes_limit=int(limit) if limit else None,
    )


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def max_chunk_positions(n_docs: int) -> int:
    """Largest power-of-two window length L with (L+1)*C < 2^31."""
    return _pow2_floor(INT32_LIMIT // max(n_docs, 1) - 1)


def query_sizes(info: DeviceInfo | None, n_docs: int) -> tuple[int, int]:
    """(chunk_positions, max_intervals_per_chunk) for a store of ``n_docs``
    columns on the described device (``None``: the host).

    A device that reports a memory limit gets the largest power-of-two
    chunk whose coverage plane, and the largest candidate bucket whose rows,
    each fit in 1/DISPATCH_SHARE of it. Without a limit the host sizes
    apply. Either way the chunk keeps the int32 scatter index in range.
    """
    if info is None or info.bytes_limit is None:
        chunk, rows = HOST_CHUNK_POSITIONS, HOST_MAX_INTERVALS
    else:
        budget = info.bytes_limit // DISPATCH_SHARE
        chunk = _pow2_floor(budget // (PLANE_BYTES_PER_CELL * max(n_docs, 1)))
        rows = _pow2_floor(budget // ROW_BYTES)
    return min(chunk, max_chunk_positions(n_docs)), rows


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and left
    alone. Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed
    path, so later processes of the same checkout hit it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    checkout = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(checkout, CACHE_DIR_NAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line each.
    A card set below its maximum power runs slower under load, so every
    recorded time names the card and its limit."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip()
