"""Multi-host initialization and mesh construction.

The reference is strictly single-process (SURVEY §5: no distributed layer).
Scale-out here follows the standard JAX multi-controller recipe: one process
per host, ``jax.distributed.initialize``, then a global ``(dp, sp)`` mesh
over all devices — the same mesh the single-host path uses
(memo_tpu/parallel/sharded.py), so query code is identical at any scale.

Sharding layout guidance (how the axes map to the interconnect):

- ``dp`` (window batches) is communication-free -> lay it across HOSTS so
  the only traffic that would cross the network is none at all.
- ``sp`` (positions or intervals) stays WITHIN a host so the
  interval-strategy ``psum`` is an NCCL collective over NVLink.

``make_global_mesh`` encodes exactly that: dp = number of processes,
sp = local device count, with mesh axes ordered (dp, sp) over
``jax.devices()`` (which enumerates devices process-major).

Hermetic testing without a cluster: ``jax.distributed`` also accepts a
single-process "cluster" (num_processes=1), and the virtual CPU mesh
(tests/conftest.py) exercises the same shard_map programs on 8 fake
devices.
"""

from __future__ import annotations

import os

from memo_tpu.parallel.sharded import make_mesh
from memo_tpu.utils.logging import get_logger

log = get_logger(__name__)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize JAX for multi-host execution (idempotent).

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or lets
    JAX auto-detect on the platforms it supports (a cluster manager such as
    SLURM); a bare GPU host needs all three.
    Single-process runs may skip calling this entirely.
    """
    import jax

    if jax.distributed.is_initialized():
        return  # already initialized
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes
            if num_processes is not None
            else os.environ["JAX_NUM_PROCESSES"]
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None else os.environ["JAX_PROCESS_ID"]
        )
    jax.distributed.initialize(**kwargs)
    log.info(
        "jax.distributed initialized: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def make_global_mesh():
    """(dp, sp) mesh with dp across hosts (no traffic) and sp within a host
    (psum over NVLink). On one host this is (1, n_devices)."""
    import jax

    return make_mesh(dp=jax.process_count(), sp=jax.local_device_count())
