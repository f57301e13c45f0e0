"""Multi-process initialization (several hosts, or several processes on
one host).

The reference is strictly single-host (its parallelism is the Mitsuba C++
thread pool over image blocks, ``src/eradiate/kernel/_render.py:433-468``);
this module is this build's multi-process entry. The caller (or
``ERADIATE_TPU_COORDINATOR`` etc.) supplies the coordinator address, the
process count and this process's id explicitly. When several processes
share one host, give each its own GPU through ``local_device_ids``: a JAX
process reserves most of a card's memory when it first uses it, so two
processes must never open the same card.

Usage (one call at program start, before any jax computation)::

    import eradiate_tpu.parallel as p
    p.initialize()              # no-op if already initialized / single host
    mesh = p.make_render_mesh(n_spectral, n_sample)   # global device mesh
    result = p.render_sharded(scene, sensor, config, spp, mesh=mesh)

Every process calls ``render_*_sharded`` with the same host-side scene;
inputs are placed as global arrays (each process contributes only its
addressable shards) and outputs are gathered to every host — see
``render._put_global`` / ``render._fetch``.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> bool:
    """Initialize ``jax.distributed`` for a multi-process run.

    Parameters default to the ``ERADIATE_TPU_COORDINATOR`` /
    ``ERADIATE_TPU_NUM_PROCESSES`` / ``ERADIATE_TPU_PROCESS_ID`` /
    ``ERADIATE_TPU_LOCAL_DEVICE_IDS`` (comma-separated) env vars. Without a
    coordinator the run is single-process and nothing is initialized.
    ``local_device_ids``: the local devices this process may use (e.g.
    ``[process_id]`` for one process per GPU on a shared host); ``None``
    lets the process see every local device. Safe to call twice: returns
    ``True`` when a multi-process backend is (already) up, ``False`` when
    running single-process.
    """
    global _initialized
    # IMPORTANT: do NOT touch backend-initializing jax APIs
    # (jax.process_count(), jax.devices(), ...) before
    # jax.distributed.initialize — on jax 0.9 they initialize the XLA
    # backend, after which distributed init always fails.
    if _initialized:
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get(
        "ERADIATE_TPU_COORDINATOR"
    )
    env_np = os.environ.get("ERADIATE_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("ERADIATE_TPU_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    env_ids = os.environ.get("ERADIATE_TPU_LOCAL_DEVICE_IDS")
    if local_device_ids is None and env_ids:
        local_device_ids = [int(i) for i in env_ids.split(",")]

    if coordinator_address is None:
        # single process, nothing to initialize
        _initialized = True
        return False

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except (RuntimeError, ValueError) as exc:
        # tolerable when the caller already initialized; fatal when we end
        # up single-process anyway
        logger.warning("jax.distributed.initialize failed: %s", exc)
        if jax.process_count() <= 1:
            raise RuntimeError(
                "multi-host initialization was requested (coordinator "
                f"{coordinator_address!r}) but failed — call "
                "eradiate_tpu.parallel.initialize() before ANY other jax "
                "API use (jax.devices()/process_count() initialize the "
                "backend and block distributed setup)"
            ) from exc
    _initialized = True
    n = jax.process_count()
    if n > 1:
        logger.info(
            "multi-host up: process %d/%d, %d local / %d global devices",
            jax.process_index(), n,
            jax.local_device_count(), jax.device_count(),
        )
    return n > 1
