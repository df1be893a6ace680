"""Multi-host process-group initialization.

The reference is single-process with no communication backend (SURVEY.md
§2.9); multi-host scaling here rides ``jax.distributed`` + GSPMD — no
custom transport. This module is the thin entry point a launcher calls
once per process before building meshes: pass the coordinator address
(``localhost:<port>`` on one host), process count and id explicitly, or
set ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``. Nothing is discovered from the environment beyond
those.

After initialization, ``jax.devices()`` spans every process and the mesh
helpers in :mod:`spec_viterbi.parallel.mesh` shard across them
transparently; XLA picks the collectives from the mesh.
"""

from __future__ import annotations

import os


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the JAX process group; returns True if multi-process.

    Safe to call unconditionally: single-process environments (no
    coordinator configured, one host) return False without touching
    ``jax.distributed``.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if not coordinator_address:
        return False  # single process

    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def process_info() -> dict:
    """{'process_id', 'process_count', 'local_devices', 'global_devices'}."""
    import jax

    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
