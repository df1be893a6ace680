"""Device-mesh construction helpers.

The reference is single-process with zero distributed machinery (SURVEY.md
§2.9); scaling here is an extension: a named `jax.sharding.Mesh`
with up to three logical axes:

- ``data``  — batch of sequences (DP; the `emit_50_3500_20.ess` workload),
- ``state`` — HMM state blocks (TP; shards the N×N (min,+) operator),
- ``time``  — observation time blocks (SP; associative operator composition).

XLA lowers the collectives to the devices' interconnect; multi-process groups come from
``jax.distributed.initialize`` (called by the user's launcher, not here).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
STATE_AXIS = "state"
TIME_AXIS = "time"


def make_mesh(
    data: int = 1,
    state: int = 1,
    time: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a named mesh of shape ``(data, state, time)``.

    The product may be smaller than the device count; extra devices are
    left unused (a deliberate policy: decode benchmarks want exact shapes,
    not max utilization of a ragged remainder).
    """
    devs = devices if devices is not None else jax.devices()
    need = data * state * time
    if need > len(devs):
        raise ValueError(
            f"mesh ({data}×{state}×{time}={need}) exceeds {len(devs)} devices"
        )
    grid = np.array(devs[:need]).reshape(data, state, time)
    return Mesh(grid, (DATA_AXIS, STATE_AXIS, TIME_AXIS))


def fetch_global(arr) -> np.ndarray:
    """Host-fetch a possibly process-spanning global ``jax.Array``.

    ``np.asarray`` raises on arrays with non-addressable shards (a mesh
    spanning a multi-host process group), which is exactly what the DP/TP
    entry points produce across processes. Fully-addressable arrays (single
    process, or replicated outputs) take the zero-copy path; otherwise
    every process materializes the FULL value via an allgather of the
    addressable shards — the SPMD convention: all hosts see the same
    result, mirroring what ``np.asarray`` gives on one host.
    """
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def batch_sharding(mesh: Mesh, batch_dim: int = 0) -> NamedSharding:
    """Sharding that splits a batch dimension over the ``data`` axis."""
    spec = [None, None]
    spec[batch_dim] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
