"""Device mesh construction and sharding helpers.

The reference has no multi-device capability at all (single GPU, no
NCCL/MPI — SURVEY.md §2.4); scaling is a new first-class component: a 2-D
mesh over {data, feat} that follows the algorithm, not the interconnect:

  * ``data``  — match-pair / track / query-feature data parallelism (the SfM
    analogue of DP: each device owns a slice of the work items)
  * ``feat``  — target-feature-axis sharding of the brute-force distance
    matrix (the SfM analogue of sequence/tensor parallelism: the N x M
    distance matrix is tiled across devices, structurally identical to ring
    attention over the feature axis)

XLA lowers the collectives to NCCL; ``jax.distributed`` extends the same
mesh across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "data"
FEAT_AXIS = "feat"


def make_mesh(
    devices: Optional[Sequence] = None,
    data: Optional[int] = None,
    feat: int = 1,
) -> Mesh:
    """Build a (data, feat) mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // feat
    assert data * feat == n, f"{data}x{feat} != {n} devices"
    arr = np.array(devices).reshape(data, feat)
    return Mesh(arr, (DATA_AXIS, FEAT_AXIS))


def shard_tracks(mesh: Mesh):
    """Sharding for track-major arrays: leading axis over data."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def host_value(x) -> np.ndarray:
    """Host numpy value of any array — including non-fully-addressable
    global arrays under multi-process ``jax.distributed`` (each process owns
    only its local shards; replicated arrays read from a local shard, sharded
    arrays gather across processes).  Single-process arrays pass through a
    plain ``np.asarray``."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        if x.sharding.is_fully_replicated:
            return np.asarray(x.addressable_shards[0].data)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def host_tree(tree):
    """host_value over every leaf of a pytree."""
    return jax.tree_util.tree_map(host_value, tree)


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None):
    """Multi-host bring-up (one process per host): jax.distributed.
    No-op when already initialised or single-process."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
