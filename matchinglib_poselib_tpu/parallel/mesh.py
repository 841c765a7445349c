"""Device mesh and collective wrappers.

The reference has no distributed backend (SURVEY.md §2.4): its concurrency
is OpenMP loops and an 8-thread pool. This framework's scale-out design
replaces that with one `jax.sharding.Mesh` carrying two axes:

- ``pairs``: data parallelism over image pairs / frames (the OpenMP
  keypoint-chunk loop of match_statOptFlow.cpp:1158 generalized to whole
  pairs; also the frame-stream sharding of §5.7)
- ``db``: model-parallel sharding of descriptor databases for db-sharded kNN
  (replaces the NMSLIB thread pool, nmslib_matchers.h:330-345) and of
  point blocks in distributed BA.

All collectives ride XLA (`psum`/`all_gather`/`ppermute`) over NVLink within
a host and the network across hosts; single-device runs degrade to no-ops because
shard_map over a 1-sized axis is the identity partitioning.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


PAIRS_AXIS = "pairs"
DB_AXIS = "db"


def make_mesh(
    devices=None, db_parallelism: int | None = None
) -> Mesh:
    """Build the ("pairs", "db") mesh over the available devices.

    ``db_parallelism`` splits devices between the two axes; default puts
    2-way db sharding when >= 4 devices are available, else everything on
    the pairs axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if db_parallelism is None:
        db_parallelism = 2 if n >= 4 else 1
    while n % db_parallelism != 0:
        db_parallelism -= 1
    arr = np.asarray(devices).reshape(n // db_parallelism, db_parallelism)
    return Mesh(arr, (PAIRS_AXIS, DB_AXIS))


def pairs_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the pairs axis (batch of image pairs)."""
    return NamedSharding(mesh, P(PAIRS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def db_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a descriptor database along its row axis over the db axis."""
    return NamedSharding(mesh, P(DB_AXIS))
