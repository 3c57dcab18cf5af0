"""Device-mesh construction.

Axes:
- ``shards`` — count-space sharding: the 4^K dense array is split over chips,
  interleaved by the code's low bits for load balance (canonical codes are
  skewed toward the low half of the range because canonical = min(fwd, rc);
  low bits are uniform). This is the mesh analog of the reference's serial
  fragment loop (indexer.py:197-296).
- ``data`` — data parallelism: chips in the same shard column replicate the
  dense shard and split the sequence batch; updates are exchanged with an
  all-gather so replicas stay bit-identical.

Both axes stay on the host's card-to-card links (NVLink joins every card to
every other at one rate, so the mesh follows the algorithm alone);
multi-host runs put the host boundary on ``data`` so the only cross-host
traffic is input spraying.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
SHARD_AXIS = "shards"


def make_mesh(
    n_shards: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_shards is None:
        n_shards = len(devices) // n_data
    need = n_shards * n_data
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(n_data, n_shards)
    return Mesh(grid, (DATA_AXIS, SHARD_AXIS))
