"""Device-mesh helpers for tile-data-parallel encoding.

The reference has no parallelism at all (SURVEY.md §2.4); the rebuild's
scaling unit is the *tile*: independent FLAC streams map onto a device mesh
with axes

  * ``tiles``  -- data parallelism over spatial tiles (tiles never
                  communicate during encode)
  * ``blocks`` -- intra-tile block parallelism (frames of one tile spread
                  over devices; only the per-tile byte-size reduction
                  crosses this axis)

Only the byte-offset spatial index needs communication: an all-gather of
per-tile compressed sizes followed by an exclusive prefix sum -- a few KB.
The mesh assumes no interconnect topology: devices are taken in
``jax.local_devices()`` order, which suits cards joined all to all.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["tile_mesh", "tile_sharding", "P", "Mesh", "NamedSharding"]


def tile_mesh(n_devices: int | None = None, blocks_axis: int = 1) -> Mesh:
    """Build a (tiles, blocks) mesh over the visible devices.

    Args:
        n_devices: number of devices to use (default: all visible).
        blocks_axis: size of the intra-tile ``blocks`` axis; the ``tiles``
            axis gets the remaining factor.
    """
    # local devices: under jax.distributed each host encodes its own tile
    # slice (parallel/multihost.py); remote devices are never addressed
    devs = jax.local_devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, only {len(devs)} visible")
    if n_devices % blocks_axis:
        raise ValueError("n_devices must be divisible by blocks_axis")
    arr = np.array(devs[:n_devices]).reshape(n_devices // blocks_axis, blocks_axis)
    return Mesh(arr, ("tiles", "blocks"))


def tile_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
