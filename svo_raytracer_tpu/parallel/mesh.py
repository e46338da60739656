"""Device mesh helpers.

The reference is single-process/single-GPU (SURVEY.md §2.2); its scaling axes
map to a JAX device mesh here:

  ``tiles`` — image-row (ray-tile) data parallelism: every device traces its
  rows against a replicated octree; the analog of the 8x8 workgroup grid
  writ large across devices.  Voxel-parameter gradients all-reduce over
  this axis, overlapped with backward by XLA's collective scheduler.  The
  mesh follows the algorithm only: every GPU of a host reaches every
  other at the same NVLink rate.

Octree brick sharding (parallel/bricks.py) rides the same mesh on a second
``bricks`` axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def tile_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over ray tiles."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("tiles",))


def grid_mesh(n_tiles: int, n_bricks: int, devices=None) -> Mesh:
    """2-D ``(tiles, bricks)`` mesh: image rows shard over ``tiles``, the
    octree brick decomposition over ``bricks`` (parallel/bricks.py)."""
    if devices is None:
        devices = jax.devices()
    devices = np.array(devices[: n_tiles * n_bricks]).reshape(n_tiles,
                                                              n_bricks)
    return Mesh(devices, axis_names=("tiles", "bricks"))
