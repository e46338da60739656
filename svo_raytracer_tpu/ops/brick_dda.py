"""Occupancy-grid packing for the brick traversal (host NumPy).

The brick-grid level of the traversal (ops/brick_trace.py,
ops/wavefront.py) probes one bit per brick cell: the grid is stored as
z-packed 32-bit words, one column of 32 z-cells per word.
"""

from __future__ import annotations

import numpy as np

LANES = 128


def pack_occupancy(vox: np.ndarray) -> np.ndarray:
    """Pack a (G,G,G) boolean/int occupancy grid into z-packed u32 words.

    Returns int32 (G*G*ceil(G/32),) — word ``(x*G + y)*W + (z >> 5)`` holds
    bit ``z & 31`` of column (x, y).  Pure NumPy (scene-build time).
    """
    vox = np.asarray(vox) != 0
    G = vox.shape[0]
    assert vox.shape == (G, G, G), vox.shape
    W = -(-G // 32)
    words = np.zeros((G, G, W), np.uint32)
    for z in range(G):
        words[:, :, z // 32] |= vox[:, :, z].astype(np.uint32) << np.uint32(z % 32)
    return words.reshape(-1).view(np.int32)


def table_rows(words) -> np.ndarray:
    """(V,) packed words -> (ceil(V/128), 128) int32 rows, zero-padded
    (the BrickScene.l0_table layout; flattened, word order is kept)."""
    w = np.asarray(words, np.int32)
    pad = (-w.shape[0]) % LANES
    if pad:
        w = np.pad(w, (0, pad))
    return w.reshape(-1, LANES)
