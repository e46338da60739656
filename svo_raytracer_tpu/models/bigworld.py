"""Direct heightmap -> BrickScene construction for giant worlds.

The chunked octree build (models/world.py build_world, the analog of the
reference's WorldGenerator.java:12-40 + Octree.java:237-350 pipeline)
round-trips every chunk through the device and the octree SoA, whose
cost grows with the world's volume.  But the production traversal
(ops/wavefront.py) and its oracle (ops/brick_trace.py) consume a
BrickScene, not an octree, and a heightmap world's bricks are a
closed-form function of the column heights.  This module builds the
BrickScene directly in host NumPy:

  * per brick column, hmin/hmax over the 32x32 footprint classify each
    brick as uniform-air / uniform-stone / mixed (chunkgen-heightmap
    semantics: solid iff wy <= h = int(hm/65536*height_scale); top-4
    voxels take the matmap material, below is stone=1 —
    chunkgen-heightmap.comp:13-31, models/heightmap.py);
  * mixed bricks rasterize vectorized in batches;
  * exposed voxels (top faces, and side faces above a neighbor column's
    top) carry a digit-packed normal from the height gradient
    (normalize(-dh/dx, 2, -dh/dz)).  DELTA vs the octree pipeline: the
    reference estimates normals from the 3^3 air neighborhood
    (Octree.java:620-649); the gradient normal agrees on smooth terrain
    and differs on overhang-free cliffs only in magnitude weighting.
    Scenes needing exact normal parity (the 1024^3 bench world) keep
    the octree build path.

Worlds whose attribute table passes int32 indexing (8192^3, ~6 G words)
build here but are refused by ``wavefront.prepare`` (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from ..ops import brick_dda, brick_scene

BRICK = 32


def _pack_normal_digits(nx, ny, nz):
    """Vectorized Util.java:140-146 digit packing (trunc like Java)."""

    def digit(v):
        return (np.trunc(np.trunc(v * 9) / 2) + 5).astype(np.int64)

    return digit(nx) + 10 * digit(ny) + 100 * digit(nz)


def heightmap_brick_scene(hm, mm, world_size: int,
                          height_scale: int | None = None,
                          batch: int = 2048) -> brick_scene.BrickScene:
    """Build a BrickScene for a heightmap world of ``world_size`` voxels.

    hm: (world_size, world_size) uint16 heightmap (upsample the source
    DEM to world resolution first);
    mm: same-shape int material ids (clipped to [0, 3]).
    """
    ws = world_size
    G = ws // BRICK
    if height_scale is None:
        height_scale = ws // 2
    assert hm.shape == (ws, ws), (hm.shape, ws)
    full_depth = int(np.log2(ws))

    h = (hm.astype(np.float64) / 65536.0 * height_scale).astype(np.int64)
    m = np.clip(mm.astype(np.int64), 0, 3)

    # column gradient -> unit normal (y up); used by every exposed voxel
    dhx = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) / 2.0
    dhz = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) / 2.0
    dhx[0, :] = h[1, :] - h[0, :]
    dhx[-1, :] = h[-1, :] - h[-2, :]
    dhz[:, 0] = h[:, 1] - h[:, 0]
    dhz[:, -1] = h[:, -1] - h[:, -2]
    nlen = np.sqrt(dhx * dhx + 4.0 + dhz * dhz)
    raw_col = _pack_normal_digits(-dhx / nlen, 2.0 / nlen, -dhz / nlen)

    # a voxel's side faces are exposed above the lowest neighbor column
    hnb = np.minimum.reduce([np.roll(h, 1, 0), np.roll(h, -1, 0),
                             np.roll(h, 1, 1), np.roll(h, -1, 1)])

    # ---- per-brick-column classification -------------------------------
    hb = h.reshape(G, BRICK, G, BRICK)
    hmin = hb.min(axis=(1, 3))          # (G, G) per brick column
    hmax = hb.max(axis=(1, 3))

    # axes: h arrays are (x, z); hmin[:, None, :] is (bx, 1, bz) and
    # broadcasting against the (1, by, 1) layer index yields (bx,by,bz),
    # matching the flat cell id (bx*G + by)*G + bz used everywhere
    by = np.arange(G, dtype=np.int64)[None, :, None]  # brick y layer
    top = (by + 1) * BRICK - 1
    bot = by * BRICK
    # uniform stone: every voxel solid AND below the material band
    uni_stone = top <= (hmin[:, None, :] - 5)
    air = bot > hmax[:, None, :]
    mixed = ~uni_stone & ~air
    assert uni_stone.shape == (G, G, G)

    stone_depth = full_depth - 5        # brick-size leaf
    flat_attr = np.zeros(G * G * G, np.int64)
    flat_attr[uni_stone.reshape(-1)] = 1 | (stone_depth << 24)
    mixed_flat = mixed.reshape(-1)
    mixed_cells = np.nonzero(mixed_flat)[0].astype(np.int64)
    n_mixed = len(mixed_cells)
    brick_slot = np.full(G * G * G, -1, np.int32)
    brick_slot[mixed_cells] = np.arange(n_mixed, dtype=np.int32)

    # ---- rasterize mixed bricks in batches -----------------------------
    attrs = np.zeros((max(n_mixed, 1), 32768), np.int32)
    occ_words = np.zeros((max(n_mixed, 1), 8, 128), np.int32)
    off = np.arange(BRICK, dtype=np.int64)
    for b0 in range(0, n_mixed, batch):
        cells = mixed_cells[b0:b0 + batch]
        nb = len(cells)
        bx = cells // (G * G)
        byy = (cells // G) % G
        bz = cells % G
        # world x/z coords of the 32x32 footprint: (nb, 32)
        wx = bx[:, None] * BRICK + off[None, :]
        wz = bz[:, None] * BRICK + off[None, :]
        hcol = h[wx[:, :, None], wz[:, None, :]]        # (nb, 32, 32)
        mcol = m[wx[:, :, None], wz[:, None, :]]
        rcol = raw_col[wx[:, :, None], wz[:, None, :]]
        nbcol = hnb[wx[:, :, None], wz[:, None, :]]
        wy = (byy[:, None] * BRICK + off[None, :])      # (nb, 32)
        # voxel grid axes: (nb, x, y, z)
        hc = hcol[:, :, None, :]
        solid = wy[:, None, :, None] <= hc
        near = (hc - wy[:, None, :, None]) <= 4
        value = np.where(solid, np.where(near, mcol[:, :, None, :], 1), 0)
        exposed = solid & ((wy[:, None, :, None] == hc)
                           | (wy[:, None, :, None] > nbcol[:, :, None, :]))
        raw = np.where(exposed, rcol[:, :, None, :], 0)
        attr = np.where(solid,
                        value | (raw << 8)
                        | (np.int64(full_depth) << 24), 0)
        attrs[b0:b0 + nb] = attr.reshape(nb, 32768).astype(np.int32)
        occ_words[b0:b0 + nb] = brick_scene.occupancy_words(
            attrs[b0:b0 + nb])

    l0 = (flat_attr != 0) | (brick_slot >= 0)
    l0_table = brick_dda.table_rows(
        brick_dda.pack_occupancy(l0.reshape(G, G, G)))
    return brick_scene.BrickScene(
        world_size=ws, grid_size=G, n_mixed=n_mixed,
        l0_table=l0_table, brick_slot=brick_slot,
        brick_attr=flat_attr.astype(np.int32),
        occ_words=occ_words, attrs=attrs.reshape(max(n_mixed, 1), 256,
                                                 128))
