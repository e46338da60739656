"""Brick decomposition of the octree — the scene format of the
production traversal (ops/wavefront.py) and its XLA reference
(ops/brick_trace.py).

Re-expresses the reference's octree traversal
(src/shaders/svotrace.comp:211-432) as DDA marches over *dense* brick
payloads:

  * an L0 occupancy grid of (world/32)^3 brick cells (4 KB at 1024^3);
  * per *mixed* brick (one containing leaves smaller than the brick): a
    32^3 occupancy bitfield (1024 words, 4 KB) and a 32^3 per-voxel
    attribute table (128 KB);
  * *uniform* bricks (fully covered by one leaf — air or solid) carry a
    single attribute word and need no payload at all.

Attribute word per voxel (i32): ``value | raw_normal << 8 | depth << 24``
where ``raw_normal`` is the tag-dependent 16-bit field the reference
shader decodes as a normal (svotrace.comp:381-388; see
core/octree.effective_normal_raw — the subdividable-leaf stale-mask quirk
is preserved) and ``depth`` is the leaf's depth below the root, so the
hit record can reconstruct the leaf cube (scale_exp2 = 2^-depth) exactly
as the ESVO walk reports it.

This is scene *preprocessing* (host NumPy, one-time per scene — the
analog of the SSBO upload at Main.java:122), not per-frame work.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..utils import constants as C
from . import brick_dda

BRICK = 32  # voxels per brick edge; 32^3 occupancy bits == 1024 words


@dataclasses.dataclass
class BrickScene:
    """Device-ready brick decomposition of one octree scene."""

    world_size: int          # voxel resolution of the world cube [1,2]^3
    grid_size: int           # bricks per edge (world_size // 32)
    n_mixed: int
    l0_table: Any            # (rows,128) i32 — z-packed brick-occupancy words
    brick_slot: Any          # (G^3,) i32 — mixed-brick slot, -1 if uniform
    brick_attr: Any          # (G^3,) i32 — uniform attr (value 0 => air)
    occ_words: Any           # (n_mixed, 8, 128) i32 — 32^3 occupancy bits
    attrs: Any               # (n_mixed, 256, 128) i32 — per-voxel attr words

    def to_device(self):
        import jax.numpy as jnp

        return BrickScene(
            world_size=self.world_size, grid_size=self.grid_size,
            n_mixed=self.n_mixed,
            l0_table=jnp.asarray(self.l0_table, jnp.int32),
            brick_slot=jnp.asarray(self.brick_slot, jnp.int32),
            brick_attr=jnp.asarray(self.brick_attr, jnp.int32),
            occ_words=jnp.asarray(self.occ_words, jnp.int32),
            attrs=jnp.asarray(self.attrs, jnp.int32),
        )


def _attr_word(value, raw_normal, depth):
    return (value.astype(np.int64) & 0xFF) | ((raw_normal.astype(np.int64)
                                               & 0xFFFF) << 8) \
        | (depth.astype(np.int64) << 24)


def _leaf_attr(value, normal, mask, nodes, tags, depth):
    """Attribute word(s) of leaf nodes (module docstring encoding)."""
    raw = np.where(tags == C.TAG_SURFACE_LEAF, normal[nodes],
                   np.where(tags == C.TAG_NON_SURFACE_LEAF, 0, mask[nodes]))
    return _attr_word(value[nodes], raw,
                      np.asarray(depth, np.int64) * np.ones(len(nodes),
                                                            np.int64)
                      if np.ndim(depth) == 0 else depth)


def _raster_subtrees(child, mask, value, normal, roots, brick_depth,
                     brick: int = BRICK):
    """Rasterize brick-level branch subtrees to (n, brick^3) attr words.

    ``roots``: (n,) node indices of brick-level BRANCH nodes;
    ``brick_depth``: their depth below the root.  Level-synchronous
    vectorized descent (the same loop as brickify pass 2)."""
    n = len(roots)
    attrs = np.zeros((n, brick * brick * brick), np.int32)
    if n == 0:
        return attrs
    k = np.arange(8, dtype=np.int64)
    nodes = np.asarray(roots, np.int64)
    tags = np.full(n, C.TAG_BRANCH, np.int64)
    slots = np.arange(n, dtype=np.int64)
    lx = np.zeros(n, np.int64)
    ly = np.zeros(n, np.int64)
    lz = np.zeros(n, np.int64)
    span = brick
    depth = brick_depth
    while True:
        is_branch = (tags == C.TAG_BRANCH) & (child[nodes] != 0)
        leaf = ~is_branch
        if leaf.any():
            attr = _leaf_attr(value, normal, mask, nodes[leaf], tags[leaf],
                              depth)
            base = ((lx[leaf] * brick + ly[leaf]) * brick + lz[leaf]
                    + slots[leaf] * brick**3)
            s = span
            off = np.arange(s, dtype=np.int64)
            o3 = (off[:, None, None] * brick * brick
                  + off[None, :, None] * brick + off[None, None, :]
                  ).reshape(-1)
            attrs.reshape(-1)[(base[:, None] + o3[None, :]).reshape(-1)] \
                = np.repeat(attr, s * s * s).astype(np.int32)
        if span == 1 or not is_branch.any():
            break
        bn = nodes[is_branch]
        bs = slots[is_branch]
        bx, by, bz = lx[is_branch], ly[is_branch], lz[is_branch]
        nodes = (child[bn][:, None] + k[None, :]).reshape(-1)
        tags = ((mask[bn][:, None] >> (2 * k[None, :])) & 3).reshape(-1)
        slots = np.repeat(bs, 8)
        half = span // 2
        lx = (bx[:, None] + (k[None, :] & 1) * half).reshape(-1)
        ly = (by[:, None] + ((k[None, :] >> 1) & 1) * half).reshape(-1)
        lz = (bz[:, None] + ((k[None, :] >> 2) & 1) * half).reshape(-1)
        span //= 2
        depth += 1
    return attrs


def occupancy_words(attrs, brick: int = BRICK):
    """(n, brick^3) attr words -> (n, 8, 128) z-packed occupancy bits
    (word (x*32 + y), bit z — matches ops/brick_dda.pack_occupancy)."""
    n = attrs.shape[0]
    solid = (attrs & 0xFF) != 0
    vox = solid.reshape(n, brick, brick, brick)
    w = np.zeros((n, brick, brick), np.uint32)
    for z in range(brick):
        w |= vox[:, :, :, z].astype(np.uint32) << np.uint32(z)
    return w.reshape(n, 8, 128).view(np.int32)


def _host_tables(tree):
    n = tree.n_nodes
    return tuple(np.asarray(a[:n]).astype(np.int64)
                 for a in (tree.child, tree.mask, tree.value, tree.normal))


def _brick_level(tree, child, mask, value, normal, brick: int):
    """Pass 1 of :func:`brickify`: descend to brick level.  Returns
    (uniform attr per brick cell, mixed cells, their subtree roots,
    brick depth below the root)."""
    ws = tree.world_size
    if ws % brick or ws < brick:
        raise ValueError(f"world_size {ws} not a multiple of brick {brick}")
    G = ws // brick

    def leaf_attr(nodes, tags, depth):
        return _leaf_attr(value, normal, mask, nodes, tags,
                          np.full(nodes.shape, depth, np.int64))

    uni = np.zeros(G * G * G, np.int64)       # uniform attr per brick cell
    mixed_cell: list[np.ndarray] = []         # flat brick cell ids
    mixed_node: list[np.ndarray] = []         # subtree roots (branch nodes)

    nodes = np.array([0], np.int64)
    tags = np.array([C.TAG_BRANCH], np.int64)
    xs = np.zeros(1, np.int64)
    ys = np.zeros(1, np.int64)
    zs = np.zeros(1, np.int64)
    span = ws
    depth = 0
    k = np.arange(8, dtype=np.int64)

    while True:
        is_branch = (tags == C.TAG_BRANCH) & (child[nodes] != 0)
        if span == brick:
            leaf = ~is_branch
            cell = (xs * G + ys) * G + zs
            uni[cell[leaf]] = leaf_attr(nodes[leaf], tags[leaf], depth)
            mixed_cell.append(cell[is_branch])
            mixed_node.append(nodes[is_branch])
            break
        # leaves above brick level cover span/brick whole bricks
        leaf = ~is_branch
        if leaf.any():
            sb = span // brick
            attr = leaf_attr(nodes[leaf], tags[leaf], depth)
            bx, by, bz = xs[leaf], ys[leaf], zs[leaf]
            off = np.arange(sb, dtype=np.int64)
            # flat cells of the sb^3 block per leaf
            cx = (bx[:, None] + off[None, :])            # (L, sb)
            cy = (by[:, None] + off[None, :])
            cz = (bz[:, None] + off[None, :])
            cells = ((cx[:, :, None, None] * G + cy[:, None, :, None]) * G
                     + cz[:, None, None, :]).reshape(len(attr), -1)
            uni[cells.reshape(-1)] = np.repeat(attr, sb * sb * sb)
        if not is_branch.any():
            break
        bn = nodes[is_branch]
        bx, by, bz = xs[is_branch], ys[is_branch], zs[is_branch]
        nodes = (child[bn][:, None] + k[None, :]).reshape(-1)
        tags = ((mask[bn][:, None] >> (2 * k[None, :])) & 3).reshape(-1)
        half = (span // brick) // 2
        xs = (bx[:, None] + (k[None, :] & 1) * half).reshape(-1)
        ys = (by[:, None] + ((k[None, :] >> 1) & 1) * half).reshape(-1)
        zs = (bz[:, None] + ((k[None, :] >> 2) & 1) * half).reshape(-1)
        span //= 2
        depth += 1

    empty = np.zeros(0, np.int64)
    return (uni, np.concatenate(mixed_cell) if mixed_cell else empty,
            np.concatenate(mixed_node) if mixed_node else empty, depth)


def count_mixed(tree, brick: int = BRICK) -> int:
    """Mixed bricks :func:`brickify` would make, without rasterizing."""
    return len(_brick_level(tree, *_host_tables(tree), brick)[1])


def brickify(tree, brick: int = BRICK) -> BrickScene:
    """Decompose an Octree (host SoA) into the brick scene format.

    The descent mirrors the child addressing of the SoA table (child base +
    octant k; tag = 2 bits of the parent's mask, Octree.java:589-599).
    Worlds smaller than one brick are rejected — use the ESVO path there.
    """
    child, mask, value, normal = _host_tables(tree)
    uni, mixed_cell, mixed_node, brick_depth = _brick_level(
        tree, child, mask, value, normal, brick)
    G = tree.world_size // brick
    n_mixed = len(mixed_cell)

    slot_map = np.full(G * G * G, -1, np.int32)
    slot_map[mixed_cell] = np.arange(n_mixed, dtype=np.int32)

    # ---- pass 2: rasterize mixed subtrees to 32^3 voxels ----------------
    nm = max(n_mixed, 1)
    attrs = np.zeros((nm, brick * brick * brick), np.int32)
    if n_mixed:
        attrs[:n_mixed] = _raster_subtrees(child, mask, value, normal,
                                           mixed_node, brick_depth, brick)
    occ_words = occupancy_words(attrs, brick)

    l0_occ = ((uni & 0xFF) != 0) | (slot_map >= 0)
    l0_table = brick_dda.table_rows(
        brick_dda.pack_occupancy(l0_occ.reshape(G, G, G)))

    return BrickScene(
        world_size=tree.world_size, grid_size=G, n_mixed=n_mixed,
        l0_table=l0_table,
        brick_slot=slot_map,
        brick_attr=uni.astype(np.int32),
        occ_words=occ_words,
        attrs=attrs.reshape(nm, 256, 128),
    )


@dataclasses.dataclass
class ScenePatch:
    """Device-update description from :func:`brickify_patch`."""

    cells: np.ndarray      # (m,) flat brick cells touched
    cell_slot: np.ndarray  # (m,) new slot per cell (-1 = uniform)
    cell_attr: np.ndarray  # (m,) new uniform attr per cell (0 if mixed)
    upd_slots: np.ndarray  # (p,) slots whose payload rows changed
    occ_rows: np.ndarray   # (p, 8, 128)
    attr_rows: np.ndarray  # (p, 256, 128)
    n_mixed: int           # mixed count after the patch


def brickify_patch(tree, scene: BrickScene, vmin, vmax,
                   brick: int = BRICK) -> ScenePatch:
    """Recompute the bricks overlapping voxel AABB [vmin, vmax] after an
    edit (the incremental analog of the reference's ranged SSBO update,
    Octree.java:676-698 + Main.java:349-350) and update ``scene`` (host
    arrays) in place.

    Mixed->uniform transitions orphan their payload slot — the arena only
    grows, exactly like the reference's tombstoned subtrees
    (Octree.java:954-956); a full :func:`brickify` reclaims.
    """
    child, mask, value, normal = _host_tables(tree)
    G = scene.grid_size
    lo = np.clip(np.asarray(vmin) // brick, 0, G - 1)
    hi = np.clip(np.asarray(vmax) // brick, 0, G - 1)
    cx, cy, cz = (a.reshape(-1) for a in np.meshgrid(
        *(np.arange(lo[i], hi[i] + 1) for i in range(3)), indexing="ij"))
    m = len(cx)

    # per-cell walk root -> brick level (octant addressing as in brickify)
    node = np.zeros(m, np.int64)
    tag = np.full(m, C.TAG_BRANCH, np.int64)
    ox = np.zeros(m, np.int64)
    oy = np.zeros(m, np.int64)
    oz = np.zeros(m, np.int64)
    fdepth = np.zeros(m, np.int64)
    leafed = np.zeros(m, bool)
    span, depth = G, 0
    while span > 1:
        is_branch = (tag == C.TAG_BRANCH) & (child[node] != 0)
        newly = ~is_branch & ~leafed
        fdepth[newly] = depth
        leafed |= ~is_branch
        half = span // 2
        kx = ((cx - ox) >= half).astype(np.int64)
        ky = ((cy - oy) >= half).astype(np.int64)
        kz = ((cz - oz) >= half).astype(np.int64)
        k = kx | (ky << 1) | (kz << 2)
        new_tag = (mask[node] >> (2 * k)) & 3
        node = np.where(is_branch, child[node] + k, node)
        tag = np.where(is_branch, new_tag, tag)
        span, depth = half, depth + 1
        ox = ox + np.where(is_branch, kx * half, 0)
        oy = oy + np.where(is_branch, ky * half, 0)
        oz = oz + np.where(is_branch, kz * half, 0)
    is_branch = (tag == C.TAG_BRANCH) & (child[node] != 0)
    newly = ~is_branch & ~leafed
    fdepth[newly] = depth
    mixed = is_branch

    flat = (cx * G + cy) * G + cz
    uni_attr = np.zeros(m, np.int64)
    if (~mixed).any():
        uni_attr[~mixed] = _leaf_attr(value, normal, mask, node[~mixed],
                                      tag[~mixed], fdepth[~mixed])

    prev = scene.brick_slot[flat].astype(np.int64)
    need_new = mixed & (prev < 0)
    slot = np.where(mixed, prev, -1)
    slot[need_new] = scene.n_mixed + np.arange(need_new.sum())
    n_mixed2 = scene.n_mixed + int(need_new.sum())

    attrs_m = _raster_subtrees(child, mask, value, normal, node[mixed],
                               depth, brick)
    occ_m = occupancy_words(attrs_m, brick)

    # in-place host-scene update
    scene.brick_slot[flat] = slot.astype(np.int32)
    scene.brick_attr[flat] = np.where(mixed, 0, uni_attr).astype(np.int32)
    grow = n_mixed2 - scene.occ_words.shape[0]
    if grow > 0:
        scene.occ_words = np.concatenate(
            [scene.occ_words, np.zeros((grow, 8, 128), np.int32)])
        scene.attrs = np.concatenate(
            [scene.attrs, np.zeros((grow, 256, 128), np.int32)])
    upd = slot[mixed]
    scene.occ_words[upd] = occ_m
    scene.attrs[upd] = attrs_m.reshape(-1, 256, 128)
    scene.n_mixed = n_mixed2
    l0_occ = (((scene.brick_attr & 0xFF) != 0) | (scene.brick_slot >= 0))
    scene.l0_table = brick_dda.table_rows(
        brick_dda.pack_occupancy(l0_occ.reshape(G, G, G)))

    return ScenePatch(cells=flat.astype(np.int32),
                      cell_slot=slot.astype(np.int32),
                      cell_attr=np.where(mixed, 0, uni_attr).astype(np.int32),
                      upd_slots=upd.astype(np.int32), occ_rows=occ_m,
                      attr_rows=attrs_m.reshape(-1, 256, 128),
                      n_mixed=n_mixed2)
