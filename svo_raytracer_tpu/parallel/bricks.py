"""Octree brick sharding — spatial decomposition of the world across devices.

The reference's world is one monolithic ~2 GB arena on a single GPU
(``src/engine/Constants.java:11``, ``src/engine/Main.java:122``); its only
decomposition is the *build-time* chunk grid (``src/engine/Octree.java:237-250``).
For worlds that outgrow one device's memory the answer here is to shard the
octree itself: cut the tree at octant level ``L`` into ``8**L`` *bricks*
(standalone sub-octrees, each re-rooted to span the canonical [1,2]^3 cube),
place them round-robin on a ``bricks`` mesh axis, and let every device
traverse only the segment of each ray that crosses its own bricks.

No mid-traversal ray handoff or halo exchange is needed (SURVEY.md §7 "hard
parts (e)"): bricks tile space disjointly, so the restriction of ESVO
traversal to a brick's cube finds the first hit *within that brick*, and the
global first hit is simply the nearest per-brick hit —

    global_hit(ray) = argmin_{b : brick b hit} t_b(ray)

— one ``pmin``/``psum`` combine over the ``bricks`` axis.  This
replaces the reference's host<->device buffer traffic as the "communication
backend" (SURVEY.md §2.2 last row) with XLA collectives.

Geometry mapping (exact in float32 up to one rounding at +1.0):  brick ``b``
at level L owns the sub-cube ``corner_b + [0, 2^-L]^3`` of the world cube
[1,2]^3; a global ray (o, d) becomes the brick-local ray
``((o - corner_b) * 2^L + 1, d)`` and local hit distances scale back as
``t_global = t_local * 2^-L``.

Composes with ray-tile sharding on a 2-D ``(tiles, bricks)`` mesh: rows
sharded over ``tiles``, tree sharded over ``bricks``, combine over ``bricks``
only.  The LOD heuristics that key on absolute t (cone-trace clamp at
t > 0.05, svotrace.comp:275-277) fire at brick-local distances here — an
accepted LOD-only deviation, documented rather than hidden.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.octree import Octree, ROOT
from ..ops import shade, traverse
from ..utils import constants as C

f32 = jnp.float32
i32 = jnp.int32

_INF = f32(np.inf)


@dataclasses.dataclass
class BrickSet:
    """8**level standalone sub-octrees in one stacked SoA (axis 0 = brick).

    ``orig`` maps each brick-local node slot to its node index in the source
    tree (pad slots map to 0) so differentiable-render parameter gathers and
    edits keep addressing the *global* table.
    """

    child: Any    # int32[B, cap]
    mask: Any     # int32[B, cap]
    value: Any    # int32[B, cap]
    normal: Any   # int32[B, cap]
    orig: Any     # int32[B, cap] — brick slot -> source-tree node index
    corners: Any  # float32[B, 3] — brick cube min corner in the world cube
    n_nodes: Any  # int32[B]
    level: int
    world_size: int

    @property
    def n_bricks(self) -> int:
        return int(self.child.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.child.shape[1])

    def arrays(self):
        return self.child, self.mask, self.value, self.normal

    def to_device(self) -> "BrickSet":
        return BrickSet(
            child=jnp.asarray(self.child, i32),
            mask=jnp.asarray(self.mask, i32),
            value=jnp.asarray(self.value, i32),
            normal=jnp.asarray(self.normal, i32),
            orig=jnp.asarray(self.orig, i32),
            corners=jnp.asarray(self.corners, f32),
            n_nodes=jnp.asarray(self.n_nodes, i32),
            level=self.level, world_size=self.world_size,
        )


def _extract_subtree(tree: Octree, root_old: int):
    """BFS-copy the subtree rooted at branch node ``root_old`` into a fresh
    table (slot 0 = new root).  Children of a branch stay 8 contiguous slots
    (the SoA invariant, octree.py module docstring).  Returns SoA arrays plus
    the slot->source-index map."""
    child = np.asarray(tree.child)
    mask = np.asarray(tree.mask)
    value = np.asarray(tree.value)
    normal = np.asarray(tree.normal)

    nc, nm, nv, nn, norig = [0], [0], [0], [0], [0]

    def put(slot, old):
        nc[slot] = 0
        nm[slot] = int(mask[old])
        nv[slot] = int(value[old])
        nn[slot] = int(normal[old])
        norig[slot] = int(old)

    put(0, root_old)
    queue = [(root_old, 0)]
    while queue:
        old_p, new_p = queue.pop(0)
        if child[old_p] == 0:
            continue
        base = len(nc)
        nc.extend([0] * 8)
        nm.extend([0] * 8)
        nv.extend([0] * 8)
        nn.extend([0] * 8)
        norig.extend([0] * 8)
        nc[new_p] = base
        m = int(mask[old_p])
        for k in range(8):
            old_c = int(child[old_p]) + k
            put(base + k, old_c)
            if ((m >> (2 * k)) & 3) == C.TAG_BRANCH and child[old_c] != 0:
                queue.append((old_c, base + k))
    return (np.asarray(nc, np.int32), np.asarray(nm, np.int32),
            np.asarray(nv, np.int32), np.asarray(nn, np.int32),
            np.asarray(norig, np.int32))


def _leaf_brick(tree: Octree, node: int, tag: int):
    """A brick for a path that ended on a homogeneous leaf: a synthesized
    root branch whose 8 children replicate the leaf's payload (value, packed
    normal, stale mask — preserving the effective_normal_raw quirk).  Hits
    land one level finer than in the unsplit tree (half-size hit cube), which
    only perturbs the scale_exp2-derived offsets of hit_pos/voxel_pos."""
    value = int(np.asarray(tree.value)[node])
    normal = int(np.asarray(tree.normal)[node])
    mask = int(np.asarray(tree.mask)[node])
    tag = C.TAG_NON_SURFACE_LEAF if tag == C.TAG_BRANCH else tag
    root_mask = 0
    for k in range(8):
        root_mask |= tag << (2 * k)
    nc = np.array([1] + [0] * 8, np.int32)
    nm = np.array([root_mask] + [mask] * 8, np.int32)
    nv = np.array([value] + [value] * 8, np.int32)
    nn = np.array([0] + [normal] * 8, np.int32)
    norig = np.full(9, node, np.int32)
    norig[0] = node
    return nc, nm, nv, nn, norig


def split_bricks(tree: Octree, level: int = 1,
                 pad_multiple: int = 128) -> BrickSet:
    """Cut ``tree`` at octant level ``level`` into 8**level bricks (host-side;
    run once per world, like the reference's one-time world load,
    Main.java:115-122).  Brick order follows the child-octant bit order
    bit0=+x / bit1=+y / bit2=+z (Constants.java:18-27) at each level."""
    t = tree.to_numpy()
    bricks = []
    corners = []

    def rec(node: int, tag: int, is_leaf: bool, corner, half: float,
            lvl: int):
        if lvl == level:
            if is_leaf:
                bricks.append(_leaf_brick(t, node, tag))
            else:
                bricks.append(_extract_subtree(t, node))
            corners.append(corner)
            return
        if is_leaf:
            for k in range(8):
                off = C.CHILD_OFFSETS[k]
                rec(node, tag, True,
                    (corner[0] + off[0] * half, corner[1] + off[1] * half,
                     corner[2] + off[2] * half), half / 2, lvl + 1)
            return
        base = int(t.child[node])
        m = int(t.mask[node])
        for k in range(8):
            off = C.CHILD_OFFSETS[k]
            ctag = (m >> (2 * k)) & 3
            c = base + k
            c_leaf = ctag != C.TAG_BRANCH or t.child[c] == 0
            rec(c, ctag, c_leaf,
                (corner[0] + off[0] * half, corner[1] + off[1] * half,
                 corner[2] + off[2] * half), half / 2, lvl + 1)

    rec(ROOT, C.TAG_BRANCH, int(t.child[ROOT]) == 0, (1.0, 1.0, 1.0), 0.5, 0)

    n_nodes = np.asarray([b[0].shape[0] for b in bricks], np.int32)
    cap = int(n_nodes.max())
    cap = -(-cap // pad_multiple) * pad_multiple

    def stack(i):
        out = np.zeros((len(bricks), cap), np.int32)
        for b, arrs in enumerate(bricks):
            out[b, : arrs[i].shape[0]] = arrs[i]
        return out

    return BrickSet(
        child=stack(0), mask=stack(1), value=stack(2), normal=stack(3),
        orig=stack(4), corners=np.asarray(corners, np.float32),
        n_nodes=n_nodes, level=level, world_size=tree.world_size,
    )


def _combine_local(a: traverse.HitResult, b: traverse.HitResult):
    """Nearest-hit merge of two HitResults (earlier argument wins ties)."""
    ta = jnp.where(a.hit, a.t, _INF)
    tb = jnp.where(b.hit, b.t, _INF)
    take_b = tb < ta

    def sel(x, y):
        m = take_b[..., None] if x.ndim > take_b.ndim else take_b
        return jnp.where(m, y, x)

    return traverse.HitResult(
        hit=a.hit | b.hit, value=sel(a.value, b.value), t=sel(a.t, b.t),
        iters=a.iters + b.iters, scale_exp2=sel(a.scale_exp2, b.scale_exp2),
        depth=sel(a.depth, b.depth), normal=sel(a.normal, b.normal),
        hit_pos=sel(a.hit_pos, b.hit_pos),
        voxel_pos=sel(a.voxel_pos, b.voxel_pos), node=sel(a.node, b.node),
    )


def make_brick_intersect(brick_shard, corner_shard, orig_shard, level: int,
                         axis_name: str | None = "bricks"):
    """Build an ``intersect_fn`` (intersect_octree signature minus
    tree_arrays) over this device's bricks, for use inside shard_map.

    ``brick_shard``: (child, mask, value, normal), each (B_local, cap);
    ``corner_shard``: (B_local, 3); ``orig_shard``: (B_local, cap).
    With ``axis_name=None`` the combine is local-only (single-device /
    testing path over all bricks at once).
    """
    n_local = brick_shard[0].shape[0]
    scale = f32(2.0 ** level)
    inv_scale = f32(2.0 ** -level)

    def intersect(origins, dirs, max_depth=C.MAX_DEPTH, cone_trace=False,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS, active=None,
                  stack_depth=C.MAX_DEPTH, inner_steps=None):
        best = None
        for b in range(n_local):
            arrays_b = tuple(a[b] for a in brick_shard)
            o_l = (origins - corner_shard[b][None, :]) * scale + f32(1.0)
            res = traverse.intersect_octree(
                arrays_b, o_l, dirs, max_depth=max_depth - level,
                cone_trace=cone_trace, max_iterations=max_iterations,
                active=active, stack_depth=stack_depth,
                inner_steps=inner_steps)
            node_g = jnp.where(res.hit, orig_shard[b][res.node], -1)
            t_g = res.t * inv_scale
            se_g = res.scale_exp2 * inv_scale
            normal = res.normal
            hit_pos = (origins + t_g[:, None] * dirs
                       + normal * (se_g * 2)[:, None])
            # voxel_pos from the local traversal already includes the
            # normal*scale_exp2*2*1.74 offset in LOCAL units; rescaling the
            # whole local vector rescales the offset consistently
            voxel_pos = (corner_shard[b][None, :]
                         + (res.voxel_pos - f32(1.0)) * inv_scale)
            res_g = traverse.HitResult(
                hit=res.hit, value=res.value, t=t_g, iters=res.iters,
                scale_exp2=se_g, depth=res.depth + level, normal=normal,
                hit_pos=hit_pos, voxel_pos=voxel_pos, node=node_g)
            best = res_g if best is None else _combine_local(best, res_g)

        if axis_name is None:
            return best

        # --- cross-device nearest-hit combine (collectives) ---
        t_or_inf = jnp.where(best.hit, best.t, _INF)
        t_best = jax.lax.pmin(t_or_inf, axis_name)
        n_dev = jax.lax.axis_size(axis_name)
        mine = best.hit & (t_or_inf == t_best)
        rank = jnp.where(mine, jax.lax.axis_index(axis_name), n_dev)
        rank_best = jax.lax.pmin(rank, axis_name)
        win = mine & (rank == rank_best.astype(rank.dtype))

        def sel(x):
            m = win[..., None] if x.ndim > win.ndim else win
            return jax.lax.psum(jnp.where(m, x, jnp.zeros_like(x)), axis_name)

        hit = jnp.isfinite(t_best)
        return traverse.HitResult(
            hit=hit, value=sel(best.value), t=jnp.where(hit, t_best, best.t),
            iters=jax.lax.psum(best.iters, axis_name),
            scale_exp2=sel(best.scale_exp2), depth=sel(best.depth),
            normal=sel(best.normal), hit_pos=sel(best.hit_pos),
            voxel_pos=sel(best.voxel_pos),
            node=jnp.where(hit, sel(jnp.where(best.node < 0, 0, best.node)),
                           -1),
        )

    return intersect


def _shade_rows(intersect_fn, cam5, width, height, row0, rows, render_mode,
                frame_number, gi_bounces, max_iterations):
    dirs = shade.pixel_dirs_rows(cam5, width, height, row0, rows)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam5[0], dirs.shape)
    if render_mode == 0:
        px = jnp.tile(jnp.arange(width, dtype=f32), rows)
        py = jnp.repeat(jnp.arange(rows, dtype=f32) + jnp.asarray(row0, f32),
                        width)
        col, _, _ = shade.shade_gi(None, origins, dirs, px, py, frame_number,
                                   gi_bounces=gi_bounces,
                                   max_iterations=max_iterations,
                                   intersect_fn=intersect_fn)
    elif render_mode == 1:
        col, _, _ = shade.shade_heatmap(None, origins, dirs,
                                        max_iterations=max_iterations,
                                        intersect_fn=intersect_fn)
    elif render_mode == 2:
        col, _, _ = shade.shade_direct(None, origins, dirs,
                                       max_iterations=max_iterations,
                                       intersect_fn=intersect_fn)
    elif render_mode == 3:
        col, _, _ = shade.shade_normals(None, origins, dirs,
                                        max_iterations=max_iterations,
                                        intersect_fn=intersect_fn)
    else:
        raise ValueError(f"unknown render mode {render_mode}")
    return col.reshape(rows, width, 3)


def make_brick_render(mesh: Mesh, bricks: BrickSet, width: int, height: int,
                      render_mode: int = 2, frame_number: int = 1,
                      gi_bounces: int = 1,
                      max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Full-frame render with the octree brick-sharded over the mesh's
    ``bricks`` axis and (optionally) rows sharded over a ``tiles`` axis.

    Returns ``render(brick_set, cam5) -> (H, W, 3)`` (jitted; pass the
    device-resident ``bricks.to_device()`` set).  The number of bricks must
    divide over the ``bricks`` axis; each device serially traverses its
    ``8**level / n_bricks_axis`` bricks and the nearest hit is combined with
    a pmin over the axis.
    """
    has_tiles = "tiles" in mesh.axis_names
    n_tiles = mesh.shape.get("tiles", 1)
    nb = mesh.shape["bricks"]
    assert bricks.n_bricks % nb == 0, (
        f"{bricks.n_bricks} bricks cannot shard over {nb}-way axis")
    assert height % n_tiles == 0
    rows = height // n_tiles
    level = bricks.level

    brick_spec = P("bricks")
    row_spec = P("tiles") if has_tiles else P()
    out_spec = P("tiles") if has_tiles else P()
    rep = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=((brick_spec,) * 4, brick_spec, brick_spec, rep, row_spec),
        out_specs=out_spec, check_vma=False)
    def _render(brick_arrays, corners, orig, cam5, row0):
        isect = make_brick_intersect(brick_arrays, corners, orig, level,
                                     axis_name="bricks")
        return _shade_rows(isect, cam5, width, height, row0[0], rows,
                           render_mode, frame_number, gi_bounces,
                           max_iterations)

    offs = jnp.arange(max(n_tiles, 1), dtype=i32) * rows
    jrender = jax.jit(_render)

    def render(bs: BrickSet, cam5):
        return jrender(bs.arrays(), bs.corners, bs.orig,
                       jnp.asarray(cam5, f32), offs)

    return render


def make_brick_train_step(mesh: Mesh, bricks: BrickSet, width: int,
                          height: int, lr: float = 0.5,
                          max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Differentiable-render SGD step with the octree brick-sharded (and rows
    tile-sharded when the mesh has a ``tiles`` axis).

    Voxel parameters stay replicated and node-table-aligned to the *source*
    tree — the brick intersect returns global node ids (``orig`` remap), so
    the forward gather / backward scatter-add address the global table
    unchanged (diff/render_diff.py).  The brick-combine psum makes hit
    geometry identical on every device along ``bricks``, so parameter
    gradients only need the all-reduce over ``tiles`` (the DP analog);
    autodiff differentiates *through* the brick collectives.

    Returns ``step(params, brick_set, cam5, target) -> (params, loss)``.
    """
    from ..diff.render_diff import VoxelParams

    has_tiles = "tiles" in mesh.axis_names
    n_tiles = mesh.shape.get("tiles", 1)
    nb = mesh.shape["bricks"]
    assert bricks.n_bricks % nb == 0
    assert height % n_tiles == 0
    rows = height // n_tiles
    level = bricks.level

    brick_spec = P("bricks")
    row_spec = P("tiles") if has_tiles else P()
    rep = P()

    def _local_loss(params, isect, cam5, row0, target_rows):
        dirs = shade.pixel_dirs_rows(cam5, width, height, row0, rows)
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = jnp.broadcast_to(cam5[0], dirs.shape)
        res = isect(origins, dirs, max_iterations=max_iterations)
        node = jnp.where(res.hit, res.node, 0)
        alb = params.albedo[node]
        den = jax.nn.softplus(params.density[node])
        alpha = 1.0 - jnp.exp(-den * res.scale_exp2)
        normal = jnp.nan_to_num(res.normal)
        light = jnp.clip(jnp.sum(normal * shade.SUN_DIR_DIRECT[None, :],
                                 axis=-1), 0.0, 1.0) * 0.7 + 0.3
        surf = alb * light[:, None]
        bg = shade.sky(dirs)
        col = jnp.where(res.hit[:, None],
                        alpha[:, None] * surf + (1 - alpha[:, None]) * bg, bg)
        return jnp.sum((col.reshape(rows, width, 3) - target_rows) ** 2)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(rep, (brick_spec,) * 4, brick_spec, brick_spec, rep,
                  row_spec, row_spec),
        out_specs=(rep, rep), check_vma=False)
    def _step(params, brick_arrays, corners, orig, cam5, row0, target_rows):
        isect = make_brick_intersect(brick_arrays, corners, orig, level,
                                     axis_name="bricks")
        local_sum, grads = jax.value_and_grad(_local_loss)(
            params, isect, cam5, row0[0], target_rows)
        if has_tiles:
            grads = jax.tree.map(lambda g: jax.lax.psum(g, "tiles"), grads)
            local_sum = jax.lax.psum(local_sum, "tiles")
        denom = f32(height * width * 3)
        new = VoxelParams(
            albedo=params.albedo - lr * grads.albedo / denom,
            density=params.density - lr * grads.density / denom,
        )
        return new, local_sum / denom

    offs = jnp.arange(max(n_tiles, 1), dtype=i32) * rows
    jstep = jax.jit(_step)

    def step(params, bs: BrickSet, cam5, target):
        return jstep(params, bs.arrays(), bs.corners, bs.orig,
                     jnp.asarray(cam5, f32), offs, jnp.asarray(target, f32))

    return step


def intersect_bricks_local(bricks: BrickSet, origins, dirs, **kw):
    """Single-device reference path: traverse every brick locally and merge.
    Semantically equals ``traverse.intersect_octree`` on the unsplit tree
    (up to FP rounding in t and the homogeneous-leaf refinement of
    _leaf_brick) — the correctness oracle for the sharded path."""
    isect = make_brick_intersect(bricks.arrays(), bricks.corners, bricks.orig,
                                 bricks.level, axis_name=None)
    return isect(origins, dirs, **kw)
