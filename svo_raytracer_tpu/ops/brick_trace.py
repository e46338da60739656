"""Brick-wavefront ray traversal — reference XLA implementation.

Re-expresses the reference's per-pixel octree walk
(src/shaders/svotrace.comp:211-432) as a two-level DDA over the
BrickScene decomposition (ops/brick_scene.py):

  phase A: march the (world/32)^3 brick grid (L0 occupancy) to the next
           occupied brick — uniform-solid bricks resolve immediately;
  phase B: march the 32^3 voxels of a *mixed* brick; a hit resolves the
           per-voxel attribute word, an exit re-enters phase A.

Hit semantics match the ESVO walk at full depth: the DDA's first solid
voxel along the ray starts on the boundary of the leaf cube containing
it (solid leaves are solid throughout), so the entry distance equals the
leaf-cube entry t the stack walk reports; value/normal/depth come from
the rasterized leaf attributes, so the decoded fields (including the
stale-mask normal quirk) match.  Fields that cannot match by design:
``iters`` counts DDA steps, not PUSH/ADVANCE/POP rounds; ``node`` is -1
(no node table here).  ``cone_trace``/``max_depth`` LOD caps are
accepted but ignored — this path always resolves to the finest leaf.

This module is the *semantics* implementation (pure jnp, runs anywhere,
oracle-checked by tests/test_brick_trace.py).  The production engine
(ops/wavefront.py) runs the same phases per ray in one Pallas kernel and
is checked against this module.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .traverse import HitResult

f32 = jnp.float32
i32 = jnp.int32

#: nudge (voxel units) pushing a ray past a brick boundary before the next
#: coarse round; 2^-10 voxels = 2^-20 world units, far below feature size
_EXIT_EPS = 1.0 / 1024.0


def _clamp_dir(d):
    # 1e-4 keeps the minor-axis step above ulp(1024) = 6e-5: with
    # |d| ~ 1e-8 a near-axis ray's per-step movement vanishes below the
    # f32 ulp of a 1024-scale coordinate and the DDA never advances
    eps = f32(1e-4)
    return jnp.where(jnp.abs(d) < eps, jnp.where(d >= 0, eps, -eps), d)


def _march(pos, d, extent, cell, probe, max_steps, active):
    """Amanatides–Woo DDA over cells of edge ``cell`` in [0, extent]^3.

    pos/d: (B,) component dicts {x,y,z}; ``probe(ix,iy,iz)`` -> solid mask.
    Returns (hit, ix,iy,iz, t_entry, inside, steps): ``t_entry`` is the
    entry distance (along d, same units as pos) of the hit cell, or of the
    last crossing when not hit; ``inside`` reports whether the ray is
    still inside the grid (False => exited => definite miss beyond here).
    Plain jnp, so it runs and differentiates anywhere.
    """
    ox, oy, oz = pos
    dx, dy, dz = (_clamp_dir(c) for c in d)
    inv_x, inv_y, inv_z = 1.0 / dx, 1.0 / dy, 1.0 / dz
    n = extent // cell
    gf = f32(extent)

    # slab test: advance outside rays to the box entry
    t1x, t2x = (0.0 - ox) * inv_x, (gf - ox) * inv_x
    t1y, t2y = (0.0 - oy) * inv_y, (gf - oy) * inv_y
    t1z, t2z = (0.0 - oz) * inv_z, (gf - oz) * inv_z
    t_ent = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                    jnp.minimum(t1y, t2y)),
                        jnp.minimum(t1z, t2z))
    t_exit = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                     jnp.maximum(t1y, t2y)),
                         jnp.maximum(t1z, t2z))
    t0 = jnp.maximum(t_ent, 0.0)
    misses_box = (t_ent > t_exit) | (t_exit < 0.0)
    push = jnp.where(t0 > 0.0, t0 + f32(1e-4) * cell, 0.0)
    px = ox + push * dx
    py = oy + push * dy
    pz = oz + push * dz

    ix = jnp.clip((px / cell).astype(i32), 0, n - 1)
    iy = jnp.clip((py / cell).astype(i32), 0, n - 1)
    iz = jnp.clip((pz / cell).astype(i32), 0, n - 1)
    sx = jnp.where(dx > 0, i32(1), i32(-1))
    sy = jnp.where(dy > 0, i32(1), i32(-1))
    sz = jnp.where(dz > 0, i32(1), i32(-1))
    nx = jnp.where(dx > 0, ix + 1, ix).astype(f32) * cell
    ny = jnp.where(dy > 0, iy + 1, iy).astype(f32) * cell
    nz = jnp.where(dz > 0, iz + 1, iz).astype(f32) * cell
    tx = push + (nx - px) * inv_x
    ty = push + (ny - py) * inv_y
    tz = push + (nz - pz) * inv_z
    adx, ady, adz = (jnp.abs(inv_x) * cell, jnp.abs(inv_y) * cell,
                     jnp.abs(inv_z) * cell)

    alive0 = active & ~misses_box
    t_init = jnp.where(alive0, push, 0.0)

    def body(_, c):
        ix, iy, iz, tx, ty, tz, hit, t, steps = c
        inside = ((ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
                  & (iz >= 0) & (iz < n))
        act = alive0 & inside & ~hit
        solid = probe(jnp.clip(ix, 0, n - 1), jnp.clip(iy, 0, n - 1),
                      jnp.clip(iz, 0, n - 1))
        new_hit = act & solid
        hit = hit | new_hit
        act = act & ~new_hit
        steps = steps + act.astype(i32)
        mx = (tx <= ty) & (tx <= tz)
        my = ~mx & (ty <= tz)
        mz = ~mx & ~my
        tcur = jnp.minimum(jnp.minimum(tx, ty), tz)
        t = jnp.where(act, tcur, t)
        ix = jnp.where(act & mx, ix + sx, ix)
        iy = jnp.where(act & my, iy + sy, iy)
        iz = jnp.where(act & mz, iz + sz, iz)
        tx = jnp.where(act & mx, tx + adx, tx)
        ty = jnp.where(act & my, ty + ady, ty)
        tz = jnp.where(act & mz, tz + adz, tz)
        return (ix, iy, iz, tx, ty, tz, hit, t, steps)

    c = (ix, iy, iz, tx, ty, tz, jnp.zeros(ox.shape, bool), t_init,
         jnp.zeros(ox.shape, i32))
    c = jax.lax.fori_loop(0, max_steps, body, c)
    ix, iy, iz, tx, ty, tz, hit, t, steps = c
    inside = ((ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
              & (iz >= 0) & (iz < n)) & ~misses_box
    return hit, ix, iy, iz, t, inside, steps


def decode_hits(ws, origins, dirs, hit, attr, vx, vy, vz, t_vox, iters,
                node=None):
    """Assemble a HitResult from brick-path hit records.

    attr: packed value|raw_normal<<8|depth<<24 (brick_scene._attr_word);
    (vx,vy,vz): global voxel coords of the hit voxel; t_vox: hit distance
    in voxel units along ``dirs``.  Decode math mirrors
    traverse._decode (svotrace.comp:380-431).

    ``node``: brick engines have no node table, so the field defaults to
    -1; the production engine passes its attribute index instead — a
    stable per-voxel id the differentiable renderer (diff/wave_diff.py)
    keys learnable parameters by.
    """
    value = attr & 0xFF
    raw = (attr >> 8) & 0xFFFF
    depth = (attr >> 24) & 0x1F
    nx = ((raw % 10) - 5).astype(f32)
    ny = (((raw % 100) - (raw % 10)) // 10 - 5).astype(f32)
    nz = ((raw - (raw % 100)) // 100 - 5).astype(f32)
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    has_n = raw != 0
    nx = jnp.where(has_n, nx / nlen, f32(0.0))
    ny = jnp.where(has_n, ny / nlen, f32(0.0))
    nz = jnp.where(has_n, nz / nlen, f32(0.0))
    normal = jnp.stack([nx, ny, nz], axis=-1)

    t = t_vox / f32(ws)
    scale_exp2 = jnp.exp2(-depth.astype(f32))
    span = (ws >> jnp.clip(depth, 0, 30)).astype(i32)
    span = jnp.maximum(span, 1)
    cx = (vx // span) * span
    cy = (vy // span) * span
    cz = (vz // span) * span
    corner = (jnp.stack([cx, cy, cz], axis=-1).astype(f32) / f32(ws)
              + f32(1.0))
    voxel_pos = corner + normal * (scale_exp2 * 2 * f32(1.74))[:, None]
    o = origins.astype(f32)
    d = dirs.astype(f32)
    hit_pos = o + t[:, None] * d + normal * (scale_exp2 * 2)[:, None]

    value = jnp.where(hit, value, 0)
    return HitResult(
        hit=hit, value=value, t=t, iters=iters, scale_exp2=scale_exp2,
        depth=jnp.where(hit, depth, 0), normal=normal,
        hit_pos=hit_pos, voxel_pos=voxel_pos,
        node=(jnp.full(hit.shape, -1, i32) if node is None else node),
    )


@functools.partial(jax.jit, static_argnames=("ws", "G", "n_mixed",
                                             "max_rounds"))
def _intersect_impl(l0_flat, slot_map, brick_attr, occ_flat, attrs_flat,
                    origins, dirs, active, ws, G, n_mixed, max_rounds):
    B = origins.shape[0]
    o = origins.astype(f32)
    d = dirs.astype(f32)
    ov = ((o - 1.0) * f32(ws))
    ox, oy, oz = ov[:, 0], ov[:, 1], ov[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    finite = jnp.all(jnp.isfinite(o) & jnp.isfinite(d), axis=1)
    alive = active & finite

    W = -(-G // 32)

    def l0_probe(ix, iy, iz):
        w = (ix * G + iy) * W + (iz >> 5)
        word = l0_flat[jnp.clip(w, 0, l0_flat.shape[0] - 1)]
        return ((word >> (iz & 31)) & 1) != 0

    def round_body(state):
        (t_vox, alive, hit, attr, hvx, hvy, hvz, t_hit, iters, rnd) = state
        px = ox + t_vox * dx
        py = oy + t_vox * dy
        pz = oz + t_vox * dz

        # phase A: march brick cells
        chit, bx, by, bz, tA, inside, stA = _march(
            (px, py, pz), (dx, dy, dz), ws, 32, l0_probe, 3 * G + 4, alive)
        iters = iters + stA
        # exited the world without meeting an occupied brick -> miss
        alive = alive & (chit | inside)

        cell = (bx * G + by) * G + bz
        cellc = jnp.clip(cell, 0, G * G * G - 1)
        slot = jnp.where(chit, slot_map[cellc], -1)
        uattr = brick_attr[cellc]
        uni_solid = chit & (slot < 0) & ((uattr & 0xFF) != 0)

        # uniform-solid brick: hit at the brick entry face
        entry_t = t_vox + tA
        evx = jnp.clip((px + tA * dx).astype(i32), bx * 32, bx * 32 + 31)
        evy = jnp.clip((py + tA * dy).astype(i32), by * 32, by * 32 + 31)
        evz = jnp.clip((pz + tA * dz).astype(i32), bz * 32, bz * 32 + 31)
        new_hit = alive & uni_solid
        hit = hit | new_hit
        attr = jnp.where(new_hit, uattr, attr)
        hvx = jnp.where(new_hit, evx, hvx)
        hvy = jnp.where(new_hit, evy, hvy)
        hvz = jnp.where(new_hit, evz, hvz)
        t_hit = jnp.where(new_hit, entry_t, t_hit)
        alive = alive & ~new_hit

        # phase B: march voxels of the mixed brick
        in_mixed = alive & chit & (slot >= 0)
        lx = px + tA * dx - (bx * 32).astype(f32)
        ly = py + tA * dy - (by * 32).astype(f32)
        lz = pz + tA * dz - (bz * 32).astype(f32)
        slotc = jnp.clip(slot, 0, max(n_mixed - 1, 0))

        def occ_probe(ix, iy, iz):
            w = slotc * 1024 + ix * 32 + iy
            word = occ_flat[jnp.clip(w, 0, occ_flat.shape[0] - 1)]
            return ((word >> iz) & 1) != 0

        fhit, fx, fy, fz, tB, insB, stB = _march(
            (lx, ly, lz), (dx, dy, dz), 32, 1, occ_probe, 100, in_mixed)
        iters = iters + stB
        gvx, gvy, gvz = bx * 32 + fx, by * 32 + fy, bz * 32 + fz
        fattr = attrs_flat[jnp.clip(slotc * 32768 + fx * 1024 + fy * 32 + fz,
                                    0, attrs_flat.shape[0] - 1)]
        new_hit = in_mixed & fhit
        hit = hit | new_hit
        attr = jnp.where(new_hit, fattr, attr)
        hvx = jnp.where(new_hit, gvx, hvx)
        hvy = jnp.where(new_hit, gvy, hvy)
        hvz = jnp.where(new_hit, gvz, hvz)
        t_hit = jnp.where(new_hit, entry_t + tB, t_hit)
        alive = alive & ~new_hit

        # exited brick (or fine steps exhausted): advance past the crossing
        adv = in_mixed & ~fhit
        t_vox = jnp.where(adv, entry_t + tB + f32(_EXIT_EPS), t_vox)
        # coarse steps exhausted inside the grid without a cell hit:
        stuckA = alive & ~chit & inside
        t_vox = jnp.where(stuckA, t_vox + tA + f32(_EXIT_EPS), t_vox)

        return (t_vox, alive, hit, attr, hvx, hvy, hvz, t_hit, iters,
                rnd + 1)

    def cond(state):
        return jnp.any(state[1]) & (state[9] < max_rounds)

    zi = jnp.zeros(B, i32)
    state = (jnp.zeros(B, f32), alive, jnp.zeros(B, bool), zi, zi, zi, zi,
             jnp.zeros(B, f32), zi, jnp.asarray(0, i32))
    state = jax.lax.while_loop(cond, round_body, state)
    (_, _, hit, attr, hvx, hvy, hvz, t_hit, iters, _) = state
    return decode_hits(ws, o, d, hit, attr, hvx, hvy, hvz, t_hit, iters)


def intersect_bricks(scene, origins, dirs, max_depth=None, cone_trace=False,
                     max_iterations=None, active=None, max_rounds=64):
    """Trace (B,3) rays against a BrickScene; returns a HitResult.

    Signature-compatible with traverse.intersect_octree minus the node
    table (``max_depth``/``cone_trace``/``max_iterations`` accepted for
    driver compatibility; LOD caps are ignored — see module docstring).
    """
    B = origins.shape[0]
    if active is None:
        active = jnp.ones(B, bool)
    else:
        active = active.astype(bool)
    return _intersect_impl(
        scene.l0_table.reshape(-1), scene.brick_slot, scene.brick_attr,
        scene.occ_words.reshape(-1), scene.attrs.reshape(-1),
        origins, dirs, active, scene.world_size, scene.grid_size,
        scene.n_mixed, max_rounds)


def intersect_scene(ws, origins, dirs, active=None, max_rounds=64):
    """:func:`intersect_bricks` over a WaveScene's tables (ops/wavefront.py)
    — the XLA reference the production kernel is checked and timed
    against on the same device arrays."""
    if active is None:
        active = jnp.ones(origins.shape[0], bool)
    base = ws.capacity * 32768
    return _intersect_impl(
        ws.l0, ws.brick_slot, ws.attrs[base:], ws.occ, ws.attrs, origins,
        dirs, active.astype(bool), ws.world_size, ws.grid_size,
        ws.capacity, max_rounds)
