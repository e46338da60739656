"""Shading: the four render modes, sky/sun, fog, shadows, GI bounces.

Re-expresses ``trace()`` (``src/shaders/svotrace.comp:435-646``) as fused
jitted array code over ray batches.  Where the reference runs one megakernel
thread per pixel, here each *segment* (primary ray, shadow ray, GI bounce) is
a batched traversal followed by elementwise shading — XLA fuses the shading
into the traversal epilogue, and dead rays are carried masked (the
"dead rays at 0 velocity" strategy of the reference's benchmarks,
``benchmarks.md:8-11``; compaction is a later optimization).

Render modes (svotrace.comp:443-646):
  0 — pathtraced GI: primary + diffuse bounces, sky/sun miss shading
  1 — iteration-count heatmap (cost visualization)
  2 — direct lighting: albedo + phong + per-channel exponential fog +
      shadow ray with penumbra heuristic  (the app default, Main.java:125)
  3 — normal visualization
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils import constants as C
from . import rng, traverse

f32 = jnp.float32

SQRT3 = f32(C.SQRT3)

#: Hardcoded shading palette keyed by voxel value (svotrace.comp:514-522 and
#: :577-586).  Value 1 = stone, 2 = scree, 3 = grass.
_PALETTE = {
    1: (0.84, 0.86, 0.78),
    2: (0.57, 0.50, 0.31),
    3: (0.37, 0.43, 0.27),
}

SKY_COLOR = jnp.array([0.6725, 0.8784, 1.0], f32)       # svotrace.comp:449
SKY_GRADIENT = jnp.array([0.4, 0.4, 0.25], f32)          # :450
SUN_DIR_GI = jnp.array([1.0, 1.0, 1.0], f32) / jnp.sqrt(f32(3.0))   # :546
SUN_DIR_DIRECT = jnp.array([0.5, 0.5, 0.5], f32) / jnp.sqrt(f32(0.75))  # :587


def material_color(value, voxel_pos):
    """Albedo by voxel value; default = hitpoint-1 (svotrace.comp:511-522)."""
    col = voxel_pos - f32(1.0)
    for v, rgb in _PALETTE.items():
        col = jnp.where((value == v)[:, None], jnp.asarray(rgb, f32), col)
    return col


def material_color_direct(value):
    """Mode-2 albedo: uninitialized GLSL local defaults to 0 for unknown
    values (svotrace.comp:577-586 has no default branch)."""
    col = jnp.zeros(value.shape + (3,), f32)
    for v, rgb in _PALETTE.items():
        col = jnp.where((value == v)[:, None], jnp.asarray(rgb, f32), col)
    return col


def sky(dirs):
    """Primary-miss sky gradient (svotrace.comp:449-450, :629-631)."""
    return SKY_COLOR[None, :] - dirs[:, 1:2] * SKY_GRADIENT[None, :]


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def cosine_bounce(normal, r):
    """The reference's hemisphere sample (svotrace.comp:494-506):
    newdir = normalize(u cos(2πr) + v sin(2πr) + w (1-r))."""
    w = normal
    use_y = jnp.abs(w[:, 0]) > f32(0.1)
    axis = jnp.where(use_y[:, None], jnp.asarray([0.0, 1.0, 0.0], f32),
                     jnp.asarray([1.0, 0.0, 0.0], f32))
    u = _normalize(jnp.cross(axis, w))
    v = jnp.cross(w, u)
    a = f32(2.0 * 3.14159265359) * r
    d = (u * jnp.cos(a)[:, None] + v * jnp.sin(a)[:, None]
         + w * (f32(1.0) - r)[:, None])
    return _normalize(d)


def mirror_bounce(d, normal):
    """Perfect mirror reflection (the commented-out branch at
    svotrace.comp:500-504): d - 2*dot(d, n)*n."""
    ndot = jnp.sum(d * normal, axis=-1, keepdims=True)
    return d - 2.0 * ndot * normal


def shade_gi(tree_arrays, origins, dirs, px, py, frame_number,
             gi_bounces=1, max_depth=C.MAX_DEPTH,
             max_iterations=C.MAX_RAYCAST_ITERATIONS, rng_mode="glsl",
             rng_key=None, mirror_values=(), intersect_fn=None):
    """Render mode 0 (svotrace.comp:443-560): primary + `gi_bounces`
    segments with sky/sun miss shading.

    ``intersect_fn``: optional replacement traversal with the signature of
    ``intersect_octree`` minus the leading tree_arrays (used by the
    brick-sharded path, parallel/bricks.py).

    ``mirror_values``: material ids shaded as perfect mirrors instead of
    lambertian diffuse — the reference's mirror experiments
    (svotrace.comp:500-504, benchmarks.md:6,11,15).

    Reference quirks preserved: the per-pixel random is identical across
    segments (seeds never change inside the loop), so a bounce-miss sun test
    on the re-sampled direction equals the actual bounce direction; depth is
    the *last* segment's hit distance (0 on bounce miss, -1 on primary miss).
    """
    isect = intersect_fn or functools.partial(traverse.intersect_octree,
                                              tree_arrays)
    B = origins.shape[0]
    accum = jnp.zeros((B, 3), f32)
    mask = jnp.ones((B, 3), f32)
    depth = jnp.full((B,), -1.0, f32)
    iters_out = jnp.zeros((B,), jnp.int32)
    active = jnp.ones((B,), bool)

    if rng_mode == "glsl":
        r = rng.pixel_rand(px.astype(f32), py.astype(f32),
                           jnp.asarray(frame_number, f32))
    o, d = origins, dirs
    for seg in range(gi_bounces + 1):
        # dead rays are masked out of the traversal entirely ("dead rays
        # culled", benchmarks.md:5-6) — without this, a retired or
        # NaN-direction ray spins the lock-step batch to the iteration cap
        res = isect(o, d, max_depth=max_depth, cone_trace=(seg > 0),
                    max_iterations=max_iterations, active=active)
        hit = active & res.hit
        miss = active & ~res.hit

        if seg == 0:
            # primary miss -> sky gradient (svotrace.comp:448-452)
            accum = jnp.where(miss[:, None], accum + sky(d), accum)
            iters_out = jnp.where(active, res.iters, iters_out)
        else:
            # bounce miss -> sun disk + ambient (svotrace.comp:536-557)
            sun_hit = jnp.arccos(jnp.clip(jnp.sum(d * SUN_DIR_GI[None, :],
                                                  axis=-1), -1.0, 1.0)) < f32(0.4)
            add = jnp.where(sun_hit[:, None], mask * f32(7.0), 0.0)
            add = add + mask  # ambient 1.0
            accum = jnp.where(miss[:, None], accum + add, accum)
            depth = jnp.where(miss, f32(0.0), depth)
            iters_out = jnp.where(hit, res.iters, iters_out)

        if rng_mode == "threefry":
            r = rng.threefry_uniform(rng_key, jnp.arange(B), frame_number,
                                     seg, 1)[:, 0]

        normal = jnp.nan_to_num(res.normal)
        newdir = cosine_bounce(normal, r)
        if mirror_values:
            is_mirror = jnp.zeros(B, bool)
            for v in mirror_values:
                is_mirror = is_mirror | (res.value == v)
            newdir = jnp.where(is_mirror[:, None], mirror_bounce(d, normal),
                               newdir)
        # zero normals (non-surface hits / packed-raw 555) make the bounce
        # frame degenerate -> NaN newdir; the reference's behavior there is
        # GLSL-undefined, so pick the deterministic fallback of bouncing
        # straight back
        newdir = jnp.where(jnp.isfinite(newdir), newdir, -d)
        matcolor = material_color(res.value, res.voxel_pos)

        depth = jnp.where(hit, res.t, depth)
        ndotl = jnp.sum(newdir * normal, axis=-1, keepdims=True)
        if mirror_values:
            # mirrors attenuate by albedo only (no cosine term)
            ndotl = jnp.where(is_mirror[:, None], 1.0, ndotl)
        mask = jnp.where(hit[:, None], mask * matcolor * ndotl, mask)
        o = jnp.where(hit[:, None], res.voxel_pos, o)
        d = jnp.where(hit[:, None], newdir, d)
        active = hit

    return accum, depth, iters_out


@jax.jit
def direct_shade_math(dirs, res, sh, beam_dist):
    """The pure-shading math of render mode 2 given the primary (``res``)
    and shadow (``sh``) hit records — jitted separately so host-driven
    traversal drivers (render_frame_staged) don't dispatch it op-by-op."""
    col = material_color_direct(res.value)

    normal = jnp.nan_to_num(res.normal)
    phong = jnp.sum(normal * SUN_DIR_DIRECT[None, :], axis=-1) * f32(0.1)
    flat = jnp.sum(jnp.asarray([0.0, 1.0, 0.0], f32) * SUN_DIR_DIRECT) * f32(0.1)
    col = col + jnp.where(res.depth >= 10, phong, flat)[:, None]

    true_dist = res.t + beam_dist
    # per-channel exponential fog toward white, channel coefs 1/2/4
    # (svotrace.comp:595-604; the .g/.b fog swap is invisible on white fog)
    lam = jnp.exp(-f32(0.5) * true_dist[:, None]
                  * jnp.asarray([1.0, 2.0, 4.0], f32))
    col = lam * col + (f32(1.0) - lam)

    shadowed = sh.hit & (sh.t > sh.scale_exp2 * SQRT3)
    penumbra = ~shadowed & (sh.iters > 260)
    col = jnp.where(shadowed[:, None], col - f32(0.2), col)
    col = jnp.where(penumbra[:, None],
                    col - f32(0.05) * (sh.iters.astype(f32) / f32(100.0))[:, None],
                    col)

    col = jnp.where(res.hit[:, None], col, sky(dirs))
    depth = jnp.where(res.hit, res.t, f32(0.0))
    return col, depth, res.iters


def shade_direct(tree_arrays, origins, dirs, beam_dist=None,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, intersect_fn=None):
    """Render mode 2 (svotrace.comp:572-632): albedo + phong + fog + shadow."""
    isect = intersect_fn or functools.partial(traverse.intersect_octree,
                                              tree_arrays)
    res = isect(origins, dirs, max_depth=max_depth,
                max_iterations=max_iterations)
    # shadow ray from the hit voxel toward the sun (svotrace.comp:606-619);
    # the shader reuses `res`, so the scale/iter tests read the SHADOW hit
    sh = isect(res.voxel_pos,
               jnp.broadcast_to(SUN_DIR_DIRECT, res.voxel_pos.shape),
               max_depth=max_depth, max_iterations=max_iterations,
               active=res.hit)
    bd = jnp.zeros_like(res.t) if beam_dist is None else beam_dist
    return direct_shade_math(dirs, res, sh, bd)


def shade_heatmap(tree_arrays, origins, dirs, max_depth=C.MAX_DEPTH,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS,
                  intersect_fn=None):
    """Render mode 1 (svotrace.comp:561-571): traversal-cost visualization.
    Hits are 0.005*iter (svotrace.comp:428), misses 0.01*iter (:375)."""
    isect = intersect_fn or functools.partial(traverse.intersect_octree,
                                              tree_arrays)
    res = isect(origins, dirs, max_depth=max_depth,
                max_iterations=max_iterations)
    it = res.iters.astype(f32)
    v = jnp.where(res.hit, f32(0.005) * it, f32(0.01) * it)
    col = jnp.repeat(v[:, None], 3, axis=1)
    depth = jnp.where(res.hit, res.t, f32(0.0))
    return col, depth, res.iters


def shade_normals(tree_arrays, origins, dirs, max_depth=C.MAX_DEPTH,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS,
                  intersect_fn=None):
    """Render mode 3 (svotrace.comp:633-642): normal visualization."""
    isect = intersect_fn or functools.partial(traverse.intersect_octree,
                                              tree_arrays)
    res = isect(origins, dirs, max_depth=max_depth,
                max_iterations=max_iterations)
    col = jnp.where(res.hit[:, None], res.normal * f32(0.5) + f32(0.5),
                    f32(0.0))
    depth = jnp.where(res.hit, res.t, f32(0.0))
    return col, depth, res.iters


def pixel_dirs_rows(cam5, width, height, row0, nrows):
    """Unnormalized ray directions for image rows [row0, row0+nrows),
    flattened (nrows*width, 3).  ``row0`` may be traced (ray-tile sharding
    passes each device its own row offset); ``nrows`` is static.

    dir = mix(mix(l1,l2,p.y), mix(r1,r2,p.y), p.x), p = (px+0.5)/size
    (svotrace.comp:662-664).  Row 0 = p.y~0 (GL bottom row).
    """
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    pxs = (jnp.arange(width, dtype=f32) + f32(0.5)) / f32(width)
    pys = ((jnp.arange(nrows, dtype=f32) + jnp.asarray(row0, f32) + f32(0.5))
           / f32(height))
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = left[:, None, :] + (right - left)[:, None, :] * pxs[None, :, None]
    return dirs.reshape(-1, 3)


def pixel_dirs_device(cam5, width, height):
    """All per-pixel unnormalized directions, flattened (H*W, 3)."""
    return pixel_dirs_rows(cam5, width, height, 0, height)


def beam_prepass(tree_arrays, cam5, width, height, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, packed=None):
    """Coarse-ray prepass (svobeam.comp:618-636): one cone-traced ray per
    beam_tile x beam_tile pixel tile seeds a conservative start distance.

    Reference quirks replicated deliberately: the coarse ray direction is the
    *unnormalized* corner mix (svobeam.comp:625,630 — t is then measured in
    units of |dir|>1 while the fine ray applies it along a unit direction, so
    the fine start always undershoots the true hit = conservative); the
    coarse pixel is the tile's corner (gl_GlobalInvocationID*4), not center;
    misses write 0 rather than the shader's uninitialized read.
    """
    bw, bh = width // beam_tile, height // beam_tile
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    pxs = (jnp.arange(bw, dtype=f32) * beam_tile + f32(0.5)) / f32(width)
    pys = (jnp.arange(bh, dtype=f32) * beam_tile + f32(0.5)) / f32(height)
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = (left[:, None, :]
            + (right - left)[:, None, :] * pxs[None, :, None]).reshape(-1, 3)
    origins = jnp.broadcast_to(cam5[0], dirs.shape)
    res = traverse.intersect_octree(tree_arrays, origins, dirs,
                                    max_depth=max_depth, cone_trace=True,
                                    max_iterations=max_iterations,
                                    packed=packed)
    t = jnp.where(res.hit, res.t, f32(0.0))
    return t.reshape(bh, bw)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "render_mode", "gi_bounces", "use_beam", "beam_tile",
    "max_iterations", "rng_mode", "mirror_values"))
def render_image(tree_arrays, cam5, width, height, render_mode=2,
                 frame_number=1, gi_bounces=1, use_beam=False, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, rng_mode="glsl",
                 rng_key=None, mirror_values=(), packed=None):
    """Full-frame render — the per-frame GPU work of Main.updateEarly
    (Main.java:257-288) as one jitted function.

    Returns (color (H,W,3), depth (H,W), iters (H,W)).  Row 0 is the GL
    bottom scanline; PNG writers flip.

    ``packed``: optional scene-cached word table (Octree.packed_table()) —
    without it every frame re-derives the table (8 full-table scatters, the
    dominant per-frame cost on big worlds).
    """
    cam5 = jnp.asarray(cam5, f32)
    dirs_un = pixel_dirs_device(cam5, width, height)
    dirs = dirs_un / jnp.linalg.norm(dirs_un, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam5[0], dirs.shape)
    isect = None
    if packed is not None:
        isect = functools.partial(traverse.intersect_octree, tree_arrays,
                                  packed=packed)

    beam = None
    if use_beam:
        bt = beam_prepass(tree_arrays, cam5, width, height, beam_tile,
                          max_depth, max_iterations, packed=packed)
        # fine pixel (x, y) reads beam cell (x//tile, y//tile)
        # (svotrace.comp:656-658)
        by = jnp.arange(height) // beam_tile
        bx = jnp.arange(width) // beam_tile
        beam = bt[by[:, None], bx[None, :]].reshape(-1)
        origins = origins + dirs * beam[:, None]

    px = jnp.tile(jnp.arange(width, dtype=f32), height)
    py = jnp.repeat(jnp.arange(height, dtype=f32), width)

    if render_mode == 0:
        col, depth, iters = shade_gi(tree_arrays, origins, dirs, px, py,
                                     frame_number, gi_bounces, max_depth,
                                     max_iterations, rng_mode, rng_key,
                                     mirror_values, intersect_fn=isect)
    elif render_mode == 1:
        col, depth, iters = shade_heatmap(tree_arrays, origins, dirs,
                                          max_depth, max_iterations,
                                          intersect_fn=isect)
    elif render_mode == 2:
        col, depth, iters = shade_direct(tree_arrays, origins, dirs, beam,
                                         max_depth, max_iterations,
                                         intersect_fn=isect)
    elif render_mode == 3:
        col, depth, iters = shade_normals(tree_arrays, origins, dirs,
                                          max_depth, max_iterations,
                                          intersect_fn=isect)
    else:
        raise ValueError(f"unknown render mode {render_mode}")

    return (col.reshape(height, width, 3), depth.reshape(height, width),
            iters.reshape(height, width))


def render_frame_staged(tree_arrays, cam5, width, height, render_mode=2,
                        frame_number=1, gi_bounces=1, use_beam=True,
                        beam_tile=4, max_depth=C.MAX_DEPTH,
                        max_iterations=C.MAX_RAYCAST_ITERATIONS,
                        packed=None, row_block=None, round_steps=64,
                        inner_steps=traverse.INNER_STEPS, min_rows=32,
                        grow_rounds=False, max_round_steps=512,
                        pipeline=False):
    """Host-driven full-frame render using the compacting staged traversal
    (traverse.intersect_octree_staged).

    Differences from the fully-jitted :func:`render_image`:
      * each traversal runs as host-driven rounds with ray compaction, so
        the batch never pays max(iters) x all-lanes (the lock-step convoy);
      * the frame is processed in ``row_block``-row slices, bounding the
        working set of each traversal batch;
      * the beam prepass (svobeam.comp) is ON by default — fine rays start
        at the coarse conservative hit like the reference's default path.

    Not jittable.  Returns (color (H,W,3), depth (H,W), iters (H,W)).
    """
    cam5 = jnp.asarray(cam5, f32)
    if packed is None:
        packed = traverse.make_packed_table(tree_arrays)
    isect = functools.partial(traverse.intersect_octree_staged, tree_arrays,
                              packed=packed, round_steps=round_steps,
                              max_iterations=max_iterations,
                              inner_steps=inner_steps, min_rows=min_rows,
                              grow_rounds=grow_rounds,
                              max_round_steps=max_round_steps,
                              pipeline=pipeline)
    if row_block is None:
        row_block = max(1, min(height, (1 << 18) // width))
    while height % row_block:
        row_block -= 1

    beam_img = None
    if use_beam:
        bw, bh = width // beam_tile, height // beam_tile
        l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
        pxs = (jnp.arange(bw, dtype=f32) * beam_tile + f32(0.5)) / f32(width)
        pys = (jnp.arange(bh, dtype=f32) * beam_tile + f32(0.5)) / f32(height)
        left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
        right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
        bdirs = (left[:, None, :]
                 + (right - left)[:, None, :] * pxs[None, :, None]
                 ).reshape(-1, 3)
        borig = jnp.broadcast_to(cam5[0], bdirs.shape)
        bres = isect(borig, bdirs, max_depth=max_depth, cone_trace=True)
        beam_img = jnp.where(bres.hit, bres.t, f32(0.0)).reshape(bh, bw)

    cols, depths, iters = [], [], []
    for r0 in range(0, height, row_block):
        dirs_un = pixel_dirs_rows(cam5, width, height, r0, row_block)
        dirs = dirs_un / jnp.linalg.norm(dirs_un, axis=-1, keepdims=True)
        origins = jnp.broadcast_to(cam5[0], dirs.shape)
        beam = None
        if beam_img is not None:
            by = (jnp.arange(r0, r0 + row_block)) // beam_tile
            bx = jnp.arange(width) // beam_tile
            beam = beam_img[by[:, None], bx[None, :]].reshape(-1)
            origins = origins + dirs * beam[:, None]

        if render_mode == 0:
            px = jnp.tile(jnp.arange(width, dtype=f32), row_block)
            py = jnp.repeat(jnp.arange(row_block, dtype=f32) + f32(r0), width)
            c, d, it = shade_gi(None, origins, dirs, px, py, frame_number,
                                gi_bounces, max_depth, max_iterations,
                                intersect_fn=isect)
        elif render_mode == 1:
            c, d, it = shade_heatmap(None, origins, dirs, max_depth,
                                     max_iterations, intersect_fn=isect)
        elif render_mode == 2:
            res = isect(origins, dirs, max_depth=max_depth)
            sh = isect(res.voxel_pos,
                       jnp.broadcast_to(SUN_DIR_DIRECT, res.voxel_pos.shape),
                       max_depth=max_depth, active=res.hit)
            bd = jnp.zeros_like(res.t) if beam is None else beam
            c, d, it = direct_shade_math(dirs, res, sh, bd)
        elif render_mode == 3:
            c, d, it = shade_normals(None, origins, dirs, max_depth,
                                     max_iterations, intersect_fn=isect)
        else:
            raise ValueError(f"unknown render mode {render_mode}")
        cols.append(c.reshape(row_block, width, 3))
        depths.append(d.reshape(row_block, width))
        iters.append(it.reshape(row_block, width))

    return (jnp.concatenate(cols), jnp.concatenate(depths),
            jnp.concatenate(iters))


def render_progressive(tree_arrays, cam5, width, height, spp=4,
                       gi_bounces=1, rng_key=None, mirror_values=(),
                       max_depth=C.MAX_DEPTH,
                       max_iterations=C.MAX_RAYCAST_ITERATIONS):
    """Progressive pathtrace accumulation — done *properly*.

    The reference plumbed ``frameNumber`` for running-average accumulation
    but left it commented out (svotrace.comp:712-719, Main.java:162).  Here:
    spp independent mode-0 samples with threefry counter RNG, averaged.
    Returns (color, depth of last sample).
    """
    import jax as _jax

    if rng_key is None:
        rng_key = _jax.random.PRNGKey(0)
    accum = None
    for s in range(spp):
        col, depth, _ = render_image(
            tree_arrays, cam5, width, height, render_mode=0,
            frame_number=s + 1, gi_bounces=gi_bounces, rng_mode="threefry",
            rng_key=rng_key, mirror_values=mirror_values,
            max_depth=max_depth, max_iterations=max_iterations)
        accum = col if accum is None else accum + col
    return accum / spp, depth
