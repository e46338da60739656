"""Frame rendering through the production traversal (ops/wavefront.py).

The per-frame dispatch of the reference (Main.java:257-288: set uniforms,
dispatch svotrace over the pixel grid, render modes 0-3 in
svotrace.comp:435-646) as ONE jitted function per (mode, bounces, size):
primary rays, every traversal segment and all shading between them run
in a single dispatch, like shade.render_image on the ESVO walk.

No beam prepass: the traversal's L0 brick march already gives every ray
the empty-space skip the beam kernel (svobeam.comp) exists to provide.

Shading semantics are identical to ops/shade.py (same helpers), so the
render modes match the ESVO path pixel-for-pixel up to traversal FP slop
(tests/test_render_wave.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils import constants as C
from . import rng, shade, wavefront

f32 = jnp.float32
i32 = jnp.int32


def _frame_rays(cam5, width, height):
    """Primary rays in image row order (row 0 = GL bottom scanline), unit
    directions as shade.pixel_dirs_device gives them.  (A 32x32
    block-major order sped the primary segment up alone but moved no
    frame time on the card: PERF.md.)"""
    dirs_un = shade.pixel_dirs_device(cam5, width, height)
    dirs = dirs_un / jnp.linalg.norm(dirs_un, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam5[0], dirs.shape)
    px = jnp.tile(jnp.arange(width, dtype=f32), height)
    py = jnp.repeat(jnp.arange(height, dtype=f32), width)
    return origins, dirs, px, py


def _gi_update(first, mirror_values, accum, mask, depth, iters_out, active,
               o, d, r, res):
    """One segment of render mode 0 (svotrace.comp:443-560) given its hit
    record — the between-traversal math of shade.shade_gi."""
    hit = active & res.hit
    miss = active & ~res.hit

    if first:
        accum = jnp.where(miss[:, None], accum + shade.sky(d), accum)
        iters_out = jnp.where(active, res.iters, iters_out)
    else:
        sun_hit = jnp.arccos(jnp.clip(
            jnp.sum(d * shade.SUN_DIR_GI[None, :], axis=-1),
            -1.0, 1.0)) < f32(0.4)
        add = jnp.where(sun_hit[:, None], mask * f32(7.0), 0.0) + mask
        accum = jnp.where(miss[:, None], accum + add, accum)
        depth = jnp.where(miss, f32(0.0), depth)
        iters_out = jnp.where(hit, res.iters, iters_out)

    normal = jnp.nan_to_num(res.normal)
    newdir = shade.cosine_bounce(normal, r)
    if mirror_values:
        is_mirror = jnp.zeros(active.shape, bool)
        for v in mirror_values:
            is_mirror = is_mirror | (res.value == v)
        newdir = jnp.where(is_mirror[:, None],
                           shade.mirror_bounce(d, normal), newdir)
    newdir = jnp.where(jnp.isfinite(newdir), newdir, -d)
    matcolor = shade.material_color(res.value, res.voxel_pos)

    depth = jnp.where(hit, res.t, depth)
    ndotl = jnp.sum(newdir * normal, axis=-1, keepdims=True)
    if mirror_values:
        ndotl = jnp.where(is_mirror[:, None], 1.0, ndotl)
    mask = jnp.where(hit[:, None], mask * matcolor * ndotl, mask)
    o = jnp.where(hit[:, None], res.voxel_pos, o)
    d = jnp.where(hit[:, None], newdir, d)
    return accum, mask, depth, iters_out, hit, o, d


def _gi_init(px, py, frame_number, dirs):
    B = dirs.shape[0]
    r = rng.pixel_rand(px, py, frame_number.astype(f32))
    return (jnp.zeros((B, 3), f32), jnp.ones((B, 3), f32),
            jnp.full((B,), -1.0, f32), jnp.zeros((B,), i32),
            jnp.ones((B,), bool), r)


def _heat_post(res):
    it = res.iters.astype(f32)
    v = jnp.where(res.hit, f32(0.005) * it, f32(0.01) * it)
    return (jnp.repeat(v[:, None], 3, axis=1),
            jnp.where(res.hit, res.t, f32(0.0)), res.iters)


def _norm_post(res):
    col = jnp.where(res.hit[:, None], res.normal * f32(0.5) + f32(0.5),
                    f32(0.0))
    return col, jnp.where(res.hit, res.t, f32(0.0)), res.iters


def _shadow_rays(res):
    return (res.voxel_pos,
            jnp.broadcast_to(shade.SUN_DIR_DIRECT, res.voxel_pos.shape),
            res.hit)


def shade_rays(isect, origins, dirs, px, py, frame_number, render_mode,
               gi_bounces, mirror_values=()):
    """Every traversal segment and all shading of one ray set (pixel
    coordinates ``px``/``py`` seed the GI RNG).  ``isect(o, d, active)``
    traces one segment.  Returns flat (color, depth, iters)."""
    if render_mode == 0:
        accum, mask, depth, iters_out, active, r = _gi_init(
            px, py, frame_number, dirs)
        o, d = origins, dirs
        for seg in range(gi_bounces + 1):
            res = isect(o, d, active)
            accum, mask, depth, iters_out, active, o, d = _gi_update(
                seg == 0, mirror_values, accum, mask, depth, iters_out,
                active, o, d, r, res)
        return accum, depth, iters_out
    ones = jnp.ones(dirs.shape[0], bool)
    res = isect(origins, dirs, ones)
    if render_mode == 1:
        return _heat_post(res)
    if render_mode == 2:
        so, sd, sa = _shadow_rays(res)
        sh = isect(so, sd, sa)
        return shade.direct_shade_math(dirs, res, sh, jnp.zeros_like(res.t))
    if render_mode == 3:
        return _norm_post(res)
    raise ValueError(f"unknown render mode {render_mode}")


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "render_mode", "gi_bounces", "mirror_values",
    "intersect"))
def render_frame(scene, cam5, frame_number, *, width, height, render_mode,
                 gi_bounces=1, mirror_values=(),
                 intersect=wavefront.intersect):
    """One whole frame as a single jitted dispatch.  ``intersect(scene,
    o, d, active) -> HitResult`` is the traversal (the production kernel;
    the XLA reference brick_trace.intersect_scene traces the same frame
    for comparison).  Returns (color (H,W,3), depth (H,W), iters (H,W))."""
    origins, dirs, px, py = _frame_rays(cam5, width, height)
    col, depth, it = shade_rays(
        lambda o, d, a: intersect(scene, o, d, a), origins, dirs, px, py,
        frame_number, render_mode, gi_bounces, mirror_values)
    return (col.reshape(height, width, 3), depth.reshape(height, width),
            it.reshape(height, width))


def render_frame_wavefront(wscene, cam5, width, height, render_mode=0,
                           frame_number=1, gi_bounces=1, mirror_values=(),
                           max_depth=C.MAX_DEPTH):
    """Render one frame of a WaveScene.

    Returns (color (H,W,3), depth (H,W), iters (H,W)); row 0 is the GL
    bottom scanline like shade.render_image.  ``max_depth`` is accepted
    for signature parity; the brick engine always resolves finest leaves
    (see ops/brick_trace.py docstring).  Mode 0 uses the GLSL per-pixel
    RNG (use shade.render_progressive for threefry).
    """
    del max_depth
    return render_frame(wscene, jnp.asarray(cam5, f32),
                        jnp.asarray(frame_number, f32), width=width,
                        height=height, render_mode=render_mode,
                        gi_bounces=gi_bounces,
                        mirror_values=tuple(mirror_values))
