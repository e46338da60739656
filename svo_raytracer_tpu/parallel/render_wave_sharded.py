"""Ray-tile-sharded rendering over the production traversal.

The ESVO sharded renderer (parallel/render_sharded.py) shards the jitted
XLA walk; this module shards the production engine
(ops/wavefront.intersect), which is one jittable call and therefore
composes with ``shard_map`` directly: each device renders its rows of
the image, with the brick scene replicated.  This is the multi-device
story for the reference's only scaling axis (more GL workgroups,
Main.java:285) re-expressed as mesh parallelism.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import render_wave, wavefront

f32 = jnp.float32
i32 = jnp.int32


def _row_offsets(mesh: Mesh, height: int):
    n = mesh.shape["tiles"]
    assert height % n == 0, f"height {height} must divide over {n} tiles"
    rows = height // n
    offs = jnp.arange(n, dtype=i32) * rows
    return offs, rows


def _shard_rays(cam5, width, height, rows, row0, stride=1):
    """Rays for rows ``row0, row0+stride, ...`` (``rows`` of them).
    stride=1 is a contiguous band; stride=n_devices interleaves rows
    round-robin across shards — terrain frames divide into sky/ground
    bands, which contiguous bands split unevenly while interleaved rows
    average out (scripts/scaling_harness.py)."""
    ridx = row0.astype(f32) + jnp.arange(rows, dtype=f32) * f32(stride)
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    pxs = (jnp.arange(width, dtype=f32) + f32(0.5)) / f32(width)
    pys = (ridx + f32(0.5)) / f32(height)
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = (left[:, None, :]
            + (right - left)[:, None, :] * pxs[None, :, None]).reshape(-1, 3)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam5[0], dirs.shape)
    px = jnp.tile(jnp.arange(width, dtype=f32), rows)
    py = jnp.repeat(ridx, width)
    return origins, dirs, px, py


def make_wave_sharded_render(mesh: Mesh, width: int, height: int,
                             render_mode=0, gi_bounces=1, interleave=True):
    """Jitted ``render(wscene, cam5, frame_number) -> color (H,W,3)`` with
    image rows sharded over ``tiles``.  ``interleave`` deals rows
    round-robin (row d, d+n, ... to shard d) so sky and ground rows
    spread evenly; otherwise each shard renders a contiguous band."""
    offs, rows = _row_offsets(mesh, height)
    n_sh = mesh.shape["tiles"]
    if interleave:
        offs = jnp.arange(n_sh, dtype=i32)
    stride = n_sh if interleave else 1
    rep = P()

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(rep, rep, rep, P("tiles")),
        out_specs=P("tiles"), check_vma=False)
    def _render(wscene, cam5, frame_number, row0):
        o, d, px, py = _shard_rays(cam5, width, height, rows, row0[0],
                                   stride=stride)
        col, _, _ = render_wave.shade_rays(
            lambda o, d, a: wavefront.intersect(wscene, o, d, a), o, d, px,
            py, frame_number, render_mode, gi_bounces)
        return col.reshape(rows, width, 3)

    @jax.jit
    def render(wscene, cam5, frame_number=1):
        col = _render(wscene, jnp.asarray(cam5, f32),
                      jnp.asarray(frame_number, f32), offs)
        if interleave:
            # shard d produced rows d, d+n, ... -> restore image order
            col = (col.reshape(n_sh, rows, width, 3)
                   .transpose(1, 0, 2, 3).reshape(height, width, 3))
        return col

    return render
