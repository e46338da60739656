"""Canned benchmark scenes — the five BASELINE.json configs.

  1. 64^3 procedural-noise octree, primary rays + normal shading, 512x512
  2. 256^3 heightmap terrain, direct lighting + hard shadows, 1024x1024
  3. 1024^3 cave scene, 1-bounce diffuse GI, 4 spp accumulation
  4. 2048^3 mixed materials, 16 spp progressive pathtracing
  5. 8192^3 multi-chunk generated world, real-time GI, progressive

Each ``scene_N()`` returns (octree, camera, RenderConfig).  Large configs
build chunked; callers on small hosts can pass ``scale=1/16`` etc. to shrink
world resolution while keeping the scene structure.
"""

from __future__ import annotations

import numpy as np

from ..core import build_jax
from ..utils import constants as C
from ..utils.camera import Camera


def _perlin_world(size: int, chunk: int | None = None, y_offset=None,
                  capacity=1 << 22):
    import jax.numpy as jnp

    from . import procgen, world

    chunk = chunk or min(size, 512)
    y_offset = -size // 2 if y_offset is None else y_offset

    def gen(origin):
        return procgen.generate_chunk(jnp.asarray(origin, jnp.int32),
                                      chunk_size=chunk)

    return world.build_world(size, chunk, gen, chunk_capacity=capacity,
                             world_offset=(0, y_offset, 0))


def scene_1(scale: float = 1.0):
    """64^3 procedural noise, primary rays + normal shading, 512x512."""
    size = max(16, int(64 * scale))
    tree = _perlin_world(size, chunk=size)
    cam = Camera(pos=np.array([1.5, 1.6, 1.9]))
    cam.rotate(-0.4, 0.3)
    cfg = C.RenderConfig(width=512, height=512, render_mode=3)
    return tree, cam, cfg


def scene_2(scale: float = 1.0):
    """256^3 heightmap terrain, direct lighting + hard shadows, 1024x1024."""
    import jax.numpy as jnp

    from . import heightmap as hm_mod

    size = max(32, int(256 * scale))
    # synthetic rolling-hills heightmap (the real nzbig.png asset is not in
    # the mount; worldgen --kind heightmap accepts any 16-bit PNG)
    ax = np.arange(size)
    hm = ((np.sin(ax[:, None] * 0.05) + np.cos(ax[None, :] * 0.07) + 2.2)
          / 4.4 * 20000).astype(np.uint16)
    mm = np.full((size, size), 3, np.int32)
    v = hm_mod.generate_chunk_heightmap(
        jnp.asarray(hm), jnp.asarray(mm), jnp.asarray([0, 0, 0], jnp.int32),
        chunk_size=size, height_scale=size // 2)
    tree = build_jax.build_octree(np.asarray(v), capacity=1 << 22)
    cam = Camera(pos=np.array([1.5, 1.4, 1.8]))
    cam.rotate(-0.5, 0.2)
    cfg = C.RenderConfig(width=1024, height=1024, render_mode=2)
    return tree, cam, cfg


def scene_3(scale: float = 1.0):
    """1024^3 cave scene, 1-bounce diffuse GI, 4 spp accumulation."""
    import jax.numpy as jnp

    from ..ops import noise

    size = max(64, int(1024 * scale))
    ax = jnp.arange(size, dtype=jnp.int32) * (1024 // size)
    x = ax[:, None, None]
    y = ax[None, :, None]
    z = ax[None, None, :]
    # caves: solid where 3-D simplex is above a slight bias
    g = noise.snoise(x * 0.004, y * 0.004, z * 0.004)
    v = np.asarray(jnp.where(g > -0.1, 1, 0).astype(jnp.uint8))
    tree = build_jax.build_octree(v, capacity=1 << 23)
    cam = Camera(pos=np.array([1.5, 1.5, 1.5]))
    cfg = C.RenderConfig(width=1280, height=720, render_mode=0, gi_bounces=1)
    return tree, cam, cfg


def scene_4(scale: float = 1.0):
    """2048^3 mixed diffuse+mirror materials, 16 spp progressive."""
    size = max(64, int(2048 * scale))
    tree = _perlin_world(size, chunk=min(size, 512))
    cam = Camera(pos=np.array([1.5, 1.55, 1.8]))
    cam.rotate(-0.3, 0.5)
    cfg = C.RenderConfig(width=1920, height=1080, render_mode=0, gi_bounces=1)
    return tree, cam, cfg


def scene_5(scale: float = 1.0):
    """8192^3 multi-chunk world, real-time GI, full-frame progressive."""
    size = max(128, int(8192 * scale))
    tree = _perlin_world(size, chunk=min(size, 1024))
    cam = Camera(pos=np.array([1.5, 1.52, 1.7]))
    cam.rotate(-0.25, 0.8)
    cfg = C.RenderConfig(width=1920, height=1080, render_mode=0,
                         use_beam=True, gi_bounces=1)
    return tree, cam, cfg


def _fractal_heightmap(size: int, octaves: int = 6, seed: int = 9):
    """Deterministic multi-octave value-noise heightmap, pure NumPy —
    the self-contained stand-in for a real DEM (worldgen --kind
    heightmap accepts any 16-bit PNG, e.g. the reference's nz.png)."""
    rs = np.random.RandomState(seed)
    acc = np.zeros((size, size), np.float64)
    amp, cells = 1.0, 4
    for _ in range(octaves):
        g = rs.rand(cells + 1, cells + 1)
        # bilinear upsample the coarse lattice to size^2
        xi = np.linspace(0, cells, size)
        x0 = np.minimum(xi.astype(int), cells - 1)
        fx = (xi - x0)[:, None]
        fz = (xi - x0)[None, :]
        g00 = g[np.ix_(x0, x0)]
        g10 = g[np.ix_(x0 + 1, x0)]
        g01 = g[np.ix_(x0, x0 + 1)]
        g11 = g[np.ix_(x0 + 1, x0 + 1)]
        acc += amp * ((1 - fx) * (1 - fz) * g00 + fx * (1 - fz) * g10
                      + (1 - fx) * fz * g01 + fx * fz * g11)
        amp *= 0.55
        cells *= 2
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-12)
    return (acc * 48000).astype(np.uint16)


def scene_5_brick(scale: float = 1.0, heightmap=None, matmap=None):
    """Scene 5 built directly as a BrickScene (models/bigworld.py) for
    the production traversal — the octree scene_5 exists for pipeline
    parity; its chunked device build scales with the world's volume.
    Returns (BrickScene, Camera, RenderConfig).  ``wavefront.prepare``
    accepts scales whose attribute table fits int32 indexing; the full
    8192^3 scale does not (ROADMAP).

    heightmap: optional (size, size) uint16 array or 16-bit PNG path
    (e.g. the reference's assets/heightmaps/nz.png upsampled); defaults
    to a deterministic synthetic DEM so the repo stays self-contained.
    """
    from . import bigworld

    size = max(128, int(8192 * scale))
    if heightmap is None:
        hm = _fractal_heightmap(size)
    elif isinstance(heightmap, (str, bytes)):
        from PIL import Image

        img = Image.open(heightmap)
        hm = np.asarray(img.resize((size, size),
                                   Image.BILINEAR)).astype(np.uint16)
    else:
        hm = np.asarray(heightmap, np.uint16)
        assert hm.shape == (size, size), (hm.shape, size)
    mm = (np.full((size, size), 3, np.int32) if matmap is None
          else np.asarray(matmap, np.int32))
    scene = bigworld.heightmap_brick_scene(hm, mm, size)
    cam = Camera(pos=np.array([1.5, 1.52, 1.7]))
    cam.rotate(-0.25, 0.8)
    cfg = C.RenderConfig(width=1920, height=1080, render_mode=0,
                         gi_bounces=1)
    return scene, cam, cfg


SCENES = {1: scene_1, 2: scene_2, 3: scene_3, 4: scene_4, 5: scene_5}
