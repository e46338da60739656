"""Random numbers for the pathtracer.

Two generators:

* :func:`glsl_rand` / :func:`pixel_rand` — bit-compatible port of the
  reference's sin-hash (``svotrace.comp:26-29`` and the seed composition at
  ``:486``), used for parity testing against reference mode-0 renders.  Its
  statistical quality is poor (visible banding) — exactly like the reference.
* :func:`threefry_uniform` — counter-based threefry via ``jax.random``, the
  default for our own rendering: decorrelated per (pixel, frame, bounce)
  without any cross-frame state, which is the stateless way to do progressive
  accumulation (the reference left accumulation disabled,
  svotrace.comp:712-719).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

f32 = jnp.float32


def glsl_rand(x, y):
    """fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453) in float32."""
    s = jnp.sin(x.astype(f32) * f32(12.9898) + y.astype(f32) * f32(78.233))
    v = s * f32(43758.5453)
    return v - jnp.floor(v)


def pixel_rand(px, py, frame):
    """The composed per-pixel random of render mode 0 (svotrace.comp:486):
    rand(seed0 + rand(seed0, frame*0.1), seed1 + rand(seed1, frame*0.02))."""
    frame = jnp.asarray(frame, f32)
    r1 = glsl_rand(px, jnp.broadcast_to(frame * f32(0.1), px.shape))
    r2 = glsl_rand(py, jnp.broadcast_to(frame * f32(0.02), py.shape))
    return glsl_rand(px + r1, py + r2)


def threefry_uniform(key, pixel_index, frame, bounce, n):
    """Per-pixel uniforms u in [0,1): shape = pixel_index.shape + (n,)."""
    k = jax.random.fold_in(jax.random.fold_in(key, frame), bounce)
    # One key per pixel is too slow; use a single counter draw and index it.
    base = jax.random.uniform(k, pixel_index.shape + (n,), dtype=f32)
    return base
