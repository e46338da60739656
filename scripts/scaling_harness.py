"""Virtual-device scaling harness.

Measures the two things that determine multi-chip scaling efficiency for
the ray-tile-sharded renderer without needing real chips:

  * per-device traversal LOAD (sum of iteration counts per row shard) —
    in lock-step SPMD the frame takes max(load) while useful work is
    mean(load), so efficiency <= mean/max ("balance" below);
  * wall-clock on an n-virtual-device CPU mesh vs 1 device at the SAME
    total work (a weak proxy — host cores are shared — but catches
    pathological collective/overhead regressions).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python scripts/scaling_harness.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import noise, shade
from svo_raytracer_tpu.parallel import mesh as mesh_mod
from svo_raytracer_tpu.parallel import render_sharded
from svo_raytracer_tpu.utils.camera import Camera


def main():
    size = 64
    ax = np.arange(size) * (2048 // size)
    v = np.asarray(noise.sample_perlin_terrain(
        jnp.asarray(ax[:, None, None]), jnp.asarray((ax - 1024)[None, :, None]),
        jnp.asarray(ax[None, None, :])))
    tree = build_np.build_octree_np(v).to_device()
    cam = Camera(pos=np.array([1.5, 1.62, 1.85]))
    cam.rotate(-0.4, 0.3)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    W, H = 128, 64

    # per-device load balance: iters per row-shard of the frame
    _, _, iters = shade.render_image(tree.arrays(), cam5, W, H,
                                     render_mode=2)
    iters = np.asarray(iters)
    for n in (1, 2, 4, 8):
        shard = iters.reshape(n, H // n, W).sum(axis=(1, 2)).astype(float)
        bal = shard.mean() / max(shard.max(), 1.0)
        print(json.dumps(dict(kind="load_balance", devices=n,
                              per_device_iters=[int(s) for s in shard],
                              balance=round(float(bal), 4))), flush=True)

    # same balance metric through the production traversal — its
    # per-ray iteration counts are DDA steps, not ESVO rounds
    from svo_raytracer_tpu.ops import brick_scene, render_wave, wavefront

    wsc = wavefront.prepare(brick_scene.brickify(build_np.build_octree_np(v)))
    _, _, w_iters = render_wave.render_frame_wavefront(
        wsc, cam5, W, H, render_mode=2)
    w_iters = np.asarray(w_iters)
    for n in (1, 2, 4, 8):
        shard = w_iters.reshape(n, H // n, W).sum(axis=(1, 2)).astype(float)
        bal = shard.mean() / max(shard.max(), 1.0)
        ishard = np.array([w_iters[d::n].sum() for d in range(n)], float)
        ibal = ishard.mean() / max(ishard.max(), 1.0)
        print(json.dumps(dict(kind="load_balance_wavefront", devices=n,
                              balance=round(float(bal), 4),
                              interleaved=round(float(ibal), 4))),
              flush=True)

    # wall-clock at fixed total work (weak CPU proxy)
    base = None
    for n in (1, 2, 4, 8):
        if len(jax.devices()) < n:
            break
        m = mesh_mod.tile_mesh(n)
        render = render_sharded.make_sharded_render(m, W, H, render_mode=2)
        img = render(tree.arrays(), cam5)
        jax.block_until_ready(img)
        t0 = time.time()
        for _ in range(3):
            img = render(tree.arrays(), cam5)
        s = float(jnp.sum(img))
        dt = (time.time() - t0) / 3
        if base is None:
            base = dt
        print(json.dumps(dict(kind="wallclock", devices=n,
                              ms=round(dt * 1e3, 1),
                              vs_1dev=round(base / dt, 3),
                              chk=round(s, 1))), flush=True)


if __name__ == "__main__":
    main()
