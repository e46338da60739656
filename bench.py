"""Benchmark: traversal throughput on the reference's headline workload.

Prints JSON rows {"metric", "value", "unit", "frame_ms", "platform",
"device_kind", "device_count", "gpu"}; ``gpu`` is the card's name and
power limit as nvidia-smi reports them (null where there is none).

Workload: 1024^3 procedural-terrain octree (models/world.build_terrain,
built from ``--seed`` on the device), 1920x1080 pathtraced GI (primary +
1 diffuse bounce = 2 traced segments per pixel — the reference's render
mode 0, svotrace.comp:443-560), then the same with 3 bounces.

Usage:
  python bench.py [--seed N]   # full: 1024^3 world, 1920x1080
  python bench.py --small      # quick check: 64^3, 320x180, any backend
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def gpu_name_and_power_limit():
    """nvidia-smi's name and power limit, or None without a GPU."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.splitlines()[0] if out else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from svo_raytracer_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from svo_raytracer_tpu.models import world
    from svo_raytracer_tpu.ops import brick_scene, render_wave, wavefront

    world_size, chunk_size = (64, 64) if args.small else (1024, 512)
    width, height = (320, 180) if args.small else (1920, 1080)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()),
              "gpu": gpu_name_and_power_limit()}

    t0 = time.time()
    tree = world.build_terrain(world_size, chunk_size, seed=args.seed)
    build_s = time.time() - t0
    print(f"# scene: {world_size}^3, {tree.n_nodes} nodes, built in "
          f"{build_s:.1f}s on {dev.platform}", file=sys.stderr)
    t0 = time.time()
    wsc = wavefront.prepare(brick_scene.brickify(tree))
    jax.block_until_ready(wsc)
    print(f"# brick scene ready in {time.time() - t0:.1f}s "
          f"(n_mixed={wsc.n_mixed})", file=sys.stderr)

    cam = world.terrain_camera(wsc)
    print(f"# camera at y={cam.pos[1]:.3f}", file=sys.stderr)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)

    def frame(n, bounces):
        color, _, _ = render_wave.render_frame_wavefront(
            wsc, cam5, width, height, render_mode=0, frame_number=n,
            gi_bounces=bounces)
        return color

    n_frames = 3 if args.small else 5
    for bounces in (1, 3):
        t0 = time.time()
        frame(1, bounces).block_until_ready()
        print(f"# gi-{bounces} first frame (compile+run): "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
        t0 = time.time()
        for i in range(n_frames):
            out = frame(i + 2, bounces)
        out.block_until_ready()
        dt = (time.time() - t0) / n_frames
        segments = bounces + 1
        row = {
            "metric": f"Mrays/s ({world_size}^3 pathtraced GI-{bounces}, "
                      f"{width}x{height})",
            "value": segments * width * height / dt / 1e6,
            "unit": "Mrays/s",
            "frame_ms": dt * 1e3,
            **device,
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
