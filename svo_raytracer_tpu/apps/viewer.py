"""Headless interactive viewer — the Main.java analog.

Drives the full per-frame pipeline of the reference's ``Main.updateEarly``
(``Main.java:130-289``): input -> camera -> (beam prepass) -> trace dispatch
-> present, plus SDF edits with ranged device updates, save/load hotkeys and
the debug overlay.  "Present" writes PNG frames; input comes from stdin
commands or a ``--script`` string (see ``input.KEYBINDS``).

Usage:
  python -m svo_raytracer_tpu.apps.viewer --svo assets/debug.svo
  python -m svo_raytracer_tpu.apps.viewer --demo sphere --script "wwjj p Q"
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core import build_np, sdf, svo_format
from ..core.octree import Octree
from ..io.image import write_png
from ..utils import constants as C
from ..utils.camera import Camera
from . import input as input_mod
from .app import Application


def auto_engine(tree: Octree) -> str:
    """The production brick traversal wherever it applies: worlds of at
    least one brick (32^3) whose brick scene it can index in int32
    (ops/wavefront.check_index_range); the ESVO walk otherwise."""
    from ..ops import brick_scene, wavefront

    if tree.world_size < brick_scene.BRICK:
        return "esvo"
    G = tree.world_size // brick_scene.BRICK
    capacity = wavefront.default_capacity(brick_scene.count_mixed(tree))
    try:
        wavefront.check_index_range(capacity, G)
    except ValueError:
        return "esvo"
    return "wavefront"


class Viewer(Application):
    def __init__(self, tree: Octree, width=480, height=270, out_dir=".",
                 commands=None, interactive=False, use_beam=False,
                 engine="auto"):
        self.tree_host = tree
        self.width, self.height = width, height
        self.out_dir = out_dir
        self.commands = list(commands or [])
        self.interactive = interactive
        self.render_mode = 2  # Main.java:125
        self.use_beam = use_beam
        self.show_debug = False
        self.frame_number = 0
        self.crosshair_depth = 0.0
        self.cam = Camera(pos=np.array([1.5, 1.5, 2.0]))
        self.speed = 0.02
        if engine == "auto":
            engine = auto_engine(tree)
        self.engine = engine
        self._accum = None      # progressive mode-0 accumulation buffer
        self._accum_n = 0
        self._moved = True

    # -- device plumbing --
    def pre_run(self):
        import jax.numpy as jnp

        from ..runtime.renderer import DeviceTree

        self._jnp = jnp
        self.device_tree = DeviceTree(self.tree_host)
        self.wave_scene = None
        if self.engine == "wavefront":
            from ..ops import brick_scene, wavefront

            self.brick_host = brick_scene.brickify(self.tree_host)
            self.wave_scene = wavefront.prepare(self.brick_host)

    def _rebuild_wave(self):
        if self.engine == "wavefront":
            from ..ops import brick_scene, wavefront

            self.brick_host = brick_scene.brickify(self.tree_host)
            self.wave_scene = wavefront.prepare(
                self.brick_host, capacity=self.wave_scene.capacity
                if self.wave_scene is not None
                and self.wave_scene.capacity >= self.brick_host.n_mixed
                else None)

    # -- frame --
    def update_early(self):
        cmd = None
        if self.commands:
            cmd = self.commands.pop(0)
        elif self.interactive:
            line = sys.stdin.readline()
            cmd = line if line else "Q"
        action = input_mod.parse(cmd) if cmd else None
        if action:
            self._apply(action)

        from ..ops import shade

        jnp = self._jnp
        cam5 = jnp.asarray(self.cam.uniform(), jnp.float32)
        # camera motion / edits restart progressive accumulation
        # (Main.java:161-243: any change resets frameNumber to 0)
        if self._moved:
            self.frame_number = 0
            self._accum = None
            self._accum_n = 0
            self._moved = False
        self.frame_number += 1
        if self.engine == "wavefront":
            from ..ops import render_wave

            color, depth, iters = render_wave.render_frame_wavefront(
                self.wave_scene, cam5, self.width, self.height,
                render_mode=self.render_mode,
                frame_number=self.frame_number)
        else:
            color, depth, iters = shade.render_image(
                self.device_tree.arrays(), cam5, self.width, self.height,
                render_mode=self.render_mode, frame_number=self.frame_number,
                use_beam=self.use_beam)
        color = np.asarray(color)
        if self.render_mode == 0:
            # progressive running average — done properly, unlike the
            # reference's commented-out version (svotrace.comp:712-719)
            self._accum = color if self._accum is None \
                else self._accum + color
            self._accum_n += 1
            color = self._accum / self._accum_n
        self.color = color
        depth = np.asarray(depth)
        # crosshair depth readback (Main.java:132-146) — center pixel only,
        # not the reference's full-frame glGetTexImage
        self.crosshair_depth = float(depth[self.height // 2, self.width // 2])

    def draw_ui(self):
        if self.show_debug:  # ImGui overlay analog (Main.java:292-314)
            pos = self.cam.pos
            print(f"# mode={self.render_mode} pos=({pos[0]:.3f},{pos[1]:.3f},"
                  f"{pos[2]:.3f}) rot=({self.cam.pitch:.3f},{self.cam.yaw:.3f})"
                  f" nodes={self.device_tree.n_nodes}"
                  f" frame_ms={self.frame_time_ms:.1f}"
                  f" beam={self.use_beam}", file=sys.stderr)

    def _screenshot(self):
        path = os.path.join(self.out_dir, f"frame_{self.frame_count:04d}.png")
        write_png(path, self.color)
        print(f"# wrote {path}", file=sys.stderr)

    def _place_sdf(self, value: int):
        """placeSDF (Main.java:338-353): un-project the crosshair depth,
        apply a radius-64-voxel sphere brush, upload dirty ranges."""
        target = self.cam.ray_pick_location(self.crosshair_depth,
                                            self.tree_host.world_size)
        radius = max(2, self.tree_host.world_size // 128)
        ball = sdf.Sphere(target, radius)
        new_tree, cb = sdf.use_sdf_brush(self.tree_host, ball, value)
        self.tree_host = new_tree
        self.device_tree.ranged_update(new_tree, cb)
        if self.engine == "wavefront":
            # incremental re-brick of only the touched cells instead of
            # a full brickify of the world
            from ..ops import brick_scene, wavefront

            patch = brick_scene.brickify_patch(new_tree, self.brick_host,
                                               ball.min, ball.max)
            self.wave_scene = wavefront.apply_patch(self.wave_scene,
                                                    self.brick_host, patch)
        self._moved = True
        print(f"# placed sphere v={value} at {target} "
              f"dirty=[{cb.start0},{cb.end0})+[{cb.start1},{cb.end1})",
              file=sys.stderr)

    _MOVING = ("move_forward", "move_back", "move_left", "move_right",
               "move_up", "move_down", "rotate_left", "rotate_right",
               "rotate_up", "rotate_down")

    def _apply(self, action: str):
        c = self.cam
        if action in self._MOVING or action.startswith("render_mode_"):
            self._moved = True
        if action == "move_forward":
            c.pos = c.pos + c.forward * self.speed
        elif action == "move_back":
            c.pos = c.pos - c.forward * self.speed
        elif action == "move_left":
            c.pos = c.pos - c.right * self.speed
        elif action == "move_right":
            c.pos = c.pos + c.right * self.speed
        elif action == "move_up":
            c.pos = c.pos + np.array([0, self.speed, 0])
        elif action == "move_down":
            c.pos = c.pos - np.array([0, self.speed, 0])
        elif action == "rotate_left":
            c.rotate(0.0, 0.1)
        elif action == "rotate_right":
            c.rotate(0.0, -0.1)
        elif action == "rotate_up":
            c.rotate(0.1, 0.0)
        elif action == "rotate_down":
            c.rotate(-0.1, 0.0)
        elif action.startswith("render_mode_"):
            self.render_mode = int(action[-1])
        elif action == "toggle_debug":
            self.show_debug = not self.show_debug
        elif action == "toggle_beam":
            self.use_beam = not self.use_beam
        elif action == "save_world":
            svo_format.write_svo_file(self.tree_host,
                                      os.path.join(self.out_dir, "level1.svo"))
        elif action == "read_world":
            self.tree_host = svo_format.read_svo_file(
                os.path.join(self.out_dir, "level1.svo"),
                world_size=self.tree_host.world_size)
            self.device_tree.full_upload(self.tree_host)
            self._rebuild_wave()
            self._moved = True
        elif action == "subtract_sphere":
            self._place_sdf(0)
        elif action == "put_sphere":
            self._place_sdf(1)
        elif action == "speed_turbo":
            self.speed = 0.05
        elif action == "speed_slow":
            self.speed = 0.005
        elif action == "screenshot":
            pass  # taken after render, below
        elif action == "quit":
            self.running = False
        self._pending_screenshot = action == "screenshot"

    def update_late(self):
        if getattr(self, "_pending_screenshot", False):
            self._screenshot()
            self._pending_screenshot = False


def _demo_tree(kind: str, size: int = 64) -> Octree:
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    if kind == "sphere":
        v = (np.sqrt((x - size / 2) ** 2 + (y - size / 2) ** 2
                     + (z - size / 2) ** 2) <= size / 4).astype(np.uint8)
        v[:, :size // 8, :] = 1
    else:
        raise ValueError(kind)
    return build_np.build_octree_np(v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--svo", help=".svo world file to load")
    ap.add_argument("--demo", default=None, help="demo scene (sphere)")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--out", default=".")
    ap.add_argument("--script", default=None,
                    help="space-separated commands, e.g. 'w w j p Q'")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "wavefront", "esvo"),
                    help="traversal engine (auto: wavefront wherever its "
                    "attribute index fits in int32)")
    ap.add_argument("--cpu", action="store_true", help="pin jax to CPU")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from ..utils import compile_cache

    compile_cache.enable()

    if args.svo:
        tree = svo_format.read_svo_file(args.svo)
    else:
        tree = _demo_tree(args.demo or "sphere")

    commands = args.script.split() if args.script else None
    viewer = Viewer(tree, args.width, args.height, args.out,
                    commands=commands, interactive=args.script is None,
                    use_beam=args.beam, engine=args.engine)
    viewer.launch(max_frames=args.frames or (len(commands) if commands
                                             else None))


if __name__ == "__main__":
    main()
