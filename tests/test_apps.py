"""Application-layer tests: viewer scripting, frame loop, input mapping,
bytecache/materials parity, DeviceTree incremental uploads."""

import os

import numpy as np
import pytest

from svo_raytracer_tpu.apps import input as input_mod
from svo_raytracer_tpu.core import build_np, bytecache, materials, sdf
from svo_raytracer_tpu.runtime.renderer import DeviceTree
from conftest import make_sphere_voxels


def test_bytecache_parity():
    """ByteCacheTest.eval (ByteCacheTest.java:18-27) with the reference's
    modulo-by-MB-count wrap quirk."""
    bc = bytecache.ByteCache(3)
    bc.append_byte(1)
    bc.append_byte(1)
    bc.append_byte(1)
    bc.append_byte(2)
    assert bc.get_buffer()[2] == 2
    assert bc.get_first() == 2


def test_leafmask_arithmetic():
    """gpuGenTest (ByteCacheTest.java:37-47) — with an actual assertion."""
    leaf_mask = 0
    result = leaf_mask | (0x0001 << (1 << 1))
    result |= 0x0002 << (1 << 1)
    local = (result & (0x0003 << (1 << 1))) >> (1 << 1)
    assert local == 3


def test_materials_registry():
    materials.init_materials("./assets")
    assert materials.get_num_mats() == 4
    assert materials.get_material(0).name == "air"
    assert materials.get_material(3).name == "grass"
    assert not materials.get_material(0).has_matmap()
    assert materials.get_material(1).has_matmap()


def test_input_mapping():
    assert input_mod.parse("w") == "move_forward"
    assert input_mod.parse("4") == "render_mode_3"
    assert input_mod.parse("Q") == "quit"
    assert input_mod.parse("zz") is None
    assert input_mod.parse("") is None


def test_device_tree_ranged_update():
    v = make_sphere_voxels(16, radius=5)
    tree = build_np.build_octree_np(v)
    dt = DeviceTree(tree, min_capacity=tree.n_nodes + 64)
    ball = sdf.Sphere((8, 8, 8), 2)
    new_tree, cb = sdf.use_sdf_brush(tree, ball, 2, max_lod=4)
    dt.ranged_update(new_tree, cb)
    # device mirror must equal a fresh full upload
    fresh = new_tree.to_device(pad_to=dt.capacity)
    for a, b in zip(dt.arrays(), fresh.arrays()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_tree_grows_on_overflow():
    v = make_sphere_voxels(16, radius=5)
    tree = build_np.build_octree_np(v)
    dt = DeviceTree(tree, min_capacity=tree.n_nodes)  # no slack headroom?
    big = sdf.Sphere((8, 8, 8), 6)
    new_tree, cb = sdf.use_sdf_brush(tree, big, 2, max_lod=4)
    dt.ranged_update(new_tree, cb)
    assert dt.capacity >= new_tree.n_nodes
    fresh = new_tree.to_device(pad_to=dt.capacity)
    for a, b in zip(dt.arrays(), fresh.arrays()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_viewer_scripted_session(tmp_path):
    """End-to-end headless session: move, rotate, switch mode, screenshot,
    place a sphere, save, quit — the Main.updateEarly flow."""
    from svo_raytracer_tpu.apps.viewer import Viewer, _demo_tree

    tree = _demo_tree("sphere", 32)
    viewer = Viewer(tree, width=64, height=36, out_dir=str(tmp_path),
                    commands=list("w j 4 p c 0 Q".split()), use_beam=False)
    viewer.launch(max_frames=8)
    shots = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    assert shots, "screenshot command must write a frame"
    assert (tmp_path / "level1.svo").exists(), "save_world must write .svo"
    # the sphere edit appended nodes
    assert viewer.tree_host.n_nodes > tree.n_nodes


def test_viewer_beam_mode(tmp_path):
    from svo_raytracer_tpu.apps.viewer import Viewer, _demo_tree

    tree = _demo_tree("sphere", 32)
    viewer = Viewer(tree, width=64, height=36, out_dir=str(tmp_path),
                    commands=list("\\ p Q".split()), use_beam=False)
    viewer.launch(max_frames=4)
    assert viewer.use_beam  # toggled on


@pytest.mark.slow
def test_viewer_wavefront_accumulation_and_incremental_edit(tmp_path):
    """A scripted session shows (a) progressive mode-0
    accumulation that resets on camera motion, (b) an SDF edit applied via
    brickify_patch/apply_patch — never a second full brickify."""
    from svo_raytracer_tpu.apps import viewer as viewer_mod
    from svo_raytracer_tpu.ops import brick_scene

    calls = []
    real_brickify = brick_scene.brickify

    def counting_brickify(*a, **kw):
        calls.append(1)
        return real_brickify(*a, **kw)

    brick_scene.brickify = counting_brickify
    try:
        tree = viewer_mod._demo_tree("sphere", 64)
        # mode 0, idle x2 (accumulate), move (reset), idle, edit, quit
        cmds = ["1", "", "", "w", "", "p", "Q"]
        v = viewer_mod.Viewer(tree, width=48, height=32,
                              out_dir=str(tmp_path), commands=cmds,
                              engine="wavefront")
        n_mixed_log = []

        orig_update = viewer_mod.Viewer.update_early

        def logging_update(self):
            orig_update(self)
            n_mixed_log.append((self._accum_n, self.wave_scene.n_mixed))

        viewer_mod.Viewer.update_early = logging_update
        try:
            v.launch(max_frames=len(cmds))
        finally:
            viewer_mod.Viewer.update_early = orig_update
    finally:
        brick_scene.brickify = real_brickify

    assert calls == [1], f"full brickify ran {len(calls)}x (want 1: pre_run)"
    accs = [a for a, _ in n_mixed_log]
    # frames 1-3 accumulate 1,2,3; the 'w' resets to 1
    assert accs[:4] == [1, 2, 3, 1], accs
    # the edit ran through the incremental path and the scene stayed live
    assert v.wave_scene.n_mixed >= n_mixed_log[0][1]


def test_viewer_auto_engine_rule():
    """auto picks the production traversal wherever its attribute index
    fits in int32, and the ESVO walk for worlds below one brick."""
    from svo_raytracer_tpu.apps.viewer import _demo_tree, auto_engine

    assert auto_engine(_demo_tree("sphere", 64)) == "wavefront"
    assert auto_engine(_demo_tree("sphere", 16)) == "esvo"
