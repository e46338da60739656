"""render_frame_wavefront vs the jitted ESVO renderer (shade.render_image).

Same shading helpers + oracle-matched traversal => frames should agree
pixel-for-pixel up to traversal FP slop.  Iteration counts differ by
design (DDA steps vs PUSH/ADVANCE/POP rounds), so mode 1 compares hit
structure only.
"""

import numpy as np

import jax.numpy as jnp

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene, render_wave, shade, wavefront
from svo_raytracer_tpu.utils.camera import Camera
import pytest

W, H = 64, 40


def _setup():
    vox = make_terrain_voxels(64, seed=7)
    tree = build_np.build_octree_np(vox)
    scene_h = brick_scene.brickify(tree)
    ws = wavefront.prepare(scene_h)
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    return tree.to_device(), ws, cam5


def _frac_close(a, b, tol=2e-3):
    a, b = np.asarray(a), np.asarray(b)
    return (np.abs(a - b).max(axis=-1) <= tol).mean()


@pytest.mark.slow
def test_modes_match_esvo():
    tree, ws, cam5 = _setup()
    for mode in (0, 2, 3):
        ref_c, ref_d, _ = shade.render_image(tree.arrays(), cam5, W, H,
                                             render_mode=mode,
                                             frame_number=3, gi_bounces=1)
        got_c, got_d, _ = render_wave.render_frame_wavefront(
            ws, cam5, W, H, render_mode=mode, frame_number=3, gi_bounces=1)
        fc = _frac_close(ref_c, got_c)
        assert fc >= 0.97, f"mode {mode}: color match {fc:.3f}"
        fd = (np.abs(np.asarray(ref_d) - np.asarray(got_d)) <= 2e-3).mean()
        assert fd >= 0.97, f"mode {mode}: depth match {fd:.3f}"


def test_heatmap_structure():
    tree, ws, cam5 = _setup()
    ref_c, ref_d, ref_i = shade.render_image(tree.arrays(), cam5, W, H,
                                             render_mode=1)
    got_c, got_d, got_i = render_wave.render_frame_wavefront(
        ws, cam5, W, H, render_mode=1)
    # hits (depth > 0) must agree; iteration counts are engine-specific
    agree = ((np.asarray(ref_d) > 0) == (np.asarray(got_d) > 0)).mean()
    assert agree >= 0.99, f"hit structure {agree:.3f}"
    assert np.asarray(got_i).max() > 0


@pytest.mark.slow
def test_mirror_values():
    tree, ws, cam5 = _setup()
    ref_c, _, _ = shade.render_image(tree.arrays(), cam5, W, H,
                                     render_mode=0, frame_number=2,
                                     gi_bounces=1, mirror_values=(2,))
    got_c, _, _ = render_wave.render_frame_wavefront(
        ws, cam5, W, H, render_mode=0, frame_number=2, gi_bounces=1,
        mirror_values=(2,))
    assert _frac_close(ref_c, got_c) >= 0.97
