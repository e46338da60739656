"""Sharded render over the production traversal
(parallel/render_wave_sharded.py) vs the single-device frame renderer,
on the virtual 8-device CPU mesh."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene, render_wave, wavefront
from svo_raytracer_tpu.parallel import mesh as mesh_mod
from svo_raytracer_tpu.parallel import render_wave_sharded as rws
from svo_raytracer_tpu.utils.camera import Camera

pytestmark = pytest.mark.slow  # nightly tier (pytest.ini)


@pytest.fixture(scope="module")
def wscene_cam():
    vox = make_terrain_voxels(64, seed=7)
    tree = build_np.build_octree_np(vox)
    ws = wavefront.prepare(brick_scene.brickify(tree))
    cam = Camera(pos=np.array([1.4, 1.7, 1.3]))
    cam.rotate(-0.5, 0.8)
    return ws, jnp.asarray(cam.uniform(), jnp.float32)


@pytest.mark.parametrize("mode,bounces", [(3, 0), (0, 1)])
def test_wave_sharded_matches_single(wscene_cam, mode, bounces):
    ws, cam5 = wscene_cam
    W, H = 32, 32
    m = mesh_mod.tile_mesh(8)
    render = rws.make_wave_sharded_render(m, W, H, render_mode=mode,
                                          gi_bounces=bounces)
    col = render(ws, cam5, 1)
    ref, _, _ = render_wave.render_frame_wavefront(
        ws, cam5, W, H, render_mode=mode, frame_number=1,
        gi_bounces=bounces)
    a, b = np.asarray(col), np.asarray(ref)
    assert a.shape == b.shape
    # identical rays, identical engine — pixels must match to FP slop
    frac = (np.abs(a - b) <= 1e-5).mean()
    assert frac >= 0.999, frac
