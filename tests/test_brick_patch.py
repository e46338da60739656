"""Incremental brickify (brick_scene.brickify_patch + wavefront.apply_patch)
vs a from-scratch brickify after an SDF edit — semantic equality per brick
cell (slot numbering legitimately differs: the patch appends, a rebuild
re-enumerates; orphaned slots are tombstones like Octree.java:954-956).
"""

import copy

import numpy as np

import jax.numpy as jnp

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np, sdf
from svo_raytracer_tpu.ops import brick_scene, wavefront
from test_traverse_batch import random_rays


def _edit(tree, value, center=(40, 30, 40), radius=10):
    ball = sdf.Sphere(np.asarray(center), radius)
    new_tree, _cb = sdf.use_sdf_brush(tree, ball, value)
    return new_tree, ball


def _assert_semantic_equal(scene, full):
    G = scene.grid_size
    assert full.grid_size == G
    for c in range(G * G * G):
        s_a, s_b = int(scene.brick_slot[c]), int(full.brick_slot[c])
        assert (s_a < 0) == (s_b < 0), f"cell {c} mixedness"
        if s_a < 0:
            assert scene.brick_attr[c] == full.brick_attr[c], f"cell {c}"
        else:
            np.testing.assert_array_equal(scene.occ_words[s_a],
                                          full.occ_words[s_b],
                                          err_msg=f"cell {c} occ")
            np.testing.assert_array_equal(scene.attrs[s_a],
                                          full.attrs[s_b],
                                          err_msg=f"cell {c} attrs")
    np.testing.assert_array_equal(scene.l0_table, full.l0_table)


def test_patch_matches_full_rebuild():
    vox = make_terrain_voxels(64, seed=7)
    tree = build_np.build_octree_np(vox)
    scene = brickify_copy = brick_scene.brickify(tree)
    scene = copy.deepcopy(brickify_copy)

    tree2, ball = _edit(tree, value=1)
    patch = brick_scene.brickify_patch(tree2, scene, ball.min, ball.max)
    full = brick_scene.brickify(tree2)
    _assert_semantic_equal(scene, full)
    assert patch.n_mixed == scene.n_mixed

    # second edit: subtract (exercises solid->air transitions)
    tree3, ball2 = _edit(tree2, value=0, center=(40, 34, 40), radius=12)
    patch2 = brick_scene.brickify_patch(tree3, scene, ball2.min, ball2.max)
    full3 = brick_scene.brickify(tree3)
    _assert_semantic_equal(scene, full3)
    assert patch2.n_mixed >= full3.n_mixed  # orphans never reclaimed


def test_apply_patch_device_render():
    vox = make_terrain_voxels(64, seed=9)
    tree = build_np.build_octree_np(vox)
    scene = brick_scene.brickify(tree)
    ws0 = wavefront.prepare(copy.deepcopy(scene))
    shapes0 = [a.shape for a in (ws0.l0, ws0.brick_slot, ws0.occ, ws0.attrs)]
    cap0 = ws0.capacity

    tree2, ball = _edit(tree, value=1, center=(32, 36, 32), radius=9)
    patch = brick_scene.brickify_patch(tree2, scene, ball.min, ball.max)
    ws1 = wavefront.apply_patch(ws0, scene, patch)
    ws_full = wavefront.prepare(brick_scene.brickify(tree2))
    # capacity headroom: the patched scene keeps every shape (no recompile)
    assert ws1.capacity == cap0 and ws1.n_mixed == patch.n_mixed
    assert [a.shape for a in (ws1.l0, ws1.brick_slot, ws1.occ,
                              ws1.attrs)] == shapes0

    o, d = random_rays(512, seed=3)
    a = wavefront.intersect(ws1, jnp.asarray(o), jnp.asarray(d))
    b = wavefront.intersect(ws_full, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    h = np.asarray(a.hit)
    np.testing.assert_array_equal(np.asarray(a.value)[h],
                                  np.asarray(b.value)[h])
    np.testing.assert_allclose(np.asarray(a.t)[h], np.asarray(b.t)[h],
                               atol=1e-5)


def test_apply_patch_outgrowing_capacity_reprepares():
    """A patch with more mixed bricks than the device capacity falls back
    to a full prepare with new headroom."""
    vox = make_sphere_voxels(128, radius=20)
    tree = build_np.build_octree_np(vox)
    scene = brick_scene.brickify(tree)
    ws0 = wavefront.prepare(copy.deepcopy(scene), capacity=scene.n_mixed)
    # a ball in the empty corner turns air bricks into mixed ones
    tree2, ball = _edit(tree, value=1, center=(12, 12, 12), radius=6)
    patch = brick_scene.brickify_patch(tree2, scene, ball.min, ball.max)
    assert patch.n_mixed > ws0.capacity
    ws1 = wavefront.apply_patch(ws0, scene, patch)
    assert ws1.capacity >= patch.n_mixed
    o, d = random_rays(256, seed=4)
    a = wavefront.intersect(ws1, jnp.asarray(o), jnp.asarray(d))
    b = wavefront.intersect(wavefront.prepare(brick_scene.brickify(tree2)),
                            jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
