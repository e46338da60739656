"""Tree validation + canned-scene smoke tests (scaled down for CPU)."""

import numpy as np
import pytest

from svo_raytracer_tpu.core import build_np, validate
from svo_raytracer_tpu.models import scenes
from conftest import make_sphere_voxels


def test_valid_tree_passes(sphere_tree):
    rep = validate.validate_tree(sphere_tree)
    assert rep.ok, rep.errors
    assert rep.reachable == sphere_tree.n_nodes - 7  # root block spares


def test_corrupt_child_pointer_detected(sphere_tree):
    t = sphere_tree.to_numpy()
    t.child[0] = t.n_nodes + 100  # out of range
    rep = validate.validate_tree(t)
    assert not rep.ok
    assert "out of range" in rep.errors[0]


def test_shared_children_detected(sphere_tree):
    t = sphere_tree.to_numpy()
    # point two branches at the same child block
    branches = np.nonzero(np.asarray(t.child[:t.n_nodes]))[0]
    assert len(branches) >= 2
    t.child[branches[1]] = t.child[branches[0]]
    rep = validate.validate_tree(t)
    assert not rep.ok


def test_scene1_smoke():
    tree, cam, cfg = scenes.scene_1(scale=0.5)  # 32^3
    assert tree.n_nodes > 8
    assert cfg.render_mode == 3
    rep = validate.validate_tree(tree.to_numpy())
    assert rep.ok, rep.errors


def test_scene2_smoke():
    tree, cam, cfg = scenes.scene_2(scale=1 / 8)  # 32^3 heightmap
    assert tree.n_nodes > 8
    rep = validate.validate_tree(tree.to_numpy())
    assert rep.ok, rep.errors


def test_scene3_smoke():
    tree, cam, cfg = scenes.scene_3(scale=1 / 16)  # 64^3 caves
    assert tree.n_nodes > 8
    assert cfg.render_mode == 0
    rep = validate.validate_tree(tree.to_numpy())
    assert rep.ok, rep.errors


def test_scene5_brick_smoke():
    """scene_5 production path at 1/32 scale (256^3): direct BrickScene
    build + traversal probe agreement with the closed-form surface."""
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import wavefront as wf

    scene, cam, cfg = scenes.scene_5_brick(scale=1 / 32)
    assert scene.world_size == 256 and scene.n_mixed > 0
    W = wf.prepare(scene)
    hm = scenes._fractal_heightmap(256)
    h = (hm.astype(np.float64) / 65536.0 * 128).astype(np.int64)
    rs = np.random.RandomState(5)
    vx = rs.randint(8, 248, 64)
    vz = rs.randint(8, 248, 64)
    o = np.stack([1 + (vx + 0.5) / 256, np.full(64, 1.999),
                  1 + (vz + 0.5) / 256], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (64, 1))
    r = wf.intersect(W, jnp.asarray(o), jnp.asarray(d))
    t_exp = 1.999 - (1 + (h[vx, vz] + 1) / 256)
    ok = np.asarray(r.hit) & (np.abs(np.asarray(r.t) - t_exp) < 1e-3)
    assert ok.mean() >= 0.98, ok.mean()
