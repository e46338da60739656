"""The production traversal kernel (ops/wavefront.py) vs the XLA brick
reference (ops/brick_trace.py).

On CPU the kernel runs in Pallas interpret mode (the Triton route's
semantics, no card needed); ``gpu``-marked tests run it compiled on the
card.  The two engines share the scene format and the decode, so fields
agree to FP slop and hit masks agree.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene, brick_trace, wavefront
from svo_raytracer_tpu.utils import compile_cache
from test_traverse_batch import random_rays


def _compare(tree, origins, dirs, min_hit_agree=0.995, min_strict=0.98,
             active=None):
    scene = brick_scene.brickify(tree)
    ws = wavefront.prepare(scene)
    o, d = jnp.asarray(origins), jnp.asarray(dirs)
    act = None if active is None else jnp.asarray(active)
    ref = brick_trace.intersect_bricks(scene.to_device(), o, d, active=act)
    got = wavefront.intersect(ws, o, d, act)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: np.asarray(v) for k, v in got._asdict().items()}
    assert got["hit"].shape == (origins.shape[0],)
    agree = (ref["hit"] == got["hit"]).mean()
    assert agree >= min_hit_agree, f"hit agreement {agree}"
    both = ref["hit"] & got["hit"]
    if not both.any():
        return ref, got
    strict = np.ones(origins.shape[0], bool)
    strict &= ~both | (ref["value"] == got["value"])
    strict &= ~both | (ref["depth"] == got["depth"])
    strict &= ~both | (np.abs(ref["t"] - got["t"]) <= 2e-4)
    strict &= ~both | (np.abs(ref["normal"] - got["normal"]).max(-1) <= 1e-5)
    frac = strict[both].mean()
    assert frac >= min_strict, (
        f"strict {frac:.3f}; bad {np.nonzero(both & ~strict)[0][:5]}")
    return ref, got


def test_sphere_64():
    vox = make_sphere_voxels(64, radius=24)
    tree = build_np.build_octree_np(vox)
    o, d = random_rays(192, seed=11)
    _compare(tree, o, d)


def test_terrain_64():
    vox = make_terrain_voxels(64, seed=7)
    tree = build_np.build_octree_np(vox)
    o, d = random_rays(192, seed=12)
    _compare(tree, o, d)


def test_active_mask_and_nan():
    vox = make_sphere_voxels(64, radius=24)
    tree = build_np.build_octree_np(vox)
    ws = wavefront.prepare(brick_scene.brickify(tree))
    o = np.array([[0.5, 1.5, 1.5], [np.nan, 1.5, 1.5], [0.5, 1.5, 1.5]],
                 np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (3, 1))
    act = jnp.asarray([True, True, False])
    res = wavefront.intersect(ws, jnp.asarray(o), jnp.asarray(d), act)
    hit = np.asarray(res.hit)
    assert hit[0] and not hit[1] and not hit[2]
    assert int(res.node[1]) == -1 and int(res.node[2]) == -1


def _near_axis_rays(n, seed):
    """Rays with one direction component inside the 1e-4 clamp window."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(1.05, 1.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n)
    mag = rng.uniform(1e-8, 9e-5, n).astype(np.float32)
    d[np.arange(n), ax] = np.where(d[np.arange(n), ax] >= 0, mag, -mag)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _inside_solid_rays(n, seed):
    """Origins inside the solid lower half of a terrain world."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(1.1, 1.9, n), rng.uniform(1.01, 1.15, n),
                  rng.uniform(1.1, 1.9, n)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


CASES = {
    # name: (voxel grid builder, ray builder)
    "sphere64": (lambda: make_sphere_voxels(64, radius=24),
                 lambda: random_rays(256, seed=31)),
    "terrain64": (lambda: make_terrain_voxels(64, seed=3),
                  lambda: random_rays(256, seed=32)),
    "terrain128_g4": (lambda: make_terrain_voxels(128, seed=4),
                      lambda: random_rays(256, seed=33)),
    "all_uniform": (lambda: np.ones((64, 64, 64), np.uint8),
                    lambda: random_rays(256, seed=34, inside_bias=0.0)),
    "empty": (lambda: np.zeros((64, 64, 64), np.uint8),
              lambda: random_rays(256, seed=35)),
    "inside_solid": (lambda: make_terrain_voxels(64, seed=6),
                     lambda: _inside_solid_rays(256, seed=36)),
    "near_axis": (lambda: make_terrain_voxels(64, seed=8),
                  lambda: _near_axis_rays(256, seed=37)),
    "padded_batch": (lambda: make_sphere_voxels(64, radius=20),
                     lambda: random_rays(wavefront.BLOCK + 3, seed=38)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_brick_trace(case):
    vox_fn, ray_fn = CASES[case]
    tree = build_np.build_octree_np(vox_fn())
    o, d = ray_fn()
    ref, got = _compare(tree, o, d)
    if case == "empty":
        assert not got["hit"].any()
    elif case == "all_uniform":
        assert got["hit"].all()
        # uniform bricks resolve at the brick grid: no voxel march steps
        scene = brick_scene.brickify(tree)
        assert scene.n_mixed == 0
    else:
        assert got["hit"].any()
    # iteration counts are DDA steps in both engines
    assert (ref["iters"] == got["iters"]).mean() >= 0.98


def test_node_is_attribute_index():
    """HitResult.node is the attrs index: mixed voxels at
    slot*32768 + widx, uniform bricks at capacity*32768 + cell — the id
    diff/wave_diff.py keys parameters by."""
    v = np.full((64, 64, 64), 2, np.uint8)
    v[40, 40, 40] = 0               # an air pocket: brick (1,1,1) mixed
    tree = build_np.build_octree_np(v)
    scene = brick_scene.brickify(tree)
    ws = wavefront.prepare(scene)
    G = ws.grid_size
    assert scene.n_mixed == 1 and scene.brick_slot[0] < 0
    c = 1 + 40.5 / 64
    o = np.array([[1.25, 1.25, 0.5],   # -> uniform brick cell (0,0,0)
                  [c, c, c],           # from the pocket -> voxel (40,40,41)
                  [1.25, 1.25, 2.5]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]],
                 np.float32)          # the third ray points away: miss
    res = wavefront.intersect(ws, jnp.asarray(o), jnp.asarray(d))
    node = np.asarray(res.node)
    assert node[0] == ws.capacity * 32768 + 0
    slot = int(scene.brick_slot[(1 * G + 1) * G + 1])
    widx = (40 % 32) * 1024 + (40 % 32) * 32 + (41 % 32)
    assert node[1] == slot * 32768 + widx
    assert node[2] == -1
    attrs = np.asarray(ws.attrs)
    assert (attrs[node[:2]] & 0xFF).tolist() == [2, 2]
    assert list(np.asarray(res.value)) == [2, 2, 0]


def test_prepare_rejects_int32_attribute_index():
    with pytest.raises(ValueError, match="int32"):
        wavefront.check_index_range(70000, 256)   # the 8192^3 class
    wavefront.check_index_range(65000, 32)        # fits


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False),
                                            ("metal", None)])
def test_interpret_decision(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="no Pallas route"):
            wavefront.use_interpret()
    else:
        assert wavefront.use_interpret() is expect


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, "/some/where")
    assert compile_cache.enable() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        path = compile_cache.enable()
        assert path == compile_cache.ROOT + "/.jax_cache"
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_render_frame_engines_agree():
    """The whole frame through the kernel equals the frame through the
    XLA reference (the seam chip_smoke.py times both ends with)."""
    from svo_raytracer_tpu.ops import render_wave
    from svo_raytracer_tpu.utils.camera import Camera

    tree = build_np.build_octree_np(make_terrain_voxels(64, seed=7))
    ws = wavefront.prepare(brick_scene.brickify(tree))
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    kw = dict(width=24, height=16, render_mode=0, gi_bounces=1)
    a = render_wave.render_frame(ws, cam5, jnp.float32(2), **kw)
    b = render_wave.render_frame(ws, cam5, jnp.float32(2),
                                 intersect=brick_trace.intersect_scene, **kw)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert (np.abs(np.asarray(x) - np.asarray(y)) <= 1e-4).mean() >= 0.99


@pytest.mark.slow
def test_g64_world():
    """G=64 (2048^3) support on a hand-built scene (a dense 2048^3 voxel
    grid is infeasible on CPU); oracle = brick_trace, which is G-general."""
    from svo_raytracer_tpu.ops.brick_dda import pack_occupancy, table_rows

    G, ws_sz = 64, 2048
    rs = np.random.RandomState(3)
    occ3 = np.zeros((G, G, G), bool)
    brick_slot = np.full(G * G * G, -1, np.int32)
    brick_attr = np.zeros(G * G * G, np.int32)
    # mixed bricks along a diagonal band (including z>31 cells: the
    # second L0 word) with random half-filled occupancy
    mixed_cells = []
    for i in range(0, G, 3):
        c = (i * G + (G - 1 - i)) * G + i
        occ3[i, G - 1 - i, i] = True
        mixed_cells.append(c)
    n_mixed = len(mixed_cells)
    occ_words = np.zeros((n_mixed, 8, 128), np.int32)
    attrs = np.zeros((n_mixed, 256, 128), np.int32)
    for s, c in enumerate(mixed_cells):
        brick_slot[c] = s
        vox = rs.rand(32, 32, 32) < 0.3
        occ_words[s] = np.asarray(pack_occupancy(vox)).reshape(8, 128)
        attrs[s] = ((vox.reshape(256, 128) != 0)
                    * (2 + (559 << 8) + (11 << 24))).astype(np.int32)
    # a few uniform-solid bricks (slot -1, attr != 0), one with z>31
    for (ux, uy, uz) in ((4, 4, 40), (50, 50, 50)):
        occ3[ux, uy, uz] = True
        brick_attr[(ux * G + uy) * G + uz] = 1 + (559 << 8) + (6 << 24)
    scene = brick_scene.BrickScene(
        world_size=ws_sz, grid_size=G, n_mixed=n_mixed,
        l0_table=table_rows(pack_occupancy(occ3)), brick_slot=brick_slot,
        brick_attr=brick_attr, occ_words=occ_words, attrs=attrs)
    ws = wavefront.prepare(scene)
    o, d = random_rays(256, seed=17)
    ref = brick_trace.intersect_bricks(scene.to_device(), jnp.asarray(o),
                                       jnp.asarray(d))
    got = wavefront.intersect(ws, jnp.asarray(o), jnp.asarray(d))
    rh, gh = np.asarray(ref.hit), np.asarray(got.hit)
    assert (rh == gh).mean() >= 0.99, (rh.sum(), gh.sum())
    both = rh & gh
    assert both.any()
    assert (np.asarray(ref.value)[both]
            == np.asarray(got.value)[both]).mean() >= 0.98
    assert (np.abs(np.asarray(ref.t) - np.asarray(got.t))[both]
            <= 2e-4).mean() >= 0.98


@pytest.mark.gpu
def test_compiled_kernel_matches_brick_trace():
    """The kernel compiled for the card (no interpret mode) vs the XLA
    reference on the same card."""
    tree = build_np.build_octree_np(make_terrain_voxels(128, seed=4))
    o, d = random_rays(4096, seed=41)
    _compare(tree, o, d)


@pytest.mark.gpu
def test_compiled_frame_matches_xla_frame():
    from svo_raytracer_tpu.ops import render_wave
    from svo_raytracer_tpu.utils.camera import Camera

    tree = build_np.build_octree_np(make_terrain_voxels(128, seed=7))
    ws = wavefront.prepare(brick_scene.brickify(tree))
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    kw = dict(width=320, height=180, render_mode=2)
    a = render_wave.render_frame(ws, cam5, jnp.float32(1), **kw)[1]
    b = render_wave.render_frame(ws, cam5, jnp.float32(1),
                                 intersect=brick_trace.intersect_scene,
                                 **kw)[1]
    assert (np.abs(np.asarray(a) - np.asarray(b)) <= 2e-3).mean() >= 0.99
