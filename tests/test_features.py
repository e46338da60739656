"""Tests for mirror materials, progressive accumulation, checkpointing,
and profiling helpers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.diff import checkpoint, render_diff as rd
from svo_raytracer_tpu.ops import shade
from svo_raytracer_tpu.utils import profiling
from svo_raytracer_tpu.utils.camera import Camera
from conftest import make_sphere_voxels


@pytest.fixture(scope="module")
def scene():
    v = make_sphere_voxels(32)
    v[:, :4, :] = 3
    tree = build_np.build_octree_np(v).to_device()
    cam = Camera(pos=np.array([1.5, 1.6, 2.3]))
    cam.rotate(-0.3, 0.0)
    return tree, jnp.asarray(cam.uniform(), jnp.float32)


def test_mirror_materials_change_image(scene):
    tree, cam5 = scene
    a, _, _ = shade.render_image(tree.arrays(), cam5, 32, 32, render_mode=0,
                                 frame_number=1)
    b, _, _ = shade.render_image(tree.arrays(), cam5, 32, 32, render_mode=0,
                                 frame_number=1, mirror_values=(1,))
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(b).all()
    assert not np.array_equal(a, b)


def test_mirror_reflection_direction():
    d = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r = np.asarray(shade.mirror_bounce(d, n))
    np.testing.assert_allclose(r, [[0.0, 1.0, 0.0]], atol=1e-6)
    # grazing: reflect across the normal
    d = jnp.asarray([[0.7071, -0.7071, 0.0]], jnp.float32)
    r = np.asarray(shade.mirror_bounce(d, n))
    np.testing.assert_allclose(r, [[0.7071, 0.7071, 0.0]], atol=1e-4)


def test_progressive_accumulation_reduces_variance(scene):
    tree, cam5 = scene
    key = jax.random.PRNGKey(7)
    one, _ = shade.render_progressive(tree.arrays(), cam5, 32, 32, spp=1,
                                      rng_key=key)
    many, _ = shade.render_progressive(tree.arrays(), cam5, 32, 32, spp=8,
                                       rng_key=key)
    other, _ = shade.render_progressive(tree.arrays(), cam5, 32, 32, spp=8,
                                        rng_key=jax.random.PRNGKey(8))
    # accumulated renders from different keys agree better than single-spp
    d1 = np.abs(np.asarray(one) - np.asarray(other)).mean()
    d8 = np.abs(np.asarray(many) - np.asarray(other)).mean()
    assert d8 < d1


def test_checkpoint_roundtrip(tmp_path, scene):
    tree, cam5 = scene
    params = rd.init_params(tree.arrays())
    p = str(tmp_path / "params.npz")
    checkpoint.save_params(params, p, step=42)
    loaded, step = checkpoint.load_params(p)
    assert step == 42
    np.testing.assert_array_equal(np.asarray(loaded.albedo),
                                  np.asarray(params.albedo))

    from svo_raytracer_tpu.core.octree import Octree
    t = str(tmp_path / "tree.npz")
    checkpoint.save_tree_npz(tree, t)
    back = checkpoint.load_tree_npz(t)
    assert back.n_nodes == tree.n_nodes
    assert back.world_size == tree.world_size
    np.testing.assert_array_equal(np.asarray(back.child),
                                  np.asarray(tree.child)[:tree.n_nodes])


def test_profiling_timers():
    profiling.reset()
    with profiling.timer("phase_a"):
        sum(range(1000))
    with profiling.timer("phase_a"):
        sum(range(1000))
    s = profiling.summary()
    assert s["phase_a"]["count"] == 2
    assert s["phase_a"]["total_s"] > 0


def test_packed_table_semantics(scene):
    """packed word: child base for branches, 0 for leaves; bit0 = value!=0."""
    from svo_raytracer_tpu.ops.traverse import make_packed_table

    tree, _ = scene
    packed = np.asarray(make_packed_table(tree.arrays()))
    child = np.asarray(tree.child)
    mask = np.asarray(tree.mask)
    value = np.asarray(tree.value)
    # root
    assert packed[0] >> 1 == child[0]
    assert (packed[0] & 1) == int(value[0] != 0)
    # every branch's children
    for p in np.nonzero(child)[0][:200]:
        for k in range(8):
            ci = child[p] + k
            tag = (mask[p] >> (2 * k)) & 3
            want_child = child[ci] if tag == 0 else 0
            assert packed[ci] >> 1 == want_child, (p, k, ci)
            assert (packed[ci] & 1) == int(value[ci] != 0)


def test_png_writer_roundtrip(tmp_path):
    """write_png needs only the standard library; Pillow reads it back."""
    from PIL import Image

    from svo_raytracer_tpu.io.image import write_png

    rng = np.random.default_rng(0)
    col = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, col)
    got = np.asarray(Image.open(path))
    want = (np.clip(col, 0, 1) * 255).astype(np.uint8)[::-1]
    np.testing.assert_array_equal(got, want)
