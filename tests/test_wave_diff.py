"""K-hit transmittance compositing on the production traversal: custom
VJP vs plain autodiff, FD checks, and gradients THROUGH visibility (a
front voxel's density modulates the gradient reaching the voxel it
occludes — single-hit compositing cannot express this)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.diff import wave_diff as wd
from svo_raytracer_tpu.ops import brick_scene, wavefront
from svo_raytracer_tpu.utils.camera import Camera



def _two_wall_scene():
    """Two parallel 1-voxel walls normal to +z: every center ray crosses
    wall A (z=10) then wall B (z=20)."""
    v = np.zeros((32, 32, 32), np.int32)
    v[8:24, 8:24, 10] = 1   # front wall, material 1
    v[8:24, 8:24, 20] = 2   # back wall, material 2
    tree = build_np.build_octree_np(v)
    return wavefront.prepare(brick_scene.brickify(tree))


def _center_rays(n=8):
    span = np.linspace(1.45, 1.55, n, dtype=np.float32)
    o = np.stack([span, np.full(n, 1.5, np.float32),
                  np.full(n, 1.05, np.float32)], axis=1)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def walls():
    ws = _two_wall_scene()
    o, d = _center_rays()
    chain = wd.khit_chain(ws, o, d, 3)
    return ws, o, d, chain


@pytest.mark.slow
def test_chain_sees_both_walls(walls):
    ws, o, d, chain = walls
    hitm = np.asarray(chain.hitm)
    assert hitm[0].all(), "stage 0 must hit the front wall"
    assert hitm[1].all(), "stage 1 must hit the back wall"
    assert not hitm[2].any(), "no third surface exists"
    # distinct param indices for the two walls
    assert (np.asarray(chain.aidx[0]) != np.asarray(chain.aidx[1])).all()


@pytest.mark.slow
def test_custom_vjp_matches_autodiff(walls):
    ws, o, d, chain = walls
    params = wd.init_params(ws)
    bg = wd.shade.sky(d)
    g_out = jnp.asarray(np.random.RandomState(0).randn(o.shape[0], 3),
                        jnp.float32)

    def loss_custom(alb, den):
        return jnp.sum(wd.composite_khit(alb, den, chain, bg) * g_out)

    def loss_ref(alb, den):
        return jnp.sum(wd.composite_khit_ref(alb, den, chain, bg) * g_out)

    ga, gd = jax.grad(loss_custom, argnums=(0, 1))(params.albedo,
                                                   params.density)
    ra, rd_ = jax.grad(loss_ref, argnums=(0, 1))(params.albedo,
                                                 params.density)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ra),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(rd_),
                               rtol=1e-4, atol=1e-6)
    # forward values agree too
    np.testing.assert_allclose(
        np.asarray(wd.composite_khit(params.albedo, params.density, chain,
                                     bg)),
        np.asarray(wd.composite_khit_ref(params.albedo, params.density,
                                         chain, bg)), atol=1e-6)


@pytest.mark.slow
def test_density_grad_matches_fd(walls):
    ws, o, d, chain = walls
    params = wd.init_params(ws, init_density=2.0)
    bg = wd.shade.sky(d)
    target = jnp.zeros((o.shape[0], 3), jnp.float32)

    def loss(den):
        col = wd.composite_khit(params.albedo, den, chain, bg)
        return jnp.mean((col - target) ** 2)

    g = np.asarray(jax.grad(loss)(params.density))
    front = int(np.asarray(chain.aidx)[0, 4])
    eps = 1e-3
    fd = (float(loss(params.density.at[front].add(eps)))
          - float(loss(params.density.at[front].add(-eps)))) / (2 * eps)
    assert np.isclose(g[front], fd, rtol=5e-2, atol=1e-7), (g[front], fd)


@pytest.mark.slow
def test_gradient_flows_through_visibility(walls):
    """Raising the FRONT wall's density must shrink the gradient w.r.t.
    the BACK wall's parameters — occlusion is differentiable."""
    ws, o, d, chain = walls
    params = wd.init_params(ws, init_density=2.0)
    bg = wd.shade.sky(d)
    target = jnp.zeros((o.shape[0], 3), jnp.float32)
    aidx = np.asarray(chain.aidx)
    front_ids = jnp.asarray(np.unique(aidx[0]))
    back_ids = np.unique(aidx[1])

    def back_grad_mag(density):
        def loss(alb):
            col = wd.composite_khit(alb, density, chain, bg)
            return jnp.mean((col - target) ** 2)
        ga = np.asarray(jax.grad(loss)(params.albedo))
        return float(np.abs(ga[back_ids]).sum())

    g_lo = back_grad_mag(params.density)
    # softplus(62)*ds ~ 1.9 => front alpha ~0.86: the back wall is now
    # mostly occluded and its gradient must shrink accordingly
    denser = params.density.at[front_ids].add(60.0)
    g_hi = back_grad_mag(denser)
    assert g_hi < g_lo * 0.35, (g_lo, g_hi)
    # and FD agrees the cross-term exists: front density changes the loss
    # via what it hides, even when the front albedo matches the target
    def loss_d(den):
        col = wd.composite_khit(params.albedo, den, chain, bg)
        return jnp.mean((col - target) ** 2)
    front = int(aidx[0, 0])
    eps = 1e-3
    fd = (float(loss_d(params.density.at[front].add(eps)))
          - float(loss_d(params.density.at[front].add(-eps)))) / (2 * eps)
    g = np.asarray(jax.grad(loss_d)(params.density))
    assert np.isclose(g[front], fd, rtol=5e-2, atol=1e-8)


@pytest.mark.slow
def test_wave_train_step_converges():
    ws = _two_wall_scene()
    # default camera faces -z: stand past the walls and look back
    cam = Camera(pos=np.array([1.5, 1.5, 1.95]))
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    W, H = 16, 8
    params = wd.init_params(ws, init_density=4.0)
    # table-sized params + mean loss => per-entry grads are tiny; the
    # loss floor is the irreducible sky term on miss pixels
    step = wd.make_wave_train_step(W, H, K=2, lr=400.0)
    target = jnp.zeros((H, W, 3), jnp.float32)
    losses = []
    for _ in range(8):
        params, loss = step(params, ws, cam5, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.97, losses
    assert all(a >= b for a, b in zip(losses, losses[1:])), losses
    assert all(np.isfinite(losses))


@pytest.mark.slow
def test_wave_sharded_train_step():
    """Sharded (tiles mesh) wavefront training: psum'd grads, finite
    loss, and per-step agreement with the unsharded step."""
    from svo_raytracer_tpu.parallel import mesh as mesh_mod

    ws = _two_wall_scene()
    cam = Camera(pos=np.array([1.5, 1.5, 1.95]))
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    W, H = 16, 8
    m = mesh_mod.tile_mesh(4)
    params = wd.init_params(ws, init_density=4.0)
    target = jnp.zeros((H, W, 3), jnp.float32)
    step_sh = wd.make_wave_sharded_train_step(m, W, H, K=2, lr=2.0)
    p_sh, loss_sh = step_sh(params, ws, cam5, target)
    step_un = wd.make_wave_train_step(W, H, K=2, lr=2.0)
    p_un, loss_un = step_un(params, ws, cam5, target)
    assert np.isfinite(float(loss_sh))
    np.testing.assert_allclose(float(loss_sh), float(loss_un), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(p_sh.density),
                               np.asarray(p_un.density), atol=1e-5)


def test_train_step_grads_match_fd():
    """The jitted train step's gradient (custom VJP through the K-hit
    chain the kernel traces) agrees with central finite differences of
    the same loss, at a size small enough for the fast tier."""
    ws = _two_wall_scene()
    o, d = _center_rays(4)
    chain = wd.khit_chain(ws, o, d, 2)
    hitm = np.asarray(chain.hitm)
    assert hitm[0].all() and hitm[1].all()
    params = wd.init_params(ws, init_density=1.0)
    bg = wd.shade.sky(d)
    target = jnp.full((o.shape[0], 3), 0.2, jnp.float32)

    def loss(alb, den):
        col = wd.composite_khit(alb, den, wd.khit_chain(ws, o, d, 2), bg)
        return jnp.mean((col - target) ** 2)

    ga, gd = jax.jit(jax.grad(loss, argnums=(0, 1)))(params.albedo,
                                                     params.density)
    aidx = np.asarray(chain.aidx)
    eps = 1e-3
    for k in (0, 1):
        i = int(aidx[k, 1])
        fd = (float(loss(params.albedo, params.density.at[i].add(eps)))
              - float(loss(params.albedo, params.density.at[i].add(-eps)))
              ) / (2 * eps)
        assert np.isclose(float(gd[i]), fd, rtol=5e-2, atol=1e-7), (k, fd)
        fa = (float(loss(params.albedo.at[i, 0].add(eps), params.density))
              - float(loss(params.albedo.at[i, 0].add(-eps), params.density))
              ) / (2 * eps)
        assert np.isclose(float(ga[i, 0]), fa, rtol=5e-2, atol=1e-7), (k, fa)
