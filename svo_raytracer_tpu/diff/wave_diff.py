"""Differentiable rendering on the production traversal with gradients
through visibility.

The reference renderer has no gradients (SURVEY.md §7 delta 4); the
single-hit alpha compositing of diff/render_diff.py cannot pass a
gradient through occlusion.  This module can:

  * :func:`khit_chain` marches K hits per ray with the production
    traversal (ops/wavefront.intersect — one jittable call, so it shards
    with ``shard_map``).  Traversal is geometric and carries no
    gradients; the chain (per-hit parameter index, cube edge, light
    term) is the residual set.
  * :func:`composite_khit` is front-to-back transmittance compositing
    over the chain with a hand-derived :func:`jax.custom_vjp`: the
    backward pass is a closed-form suffix recurrence + scatter-add into
    the parameter tables.  Because hit k's alpha attenuates every later
    hit AND the sky term, d loss/d density[front] sees the back voxel —
    raising a front voxel's density *reduces* the gradient reaching what
    it occludes (tests/test_wave_diff.py pins this, FD-verified).

Parameters are keyed by the traversal's stable per-voxel id
(HitResult.node = attribute index: mixed-brick voxels at
slot*32768+widx, uniform bricks at capacity*32768+cell — see
ops/wavefront.py), so tables are (capacity*32768 + G^3,)-aligned and
gradients all-reduce across ray-tile shards exactly like the ESVO path's
node tables.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import shade, wavefront

f32 = jnp.float32
i32 = jnp.int32


class WaveParams(NamedTuple):
    """Learnable per-voxel appearance parameters, attr-index aligned."""

    albedo: jax.Array   # f32 (capacity*32768 + G^3, 3)
    density: jax.Array  # f32 (capacity*32768 + G^3,) pre-softplus


def param_size(wscene) -> int:
    return wscene.capacity * wavefront.BRICK_WORDS + wscene.grid_size ** 3


def init_params(wscene, init_density: float = 10.0) -> WaveParams:
    """Palette-seeded init like render_diff.init_params: an untrained
    render matches the direct-mode albedo of the scene's materials.
    Built on the device from the scene's attribute table."""
    n = param_size(wscene)

    @jax.jit
    def _build(attrs):
        value = attrs & 0xFF
        albedo = jnp.full((n, 3), 0.5, f32)
        for v, rgb in shade._PALETTE.items():
            albedo = jnp.where((value == v)[:, None],
                               jnp.asarray(rgb, f32)[None, :], albedo)
        return albedo

    return WaveParams(albedo=_build(wscene.attrs),
                      density=jnp.full((n,), init_density, f32))


class HitChain(NamedTuple):
    """K stacked hit records (geometry only — no gradients)."""

    aidx: jax.Array   # i32 (K, B) param index (0 where no hit)
    hitm: jax.Array   # f32 (K, B) 1.0 where hit k exists
    ds: jax.Array     # f32 (K, B) hit cube edge (normalized units)
    light: jax.Array  # f32 (K, B) diffuse sun term at the hit


def _advance_past(origins, dirs, res):
    """Origin for the next traversal stage: just past the exit face of
    the hit cube.  The corner comes from the entry point nudged into the
    cube (NOT from voxel_pos/normal — zero-normal voxels decode to NaN,
    the reference's stale-mask quirk, brick_trace.decode_hits)."""
    e = res.scale_exp2[:, None]
    p_in = origins + (res.t + 0.01 * res.scale_exp2)[:, None] * dirs
    corner = 1.0 + jnp.floor((p_in - 1.0) / e) * e
    d = jnp.where(jnp.abs(dirs) < 1e-4,
                  jnp.where(dirs >= 0, f32(1e-4), f32(-1e-4)), dirs)
    tx = jnp.maximum((corner - origins) / d, (corner + e - origins) / d)
    t_exit = jnp.min(tx, axis=-1)
    t_push = t_exit + 0.05 * res.scale_exp2
    return origins + t_push[:, None] * dirs


def khit_chain(wscene, origins, dirs, K) -> HitChain:
    """March K hits per ray through the production traversal."""
    B = origins.shape[0]
    # normalize ONCE and use the unit dirs everywhere below: res.t is
    # measured along the traced (unit) direction, so _advance_past must
    # advance along the same vector (callers may pass the unnormalized
    # shade.pixel_dirs_device output)
    dirs = d_unit(dirs)
    act = jnp.ones(B, bool)
    o = origins
    aidxs, hitms, dss, lights = [], [], [], []
    for _ in range(K):
        res = wavefront.intersect(wscene, o, dirs, act)
        hit = act & res.hit
        aidxs.append(jnp.where(hit, res.node, 0))
        hitms.append(hit.astype(f32))
        dss.append(jnp.where(hit, res.scale_exp2, 0.0))
        normal = jnp.nan_to_num(res.normal)
        lights.append(jnp.clip(
            jnp.sum(normal * shade.SUN_DIR_DIRECT[None, :], axis=-1),
            0.0, 1.0) * 0.7 + 0.3)
        o = _advance_past(o, dirs, res)
        act = hit
    return HitChain(aidx=jnp.stack(aidxs), hitm=jnp.stack(hitms),
                    ds=jnp.stack(dss), light=jnp.stack(lights))


def d_unit(d):
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


# ------------------------------------------------------------- compositor
@jax.custom_vjp
def composite_khit(albedo, density, chain: HitChain, bg):
    """Front-to-back transmittance compositing over a K-hit chain.

      alpha_k = hit_k * (1 - exp(-softplus(density[aidx_k]) * ds_k))
      col     = sum_k T_k alpha_k albedo[aidx_k] light_k  +  T_K bg
      T_k     = prod_{j<k} (1 - alpha_j)

    The custom VJP saves only the chain + gathered scalars and writes the
    backward as a suffix recurrence + two scatter-adds (what reverse-mode
    would build anyway, minus the forward-graph bookkeeping; also the
    SURVEY §7 "backward scatters dL/d(albedo,density) per hit voxel"
    contract, now through visibility)."""
    col, _ = _composite_fwd_math(albedo, density, chain, bg)
    return col


def _composite_fwd_math(albedo, density, chain, bg):
    K, B = chain.aidx.shape
    T = jnp.ones(B, f32)
    col = jnp.zeros((B, 3), f32)
    Ts, alphas, albs, exps = [], [], [], []
    for k in range(K):
        den = jax.nn.softplus(density[chain.aidx[k]])
        ex = jnp.exp(-den * chain.ds[k])
        alpha = chain.hitm[k] * (1.0 - ex)
        alb = albedo[chain.aidx[k]]
        col = col + (T * alpha * chain.light[k])[:, None] * alb
        Ts.append(T)
        alphas.append(alpha)
        albs.append(alb)
        exps.append(ex)
        T = T * (1.0 - alpha)
    col = col + T[:, None] * bg
    return col, (Ts, alphas, albs, exps, T)


def _composite_fwd(albedo, density, chain, bg):
    col, (Ts, alphas, albs, exps, Tend) = _composite_fwd_math(
        albedo, density, chain, bg)
    res = (jnp.stack(Ts), jnp.stack(alphas), jnp.stack(albs),
           jnp.stack(exps), Tend, density, chain, bg)
    return col, res


def _composite_bwd(res, g):
    Ts, alphas, albs, exps, Tend, density, chain, bg = res
    K, B = chain.aidx.shape
    d_albedo = jnp.zeros((density.shape[0], 3), f32)
    d_density = jnp.zeros(density.shape, f32)
    # suffix S_k = sum_{j>k} T_j alpha_j light_j (g . alb_j) + T_end (g . bg)
    # d col/d alpha_k = T_k light_k (g . alb_k) - S_k / (1 - alpha_k)
    gb = jnp.sum(g * bg, axis=-1)
    S = Tend * gb
    for k in range(K - 1, -1, -1):
        ga = jnp.sum(g * albs[k], axis=-1)
        direct = Ts[k] * chain.light[k] * ga
        d_alpha = direct - S / jnp.maximum(1.0 - alphas[k], 1e-20)
        # alpha = hit * (1 - exp(-softplus(den_raw) * ds))
        den_raw = density[chain.aidx[k]]
        d_den = (d_alpha * chain.hitm[k] * exps[k] * chain.ds[k]
                 * jax.nn.sigmoid(den_raw))
        w_alb = (Ts[k] * alphas[k] * chain.light[k])[:, None] * g
        d_albedo = d_albedo.at[chain.aidx[k]].add(
            w_alb * chain.hitm[k][:, None])
        d_density = d_density.at[chain.aidx[k]].add(d_den * chain.hitm[k])
        S = S + direct * alphas[k]
    d_chain = jax.tree.map(
        lambda x: (np.zeros(x.shape, jax.dtypes.float0)
                   if jnp.issubdtype(x.dtype, jnp.integer)
                   else jnp.zeros_like(x)), chain)
    return d_albedo, d_density, d_chain, jnp.zeros_like(bg)


composite_khit.defvjp(_composite_fwd, _composite_bwd)


def composite_khit_ref(albedo, density, chain, bg):
    """Same math WITHOUT custom_vjp — plain autodiff reference the tests
    check the hand-written backward against."""
    col, _ = _composite_fwd_math(albedo, density, chain, bg)
    return col


# ------------------------------------------------------------- training
def render_wave_diff(params: WaveParams, wscene, origins, dirs, K,
                     use_ref_vjp=False):
    chain = khit_chain(wscene, origins, dirs, K)
    bg = shade.sky(d_unit(dirs))
    fn = composite_khit_ref if use_ref_vjp else composite_khit
    return fn(params.albedo, params.density, chain, bg)


def make_wave_train_step(width, height, K=3, lr=0.5):
    """Jitted SGD step on (albedo, density) through the K-hit chain.
    ``step(params, wscene, cam5, target) -> (params, loss)``; the scene is
    an argument, so an edited scene trains without a new step."""

    def loss_fn(params, wscene, cam5, target):
        dirs = shade.pixel_dirs_device(cam5, width, height)
        dirs = d_unit(dirs)
        origins = jnp.broadcast_to(cam5[0], dirs.shape)
        chain = khit_chain(wscene, origins, dirs, K)
        bg = shade.sky(dirs)
        col = composite_khit(params.albedo, params.density, chain, bg)
        return jnp.mean((col.reshape(height, width, 3) - target) ** 2)

    @jax.jit
    def step(params, wscene, cam5, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, wscene, cam5,
                                                  target)
        new = WaveParams(albedo=params.albedo - lr * grads.albedo,
                         density=params.density - lr * grads.density)
        return new, loss

    return step


def make_wave_sharded_train_step(mesh, width, height, K=2, lr=0.5):
    """Ray-tile-sharded training step: each device traces its row block's
    K-hit chain with the production traversal and the parameter gradients
    psum over ``tiles`` — the production-engine analog of
    parallel/render_sharded.make_sharded_train_step.  ``step(params,
    wscene, cam5, target) -> (params, loss)``."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.render_wave_sharded import _shard_rays

    n_sh = mesh.shape["tiles"]
    assert height % n_sh == 0
    rows = height // n_sh
    B = rows * width
    rep = P()

    def shard_loss(params, wscene, cam5, target_rows, row0):
        o, d, _px, _py = _shard_rays(cam5, width, height, rows, row0[0],
                                     stride=n_sh)
        chain = khit_chain(wscene, o, d, K)
        bg = shade.sky(d)
        col = composite_khit(params.albedo, params.density, chain, bg)
        err = (col.reshape(rows, width, 3) - target_rows) ** 2
        return jnp.sum(err) / (height * width * 3)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(rep, rep, rep, P("tiles"), P("tiles")),
        out_specs=(rep, rep), check_vma=False)
    def _grad_shard(params, wscene, cam5, target, row0):
        loss, grads = jax.value_and_grad(shard_loss)(params, wscene, cam5,
                                                     target, row0)
        loss = jax.lax.psum(loss, "tiles")
        grads = jax.tree.map(lambda x: jax.lax.psum(x, "tiles"), grads)
        return loss, grads

    offs = jnp.arange(n_sh, dtype=i32)  # interleaved rows (balance)

    @jax.jit
    def step(params, wscene, cam5, target):
        # image rows d, d+n, ... belong to shard d (interleaved layout)
        tgt = (target.reshape(rows, n_sh, width, 3).transpose(1, 0, 2, 3)
               if target.ndim == 3 else target)
        loss, grads = _grad_shard(params, wscene, jnp.asarray(cam5, f32),
                                  tgt, offs)
        new = WaveParams(albedo=params.albedo - lr * grads.albedo,
                         density=params.density - lr * grads.density)
        return new, loss

    return step
