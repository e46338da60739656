"""Ray-tile-sharded rendering and training over a device mesh.

The image's rows are sharded over the ``tiles`` mesh axis; the octree node
table and voxel parameters are replicated (octrees up to a few GB fit every
device — parallel/bricks.py shards the tree itself).
Voxel-parameter gradients are ``psum``-reduced over ``tiles``; XLA schedules
the all-reduce overlapped with the backward scatter chain (SURVEY.md §2.2
last row, §5 "Distributed communication backend").

This re-expresses the reference's only scaling story (more GL workgroups
on one GPU) as shard_map over a Mesh with XLA collectives — not a port of
any host-side code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..diff.render_diff import VoxelParams, render_diff
from ..ops import shade, traverse
from ..utils import constants as C

f32 = jnp.float32


def _row_offsets(mesh: Mesh, height: int):
    n = mesh.shape["tiles"]
    assert height % n == 0, f"height {height} must divide over {n} tiles"
    rows = height // n
    offs = jnp.arange(n, dtype=jnp.int32) * rows
    return offs, rows


def make_sharded_render(mesh: Mesh, width: int, height: int, render_mode=2,
                        max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Full-frame render with rows sharded over the ``tiles`` axis.

    Returns ``render(tree_arrays, cam5) -> (H, W, 3)`` (jitted).  The octree
    is replicated; each device traces height/n_tiles rows.
    """
    offs, rows = _row_offsets(mesh, height)
    rep = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=((rep,) * 4, rep, P("tiles")),
        out_specs=P("tiles"), check_vma=False)
    def _render(tree_arrays, cam5, row0):
        dirs = shade.pixel_dirs_rows(cam5, width, height, row0[0], rows)
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = jnp.broadcast_to(cam5[0], dirs.shape)
        if render_mode == 2:
            col, _, _ = shade.shade_direct(tree_arrays, origins, dirs,
                                           max_iterations=max_iterations)
        elif render_mode == 3:
            col, _, _ = shade.shade_normals(tree_arrays, origins, dirs,
                                            max_iterations=max_iterations)
        elif render_mode == 1:
            col, _, _ = shade.shade_heatmap(tree_arrays, origins, dirs,
                                            max_iterations=max_iterations)
        else:
            raise ValueError("sharded render supports modes 1/2/3")
        return col.reshape(rows, width, 3)

    @jax.jit
    def render(tree_arrays, cam5):
        return _render(tree_arrays, jnp.asarray(cam5, f32), offs)

    return render


def make_sharded_train_step(mesh: Mesh, width: int, height: int,
                            lr: float = 0.5,
                            max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Differentiable-render training step sharded over ray tiles.

    Returns ``step(params, tree_arrays, cam5, target) -> (params, loss)``.
    ``target`` is the full (H, W, 3) image (sharded by rows on entry).  Local
    per-tile gradients are psum'd over ``tiles`` so every device applies the
    same update to its replicated parameters.
    """
    offs, rows = _row_offsets(mesh, height)
    rep = P()

    def _local_loss(params, tree_arrays, cam5, row0, target_rows):
        dirs = shade.pixel_dirs_rows(cam5, width, height, row0, rows)
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = jnp.broadcast_to(cam5[0], dirs.shape)
        res = traverse.intersect_octree(tree_arrays, origins, dirs,
                                        max_iterations=max_iterations)
        node = jnp.where(res.hit, res.node, 0)
        alb = params.albedo[node]
        den = jax.nn.softplus(params.density[node])
        alpha = 1.0 - jnp.exp(-den * res.scale_exp2)
        normal = jnp.nan_to_num(res.normal)
        light = jnp.clip(jnp.sum(normal * shade.SUN_DIR_DIRECT[None, :],
                                 axis=-1), 0.0, 1.0) * 0.7 + 0.3
        surf = alb * light[:, None]
        bg = shade.sky(dirs)
        col = jnp.where(res.hit[:, None],
                        alpha[:, None] * surf + (1 - alpha[:, None]) * bg, bg)
        return jnp.sum((col.reshape(rows, width, 3) - target_rows) ** 2)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(rep, (rep,) * 4, rep, P("tiles"), P("tiles")),
        out_specs=(rep, rep), check_vma=False)
    def _step(params, tree_arrays, cam5, row0, target_rows):
        local_sum, grads = jax.value_and_grad(_local_loss)(
            params, tree_arrays, cam5, row0[0], target_rows)
        # gradient all-reduce over ray tiles (the DP all-reduce analog);
        # XLA overlaps this with the backward scatter chain
        grads = jax.tree.map(lambda g: jax.lax.psum(g, "tiles"), grads)
        loss = jax.lax.psum(local_sum, "tiles") / (height * width * 3)
        denom = f32(height * width * 3)
        new = VoxelParams(
            albedo=params.albedo - lr * grads.albedo / denom,
            density=params.density - lr * grads.density / denom,
        )
        return new, loss

    @jax.jit
    def step(params, tree_arrays, cam5, target):
        return _step(params, tree_arrays, jnp.asarray(cam5, f32), offs,
                     jnp.asarray(target, f32))

    return step
