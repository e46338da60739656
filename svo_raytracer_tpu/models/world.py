"""Chunked world builds — the constructCompleteOctree analog.

The reference builds big worlds as a fixed top tree of interior nodes down to
chunk level (``fillEmptyChildren``, ``Octree.java:481-502``), then per chunk:
GPU noise dispatch -> 1 GB readback -> 8 host threads building sub-octrees ->
byte-buffer splice (``Octree.java:250-343``).  Here each chunk's voxels are
generated *and* reduced to a node table on device (no readback), and splicing
is an index-remapped array append.

Known graph delta vs the reference (renders identically): the reference
unconditionally creates the 8 sub-octree heads of every chunk as interior
nodes (``Octree.java:317-343``), even over homogeneous regions; our
whole-chunk build lets a homogeneous half-chunk collapse to a subdividable
leaf.  Exposure/normal clipping at chunk borders matches the reference
exactly (each chunk sees only its own grid; cross-chunk neighbors are
treated as solid — the same border artifact).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..core import build_jax
from ..core.octree import Octree, ROOT
from ..utils import constants as C


def chunk_layout(world_size: int, chunk_size: int):
    """Top-of-tree layout: (top_tree_arrays, [(origin, chunk_slot), ...]).

    Replicates fillEmptyChildren (Octree.java:481-502): a full branch tree
    of interior (value 1) nodes down to chunk level, chunks enumerated in
    DFS octant order.
    """
    levels = int(np.log2(world_size // chunk_size))
    cap = 8
    for d in range(1, levels + 1):
        cap += 8 ** d
    cap += 8  # root block padding
    child = np.zeros(cap, np.int32)
    mask = np.zeros(cap, np.int32)
    value = np.zeros(cap, np.int32)
    normal = np.zeros(cap, np.int32)
    n = [8]
    value[ROOT] = 1
    chunks: list[tuple[tuple[int, int, int], int]] = []

    def fill(parent: int, lvl: int, pos):
        if lvl == 0:
            chunks.append((tuple(int(p) for p in pos), parent))
            return
        csize = chunk_size << (lvl - 1)
        base = n[0]
        n[0] += 8
        child[parent] = base
        mask[parent] = 0  # all children are branches (tag 0)
        for k, off in enumerate(C.CHILD_OFFSETS):
            value[base + k] = 1
        for k, off in enumerate(C.CHILD_OFFSETS):
            cpos = (pos[0] + off[0] * csize, pos[1] + off[1] * csize,
                    pos[2] + off[2] * csize)
            fill(base + k, lvl - 1, cpos)

    fill(ROOT, levels, (0, 0, 0))
    top = Octree(child=child[:n[0]], mask=mask[:n[0]], value=value[:n[0]],
                 normal=normal[:n[0]], n_nodes=n[0], world_size=world_size)
    return top, chunks


def splice_chunk(world: Octree, chunk_slot: int, chunk: Octree) -> Octree:
    """Graft a chunk tree under ``chunk_slot`` — the array version of the
    byte-buffer splice at Octree.java:317-343 (append + pointer remap)."""
    chunk = chunk.to_numpy()
    offset = world.n_nodes
    m = chunk.n_nodes - 8  # drop the chunk root block (slots 0..7)

    def grow(a, extra):
        return np.concatenate([np.asarray(a), extra])

    ch = np.asarray(chunk.child[8:chunk.n_nodes]).copy()
    ch = np.where(ch > 0, ch + (offset - 8), 0).astype(np.int32)
    new = Octree(
        child=grow(world.child[:world.n_nodes], ch),
        mask=grow(world.mask[:world.n_nodes],
                  np.asarray(chunk.mask[8:chunk.n_nodes])),
        value=grow(world.value[:world.n_nodes],
                   np.asarray(chunk.value[8:chunk.n_nodes])),
        normal=grow(world.normal[:world.n_nodes],
                    np.asarray(chunk.normal[8:chunk.n_nodes])),
        n_nodes=world.n_nodes + m,
        world_size=world.world_size,
    )
    # the chunk slot adopts the chunk root's payload
    root_child = int(chunk.child[ROOT])
    new.child[chunk_slot] = (offset + root_child - 8) if root_child else 0
    new.mask[chunk_slot] = int(chunk.mask[ROOT])
    new.value[chunk_slot] = int(chunk.value[ROOT])
    return new


def build_world(world_size: int, chunk_size: int,
                gen_fn: Callable[[tuple[int, int, int]], np.ndarray],
                max_lod: int | None = None,
                chunk_capacity: int = 1 << 20,
                world_offset=(0, 0, 0),
                verbose: bool = False) -> Octree:
    """Build a chunked world octree.

    ``gen_fn(origin) -> (chunk_size^3) voxel grid`` (device or host array).
    ``max_lod`` is depth *within a chunk* (reference: 1 + maxLOD(9) = 10
    levels for a 1024 chunk = full voxel res; pass 10 or None for the same).
    ``world_offset`` shifts generation coordinates (Constants.WORLD_OFFSET /
    the rootPos arg of Octree.java:358).
    """
    if world_size == chunk_size:
        v = np.asarray(gen_fn(tuple(world_offset)))
        return build_jax.build_octree(v, max_lod=max_lod,
                                      capacity=chunk_capacity,
                                      world_size=world_size)

    world, chunks = chunk_layout(world_size, chunk_size)
    for i, (origin, slot) in enumerate(chunks):
        gpos = (origin[0] + world_offset[0], origin[1] + world_offset[1],
                origin[2] + world_offset[2])
        v = gen_fn(gpos)
        chunk = build_jax.build_octree(v, max_lod=max_lod,
                                       capacity=chunk_capacity,
                                       world_size=chunk_size)
        world = splice_chunk(world, slot, chunk)
        if verbose:
            print(f"chunk {i + 1}/{len(chunks)} at {gpos}: "
                  f"{chunk.n_nodes} nodes, world total {world.n_nodes}")
    return world


def build_world_sharded(world_size: int, chunk_size: int,
                        gen_fn: Callable, mesh,
                        max_lod: int | None = None,
                        chunk_capacity: int = 1 << 20,
                        world_offset=(0, 0, 0),
                        verbose: bool = False) -> Octree:
    """:func:`build_world` with chunk generation+build data-parallel over
    the mesh's ``tiles`` axis (SURVEY §2.2 row 3: the reference's
    GPU-noise -> 8 host threads pipeline re-expressed as pjit sharding).

    ``gen_fn(origin_i32_array) -> (chunk^3) voxels`` must be JITTABLE
    (it runs inside ``shard_map``; the stock generators in
    models/procgen.py and models/heightmap.py qualify).  Each device
    generates and level-synchronously builds one chunk per group; the
    host splices group results in DFS chunk order, so the resulting
    node table is IDENTICAL to the serial :func:`build_world` output
    (tests/test_worldgen.py asserts array equality).
    """
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    if world_size == chunk_size:
        return build_world(world_size, chunk_size, gen_fn, max_lod=max_lod,
                           chunk_capacity=chunk_capacity,
                           world_offset=world_offset, verbose=verbose)

    n_dev = mesh.shape["tiles"]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("tiles"),
        out_specs=(P("tiles"),) * 5, check_vma=False)
    def _build_group(origins):  # (1, 3) i32 per shard
        v = gen_fn(origins[0])
        child, mask, value, normal, n = build_jax.build_octree_jax(
            v, max_lod=max_lod, capacity=chunk_capacity)
        return (child[None], mask[None], value[None], normal[None],
                n.reshape(1))

    world, chunks = chunk_layout(world_size, chunk_size)
    origins = np.asarray([[o[0] + world_offset[0], o[1] + world_offset[1],
                           o[2] + world_offset[2]] for o, _ in chunks],
                         np.int32)
    built = jax.jit(_build_group)  # one compiled fn reused per group
    for g0 in range(0, len(chunks), n_dev):
        grp = origins[g0:g0 + n_dev]
        pad = n_dev - len(grp)
        if pad:  # partial tail group: repeat the last origin, drop results
            grp = np.concatenate([grp, np.repeat(grp[-1:], pad, axis=0)])
        child, mask, value, normal, ns = built(jnp.asarray(grp))
        ns = np.asarray(ns)
        for j in range(min(n_dev, len(chunks) - g0)):
            n_j = int(ns[j])
            if n_j > chunk_capacity:
                raise MemoryError(f"chunk needs {n_j} > {chunk_capacity}")
            chunk = Octree(child=np.asarray(child[j]),
                           mask=np.asarray(mask[j]),
                           value=np.asarray(value[j]),
                           normal=np.asarray(normal[j]),
                           n_nodes=n_j, world_size=chunk_size)
            world = splice_chunk(world, chunks[g0 + j][1], chunk)
        if verbose:
            print(f"chunk group {g0 // n_dev}: world total {world.n_nodes}")
    return world


def build_terrain(world_size: int = 1024, chunk_size: int = 512,
                  seed: int = 0, chunk_capacity: int = 1 << 24) -> Octree:
    """The headline procedural-terrain world (benchmarks.md:5): Perlin
    terrain chunks generated and built on the device, the terrain band
    centred at y=0 like the reference's rootPos (0,-1024,0).  ``seed``
    selects which stretch of the (deterministic) terrain is built: it
    shifts the world by ``seed`` world widths along x."""
    import jax.numpy as jnp

    from . import procgen

    def gen(origin):
        return procgen.generate_chunk(jnp.asarray(origin, jnp.int32),
                                      chunk_size=chunk_size)

    return build_world(world_size, chunk_size, gen,
                       chunk_capacity=chunk_capacity,
                       world_offset=(seed * world_size, -world_size // 2, 0))


def terrain_camera(wscene):
    """A camera just above the terrain surface, looking down-range: probe
    25 downward rays and stand over the clearest column (host Camera)."""
    import jax.numpy as jnp

    from ..ops import wavefront
    from ..utils.camera import Camera

    gx = np.linspace(1.2, 1.8, 5, dtype=np.float32)
    pxz = np.stack(np.meshgrid(gx, gx, indexing="ij"), -1).reshape(-1, 2)
    o = np.concatenate([pxz[:, :1], np.full((25, 1), 1.999, np.float32),
                        pxz[:, 1:]], axis=1)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (25, 1))
    res = wavefront.intersect(wscene, jnp.asarray(o), jnp.asarray(d))
    ts = np.asarray(res.t)   # 0 where a column misses
    best = int(np.argmax(ts))
    surf_y = 1.999 - float(ts[best])
    cam = Camera(pos=np.array([o[best, 0], min(surf_y + 0.05, 1.99),
                               o[best, 2]]))
    cam.rotate(-0.35, 0.4)
    return cam
