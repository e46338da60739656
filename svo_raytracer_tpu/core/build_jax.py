"""Device-side octree construction — jitted bottom-up build.

The reference builds each chunk's octree with a recursive CPU scan over the
dense voxel grid (``src/engine/Octree.java:511-670``), O(size^3) re-scans per
node, parallelized with 8 host threads (``OctreeThread.java``).  The device
re-design (SURVEY.md §7 delta 3) is a *level-synchronous* build:

  Phase A — bottom-up statistics, one fused pass per level: per-cell
    homogeneity via min/max 2x strided-slice folds, the reference's quirky
    "value" pick (corner if nonzero else first-nonzero in (z,y,x) scan
    order — computed hierarchically as an argmin over raster-position keys),
    voxel exposure via a 3^3 air dilation, digit-packed normals via
    separable shifted sums, and the corner-probe big-node exposure test.
  Phase B — top-down level-order allocation: branch ranks by prefix sum,
    children of rank-r branch occupy slots base + 8r .. base + 8r + 7, and
    per-level masked scatters emit value/mask/normal/child arrays.

Layout note: the octant folds avoid reshapes with tiny trailing dims (the
naive ``(n,2,n,2,n,2)`` pooling reshape); they use strided ``lax.slice``
reads for octant subsets and ``lax.pad``-with-interior-padding sums for
octant interleaves.

Semantics are bit-equal to the NumPy oracle (``build_np.py``) — including the
reference's corner-probe exposure quirk — and the emitted graph serializes to
identical ``.svo`` bytes (allocation order differs: level-order here, DFS in
the oracle; ``svo_format.export_svo`` canonicalizes both to BFS).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as C
from .octree import Octree

i32 = jnp.int32
_KEY_INF = jnp.iinfo(jnp.int32).max


def _octant(a, ox, oy, oz):
    """Strided octant subset a[ox::2, oy::2, oz::2] (layout-safe)."""
    return jax.lax.slice(a, (ox, oy, oz), a.shape, (2, 2, 2))


def _interleave8(subs):
    """Assemble full[2i+ox, 2j+oy, 2k+oz] = subs[(ox,oy,oz)][i,j,k] via
    interior-padded adds — no tiny-dim reshapes."""
    total = None
    for (ox, oy, oz), sub in subs.items():
        padded = jax.lax.pad(sub, jnp.asarray(0, sub.dtype),
                             [(ox, 1 - ox, 1), (oy, 1 - oy, 1),
                              (oz, 1 - oz, 1)])
        total = padded if total is None else total + padded
    return total


def _upsample2(a):
    """full[2i+o] = a[i] for all octants o (nearest-neighbor x2)."""
    return _interleave8({off: a for off in C.CHILD_OFFSETS})


def _fold8(a, op):
    """Reduce 2x2x2 blocks with ``op`` via strided octant reads."""
    out = None
    for (ox, oy, oz) in C.CHILD_OFFSETS:
        sub = _octant(a, ox, oy, oz)
        out = sub if out is None else op(out, sub)
    return out


def _min_key_fold(key, val):
    """Per 2x2x2 block: (min key, value at min key)."""
    ok, ov = None, None
    for (ox, oy, oz) in C.CHILD_OFFSETS:
        k = _octant(key, ox, oy, oz)
        v = _octant(val, ox, oy, oz)
        if ok is None:
            ok, ov = k, v
        else:
            take = k < ok
            ok = jnp.where(take, k, ok)
            ov = jnp.where(take, v, ov)
    return ok, ov


def _voxel_exposure_and_normals(v):
    """Per-voxel (exposed, packed_normal): air dilation + separable offset
    sums over the 3^3 neighborhood, grid-clipped (out-of-grid is never air;
    Octree.java:620-649)."""
    air = (v == 0).astype(i32)

    def shift_sum3(a, axis):
        lo = jnp.concatenate([jnp.zeros_like(jax.lax.slice_in_dim(a, 0, 1, axis=axis)),
                              jax.lax.slice_in_dim(a, 0, -1, axis=axis)], axis=axis)
        hi = jnp.concatenate([jax.lax.slice_in_dim(a, 1, None, axis=axis),
                              jnp.zeros_like(jax.lax.slice_in_dim(a, 0, 1, axis=axis))],
                             axis=axis)
        return lo + a + hi

    def shift_diff(a, axis):
        lo = jnp.concatenate([jnp.zeros_like(jax.lax.slice_in_dim(a, 0, 1, axis=axis)),
                              jax.lax.slice_in_dim(a, 0, -1, axis=axis)], axis=axis)
        hi = jnp.concatenate([jax.lax.slice_in_dim(a, 1, None, axis=axis),
                              jnp.zeros_like(jax.lax.slice_in_dim(a, 0, 1, axis=axis))],
                             axis=axis)
        return hi - lo

    yz = shift_sum3(shift_sum3(air, 1), 2)
    xz = shift_sum3(shift_sum3(air, 0), 2)
    xy = shift_sum3(shift_sum3(air, 0), 1)
    nx = shift_diff(yz, 0)
    ny = shift_diff(xz, 1)
    nz_ = shift_diff(xy, 2)
    exposed = shift_sum3(yz, 0) > 0

    def trunc_half(a):
        # Java int division by 2 truncates toward zero
        return jnp.where(a < 0, -((-a) // 2), a // 2)

    packed = (trunc_half(nx) + 5) + (trunc_half(ny) + 5) * 10 \
        + (trunc_half(nz_) + 5) * 100
    return exposed, packed.astype(i32)


def _big_node_exposure(v, s):
    """Corner-probe exposure for cells of size s (Octree.java:651-670): the
    <=27 probe points with all three coords in {c-1, c+s, c+s+1}, clipped to
    the grid (out-of-grid probes are skipped, i.e. not air)."""
    S = v.shape[0]
    n = S // s
    base = jnp.arange(n, dtype=i32) * s
    offs = jnp.asarray([-1, s, s + 1], i32)
    coords = base[:, None] + offs[None, :]          # (n, 3)
    valid = (coords >= 0) & (coords < S)
    cc = jnp.clip(coords, 0, S - 1)

    exposed = jnp.zeros((n, n, n), bool)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                probe = v[cc[:, a][:, None, None], cc[:, b][None, :, None],
                          cc[:, c][None, None, :]] == 0
                ok = (valid[:, a][:, None, None] & valid[:, b][None, :, None]
                      & valid[:, c][None, None, :])
                exposed = exposed | (probe & ok)
    return exposed


@functools.partial(jax.jit, static_argnames=("max_lod", "capacity"))
def build_octree_jax(voxels, max_lod: int | None = None,
                     capacity: int = 1 << 20):
    """Build the SoA node table from a dense [x,y,z] voxel grid on device.

    Returns (child, mask, value, normal, n_nodes) int32 arrays of length
    ``capacity`` (+ scalar count).  If the tree exceeds ``capacity`` the count
    is still correct — check ``n_nodes <= capacity`` and rebuild bigger.
    """
    v = jnp.asarray(voxels, i32)
    S = v.shape[0]
    levels = int(np.log2(S))
    if max_lod is None:
        max_lod = levels
    max_lod = min(max_lod, levels)

    # ---- Phase A: per-level stats (bottom-up, strided folds) ----
    mins, maxs = {levels: v}, {levels: v}
    for d in range(levels - 1, -1, -1):
        mins[d] = _fold8(mins[d + 1], jnp.minimum)
        maxs[d] = _fold8(maxs[d + 1], jnp.maximum)

    # first-nonzero in the reference's (z,y,x)-raster scan order, computed
    # hierarchically: per-voxel key = z*S^2 + y*S + x (global raster position
    # restricted to any cell preserves local scan order), argmin-folded.
    ax = jnp.arange(S, dtype=i32)
    raster = (ax[None, None, :] * S + ax[None, :, None]) * S + ax[:, None, None]
    key0 = jnp.where(v != 0, raster, _KEY_INF)
    keys, vals = {levels: key0}, {levels: v}
    for d in range(levels - 1, -1, -1):
        keys[d], vals[d] = _min_key_fold(keys[d + 1], vals[d + 1])

    exposed1, packed_normals = _voxel_exposure_and_normals(v)

    stats = {}
    for d in range(1, max_lod + 1):
        s = S >> d
        corner = v[::s, ::s, ::s]
        if d == max_lod:
            leaf = jnp.ones_like(corner, dtype=bool)
            value = corner
        else:
            homog = mins[d] == maxs[d]
            first_nz = jnp.where(keys[d] != _KEY_INF, vals[d], 0)
            leaf = homog
            value = jnp.where(homog, corner,
                              jnp.where(corner != 0, corner, first_nz))
        if s == 1:
            exp_ = exposed1
            normal = packed_normals
            tag = jnp.where(
                leaf & (value != 0),
                jnp.where(exp_, C.TAG_SURFACE_LEAF, C.TAG_NON_SURFACE_LEAF),
                jnp.where(leaf, C.TAG_NON_SURFACE_LEAF, C.TAG_BRANCH))
        else:
            normal = jnp.zeros_like(corner)
            big = _big_node_exposure(v, s)
            tag = jnp.where(
                leaf & (value != 0),
                jnp.where(big, C.TAG_BRANCH, C.TAG_SUBDIV_LEAF),
                jnp.where(leaf, C.TAG_SUBDIV_LEAF, C.TAG_BRANCH))
        stats[d] = dict(tag=tag.astype(i32), value=value.astype(i32),
                        normal=jnp.where(tag == C.TAG_SURFACE_LEAF,
                                         normal, 0).astype(i32))

    # ---- Phase B: level-order allocation + emission ----
    child = jnp.zeros(capacity, i32)
    mask = jnp.zeros(capacity, i32)
    value_arr = jnp.zeros(capacity, i32)
    normal_arr = jnp.zeros(capacity, i32)
    value_arr = value_arr.at[0].set(1)  # root (dummy head, Octree.java:97-100)

    # full-grid running state at the parent level
    parent_slot = jnp.zeros((1, 1, 1), i32)          # slot of each parent cell
    parent_exists = jnp.ones((1, 1, 1), bool)
    level_base = jnp.asarray(8, i32)                 # root block occupies 0..7
    n_nodes = jnp.asarray(8, i32)

    for d in range(1, max_lod + 1):
        st = stats[d]
        if d == 1:
            parent_branch = jnp.ones((1, 1, 1), bool)
        else:
            parent_branch = (stats[d - 1]["tag"] == C.TAG_BRANCH)
        pb = parent_exists & parent_branch

        flat_pb = pb.reshape(-1).astype(i32)
        rank = (jnp.cumsum(flat_pb) - flat_pb).reshape(pb.shape)
        n_branch = jnp.sum(flat_pb)
        child_base = level_base + 8 * rank           # per parent cell

        # parent child pointers + masks (mask assembled from child tags)
        cmask = jnp.zeros(pb.shape, i32)
        for k, (ox, oy, oz) in enumerate(C.CHILD_OFFSETS):
            cmask = cmask | (_octant(st["tag"], ox, oy, oz) << (2 * k))
        pslots = jnp.where(pb, parent_slot, capacity).reshape(-1)
        child = child.at[pslots].set(
            jnp.where(pb, child_base, 0).reshape(-1), mode="drop")
        mask = mask.at[pslots].set(cmask.reshape(-1), mode="drop")

        # emit the children: slot[2i+o] = child_base[i] + octant_index(o)
        cslot = _interleave8({
            off: child_base + k for k, off in enumerate(C.CHILD_OFFSETS)})
        cexists = _upsample2(pb)
        safe_slots = jnp.where(cexists, cslot, capacity).reshape(-1)
        value_arr = value_arr.at[safe_slots].set(st["value"].reshape(-1),
                                                 mode="drop")
        normal_arr = normal_arr.at[safe_slots].set(st["normal"].reshape(-1),
                                                   mode="drop")
        level_base = level_base + 8 * n_branch
        n_nodes = n_nodes + 8 * n_branch
        parent_slot = cslot
        parent_exists = cexists

    return child, mask, value_arr, normal_arr, n_nodes


def build_octree(voxels, max_lod: int | None = None,
                 capacity: int = 1 << 20, world_size: int | None = None) -> Octree:
    """Host-friendly wrapper returning an :class:`Octree` on device."""
    S = int(voxels.shape[0])
    child, mask, value, normal, n = build_octree_jax(
        voxels, max_lod=max_lod, capacity=capacity)
    n = int(n)
    if n > capacity:
        raise MemoryError(
            f"octree needs {n} node slots but capacity is {capacity}; "
            f"rebuild with capacity>={n}")
    return Octree(child=child, mask=mask, value=value, normal=normal,
                  n_nodes=n, world_size=world_size or S)
