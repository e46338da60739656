"""Sparse-voxel-octree node table — the device-side octree representation.

The reference stores a pointer-compressed SVO in one flat big-endian byte
buffer with *variable-size* nodes (7/3/1 bytes; ``src/engine/Octree.java:68-95``)
and finds child *k* by summing the byte sizes of children 0..k-1 from a 2-bit
leaf mask (``Octree.java:901-921``, mirrored on the GPU at
``src/shaders/svotrace.comp:132-157``).  That layout is hostile to a lock-step
vector machine: every child fetch is a serial byte walk.

Here every node is one fixed-stride record in a structure-of-arrays int32
table, and a branch's 8 children occupy 8 *contiguous* slots, so fetching
child k is a single gather at ``child[parent] + k``.  The reference's
*semantics* are preserved exactly so ``.svo`` files map 1:1 (see
``svo_format.py``):

  child[i]  : absolute node index of child 0 (0 == no children / leaf payload)
  mask[i]   : 16-bit leaf mask, 2 bits per child (tag values Octree.java:589-599)
  value[i]  : material id, 0 = air (1 byte in the reference)
  normal[i] : digit-packed surface normal for surface leaves (Util.java:140-146)

A child's *type* is the 2-bit tag in its parent's mask:

  0 = branch            (7-byte node in the reference)
  1 = surface leaf      (3-byte: value + packed normal)
  2 = subdividable leaf (7-byte padded leaf, in-place promotable)
  3 = non-surface leaf  (1-byte: value only)

Reference quirk preserved for bit-exact parity: when the traversal hits a
non-surface-leaf node (branch at the depth cutoff, or subdividable leaf) the
shader decodes the node's *leaf-mask bytes* as a packed normal
(svotrace.comp:381-388 reads ``targetNode.leafMask``).  The effective raw
normal field is therefore tag-dependent; see :func:`effective_normal_raw`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..utils import constants as C

# Node slot 0 is always the root, so 0 can double as the "no children"
# sentinel exactly like the reference's relative child pointer 0.
ROOT = 0


@dataclasses.dataclass
class Octree:
    """SoA octree node table plus world metadata.

    Arrays may be NumPy (host) or jax.Array (device); all code treats them
    uniformly.  ``n_nodes`` counts live slots; arrays may be over-allocated
    (padded to a capacity) so device buffers keep a stable shape across edits.
    """

    child: Any   # int32[cap] — absolute index of first child, 0 = leaf
    mask: Any    # int32[cap] — 16-bit leaf mask (2 bits x 8 children)
    value: Any   # int32[cap] — material id (0 = air)
    normal: Any  # int32[cap] — digit-packed normal (surface leaves)
    n_nodes: int
    world_size: int  # voxel resolution spanned by the root cube

    @property
    def capacity(self) -> int:
        return int(self.child.shape[0])

    # -- convenience accessors (host-side; small-scale use) -----------------
    def child_tag(self, parent: int, k: int) -> int:
        """2-bit type tag of child k (Octree.java:589-599)."""
        return (int(self.mask[parent]) >> (2 * k)) & 3

    def child_index(self, parent: int, k: int) -> int:
        return int(self.child[parent]) + k

    def node_counts(self) -> dict:
        """Node-type census (the analog of Octree.printNodeCounts:1018-1026).

        Types are derived from parent masks; the root is counted as interior.
        """
        counts = {"interior": 1, "surface_leaf": 0, "non_surface_leaf": 0,
                  "subdividable_leaf": 0}
        names = {C.TAG_BRANCH: "interior", C.TAG_SURFACE_LEAF: "surface_leaf",
                 C.TAG_SUBDIV_LEAF: "subdividable_leaf",
                 C.TAG_NON_SURFACE_LEAF: "non_surface_leaf"}
        child = np.asarray(self.child[: self.n_nodes])
        mask = np.asarray(self.mask[: self.n_nodes])
        for p in np.nonzero(child)[0]:
            m = int(mask[p])
            for k in range(8):
                counts[names[(m >> (2 * k)) & 3]] += 1
        return counts

    def to_numpy(self) -> "Octree":
        return Octree(
            child=np.asarray(self.child), mask=np.asarray(self.mask),
            value=np.asarray(self.value), normal=np.asarray(self.normal),
            n_nodes=self.n_nodes, world_size=self.world_size,
        )

    def to_device(self, pad_to: int | None = None) -> "Octree":
        """Move the table to the default JAX device, optionally padding the
        capacity up to ``pad_to`` so edits don't change buffer shapes."""
        import jax.numpy as jnp

        cap = self.capacity if pad_to is None else max(pad_to, self.n_nodes)

        def pad(a):
            a = np.asarray(a)
            if cap > a.shape[0]:
                a = np.pad(a, (0, cap - a.shape[0]))
            return jnp.asarray(a[:cap], dtype=jnp.int32)

        return Octree(
            child=pad(self.child), mask=pad(self.mask), value=pad(self.value),
            normal=pad(self.normal), n_nodes=self.n_nodes,
            world_size=self.world_size,
        )

    def arrays(self):
        """(child, mask, value, normal) tuple for kernel calls."""
        return self.child, self.mask, self.value, self.normal

    def packed_table(self):
        """Device-cached traversal word table (ops/traverse.make_packed_table).

        The packed word folds each node's 2-bit type tag into its own slot
        via 8 scatters over the full table — O(N) work that must happen once
        per *scene*, not once per frame.  Pass the result to render/intersect calls as
        ``packed=``; invalidated by edits (core/sdf.py returns new tables).
        """
        if getattr(self, "_packed", None) is None:
            from ..ops.traverse import make_packed_table

            self._packed = make_packed_table(self.arrays())
        return self._packed


def empty(capacity: int, world_size: int) -> Octree:
    """A one-node octree: interior root with no children (value 1), matching
    the reference's dummy head (Octree.java:97-100)."""
    oct = Octree(
        child=np.zeros(capacity, np.int32),
        mask=np.zeros(capacity, np.int32),
        value=np.zeros(capacity, np.int32),
        normal=np.zeros(capacity, np.int32),
        n_nodes=1,
        world_size=world_size,
    )
    oct.value[ROOT] = 1
    return oct


def effective_normal_raw(tag, child_base, mask, normal):
    """Raw 16-bit field the shader decodes as a normal for a hit node.

    Mirrors the extract* functions (svotrace.comp:88-130): surface leaves carry
    a real packed normal; branches and subdividable leaves expose their
    leaf-mask bytes (zero for fresh subdividable leaves, the stale child mask
    for branches / promoted leaves); non-surface leaves expose zero.  Works
    elementwise on arrays.
    """
    import numpy as xp

    tag = xp.asarray(tag)
    return xp.where(
        tag == C.TAG_SURFACE_LEAF, normal,
        xp.where(tag == C.TAG_NON_SURFACE_LEAF, 0, mask),
    )
