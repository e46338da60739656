"""Multi-host initialization and meshes.

The reference has no distributed anything (SURVEY.md §2.2); the story here
is ``jax.distributed`` + a host-spanning mesh.  With several hosts each
process calls :func:`init_distributed` once, builds the global ``tiles``
mesh, and the tile-sharded render/train fns in ``render_sharded.py`` work
unchanged (they address devices through the mesh).  Octree replication
happens at ``to_device`` time via the mesh's replicated sharding; XLA hands
the gradient psum to the collective library (NCCL on GPUs).

Single-host/virtual-device runs skip init entirely — tile_mesh over local
devices — which is what the CI tests and the driver's dry run exercise.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (idempotent).  With no args, relies on the
    cluster environment's auto-detection; where none exists (a single
    multi-GPU host), pass ``coordinator_address`` (``localhost:<port>``),
    ``num_processes`` and ``process_id``."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def global_tile_mesh() -> Mesh:
    """1-D ``tiles`` mesh over every device in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), axis_names=("tiles",))


def host_local_rows(height: int, mesh: Mesh) -> tuple[int, int]:
    """The row window this host's devices own under row sharding — used to
    feed per-host targets without materializing the global image anywhere."""
    n = mesh.shape["tiles"]
    assert height % n == 0
    rows = height // n
    local_ids = [d.id for d in jax.local_devices()]
    lo = min(local_ids) * rows
    hi = (max(local_ids) + 1) * rows
    return lo, hi
