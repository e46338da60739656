"""Test harness configuration.

Tests run on CPU by default, with a virtual 8-device mesh so the sharded
paths (tile-sharded rendering, gradient all-reduce) run without several
GPUs, and Pallas kernels run interpreted.  ``JAX_PLATFORMS``, when set,
is honoured: ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` runs
the card-only tests (marker ``gpu``) on the GPU.  Flags are set before
JAX initializes.
"""

import os
import sys

# XLA_FLAGS is read lazily at CPU-backend init, so setting it here works even
# if jax was imported earlier in the process.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from svo_raytracer_tpu.core import build_np  # noqa: E402


def make_sphere_voxels(size: int = 32, radius: int | None = None,
                       center=None, value: int = 1) -> np.ndarray:
    """Dense voxel ball, the analog of chunkgen.comp's sampleSphere (:8-16)."""
    if radius is None:
        radius = size // 4
    if center is None:
        center = (size // 2,) * 3
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    dist = np.round(np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                            + (z - center[2]) ** 2) - radius)
    return np.where(dist <= 0, value, 0).astype(np.uint8)


def make_terrain_voxels(size: int = 32, seed: int = 0) -> np.ndarray:
    """Low-frequency pseudo-terrain with several materials — inhomogeneous
    cells, exposed/interior regions, multiple node types."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.2, 0.8, (4, 4))
    hx = np.linspace(0, 3, size)
    h = coarse[np.clip(hx.astype(int), 0, 3)[:, None],
               np.clip(hx.astype(int), 0, 3)[None, :]]
    heights = (h * size).astype(int)
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    solid = y <= heights[x, z]
    near_surface = y >= heights[x, z] - 3
    mat = np.where(near_surface, 3, 1)
    return np.where(solid, mat, 0).astype(np.uint8)


@pytest.fixture
def sphere_voxels():
    return make_sphere_voxels(32)


@pytest.fixture
def terrain_voxels():
    return make_terrain_voxels(32)


@pytest.fixture
def sphere_tree(sphere_voxels):
    return build_np.build_octree_np(sphere_voxels)


@pytest.fixture
def terrain_tree(terrain_voxels):
    return build_np.build_octree_np(terrain_voxels)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need the card: decided here, at run time, so
    every xdist worker collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free XLA/tracing caches between test modules: every compiled
    executable stays alive for the life of the process, so a worker that
    runs many distinct-shape compiles would otherwise grow without bound
    (caches are per-module anyway: fixtures rebuild scenes)."""
    yield
    import jax

    jax.clear_caches()
