"""svo_raytracer_tpu — a differentiable sparse-voxel-octree pathtracer in JAX,
running on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework capability-matched to the reference
Java/LWJGL ESVO renderer (dyoo47/svo-raytracer). See SURVEY.md for the layer map
this package follows:

  utils/     — config, math helpers, camera, profiling           (L4 helpers)
  core/      — octree node table, builders, .svo codec, SDF edits (L3 scene core)
  ops/       — traversal/shading/noise kernels (XLA + Pallas/Triton) (L2 device kernels)
  models/    — procedural & heightmap worlds, canned scenes       (scene "models")
  parallel/  — device meshes, ray-tile sharding, collectives      (multi-device)
  diff/      — differentiable rendering, custom VJPs              (gradients)
  apps/      — frame-loop app skeleton, viewer, worldgen CLIs     (L4 application)
  io/        — image/png IO, checkpointing                        (assets)
"""

__version__ = "0.1.0"
