"""MetricSfM-TPU: a structure-from-motion framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
MetricSfM suite (C++/Ceres/CUDA): sparse incremental SfM for web/aerial/street
imagery, GPS-aided SLAM refinement, dense stereo, and interop exports — built
around fixed-shape masked batch arrays, vmap/shard_map data parallelism over a
device mesh, and a native Schur-complement Levenberg-Marquardt bundle adjuster
replacing Ceres.

Package layout:
  ops/       pure-function compute kernels (geometry, solvers, matching, SIFT, SGM)
  ba/        bundle adjustment: residuals, Schur-LM solver, distributed assembly
  models/    scene data model + pipeline drivers (incremental SfM, SLAM-GPS, dense)
  parallel/  mesh/sharding helpers and multi-chip execution paths
  io/        feature/match/track stores, checkpoint-resume, interop exports
  utils/     EXIF, UTM, misc host-side helpers
"""

import jax as _jax

# Geometry and BA math requires true f32 matmuls.  On an NVIDIA GPU an f32
# product otherwise runs in TF32, which keeps ~3 decimal digits and breaks
# rotation algebra and the normal equations.  Kernels that *want* bf16
# (descriptor matching) opt in by casting their operands to bfloat16 and
# asking for DEFAULT precision explicitly — this setting does not upcast
# bf16 inputs.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

