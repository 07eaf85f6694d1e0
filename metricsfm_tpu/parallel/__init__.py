"""Device-mesh sharding: data-parallel matching/extraction, distributed BA.

No counterpart exists in the single-node reference (SURVEY.md §2.11 — its
parallelism is OpenMP loops and CUDA kernels); these are the device
scaling axes: images/pairs/tracks sharded over a `jax.sharding.Mesh` with
XLA collectives (NCCL between the cards of a host).
"""
from .mesh import make_mesh, shard_tracks  # noqa: F401
from .sharded_ba import solve_lm_sharded  # noqa: F401
