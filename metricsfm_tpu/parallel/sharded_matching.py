"""Data-parallel pairwise matching over the device mesh.

The reference parallelizes candidate-pair matching with OpenMP threads
(fine_matching_graph.cc:87); here batches of image pairs shard over the
mesh `data` axis — each device matches its pairs with the brute-force
kernel, no communication.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import matching


def make_sharded_matcher(mesh: Mesh, ratio_good: float = 0.6,
                         ratio_all: float = 0.85, chunk: int = 2048,
                         axis_name: str = "data"):
    """Jitted matcher for (B, N, D) descriptor pair batches sharded on B."""

    def match_shard(d1, d2, m1, m2):
        fn = lambda a, b, x, y: matching.match_pair(
            a, b, x, y, ratio_good, ratio_all, chunk=chunk)
        return jax.vmap(fn)(d1, d2, m1, m2)

    spec = P(axis_name)
    out_spec = {"idx2": spec, "good": spec, "all": spec, "dist_sq": spec}
    fn = jax.shard_map(match_shard, mesh=mesh,
                       in_specs=(spec, spec, spec, spec),
                       out_specs=out_spec)
    return jax.jit(fn)


def match_pairs_sharded(desc1, desc2, mask1, mask2, mesh: Mesh, **kw):
    """Shard (B, N, D) pair batches over the mesh and match them."""
    sharding = NamedSharding(mesh, P("data"))
    d1 = jax.device_put(desc1, sharding)
    d2 = jax.device_put(desc2, sharding)
    m1 = jax.device_put(mask1, sharding)
    m2 = jax.device_put(mask2, sharding)
    matcher = make_sharded_matcher(mesh, **kw)
    return matcher(d1, d2, m1, m2)
