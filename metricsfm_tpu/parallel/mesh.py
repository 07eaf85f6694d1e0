"""Mesh construction + problem sharding helpers."""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D data mesh over the first n_data devices (default: all).

    One axis is enough: the cards of a host are joined all to all (NVLink),
    so the mesh follows the algorithm's data axis, not a topology."""
    devs = jax.devices()
    n = n_data or len(devs)
    return Mesh(np.array(devs[:n]), (axis_name,))


# -- multi-host runtime (SURVEY §5 distributed communication backend;
#    no reference counterpart — the reference is single-process) ----------

def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Bring up the jax.distributed runtime for a multi-process run.

    Safe to call in every entry path: a single-process run (no coordinator
    configured via args or JAX_COORDINATOR_ADDRESS / standard cluster env)
    is a no-op.  Returns the process index (0 when single-process).
    The jit-compiled psum/all_gather in parallel/* are unchanged; only the
    mesh grows to jax.devices() spanning all processes.  Without a cluster
    environment, pass coordinator_address (e.g. "localhost:<port>"),
    num_processes and process_id explicitly.
    """
    import os
    if jax.process_count() > 1:
        return jax.process_index()          # already initialized
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and num_processes is None \
            and "JAX_NUM_PROCESSES" not in os.environ:
        return 0                            # single-process run
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_index()


def make_global_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over ALL devices of ALL processes (multi-host when
    initialize_distributed brought up >1 process; identical to make_mesh
    on one host)."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def owned_range(n_items: int, process_id: Optional[int] = None,
                process_count: Optional[int] = None):
    """Contiguous [lo, hi) shard of an item axis owned by this process.

    The host-sharded store policy: each process extracts / matches / pages
    only its image range (the reference's per-image files map naturally to
    per-host shards — SURVEY §5); resume stays per shard.
    """
    p = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    per = -(-n_items // n)
    lo = min(p * per, n_items)
    return lo, min(lo + per, n_items)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    value=0):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


def shard_tracks(problem, mesh: Mesh, axis_name: str = "data"):
    """Shard a BAProblem's track-indexed arrays over the mesh data axis.

    Camera-indexed arrays are replicated.  Track count must be padded to a
    multiple of the axis size (bucketed shapes already are, since buckets
    are powers of two).
    """
    n = mesh.shape[axis_name]
    assert problem.n_points % n == 0, \
        f"track count {problem.n_points} not divisible by mesh axis {n}"
    track_sharded = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def place(x, sharded):
        return jax.device_put(x, track_sharded if sharded else repl)

    return problem._replace(
        poses=place(problem.poses, False),
        intrs=place(problem.intrs, False),
        cam_model=place(problem.cam_model, False),
        points=place(problem.points, True),
        track_cam=place(problem.track_cam, True),
        track_uv=place(problem.track_uv, True),
        track_mask=place(problem.track_mask, True),
        track_weight=place(problem.track_weight, True),
        pose_mut=place(problem.pose_mut, False),
        intr_mut=place(problem.intr_mut, False),
        point_mut=place(problem.point_mut, True),
        gps_pos=place(problem.gps_pos, False),
        gps_weight=place(problem.gps_weight, False),
        pose_prior=place(problem.pose_prior, False),
        pose_prior_weight=place(problem.pose_prior_weight, False),
        gps_triple=place(problem.gps_triple, False),
        gps_triple_weight=place(problem.gps_triple_weight, False),
    )
