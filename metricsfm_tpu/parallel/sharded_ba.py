"""Distributed Schur-complement LM over a device mesh.

The north-star component (SURVEY.md §2.11, §7 hard part #1): replaces the
reference's single-threaded Ceres DENSE_SCHUR (optimizer.cc:47) with a
track-sharded bundle adjuster:

* Tracks (points + their observations) are sharded over the mesh `data`
  axis; cameras are replicated.  Every term of the reduced camera system
  (S, rhs) is a sum over tracks, so each shard computes an additive partial
  and one `lax.psum` over ICI completes the normal equations.
* Point elimination (batched 3x3 inverses) and back-substitution stay
  entirely local to each shard — zero communication.
* The dense reduced solve is replicated per chip (cheap for thousands of
  camera dofs; the psum'd system is already resident everywhere).

Communication per LM iteration: one psum of (D^2 + D) floats + one scalar
psum for the cost — independent of the number of observations.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ba.lm import (LMConfig, _assemble_and_solve_cg, backsub_points,
                     gps_residuals, gps_triple_residuals,
                     partial_camera_system, pose_prior_residuals,
                     robust_cost, solve_reduced,
                     compute_residuals)
from ..ba.problem import BAProblem


def _local_cost(problem: BAProblem, huber_delta, axis_name):
    r = compute_residuals(problem)
    c = robust_cost(r, problem.track_mask, huber_delta)
    c = jax.lax.psum(c, axis_name)
    # camera-indexed terms are replicated: add once, after the psum
    rg = gps_residuals(problem)
    rp = pose_prior_residuals(problem)
    rt = gps_triple_residuals(problem)
    return (c + 0.5 * jnp.sum(rg * rg) + 0.5 * jnp.sum(rp * rp)
            + 0.5 * jnp.sum(rt * rt))


def _make_step(cfg: LMConfig, axis_name: str):
    def step(problem: BAProblem, lam, tol_rel=None):
        """One LM candidate step on the local shard (collectives inside).

        cfg.cg_iterations > 0 selects the matrix-free block-Jacobi PCG
        camera solve — the path that scales to 1k+ cameras (the dense
        partial materializes an O(P_shard*C) one-hot factor and a full
        (D, D) S per device).  Its communication is one (D,) psum per CG
        iteration instead of one (D, D) psum per LM iteration.
        `tol_rel` (traced scalar) overrides the CG relative tolerance —
        the forcing-sequence hook; every shard sees the same value, so
        the early-exit condition stays collective-consistent.
        """
        C, M = problem.n_cameras, problem.n_models
        if cfg.cg_iterations > 0:
            d_pose, d_intr, d_pt = _assemble_and_solve_cg(
                problem, lam, cfg, axis_name=axis_name, tol_rel=tol_rel)
        else:
            S_part, rhs_part, aux = partial_camera_system(problem, lam, cfg)
            S = jax.lax.psum(S_part, axis_name)
            rhs = jax.lax.psum(rhs_part, axis_name)
            d_cam = solve_reduced(S, rhs, problem, lam, cfg)
            d_pt = backsub_points(aux, d_cam, problem)
            d_pose = (d_cam[:6 * C].reshape(C, 6)
                      * problem.pose_mut[:, None])
            d_intr = (d_cam[6 * C:].reshape(M, 3)
                      * problem.intr_mut[:, None])
        return problem._replace(
            poses=problem.poses + d_pose,
            intrs=problem.intrs + d_intr,
            points=problem.points + d_pt)
    return step


def make_sharded_lm(mesh: Mesh, cfg: LMConfig = LMConfig(),
                    axis_name: str = "data"):
    """Build the HOST-CHUNKED sharded LM solver for a given mesh.

    Returns solve(problem) -> (problem, info); `problem`'s track arrays must
    be sharded over `axis_name` (see parallel.mesh.shard_tracks).

    Like ba.lm.solve_lm, each XLA execution runs at most cfg.host_chunk LM
    iterations and the host carries (lam, eta, cost) across chunks.
    """
    step = _make_step(cfg, axis_name)

    forcing = cfg.cg_forcing and cfg.cg_iterations > 0

    def lm_chunk(problem: BAProblem, lam0, eta0, cost_in, n_its):
        """Up to n_its LM iterations from carried (lam, eta, cost).
        cost_in < 0 signals a fresh solve: evaluate the initial cost here
        (one residual pass on the first chunk only)."""
        fresh = cost_in < 0
        cost0 = jax.lax.cond(
            fresh,
            lambda: _local_cost(problem, cfg.huber_delta, axis_name),
            lambda: cost_in)

        def cond(state):
            it, _, _, _, done, _ = state
            return (it < n_its) & (~done)

        def body(state):
            it, prob, lam, cost, done, eta = state
            cand = step(prob, lam, tol_rel=eta if forcing else None)
            new_cost = _local_cost(cand, cfg.huber_delta, axis_name)
            accept = (new_cost < cost) & jnp.isfinite(new_cost)
            prob = jax.tree.map(lambda a, b: jnp.where(accept, b, a), prob, cand)
            lam = jnp.where(accept,
                            jnp.maximum(lam / cfg.lambda_down, cfg.min_lambda),
                            jnp.minimum(lam * cfg.lambda_up, cfg.max_lambda))
            eta = jnp.where(accept,
                            jnp.maximum(eta ** 1.5, cfg.cg_tol), eta)
            rel = jnp.abs(cost - new_cost) / jnp.maximum(cost, 1e-20)
            done = accept & (rel < cfg.rtol)
            cost = jnp.where(accept, new_cost, cost)
            return it + 1, prob, lam, cost, done, eta

        it, prob, lam, cost, done, eta = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), problem, lam0, cost0, jnp.bool_(False), eta0))
        info = {"initial_cost": cost0, "final_cost": cost,
                "iterations": it, "lambda": lam, "converged": done}
        return prob, info, (lam, eta, cost)

    track = P(axis_name)
    repl = P()
    in_spec = BAProblem(
        poses=repl, intrs=repl, cam_model=repl, points=track,
        track_cam=track, track_uv=track, track_mask=track,
        track_weight=track, pose_mut=repl, intr_mut=repl, point_mut=track,
        gps_pos=repl, gps_weight=repl, pose_prior=repl,
        pose_prior_weight=repl, gps_triple=repl, gps_triple_weight=repl)
    info_spec = {"initial_cost": repl, "final_cost": repl,
                 "iterations": repl, "lambda": repl, "converged": repl}
    carry_spec = (repl, repl, repl)

    chunk_fn = jax.jit(jax.shard_map(
        lm_chunk, mesh=mesh,
        in_specs=(in_spec, repl, repl, repl, repl),
        out_specs=(in_spec, info_spec, carry_spec)))

    def solve(problem: BAProblem):
        dtype = problem.points.dtype
        lam = jnp.asarray(cfg.init_lambda, dtype)
        eta = jnp.asarray(cfg.cg_eta0 if forcing else cfg.cg_tol, dtype)
        cost = jnp.asarray(-1.0, dtype)          # fresh-solve sentinel
        chunk = max(1, min(cfg.host_chunk, max(cfg.max_iterations, 1)))
        total_it = 0
        initial_cost = None
        if cfg.max_iterations <= 0:
            problem, info, _ = chunk_fn(problem, lam, eta, cost,
                                        jnp.int32(0))
            info = dict(info)
            info["iterations"] = jnp.asarray(0)
            return problem, info
        while total_it < cfg.max_iterations:
            n = min(chunk, cfg.max_iterations - total_it)
            problem, info, carry = chunk_fn(problem, lam, eta, cost,
                                            jnp.int32(n))
            lam, eta, cost = carry
            total_it += int(info["iterations"])
            if initial_cost is None:
                initial_cost = info["initial_cost"]
            if bool(info["converged"]) or int(info["iterations"]) < n:
                break
        info = dict(info)
        info["iterations"] = jnp.asarray(total_it)
        info["initial_cost"] = initial_cost
        return problem, info

    return solve


def solve_lm_sharded(problem: BAProblem, mesh: Mesh,
                     cfg: LMConfig = LMConfig(), axis_name: str = "data"):
    """Convenience wrapper: shard tracks, run, return gathered problem."""
    from .mesh import shard_tracks
    sharded = shard_tracks(problem, mesh, axis_name)
    solver = make_sharded_lm(mesh, cfg, axis_name)
    out, info = solver(sharded)
    return out, info
