"""Gauss-Newton pose-graph solver with Schur landmark elimination.

Solver design (BASELINE configs[3]):

  * per-edge residuals r = log(Z⁻¹ ∘ (Tᵢ⁻¹ ∘ Tⱼ)) and their Jacobians come
    from vmapped forward-mode autodiff of the retraction-parameterized
    residual — no hand-derived Jacobians to get wrong;
  * the normal equations are assembled DENSE: (6K, 6K) for K keyframes.
    Sparse factorization is a CPU idiom; at SLAM scale (K ≤ a few
    thousand) one dense blocked Cholesky beats pointer-chasing
    sparsity, and scatter-adding (12, 12) edge blocks into a dense H is a
    single XLA scatter;
  * landmarks are eliminated by Schur complement: All is block-diagonal
    (3, 3) (closed-form inverse), the reduced system
    S = App − Apl·All⁻¹·Alp couples only poses, and landmarks
    back-substitute in one batched solve;
  * every product runs at HIGHEST float32 precision: edge information
    reaches 1e6 (GraphConfig.odom_edge_info), so the system is badly
    conditioned and a reduced-precision product would move the solution;
  * gauge freedom is fixed by a strong prior on keyframe 0, and padding
    rows are regularized by damping, so one static-shape program serves
    any graph size up to capacity.

The distributed variant shards edges across devices and psum-reduces
H and b — see veloslam_tpu.parallel.sharded.solve_graph_step_sharded.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from veloslam_tpu.core import se3
from veloslam_tpu.graph.posegraph import GraphArrays

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class SolveStats(NamedTuple):
    initial_cost: jax.Array
    final_cost: jax.Array
    iterations: jax.Array


def _edge_residual(qi, ti, qj, tj, mq, mt, di, dj):
    """Residual of one pose-pose edge at retraction deltas (di, dj)."""
    Pi = se3.retract(se3.Pose(qi, ti), di)
    Pj = se3.retract(se3.Pose(qj, tj), dj)
    pred = se3.compose(se3.inverse(Pi), Pj)
    meas = se3.Pose(mq, mt)
    return se3.log(se3.compose(se3.inverse(meas), pred))


def _edge_r_and_J(qi, ti, qj, tj, mq, mt):
    """(r (6,), J (6, 12)) at zero delta, via forward-mode autodiff."""
    def f(d):
        return _edge_residual(qi, ti, qj, tj, mq, mt, d[:6], d[6:])
    zero = jnp.zeros(12, ti.dtype)
    return f(zero), jax.jacfwd(f)(zero)


def _obs_residual(qi, ti, lpos, z, di, dl):
    """Landmark observation: landmark position in keyframe i's frame."""
    Pi = se3.retract(se3.Pose(qi, ti), di)
    return se3.apply(se3.inverse(Pi), lpos + dl) - z


def _obs_r_and_J(qi, ti, lpos, z):
    """(r (3,), Jp (3, 6), Jl (3, 3)) at zero deltas."""
    def f(d):
        return _obs_residual(qi, ti, lpos, z, d[:6], d[6:9])
    zero = jnp.zeros(9, ti.dtype)
    r = f(zero)
    J = jax.jacfwd(f)(zero)
    return r, J[:, :6], J[:, 6:9]


def _assemble_pose_system(g: GraphArrays, max_poses: int):
    """Dense H (6K, 6K), b (6K,) from pose-pose edges + cost."""
    K = max_poses
    r, J = jax.vmap(_edge_r_and_J)(g.q[g.e_i], g.t[g.e_i], g.q[g.e_j],
                                   g.t[g.e_j], g.e_q, g.e_t)
    w = g.e_valid.astype(r.dtype)[:, None] * g.e_info        # (E, 6)
    Jw = J * w[:, :, None]                                    # (E, 6, 12)
    blocks = _einsum("eri,erj->eij", Jw, J)                   # (E, 12, 12)
    bvec = _einsum("eri,er->ei", Jw, r)                       # (E, 12)
    cost = jnp.sum(w * r * r)

    rows = jnp.concatenate([g.e_i[:, None] * 6 + jnp.arange(6),
                            g.e_j[:, None] * 6 + jnp.arange(6)], axis=1)
    H = jnp.zeros((6 * K, 6 * K), r.dtype)
    H = H.at[rows[:, :, None], rows[:, None, :]].add(blocks)
    b = jnp.zeros(6 * K, r.dtype).at[rows].add(bvec)
    return H, b, cost


def _assemble_landmark_terms(g: GraphArrays, max_poses: int,
                             max_landmarks: int,
                             obs_huber_delta: float = 0.5):
    """Landmark-coupled terms: App-add, b_p-add, All (M,3,3), b_l (M,3),
    and per-observation blocks for the Schur product.

    Observations get a Huber influence weight (delta in meters on the
    3-D residual norm): post-center detections from subsampled scans are
    ~0.3 m noisy and occasional cross-associations reach a meter —
    unbounded quadratic influence let 137 sloppy observations drag a
    closure-corrected trajectory from 0.11 m ATE to 0.23 m (measured on
    the bench loop drive)."""
    K, M = max_poses, max_landmarks
    r, Jp, Jl = jax.vmap(_obs_r_and_J)(g.q[g.o_i], g.t[g.o_i],
                                       g.l_pos[g.o_l], g.o_z)
    rn = jnp.linalg.norm(r, axis=-1)
    hub = jnp.where(rn <= obs_huber_delta, 1.0,
                    obs_huber_delta / jnp.maximum(rn, 1e-9))  # (O,)
    w = (g.o_valid.astype(r.dtype)[:, None] * g.o_info
         * hub[:, None])                                      # (O, 3)
    Jpw = Jp * w[:, :, None]
    Jlw = Jl * w[:, :, None]
    cost = jnp.sum(w * r * r)

    rows_p = g.o_i[:, None] * 6 + jnp.arange(6)               # (O, 6)
    app = _einsum("ori,orj->oij", Jpw, Jp)                    # (O, 6, 6)
    H_pp = jnp.zeros((6 * K, 6 * K), r.dtype)
    H_pp = H_pp.at[rows_p[:, :, None], rows_p[:, None, :]].add(app)
    b_p = jnp.zeros(6 * K, r.dtype).at[rows_p].add(
        _einsum("ori,or->oi", Jpw, r))

    all_blocks = _einsum("ori,orj->oij", Jlw, Jl)             # (O, 3, 3)
    All = jax.ops.segment_sum(all_blocks, g.o_l, num_segments=M)
    b_l = jax.ops.segment_sum(_einsum("ori,or->oi", Jlw, r), g.o_l,
                              num_segments=M)
    Apl = _einsum("ori,orj->oij", Jpw, Jl)                    # (O, 6, 3)
    # Per-landmark pose-coupling tensor T_l = Σ_o [rows_o ⊗ Apl_o]
    # (M, 3, 6K): built here so distributed callers can psum per-shard
    # partials — every returned term is a SUM over observations.
    T = jnp.zeros((M, 3, 6 * K), Apl.dtype)
    T = T.at[g.o_l[:, None, None],
             jnp.arange(3)[None, :, None],
             rows_p[:, None, :]].add(jnp.swapaxes(Apl, 1, 2))
    return H_pp, b_p, All, b_l, T, cost


def _schur_step(g_cur: GraphArrays, H_ee, b_ee, H_po, b_po, All, b_l, T,
                max_poses: int, max_landmarks: int, damping: float,
                prior_weight: float):
    """One replicated Gauss-Newton step from assembled (possibly
    psum-reduced) terms: Schur-eliminate landmarks, solve poses, back-
    substitute.  Returns the updated GraphArrays."""
    K, M = max_poses, max_landmarks
    App = H_ee + H_po
    diag = jnp.arange(6 * K)
    App = App.at[diag, diag].add(damping)
    App = App.at[jnp.arange(6), jnp.arange(6)].add(prior_weight)
    b_p = b_ee + b_po

    land_mask = jnp.arange(M) < g_cur.n_landmarks
    All = All + (damping + 1e-3) * jnp.eye(3)[None]
    All_inv = jnp.linalg.inv(All)                          # batched 3x3
    All_inv = jnp.where(land_mask[:, None, None], All_inv, 0.0)

    U = _einsum("lab,lbk->lak", All_inv, T)                # (M, 3, 6K)
    S = App - _einsum("lak,lam->km", T, U)
    b_red = b_p - _einsum("lak,la->k", T,
                          _einsum("lab,lb->la", All_inv, b_l))

    delta_p = -jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S), b_red)
    Alp_dp = _einsum("lak,k->la", T, delta_p)
    delta_l = -_einsum("lab,lb->la", All_inv, b_l + Alp_dp)

    delta_p = delta_p.reshape(K, 6)
    pose_mask = (jnp.arange(K) < g_cur.n_poses)[:, None]
    delta_p = jnp.where(pose_mask, delta_p, 0.0)
    delta_l = jnp.where(land_mask[:, None], delta_l, 0.0)
    new = se3.retract(se3.Pose(g_cur.q, g_cur.t), delta_p)
    return g_cur._replace(q=new.q, t=new.t, l_pos=g_cur.l_pos + delta_l)


@functools.partial(jax.jit, static_argnames=("max_poses", "iterations",
                                             "prior_weight", "damping"))
def solve(g: GraphArrays, *, max_poses: int, iterations: int = 8,
          prior_weight: float = 1e6, damping: float = 1e-4
          ) -> Tuple[GraphArrays, SolveStats]:
    """Pose-only Gauss-Newton (odometry + loop-closure edges)."""
    K = max_poses

    def body(it, state):
        g_cur, costs = state
        H, b, cost = _assemble_pose_system(g_cur, K)
        diag = jnp.arange(6 * K)
        H = H.at[diag, diag].add(damping)
        H = H.at[jnp.arange(6), jnp.arange(6)].add(prior_weight)  # gauge
        delta = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(H), b)
        delta = delta.reshape(K, 6)
        pose_mask = (jnp.arange(K) < g_cur.n_poses)[:, None]
        delta = jnp.where(pose_mask, delta, 0.0)
        new = se3.retract(se3.Pose(g_cur.q, g_cur.t), delta)
        g_new = g_cur._replace(q=new.q, t=new.t)
        return g_new, (jnp.where(it == 0, cost, costs[0]), cost)

    g_out, (c0, c1) = jax.lax.fori_loop(
        0, iterations, body, (g, (jnp.asarray(jnp.inf, jnp.float32),
                                  jnp.asarray(jnp.inf, jnp.float32))))
    return g_out, SolveStats(initial_cost=c0, final_cost=c1,
                             iterations=jnp.asarray(iterations, jnp.int32))


@functools.partial(jax.jit, static_argnames=("max_poses", "max_landmarks",
                                             "iterations", "prior_weight",
                                             "damping"))
def solve_with_landmarks(g: GraphArrays, *, max_poses: int,
                         max_landmarks: int, iterations: int = 8,
                         prior_weight: float = 1e6, damping: float = 1e-4
                         ) -> Tuple[GraphArrays, SolveStats]:
    """Full bundle-style solve: pose-pose edges + pose-landmark
    observations, landmarks eliminated via Schur complement."""
    K, M = max_poses, max_landmarks

    def body(it, state):
        g_cur, costs = state
        H_ee, b_ee, cost_e = _assemble_pose_system(g_cur, K)
        H_po, b_po, All, b_l, T, cost_o = \
            _assemble_landmark_terms(g_cur, K, M)
        cost = cost_e + cost_o
        g_new = _schur_step(g_cur, H_ee, b_ee, H_po, b_po, All, b_l, T,
                            K, M, damping, prior_weight)
        return g_new, (jnp.where(it == 0, cost, costs[0]), cost)

    g_out, (c0, c1) = jax.lax.fori_loop(
        0, iterations, body, (g, (jnp.asarray(jnp.inf, jnp.float32),
                                  jnp.asarray(jnp.inf, jnp.float32))))
    return g_out, SolveStats(initial_cost=c0, final_cost=c1,
                             iterations=jnp.asarray(iterations, jnp.int32))
