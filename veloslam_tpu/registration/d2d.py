"""Distribution-to-distribution (D2D) registration — VGICP-style
Gaussian-to-Gaussian alignment.

Point-to-plane GICP (registration.gicp) has a self-consistency floor of a
few cm on corner/edge voxels: a voxel containing two wall faces gets one
averaged "plane" whose normal represents neither face, and points matched
to it pull the solution sideways.  D2D removes that floor by matching
voxel GAUSSIANS instead of points-to-planes: the residual is
T·μ_s − μ_t with anisotropic weight W = (Σ_t + R Σ_s Rᵀ + εI)⁻¹
(Segal's GICP cost over voxel distributions; Stoyanov's D2D-NDT).  A
corner voxel's fat covariance simply weights both directions — no wrong
normal to fight.

Shape: the cost runs over source VOXELS (≈2-8k rows), not points
(≈100k) — an order of magnitude less gather traffic per GN iteration
than point-based costs, with all 3×3 algebra batched closed-form
(adjugate inverse, registration.voxel.regularized_inverse) and the 6×6
normal equations reduced with one einsum.  No eigendecompositions, no
data-dependent shapes, one fori_loop.

The reference implements no registration at all (README.md:25-26);
BASELINE.json configs[1]/[2] demand scan-to-scan and scan-to-map — D2D
serves both (source grid vs target grid; target may be a map ROI).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from veloslam_tpu.core import se3
from veloslam_tpu.registration import voxel as vx

HIGHEST = jax.lax.Precision.HIGHEST


class D2dResult(NamedTuple):
    pose: se3.Pose
    n_matched: jax.Array     # () int32 — source voxels matched (last iter)
    mean_error: jax.Array    # () float32 — mean Mahalanobis residual
    iterations: jax.Array


# Structure-aware target gate (shared with NDT; see the rationale there).
usable_mask = vx.structure_usable


def _skew(v):
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([zero, -v[..., 2], v[..., 1]], -1),
        jnp.stack([v[..., 2], zero, -v[..., 0]], -1),
        jnp.stack([-v[..., 1], v[..., 0], zero], -1)], -2)


def d2d_normal_equations(src: vx.VoxelGrid, pose: se3.Pose,
                         target: vx.VoxelGrid, usable: jax.Array, *,
                         eps: float = 1e-3, max_dist: float = 2.0,
                         min_points: float = 3.0,
                         src_cov: jax.Array = None,
                         tgt_cov: jax.Array = None):
    """One linearization of the D2D cost: (H (6,6), b (6,), err, n_matched).

    Residual per source voxel: r = T·μ_s − μ_t, weight
    W = (Σ'_t + R Σ'_s Rᵀ + εI)⁻¹ over scale-NORMALIZED covariances
    (vx.normalized_cov — raw covariances let the coherent in-plane
    sampling bias of a moving LiDAR drag the solve backward ~one frame);
    left-perturbation Jacobian J = [−[T·μ_s]×  I] (3, 6).
    H = Σ JᵀWJ, b = Σ JᵀWr.

    Pass precomputed `src_cov`/`tgt_cov` (full tables) to hoist the
    normalization out of the GN loop.
    """
    R = se3.quat_to_matrix(pose.q)                       # (3, 3)
    mu_s = se3.apply(pose, src.mean)                     # (V, 3)
    src_ok = src.occupied & (src.count >= min_points)
    if src_cov is None:
        src_cov = vx.normalized_cov(src.cov)
    if tgt_cov is None:
        tgt_cov = vx.normalized_cov(target.cov)

    idx = vx.lookup_nearest(target, mu_s, src_ok, usable)
    hit = idx >= 0
    safe = jnp.maximum(idx, 0)
    mu_t = target.mean[safe]                             # (V, 3)
    cov_t = tgt_cov[safe]                                # (V, 3, 3)

    r = mu_s - mu_t                                      # (V, 3)
    hit &= jnp.sum(r * r, -1) < max_dist * max_dist

    cov_s_rot = jnp.einsum("ij,vjk,lk->vil", R, src_cov, R,
                           precision=HIGHEST)
    W = vx.regularized_inverse(cov_t + cov_s_rot, eps=eps)  # (V, 3, 3)
    w = jnp.where(hit, src.count, 0.0)                   # count-weighted
    W = W * w[:, None, None]

    J = jnp.concatenate([-_skew(mu_s), jnp.broadcast_to(
        jnp.eye(3, dtype=mu_s.dtype), (*mu_s.shape, 3))], -1)  # (V, 3, 6)
    WJ = jnp.einsum("vij,vjk->vik", W, J, precision=HIGHEST)  # (V, 3, 6)
    H = jnp.einsum("vji,vjk->ik", J, WJ, precision=HIGHEST)   # (6, 6)
    b = jnp.einsum("vji,vjk,vk->i", J, W, r, precision=HIGHEST)  # (6,)
    maha = jnp.einsum("vi,vij,vj->v", r, W, r, precision=HIGHEST)
    err = jnp.sum(maha) / jnp.maximum(jnp.sum(w), 1.0)
    return H, b, err, hit.sum().astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("iterations",))
def register_d2d(src: vx.VoxelGrid, target: vx.VoxelGrid,
                 usable: jax.Array, init_pose: se3.Pose, *,
                 iterations: int = 16, damping: float = 1e-6,
                 eps: float = 1e-3, max_dist: float = 2.0) -> D2dResult:
    """Gauss-Newton D2D registration of a source voxel grid onto a target
    grid.  `usable` gates target voxels (e.g. count >= min_points from
    gicp.plane_grid_from(...).usable, or simply target.occupied)."""
    src_cov = vx.normalized_cov(src.cov)      # hoisted out of the GN loop
    tgt_cov = vx.normalized_cov(target.cov)

    def body(_, state):
        pose, _, _ = state
        H, b, err, n_hit = d2d_normal_equations(
            src, pose, target, usable, eps=eps, max_dist=max_dist,
            src_cov=src_cov, tgt_cov=tgt_cov)
        Hd = H + (damping + 1e-6 * jnp.trace(H)) * jnp.eye(6, dtype=H.dtype)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hd), b)
        ok = jnp.all(jnp.isfinite(delta)) & (n_hit > 10)
        delta = jnp.where(ok, delta, 0.0)
        tn = jnp.linalg.norm(delta[3:])
        rn = jnp.linalg.norm(delta[:3])
        scale = jnp.minimum(1.0, jnp.minimum(
            1.0 / jnp.maximum(tn, 1e-12), 0.3 / jnp.maximum(rn, 1e-12)))
        return se3.retract(pose, delta * scale), err, n_hit

    pose, err, n_hit = jax.lax.fori_loop(
        0, iterations, body,
        (init_pose, jnp.asarray(jnp.inf, jnp.float32),
         jnp.asarray(0, jnp.int32)))
    return D2dResult(pose=pose, n_matched=n_hit, mean_error=err,
                     iterations=jnp.asarray(iterations, jnp.int32))


def register_scans_d2d(src_pts, src_mask, tgt_pts, tgt_mask, origin,
                       voxel_size, *, capacity: int = 8192,
                       init_pose: se3.Pose = None,
                       iterations: int = 16, min_points: int = 3
                       ) -> D2dResult:
    """Convenience scan-to-scan D2D: voxelize both scans, register."""
    src = vx.build_grid(src_pts, src_mask, origin, voxel_size,
                        capacity=capacity)
    tgt = vx.build_grid(tgt_pts, tgt_mask, origin, voxel_size,
                        capacity=capacity)
    usable = usable_mask(tgt, min_points=min_points)
    if init_pose is None:
        init_pose = se3.Pose.identity()
    return register_d2d(src, tgt, usable, init_pose, iterations=iterations)
