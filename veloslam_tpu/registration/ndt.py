"""NDT-style scan-to-map registration against voxel-Gaussian map blocks.

Point-to-distribution registration: each source point is matched to the map
voxel it falls in (veloslam_tpu.map stores MapPatch-equivalent blocks as
voxel Gaussians) and pulled toward the voxel mean under the Mahalanobis
metric of the voxel covariance — the classic NDT cost, linearized for
Gauss-Newton:

    r = p′ − μ            (3,)
    W = (Σ + εI)⁻¹        (3, 3)  closed-form adjugate inverse
    J = [−[p′]ₓ | I]      (3, 6)  left perturbation
    H = Σₚ Jᵀ W J,  b = Σₚ Jᵀ W r   — float32 einsums at HIGHEST

This is BASELINE configs[2]; the machinery intentionally shares the voxel
grid and solver shape with registration.gicp so scan-to-scan and
scan-to-map paths differ only in residual form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from veloslam_tpu.core import se3
from veloslam_tpu.registration import voxel as vx

HIGHEST = jax.lax.Precision.HIGHEST


class NdtResult(NamedTuple):
    pose: se3.Pose
    n_matched: jax.Array
    mean_error: jax.Array   # mean Mahalanobis residual
    iterations: jax.Array


class NdtGrid(NamedTuple):
    """VoxelGrid augmented with precomputed inverse covariances."""

    grid: vx.VoxelGrid
    w: jax.Array            # (V, 3, 3) — (Σ + εI)⁻¹
    usable: jax.Array       # (V,) bool


def build_ndt_grid(grid: vx.VoxelGrid, *, min_points: int = 4,
                   robust: bool = True,
                   floor_ratio: float = 0.01) -> NdtGrid:
    """Precompute per-voxel inverse covariances from any VoxelGrid (scan-
    or map-built).

    `robust` (default) conditions against accumulated-map sampling bias
    the same way as D2D: weights come from the scale-normalized,
    planarity-inflated covariance (voxel.normalized_cov — planar voxels
    behave point-to-plane-like instead of pulling toward in-cell density)
    and line-like scan-ring voxels are gated out
    (voxel.structure_usable).  `robust=False` keeps the classic NDT
    weighting (eigenvalue-clamped inverse) for scan-to-scan use where
    both sides share the sampling pattern."""
    if robust:
        w = vx.regularized_inverse(vx.normalized_cov(grid.cov), eps=1e-3)
        usable = vx.structure_usable(grid, min_points=min_points)
    else:
        w = vx.clamped_inverse(grid.cov, floor_ratio=floor_ratio)
        usable = grid.occupied & (grid.count >= min_points)
    return NdtGrid(grid=grid, w=w, usable=usable)


def _hat(v: jax.Array) -> jax.Array:
    """(..., 3) → skew-symmetric (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1),
    ], -2)


def normal_equations(pts: jax.Array, mask: jax.Array, pose: se3.Pose,
                     target: NdtGrid, *, max_dist: float = 3.0):
    g = target.grid
    p = se3.apply(pose, pts)
    idx = vx.lookup_nearest(g, p, mask, target.usable)
    hit = idx >= 0
    safe = jnp.maximum(idx, 0)
    mu = g.mean[safe]                       # (P, 3)
    W = target.w[safe]                      # (P, 3, 3)
    r = p - mu
    hit &= jnp.linalg.norm(r, axis=-1) < max_dist
    w = hit.astype(jnp.float32)

    J = jnp.concatenate([-_hat(p), jnp.broadcast_to(
        jnp.eye(3, dtype=p.dtype), (*p.shape[:-1], 3, 3))], axis=-1)  # (P,3,6)
    WJ = jnp.einsum("pab,pbj->paj", W, J,
                    precision=HIGHEST) * w[:, None, None]
    H = jnp.einsum("pai,paj->ij", J, WJ, precision=HIGHEST)
    b = jnp.einsum("paj,pa->j", WJ, r, precision=HIGHEST)
    mahal = jnp.einsum("pa,pab,pb->p", r, W, r, precision=HIGHEST)
    err = jnp.sum(mahal * w) / jnp.maximum(w.sum(), 1.0)
    return H, b, err, hit.sum().astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("iterations",))
def register(pts: jax.Array, mask: jax.Array, target: NdtGrid,
             init_pose: se3.Pose, *, iterations: int = 16,
             damping: float = 1e-4, max_dist: float = 3.0) -> NdtResult:
    """Gauss-Newton NDT registration (fixed iterations, jittable)."""

    def body(_, state):
        pose, _, _ = state
        H, b, err, n_hit = normal_equations(pts, mask, pose, target,
                                            max_dist=max_dist)
        Hd = H + (damping + 1e-6 * jnp.trace(H)) * jnp.eye(6, dtype=H.dtype)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hd), b)
        ok = jnp.all(jnp.isfinite(delta)) & (n_hit > 10)
        delta = jnp.where(ok, delta, 0.0)
        # Per-iteration step clamp (see gicp.register).
        tn = jnp.linalg.norm(delta[3:])
        rn = jnp.linalg.norm(delta[:3])
        scale = jnp.minimum(1.0, jnp.minimum(
            1.0 / jnp.maximum(tn, 1e-12),
            0.3 / jnp.maximum(rn, 1e-12)))
        delta = delta * scale
        return se3.retract(pose, delta), err, n_hit

    pose, err, n_hit = jax.lax.fori_loop(
        0, iterations, body,
        (init_pose, jnp.asarray(jnp.inf, jnp.float32),
         jnp.asarray(0, jnp.int32)))
    return NdtResult(pose=pose, n_matched=n_hit, mean_error=err,
                     iterations=jnp.asarray(iterations, jnp.int32))
