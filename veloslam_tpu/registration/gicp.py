"""Voxelized point-to-plane ICP (VGICP-style) — scan-to-scan odometry.

Supplies the registration capability the reference leaves unimplemented
(reference README.md:25-26: "SLAM algorithm" not implemented; SURVEY.md §0),
as static-shaped array programs:

  * the target scan is summarized once as a voxel-Gaussian grid
    (registration.voxel) with a per-voxel plane normal from the closed-form
    smallest eigenvector;
  * each Gauss-Newton iteration is: transform points → pack keys → binary
    search → gather (μ, n) → point-to-plane residual r = nᵀ(p′ − μ) with
    Huber weights → 6×6 normal equations as full-float32 reductions over
    the points → solve → retract;
  * fixed iteration count under `lax.fori_loop`, no data-dependent Python
    control flow, everything static-shaped and jittable.

The same step function is reused by the distributed path (normal equations
are psum-reduced across map shards, veloslam_tpu.parallel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from veloslam_tpu.core import se3
from veloslam_tpu.registration import voxel as vx


class GicpResult(NamedTuple):
    pose: se3.Pose          # target-frame pose of the source scan
    n_matched: jax.Array    # () int32 — correspondences in the last iter
    mean_error: jax.Array   # () float32 — mean |point-to-plane| residual
    iterations: jax.Array   # () int32
    # (6, 6) Gauss-Newton normal matrix of the LAST iteration, or None for
    # paths that do not expose it.  Its eigen-spectrum is the constraint
    # observability of the fit: near-zero eigenvalues mean the scene does
    # not constrain that motion direction (e.g. ground-plane-only matches
    # slide freely in x/y/yaw) — used to reject degenerate loop closures.
    H: jax.Array = None


class PlaneGrid(NamedTuple):
    """VoxelGrid augmented with per-voxel unit normals + validity."""

    grid: vx.VoxelGrid
    normal: jax.Array       # (V, 3)
    usable: jax.Array       # (V,) bool — enough points for a stable plane


def plane_grid_from(grid: vx.VoxelGrid, *, min_points: int = 4,
                    min_planarity: float = 0.35) -> PlaneGrid:
    """Derive a point-to-plane target from an existing VoxelGrid (e.g. a
    map ROI from veloslam_tpu.map) — enables scan-to-map GICP."""
    normal = vx.smallest_eigenvector(grid.cov)
    l1, l2, l3 = vx.eigvals3(grid.cov)
    planarity = (l2 - l3) / jnp.maximum(l1, 1e-12)
    usable = (grid.occupied & (grid.count >= min_points)
              & (planarity >= min_planarity))
    return PlaneGrid(grid=grid, normal=normal, usable=usable)


def build_plane_grid(pts: jax.Array, mask: jax.Array, origin, voxel_size, *,
                     capacity: int, min_points: int = 4,
                     min_planarity: float = 0.35) -> PlaneGrid:
    """Summarize a scan as per-voxel planes with planarity gating.

    `min_planarity` rejects voxels whose covariance is not plane-like
    (planarity = (λ2 − λ3)/λ1).  This matters for sparse LiDAR scans: a far
    ground voxel often contains a single scan-ring arc — a 1-D feature whose
    "smallest eigenvector" points radially, not up.  Ring features translate
    with the sensor, so matching them drags registration along the motion
    direction; gating them out removes that bias.
    """
    grid = vx.build_grid(pts, mask, jnp.asarray(origin, jnp.float32),
                         voxel_size, capacity=capacity)
    normal = vx.smallest_eigenvector(grid.cov)
    l1, l2, l3 = vx.eigvals3(grid.cov)
    planarity = (l2 - l3) / jnp.maximum(l1, 1e-12)
    usable = (grid.occupied & (grid.count >= min_points)
              & (planarity >= min_planarity))
    return PlaneGrid(grid=grid, normal=normal, usable=usable)


def associate(pts: jax.Array, mask: jax.Array, pose: se3.Pose,
              target: PlaneGrid, dense=None, approx_centers: bool = False):
    """Correspondence search at the CURRENT pose: per-point target plane
    (μ, n) + hit mask.  This is the gather-heavy half of a GICP iteration
    (voxel lookup + stat gathers); the linearization half is pure
    elementwise + a small matrix product.  Splitting them lets `register`
    re-associate every few iterations instead of every iteration — the
    lookup gathers are the expensive half, while with an INS prior the
    correspondences barely change between consecutive iterations."""
    with jax.named_scope("gicp_associate"):
        g = target.grid
        p = se3.apply(pose, pts)
        if isinstance(dense, vx.DilatedIndex):
            # Pre-dilated table: the 7-neighborhood choice + usable gating are
            # baked in at build time — one gather per point here.
            idx = vx.lookup_dilated(g, dense, p, mask)
        elif dense is not None:
            idx = vx.lookup_nearest_dense(g, dense, p, mask, target.usable,
                                          approx_centers=approx_centers)
        else:
            idx = vx.lookup_nearest(g, p, mask, target.usable)
        hit = idx >= 0
        safe = jnp.maximum(idx, 0)
        return g.mean[safe], target.normal[safe], hit


def normal_equations_fixed(pts: jax.Array, pose: se3.Pose, mu: jax.Array,
                           n: jax.Array, hit: jax.Array, *,
                           huber_delta: float = 0.5, max_dist: float = 2.0):
    """Linearization with FIXED correspondences (μ, n, hit) from a prior
    `associate` call: (H (6,6), b (6,), err (), n_matched ())."""
    with jax.named_scope("gicp_normal_equations"):
        p = se3.apply(pose, pts)
        r = jnp.sum(n * (p - mu), axis=-1)
        hit &= jnp.abs(r) < max_dist
        # Huber influence weights.
        absr = jnp.abs(r)
        w = jnp.where(absr <= huber_delta, 1.0,
                      huber_delta / jnp.maximum(absr, 1e-12))
        w = jnp.where(hit, w, 0.0)

        J = jnp.concatenate([jnp.cross(p, n), n], axis=-1)       # (P, 6)
        Jw = J * w[:, None]
        # Full float32 reductions: J carries p × n with p up to hundreds
        # of metres from the origin, and a reduced-precision (TF32-class)
        # product keeps ~3 decimal digits — enough to move the solved
        # pose.  H is an elementwise multiply + reduce: as a dot, with the
        # frame slots vmapped, it becomes a batched gemm with 6x6 outputs
        # and K = P, which on an H100 cost 0.55 ms per call at HIGHEST
        # precision against 0.16 ms for this form (96 slots x 16384
        # points).
        H = jnp.sum(Jw[:, :, None] * J[:, None, :], axis=0)
        b = jnp.einsum("pi,p->i", Jw, r,
                       precision=jax.lax.Precision.HIGHEST)
        err = jnp.sum(jnp.abs(r) * w) / jnp.maximum(jnp.sum(w), 1.0)
        return H, b, err, hit.sum().astype(jnp.int32)


def normal_equations(pts: jax.Array, mask: jax.Array, pose: se3.Pose,
                     target: PlaneGrid, *, huber_delta: float = 0.5,
                     max_dist: float = 2.0, dense=None):
    """One full linearization (associate + linearize at the same pose):
    (H (6,6), b (6,), err (), n_matched ()).

    Residual r = nᵀ(p′ − μ); left-perturbation Jacobian J = [(p′ × n)ᵀ, nᵀ].
    """
    mu, n, hit = associate(pts, mask, pose, target, dense)
    return normal_equations_fixed(pts, pose, mu, n, hit,
                                  huber_delta=huber_delta,
                                  max_dist=max_dist)


@functools.partial(jax.jit, static_argnames=("iterations",
                                             "reassociate_every",
                                             "dense_approx_centers"))
def register(pts: jax.Array, mask: jax.Array, target: PlaneGrid,
             init_pose: se3.Pose, *, iterations: int = 16,
             damping: float = 1e-6, huber_delta: float = 0.5,
             max_dist: float = 2.0,
             dense=None, reassociate_every: int = 1,
             dense_approx_centers: bool = True) -> GicpResult:
    """Gauss-Newton point-to-plane registration of a source scan against a
    target plane grid.  Fixed iteration count (static shapes); convergence
    is reflected in `mean_error`, not in early exit.

    `dense`: optional voxel.DenseIndex for O(1) correspondence lookup
    (build once per target with voxel.build_dense_index).

    `reassociate_every`: re-run correspondence search every k iterations
    (1 = classical ICP, every iteration).  The search is the only
    gather-bound stage — far costlier than a fixed-correspondence GN
    iteration — and with a good prior (INS, or the previous frame) the
    correspondence set is stable across consecutive iterations, so k of
    4-8 trades no measurable accuracy for most of the runtime
    (tests/test_registration.py covers equivalence on synthetic scenes)."""

    def gn_iter(state, mu, n, hit0):
        pose, _, _, _ = state
        H, b, err, n_hit = normal_equations_fixed(
            pts, pose, mu, n, hit0, huber_delta=huber_delta,
            max_dist=max_dist)
        Hd = H + damping * jnp.eye(6, dtype=H.dtype) \
            + 1e-6 * jnp.trace(H) * jnp.eye(6, dtype=H.dtype)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hd), b)
        # Guard against degenerate geometry blowing up the step: reject
        # non-finite solves and clamp per-iteration step length (runaway
        # steps larger than a voxel mean the linearization left its basin).
        ok = jnp.all(jnp.isfinite(delta)) & (n_hit > 10)
        delta = jnp.where(ok, delta, 0.0)
        tn = jnp.linalg.norm(delta[3:])
        rn = jnp.linalg.norm(delta[:3])
        scale = jnp.minimum(1.0, jnp.minimum(
            1.0 / jnp.maximum(tn, 1e-12),
            0.3 / jnp.maximum(rn, 1e-12)))
        delta = delta * jnp.minimum(scale, 1.0)
        return se3.retract(pose, delta), err, n_hit, H

    state = (init_pose, jnp.asarray(jnp.inf, jnp.float32),
             jnp.asarray(0, jnp.int32), jnp.zeros((6, 6), jnp.float32))
    k = max(int(reassociate_every), 1)
    # Static unroll over association blocks; the cheap fixed-correspondence
    # iterations run inside a fori_loop per block.
    done = 0
    while done < iterations:
        block = min(k, iterations - done)
        mu, n, hit0 = associate(pts, mask, state[0], target, dense,
                                approx_centers=dense_approx_centers)
        state = jax.lax.fori_loop(
            0, block, lambda _, s: gn_iter(s, mu, n, hit0), state)
        done += block
    pose, err, n_hit, H = state
    return GicpResult(pose=pose, n_matched=n_hit, mean_error=err,
                      iterations=jnp.asarray(iterations, jnp.int32), H=H)


@functools.partial(jax.jit, static_argnames=("iterations",
                                             "share_target",
                                             "reassociate_every",
                                             "dense_approx_centers"))
def register_batch(pts: jax.Array, mask: jax.Array, target: PlaneGrid,
                   init_poses: se3.Pose, dense=None, *,
                   iterations: int = 16,
                   damping: float = 1e-6, huber_delta: float = 0.5,
                   max_dist: float = 2.0,
                   share_target: bool = True,
                   reassociate_every: int = 1,
                   dense_approx_centers: bool = True) -> GicpResult:
    """Register F independent scans in ONE dispatched program (vmap).

    Two production uses:
      * batched odometry — every frame assembled from a packet batch is
        registered against the batch-start map ROI with its own INS prior
        (`share_target=True`); amortizes the per-dispatch floor that
        dominates single-frame registration on small scans;
      * batched loop-closure verification — each candidate pair brings its
        own target grid (`share_target=False`, leaves of `target` stacked
        on a leading F axis, see `stack_plane_grids`).

    Args:
      pts:  (F, P, 3) source scans.
      mask: (F, P) validity.
      target: one shared PlaneGrid, or a stacked (F, ...) PlaneGrid.
      init_poses: Pose with (F, 4) / (F, 3) leaves.
      dense: optional shared voxel.DenseIndex for the target (O(1)
        correspondence gathers; share_target only).
    Returns a GicpResult with a leading F axis on every field.
    """
    def fn(p, m, t, i, d):
        return register(p, m, t, i, iterations=iterations, damping=damping,
                        huber_delta=huber_delta, max_dist=max_dist,
                        dense=d,
                        reassociate_every=reassociate_every,
                        dense_approx_centers=dense_approx_centers)
    t_axes = None if share_target else 0
    return jax.vmap(fn, in_axes=(0, 0, t_axes, 0, None))(
        pts, mask, target, init_poses, dense)


def stack_plane_grids(grids) -> PlaneGrid:
    """Stack a list of same-capacity PlaneGrids on a new leading axis for
    `register_batch(share_target=False)` (loop-closure candidate pairs)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *grids)
