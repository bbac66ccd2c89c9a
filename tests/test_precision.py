"""Float32 products where the geometry needs them.

On a GPU, XLA may run a float32 dot at reduced (TF32-class) precision unless
the product says otherwise; the registration normal equations carry p × n
with p hundreds of metres from the origin, and the pose graph mixes edge
information of 1e2 and 1e6.  These tests pin the stated precision in the
lowered programs and check the arithmetic against a float64 oracle."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from veloslam_tpu.core import se3
from veloslam_tpu.graph import optimize, pcg
from veloslam_tpu.graph import scancontext as sc
from veloslam_tpu.graph.posegraph import PoseGraph
from veloslam_tpu.registration import d2d, gicp, ndt
from veloslam_tpu.registration import voxel as vx


def test_gicp_normal_equations_match_float64_far_from_origin():
    """H = Σ w JᵀJ, b = Σ w J r with J = [p × n | n] at ~150 m from the
    origin, against a float64 numpy oracle."""
    rng = np.random.default_rng(0)
    P = 4096
    offset = np.array([150.0, -120.0, 3.0])
    pts = (offset + rng.uniform(-20, 20, (P, 3))).astype(np.float32)
    n = rng.normal(size=(P, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    mu = (pts + rng.normal(scale=0.2, size=(P, 3))).astype(np.float32)
    hit = rng.uniform(size=P) < 0.9
    H, b, err, n_hit = jax.jit(gicp.normal_equations_fixed)(
        jnp.asarray(pts), se3.Pose.identity(), jnp.asarray(mu),
        jnp.asarray(n), jnp.asarray(hit))

    p64, n64, mu64 = (a.astype(np.float64) for a in (pts, n, mu))
    r = np.sum(n64 * (p64 - mu64), axis=1)
    ok = hit & (np.abs(r) < 2.0)
    w = np.where(np.abs(r) <= 0.5, 1.0, 0.5 / np.abs(r)) * ok
    J = np.concatenate([np.cross(p64, n64), n64], axis=1)
    H_ref = (J * w[:, None]).T @ J
    b_ref = (J * w[:, None]).T @ r
    scale = np.abs(H_ref).max()
    assert np.abs(np.asarray(H, np.float64) - H_ref).max() < 1e-5 * scale
    assert (np.abs(np.asarray(b, np.float64) - b_ref).max()
            < 1e-5 * np.abs(b_ref).max())
    assert int(n_hit) == int(ok.sum())
    assert abs(float(err) - np.sum(np.abs(r) * w) / w.sum()) < 1e-5


def _scan(P=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    pts[: P // 2, 2] = 0.0                      # a plane for usable voxels
    return jnp.asarray(pts), jnp.ones(P, bool)


def _lowered_gicp():
    pts, m = _scan()
    tg = gicp.build_plane_grid(pts, m, np.zeros(3), 1.0, capacity=512)
    return gicp.register.lower(pts, m, tg, se3.Pose.identity(),
                               iterations=2)


def _lowered_ndt():
    pts, m = _scan()
    grid = vx.build_grid(pts, m, jnp.zeros(3), 1.0, capacity=512)
    return ndt.register.lower(pts, m, ndt.build_ndt_grid(grid),
                              se3.Pose.identity(), iterations=2)


def _lowered_d2d():
    pts, m = _scan()
    grid = vx.build_grid(pts, m, jnp.zeros(3), 1.0, capacity=512)
    return d2d.register_d2d.lower(grid, grid, d2d.usable_mask(grid),
                                  se3.Pose.identity(), iterations=2)


def _graph():
    g = PoseGraph(max_poses=8, max_edges=16, max_landmarks=4, max_obs=16)
    for k in range(4):
        g.add_pose(np.array([1, 0, 0, 0], np.float32),
                   np.array([k, 0, 0], np.float32))
        if k:
            g.add_edge(k - 1, k, np.array([1, 0, 0, 0], np.float32),
                       np.array([1, 0, 0], np.float32))
    return g.arrays()


def _lowered_pose_graph():
    return optimize.solve_with_landmarks.lower(
        _graph(), max_poses=8, max_landmarks=4, iterations=1)


def _lowered_scancontext():
    rng = np.random.default_rng(0)
    return sc.descriptor_scores.lower(
        jnp.asarray(rng.uniform(0, 5, (16, sc.N_RINGS, sc.N_SECTORS)),
                    jnp.float32))


def _lowered_pcg():
    return pcg.solve_pcg_landmarks.lower(
        _graph(), max_poses=8, max_landmarks=4, iterations=1, cg_iters=2)


@pytest.mark.parametrize("lower", [_lowered_gicp, _lowered_ndt,
                                   _lowered_d2d, _lowered_pose_graph,
                                   _lowered_pcg, _lowered_scancontext],
                         ids=["gicp", "ndt", "d2d", "pose_graph", "pcg",
                              "scancontext"])
def test_products_run_at_highest_precision(lower):
    dots = [ln for ln in lower().as_text().splitlines()
            if "stablehlo.dot_general" in ln]
    assert dots, "no matrix product lowered"
    loose = [ln.strip() for ln in dots
             if not re.search(r"precision = \[HIGHEST, HIGHEST\]", ln)]
    assert not loose, loose[:3]
