import jax.numpy as jnp
import numpy as np
import pytest

from veloslam_tpu.core import se3
from veloslam_tpu.io import simulate as sim
from veloslam_tpu.registration import gicp, ndt
from veloslam_tpu.registration import voxel as vx


def _static_scan(world, pos, yaw, n_az=900, n_vert=32, max_range=120.0,
                 seed=0, noise=0.0):
    """Raycast a full revolution from a static pose; returns sensor-frame
    points (P, 3) float32."""
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    vert = np.deg2rad(np.linspace(-30.67, 10.67, n_vert))
    azg, vg = np.meshgrid(az, vert, indexing="ij")
    dirs_s = np.stack([np.cos(vg) * np.sin(azg), np.cos(vg) * np.cos(azg),
                       np.sin(vg)], -1).reshape(-1, 3)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(pos, dirs_w.shape).copy()
    dist, kind = sim.raycast(world, origins, dirs_w, max_range=max_range)
    if noise:
        rng = np.random.default_rng(seed)
        dist = np.where(dist > 0, dist + rng.normal(0, noise, dist.shape), 0)
    pts = dirs_s * dist[:, None]
    return pts[dist > 0].astype(np.float32)


def _pad(pts, n):
    mask = np.zeros(n, bool)
    mask[:len(pts)] = True
    out = np.zeros((n, 3), np.float32)
    out[:len(pts)] = pts[:n]
    return jnp.asarray(out), jnp.asarray(mask)


@pytest.fixture(scope="module")
def world():
    return sim.World.demo(seed=5, n_posts=30, n_walls=10)


def test_build_grid_stats_match_numpy():
    rng = np.random.default_rng(0)
    # three clusters in distinct voxels
    centers = np.array([[0.3, 0.3, 0.3], [5.2, 0.4, 0.5], [0.3, 7.6, 1.4]])
    pts = np.concatenate([c + rng.normal(0, 0.05, (50, 3)) for c in centers])
    mask = np.ones(len(pts), bool)
    grid = vx.build_grid(jnp.asarray(pts, jnp.float32), jnp.asarray(mask),
                         jnp.zeros(3), 1.0, capacity=16)
    occ = np.asarray(grid.occupied)
    assert occ.sum() == 3
    counts = np.asarray(grid.count)[occ]
    np.testing.assert_array_equal(np.sort(counts), [50, 50, 50])
    # means match per-cluster numpy means
    means = np.asarray(grid.mean)[occ]
    for c in centers:
        d = np.linalg.norm(means - c.reshape(1, 3), axis=1)
        i = np.argmin(d)
        cluster = pts[np.all(np.floor(pts) == np.floor(c), axis=1)]
        np.testing.assert_allclose(means[i], cluster.mean(0), atol=1e-5)
        cov_np = np.cov(cluster.T, bias=True)
        idx_grid = np.where(occ)[0][i]
        np.testing.assert_allclose(np.asarray(grid.cov)[idx_grid], cov_np,
                                   atol=1e-5)


def test_lookup_hits_and_misses():
    pts = jnp.asarray(np.array([[0.5, 0.5, 0.5], [3.5, 0.5, 0.5]]),
                      jnp.float32)
    mask = jnp.ones(2, bool)
    grid = vx.build_grid(pts, mask, jnp.zeros(3), 1.0, capacity=8)
    q = vx.pack_keys(jnp.asarray([[0.7, 0.7, 0.7], [9.0, 9.0, 9.0]],
                                 jnp.float32), jnp.ones(2, bool),
                     grid.origin, grid.voxel_size)
    idx = np.asarray(vx.lookup(grid, q))
    assert idx[0] >= 0 and idx[1] == -1
    # key → voxel center roundtrip
    ctr = np.asarray(vx.unpack_keys(grid.keys[idx[0]], grid.origin,
                                    grid.voxel_size))
    np.testing.assert_allclose(ctr, [0.5, 0.5, 0.5], atol=1e-5)


def test_merge_stats_equals_rebuild():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 3, (300, 3)).astype(np.float32)
    b = rng.normal(1, 3, (300, 3)).astype(np.float32)
    m = jnp.ones(300, bool)
    ga = vx.build_grid(jnp.asarray(a), m, jnp.zeros(3), 1.0, capacity=512)
    gb = vx.build_grid(jnp.asarray(b), m, jnp.zeros(3), 1.0, capacity=512)
    gm = vx.merge_stats(ga, gb, capacity=1024)
    gall = vx.build_grid(jnp.asarray(np.concatenate([a, b])),
                         jnp.ones(600, bool), jnp.zeros(3), 1.0,
                         capacity=1024)
    # same occupied voxel keys and matching stats
    ka = np.asarray(gm.keys[gm.occupied])
    kb = np.asarray(gall.keys[gall.occupied])
    np.testing.assert_array_equal(np.sort(ka), np.sort(kb))
    # compare count and mean for each key
    map_m = {int(k): i for i, k in enumerate(np.asarray(gm.keys))
             if k != 2**31 - 1}
    map_a = {int(k): i for i, k in enumerate(np.asarray(gall.keys))
             if k != 2**31 - 1}
    for k, i in map_m.items():
        j = map_a[k]
        np.testing.assert_allclose(np.asarray(gm.count)[i],
                                   np.asarray(gall.count)[j], rtol=1e-6)
        np.testing.assert_allclose(np.asarray(gm.mean)[i],
                                   np.asarray(gall.mean)[j], atol=1e-4)
        np.testing.assert_allclose(np.asarray(gm.cov)[i],
                                   np.asarray(gall.cov)[j], atol=1e-4)


def test_smallest_eigenvector_matches_numpy():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 3, 3))
    cov = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)
    v = np.asarray(vx.smallest_eigenvector(jnp.asarray(cov)))
    wnp, vnp = np.linalg.eigh(cov.astype(np.float64))
    want = vnp[:, :, 0]
    dots = np.abs(np.sum(v * want, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)


def test_regularized_inverse_matches_numpy():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(10, 3, 3))
    cov = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)
    inv = np.asarray(vx.regularized_inverse(jnp.asarray(cov), eps=1e-3))
    want = np.linalg.inv(cov + 1e-3 * np.eye(3))
    np.testing.assert_allclose(inv, want, rtol=2e-2, atol=1e-2)


def test_gicp_recovers_known_transform(world):
    """Scan-to-scan: target scan from pose A, source scan from pose B;
    point-to-plane GICP must recover the relative pose (BASELINE
    configs[1])."""
    pos_a = np.array([0.0, 0.0, 2.0])
    tgt = _static_scan(world, pos_a, 0.0)
    # ground-truth source pose: 40 cm forward, 3 cm up, 2° yaw
    t_gt = np.array([0.1, 0.4, 0.03], np.float32)
    yaw_gt = np.deg2rad(2.0)
    src_world = _static_scan(world, pos_a + t_gt, yaw_gt)
    P = 32768
    tgt_p, tgt_m = _pad(tgt, P)
    src_p, src_m = _pad(src_world, P)

    grid = gicp.build_plane_grid(tgt_p, tgt_m, np.zeros(3), 1.0,
                                 capacity=8192)
    res = gicp.register(src_p, src_m, grid, se3.Pose.identity(),
                        iterations=20)

    got_t = np.asarray(res.pose.t)
    got_rv = np.asarray(se3.quat_log(res.pose.q))
    assert int(res.n_matched) > 5000
    np.testing.assert_allclose(got_t, t_gt, atol=0.05)
    np.testing.assert_allclose(got_rv, [0, 0, yaw_gt], atol=0.01)


def test_ndt_scan_to_map(world):
    """Scan-to-map NDT (BASELINE configs[2]): the target is a voxel-Gaussian
    map merged from several keyframe scans (exercising merge_stats); a new
    scan with a rough odometry prior must localize against it."""
    P = 32768
    g = None
    for dx, dy, yaw in [(0, 0, 0), (1.2, 0.5, 0.15), (-0.8, 1.0, -0.2),
                        (0.5, -1.1, 0.4)]:
        pos = np.array([dx, dy, 2.0])
        pts_s = _static_scan(world, pos, yaw)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pts_w = (pts_s @ R.T + pos).astype(np.float32)
        p, m = _pad(pts_w, P)
        gi = vx.build_grid(p, m, jnp.zeros(3), 1.0, capacity=16384)
        g = gi if g is None else vx.merge_stats(g, gi, capacity=16384)
    grid = ndt.build_ndt_grid(g)

    true_t = np.array([0.6, 0.9, 2.05], np.float32)
    yaw_gt = np.deg2rad(5.0)
    src = _static_scan(world, true_t, yaw_gt)
    sp, sm = _pad(src, P)
    init = se3.Pose(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                    jnp.asarray([0.5, 0.8, 1.9], jnp.float32))
    res = ndt.register(sp, sm, grid, init, iterations=30)
    np.testing.assert_allclose(np.asarray(res.pose.t), true_t, atol=0.06)
    np.testing.assert_allclose(np.asarray(se3.quat_log(res.pose.q)),
                               [0, 0, yaw_gt], atol=0.005)
    assert int(res.n_matched) > 5000


def test_register_with_noise_still_converges(world):
    pos_a = np.array([5.0, 3.0, 2.0])
    tgt = _static_scan(world, pos_a, 0.3, noise=0.02, seed=1)
    t_gt = np.array([0.3, 0.2, 0.0], np.float32)
    src = _static_scan(world, pos_a + t_gt, 0.3, noise=0.02, seed=2)
    P = 32768
    tgt_p, tgt_m = _pad(tgt, P)
    src_p, src_m = _pad(src, P)
    grid = gicp.build_plane_grid(tgt_p, tgt_m, np.zeros(3), 1.0,
                                 capacity=8192)
    res = gicp.register(src_p, src_m, grid, se3.Pose.identity(),
                        iterations=20)
    # Both scans share yaw 0.3, so the recovered translation is the world
    # delta expressed in the target sensor frame: R(-0.3)·t_gt.
    c, s = np.cos(0.3), np.sin(0.3)
    want = np.array([c * t_gt[0] + s * t_gt[1],
                     -s * t_gt[0] + c * t_gt[1], 0.0])
    np.testing.assert_allclose(np.asarray(res.pose.t), want, atol=0.08)


def test_register_identity_stays_identity(world):
    tgt = _static_scan(world, np.array([0.0, 0.0, 2.0]), 0.0)
    P = 32768
    p, m = _pad(tgt, P)
    grid = gicp.build_plane_grid(p, m, np.zeros(3), 1.0, capacity=8192)
    res = gicp.register(p, m, grid, se3.Pose.identity(), iterations=8)
    # Mixed (corner) voxels passing the planarity gate leave a few-cm
    # self-consistency floor in this synthetic world; a D2D cost would
    # tighten this (tracked as a quality follow-up).
    np.testing.assert_allclose(np.asarray(res.pose.t), 0.0, atol=0.05)
    assert float(res.mean_error) < 0.05


@pytest.mark.slow
def test_dense_index_lookup_matches_search(world):
    """DenseIndex O(1) lookup must return the same correspondences as the
    binary-search path, and registration through it the same pose."""
    import jax.numpy as jnp
    tgt = _static_scan(world, np.array([0.0, 0.0, 2.0]), 0.0)
    src = _static_scan(world, np.array([0.1, 0.4, 2.03]), np.deg2rad(2.0))
    P = 32768
    tp, tm = _pad(tgt, P)
    sp, sm = _pad(src, P)
    grid = gicp.build_plane_grid(tp, tm, np.zeros(3), 1.0, capacity=8192)
    dense = vx.build_dense_index(grid.grid)
    i_search = np.asarray(vx.lookup_nearest(grid.grid, sp, sm, grid.usable))
    i_dense = np.asarray(vx.lookup_nearest_dense(grid.grid, dense, sp, sm,
                                                 grid.usable))
    agree = (i_search == i_dense).mean()
    assert agree > 0.999, agree

    r0 = gicp.register(sp, sm, grid, se3.Pose.identity(), iterations=16)
    r1 = gicp.register(sp, sm, grid, se3.Pose.identity(), iterations=16,
                       dense=dense, dense_approx_centers=False)
    np.testing.assert_allclose(np.asarray(r1.pose.t), np.asarray(r0.pose.t),
                               atol=2e-3)
    # The production default picks the nearest arm by voxel CENTER instead
    # of gathered means (one fewer 7P-row gather); the converged pose must
    # stay within a few mm of the exact-arm result.
    r2 = gicp.register(sp, sm, grid, se3.Pose.identity(), iterations=16,
                       dense=dense)
    np.testing.assert_allclose(np.asarray(r2.pose.t), np.asarray(r0.pose.t),
                               atol=1e-2)


@pytest.mark.slow
def test_register_batch_matches_sequential(world):
    """register_batch (vmapped, one dispatch) must produce the same poses
    as F independent register() calls — both shared-target (batched
    odometry) and stacked-target (loop-closure verification) modes."""
    pos_a = np.array([0.0, 0.0, 2.0])
    tgt = _static_scan(world, pos_a, 0.0)
    P = 16384
    tgt_p, tgt_m = _pad(tgt, P)
    grid = gicp.build_plane_grid(tgt_p, tgt_m, np.zeros(3), 1.0,
                                 capacity=8192)

    offsets = [np.array([0.1, 0.3, 0.0], np.float32),
               np.array([-0.2, 0.5, 0.05], np.float32),
               np.array([0.3, -0.1, -0.02], np.float32)]
    yaws = [np.deg2rad(1.5), np.deg2rad(-2.0), np.deg2rad(0.7)]
    srcs = [_pad(_static_scan(world, pos_a + o, y), P)
            for o, y in zip(offsets, yaws)]
    pts = jnp.stack([s[0] for s in srcs])
    msk = jnp.stack([s[1] for s in srcs])
    init = se3.Pose(jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                             (3, 1)),
                    jnp.zeros((3, 3), jnp.float32))

    batched = gicp.register_batch(pts, msk, grid, init, iterations=16)
    for k, (o, y) in enumerate(zip(offsets, yaws)):
        solo = gicp.register(pts[k], msk[k], grid, se3.Pose.identity(),
                             iterations=16)
        np.testing.assert_allclose(np.asarray(batched.pose.t[k]),
                                   np.asarray(solo.pose.t), atol=1e-5)
        np.testing.assert_allclose(np.asarray(batched.pose.q[k]),
                                   np.asarray(solo.pose.q), atol=1e-5)
        # and each recovers its own ground truth
        np.testing.assert_allclose(np.asarray(batched.pose.t[k]),
                                   o, atol=0.06)
        got_rv = np.asarray(se3.quat_log(batched.pose.q[k]))
        np.testing.assert_allclose(got_rv, [0, 0, y], atol=0.012)

    # stacked-target mode: per-scan target grids (candidate pairs)
    grids = gicp.stack_plane_grids([grid, grid, grid])
    stacked = gicp.register_batch(pts, msk, grids, init, iterations=16,
                                  share_target=False)
    np.testing.assert_allclose(np.asarray(stacked.pose.t),
                               np.asarray(batched.pose.t), atol=1e-5)


def test_rebase_grid_preserves_statistics():
    """rebase_grid re-keys the window around a new center: surviving
    voxels keep exact stats/world coords and remain binary-searchable;
    voxels leaving the window are dropped."""
    import jax.numpy as jnp

    from veloslam_tpu.registration import voxel as vx

    rng = np.random.default_rng(0)
    pts = rng.uniform(-40, 40, (8192, 3)).astype(np.float32)
    mask = jnp.ones(8192, bool)
    g = vx.build_grid(jnp.asarray(pts), mask, np.zeros(3), 1.0,
                      capacity=4096)
    new_center = jnp.asarray([500.0, 0.0, 0.0], jnp.float32)
    r = vx.rebase_grid(g, new_center)
    # new origin voxel-aligned at the requested center
    np.testing.assert_allclose(np.asarray(r.origin), [500.0, 0, 0])
    # keys sorted, no duplicates among occupied
    keys = np.asarray(r.keys)
    occ = keys != vx.INVALID_KEY
    assert np.all(np.diff(keys) >= 0)
    assert len(np.unique(keys[occ])) == occ.sum()
    # voxels at x in [-40, -13) fall outside the new +/-512 window around
    # x=500 and must be dropped; the rest survive with identical stats
    om, oc = np.asarray(g.mean), np.asarray(g.count)
    keep = (np.asarray(g.keys) != vx.INVALID_KEY) & (om[:, 0] >= -12.0)
    drop = (np.asarray(g.keys) != vx.INVALID_KEY) & (om[:, 0] < -13.0)
    assert occ.sum() == keep.sum()
    rm = np.asarray(r.mean)[occ]
    # match survivors by sorted mean signature
    a = np.sort(om[keep], axis=0)
    b = np.sort(rm, axis=0)
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert np.isclose(np.asarray(r.count).sum(), oc[keep].sum())
    # lookups against the rebased grid hit the same Gaussians
    q = om[keep][:100]
    idx = np.asarray(vx.lookup(
        r, vx.pack_keys(jnp.asarray(q), jnp.ones(100, bool), r.origin,
                        r.voxel_size)))
    assert np.all(idx >= 0)
    np.testing.assert_allclose(np.asarray(r.mean)[idx], q, atol=1e-5)
    assert drop.sum() > 0          # the fixture really crossed the window


def test_reassociate_every_matches_classical(world):
    """Block re-association (reassociate_every=k) must recover the same
    transform as classical per-iteration ICP: association is the only
    part hoisted, and with a near-basin prior the correspondence set is
    stable.  This is the production config (association gathers cost
    far more than a fixed-correspondence GN iteration)."""
    pos_a = np.array([0.0, 0.0, 2.0])
    tgt = _static_scan(world, pos_a, 0.0)
    t_gt = np.array([0.1, 0.4, 0.03], np.float32)
    yaw_gt = np.deg2rad(2.0)
    src_world = _static_scan(world, pos_a + t_gt, yaw_gt)
    P = 32768
    tgt_p, tgt_m = _pad(tgt, P)
    src_p, src_m = _pad(src_world, P)
    grid = gicp.build_plane_grid(tgt_p, tgt_m, np.zeros(3), 1.0,
                                 capacity=8192)
    dense = vx.build_dense_index(grid.grid)

    ref = gicp.register(src_p, src_m, grid, se3.Pose.identity(),
                        iterations=16)
    for k, d in ((8, None), (8, dense), (4, dense), (16, dense)):
        res = gicp.register(src_p, src_m, grid, se3.Pose.identity(),
                            iterations=16, reassociate_every=k, dense=d)
        # Same ground-truth accuracy bound as the classical path (the two
        # converge to slightly different optima in the same basin).
        np.testing.assert_allclose(np.asarray(res.pose.t), t_gt, atol=0.05)
        np.testing.assert_allclose(np.asarray(se3.quat_log(res.pose.q)),
                                   [0, 0, yaw_gt], atol=0.01)
        assert int(res.n_matched) > 5000
    # k=1 must reproduce the classical path bit-for-bit (same program
    # structure up to block count).
    res1 = gicp.register(src_p, src_m, grid, se3.Pose.identity(),
                         iterations=16, reassociate_every=1)
    np.testing.assert_allclose(np.asarray(res1.pose.t),
                               np.asarray(ref.pose.t), atol=1e-6)


def test_dilated_index_registration(world):
    """The pre-dilated dense index (production path: one gather per
    point, neighborhood + usable gating baked into the table) must agree
    with the classical search wherever the point's own voxel is usable,
    and registration through it must recover the ground-truth transform."""
    tgt = _static_scan(world, np.array([0.0, 0.0, 2.0]), 0.0)
    t_gt = np.array([0.1, 0.4, 0.03], np.float32)
    yaw_gt = np.deg2rad(2.0)
    src = _static_scan(world, np.array([0.1, 0.4, 2.03]), yaw_gt)
    P = 32768
    tp, tm = _pad(tgt, P)
    sp, sm = _pad(src, P)
    grid = gicp.build_plane_grid(tp, tm, np.zeros(3), 1.0, capacity=8192)
    dil = vx.build_dilated_index(grid.grid, grid.usable)

    i_dil = np.asarray(vx.lookup_dilated(grid.grid, dil, sp, sm))
    i_ref = np.asarray(vx.lookup_nearest(grid.grid, sp, sm, grid.usable))
    # Where the containing voxel itself is usable both must pick it.
    keys = np.asarray(vx.pack_keys(sp, sm, grid.grid.keys.dtype.type(0) * 0
                                   + np.zeros(3, np.float32),
                                   np.float32(1.0)))
    own = np.asarray(vx.lookup(grid.grid, jnp.asarray(keys)))
    own_usable = (own >= 0) & np.asarray(grid.usable)[np.maximum(own, 0)]
    # The dilated table's contract: a usable containing voxel wins.
    np.testing.assert_array_equal(i_dil[own_usable], own[own_usable])
    # The classical search prefers a nearer-mean NEIGHBOR for a small
    # fraction of edge points — overall agreement stays high.
    agree = (i_dil[own_usable] == i_ref[own_usable]).mean()
    assert agree > 0.9, agree
    # Fallback cells still resolve to usable rows only.
    hits = i_dil[i_dil >= 0]
    assert np.asarray(grid.usable)[hits].all()

    res = gicp.register(sp, sm, grid, se3.Pose.identity(), iterations=16,
                        dense=dil, reassociate_every=8)
    np.testing.assert_allclose(np.asarray(res.pose.t), t_gt, atol=0.05)
    np.testing.assert_allclose(np.asarray(se3.quat_log(res.pose.q)),
                               [0, 0, yaw_gt], atol=0.01)
