"""Per-stage wall-clock profile of the bulk odometry batch on the
default device — where does the batch time go?

Each stage is jitted separately, warmed, then timed over `--reps`
dispatches, each region closed by `jax.block_until_ready`.

Usage: python scripts/profile_bulk.py [--reps 4]
"""
import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    t0 = time.perf_counter()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from veloslam_tpu.utils import compilecache
        compilecache.enable()
    import jax.numpy as jnp
    jax.device_get(jnp.zeros(8))
    print(f"# backend up after {time.perf_counter()-t0:.1f}s "
          f"({jax.default_backend()})", flush=True)

    import bench
    from veloslam_tpu.core import se3
    from veloslam_tpu.core.timeline import interpolate_poses
    from veloslam_tpu.decode.decode import compensate, decode_packets
    from veloslam_tpu.decode.frames import assemble_frames
    from veloslam_tpu.registration import gicp
    from veloslam_tpu.registration import voxel as vx
    from veloslam_tpu.runtime import odometry as odo

    (pkts, calib, rel_s, track_rel, track_q, track_t,
     track_v) = bench._build_inputs()
    state = odo.init_state(32, map_capacity=bench.MAP_CAPACITY,
                           sample_assembly=bench.SAMPLE_ASSEMBLY)
    zero = jnp.asarray(0.0, jnp.float32)
    REG_P, ITERS, F = bench.REG_POINTS, bench.REG_ITERATIONS, 96

    def timed(name, fn, *a, reps=args.reps):
        out = fn(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*a)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:46s} {dt*1e3:9.3f} ms", flush=True)
        return out, dt

    # run ONE full step first so the map grid is realistic
    step = functools.partial(
        odo.odometry_step_batched, model="hdl32", n_beams=32,
        reg_points=REG_P, reg_iterations=ITERS, max_frames_batch=F,
        use_dense=True, reassociate_every=8,
        sample_assembly=bench.SAMPLE_ASSEMBLY)
    state2, _ = step(state, pkts, calib, rel_s, zero, zero,
                     track_rel, track_q, track_t, track_v)
    _, t_full = timed("FULL odometry_step_batched", lambda: step(
        state2, pkts, calib, rel_s, zero, zero, track_rel, track_q,
        track_t, track_v)[0].n_frames)

    # --- stage 1: decode ----------------------------------------------------
    dec_j = jax.jit(functools.partial(decode_packets, model="hdl32"))
    dec, t_dec = timed("decode_packets 16384", dec_j, pkts, calib)

    # --- stage 2: compensate ------------------------------------------------
    comp_j = jax.jit(lambda d, r, tr, tq, tt, tv: compensate(
        d, r, tr, tq, tt, tv)[0])
    xyz_w, t_comp = timed("compensate", comp_j, dec, rel_s, track_rel,
                          track_q, track_t, track_v)

    # --- stage 3: sort-select sampling -------------------------------------
    from veloslam_tpu.decode.frames import sample_frames
    sel_j = jax.jit(functools.partial(
        sample_frames, model="hdl32", max_frames=F, points_per_frame=REG_P))
    (sf, n_done, starts, carry2, open_start), t_asm = timed(
        "sample_frames (sort-select)", sel_j, dec, xyz_w, rel_s,
        state2.carry, zero)

    # --- stage 4: local frame transform -------------------------------------
    def sub_fn(pts, st, tr, tq, tt, tv):
        ins = interpolate_poses(tr, tq, tt, tv, st)
        pts_local = jax.vmap(
            lambda q, t, p: se3.apply(se3.inverse(se3.Pose(q, t)), p))(
                ins.q, ins.t, pts)
        return pts_local, ins.q, ins.t
    sub_j = jax.jit(sub_fn)
    (pts_local, ins_q, ins_t), t_sub = timed(
        "to-local transform (96x)", sub_j, sf.xyz, starts,
        track_rel, track_q, track_t, track_v)
    msk = sf.mask

    # --- stage 5: target build (plane grid + dilated index) -----------------
    def tgt_fn(grid):
        target = gicp.plane_grid_from(grid, min_points=4,
                                      min_planarity=0.35)
        dense = vx.build_dilated_index(grid, target.usable)
        return target, dense
    tgt_j = jax.jit(tgt_fn)
    (target, dense), t_tgt = timed("plane_grid_from+dilated index", tgt_j,
                                   state2.map_grid)

    # --- stage 6: registration (associate + GN) ----------------------------
    priors = se3.Pose(ins_q, ins_t)
    reg_j = jax.jit(functools.partial(
        gicp.register_batch, iterations=ITERS, reassociate_every=8))
    _, t_reg = timed("register_batch ra8 16it", reg_j, pts_local, msk,
                     target, priors, dense)

    # associate-only (one pass, vmapped like register_batch)
    assoc_j = jax.jit(jax.vmap(
        lambda p, m, q, t: gicp.associate(
            p, m, se3.Pose(q, t), target, dense)[2].sum(),
        in_axes=(0, 0, 0, 0)))
    _, t_assoc = timed("associate 1 pass (96x16K)", assoc_j, pts_local,
                       msk, ins_q, ins_t)

    # GN-only: 16 fixed-correspondence iterations
    def gn_only(p, m, q, t):
        def one(pl, ml, ql, tl):
            mu, n, hit = gicp.associate(pl, ml, se3.Pose(ql, tl), target,
                                        dense)
            def body(_, pose):
                H, b, err, nh = gicp.normal_equations_fixed(
                    pl, pose, mu, n, hit)
                delta = -jax.scipy.linalg.cho_solve(
                    jax.scipy.linalg.cho_factor(
                        H + 1e-4 * jnp.eye(6)), b)
                return se3.retract(pose, delta * 0.0)
            return jax.lax.fori_loop(0, ITERS, body,
                                     se3.Pose(ql, tl)).t.sum()
        return jax.vmap(one)(p, m, q, t)
    gn_j = jax.jit(gn_only)
    _, t_gn = timed("associate+16 GN-only iters", gn_j, pts_local, msk,
                    ins_q, ins_t)

    # --- stage 7: map update ------------------------------------------------
    def map_fn(est_q, est_t, pl, m, grid):
        pts_world = jax.vmap(
            lambda q, t, p: se3.apply(se3.Pose(q, t), p))(est_q, est_t, pl)
        scan = vx.build_grid(pts_world.reshape(-1, 3), m.reshape(-1),
                             grid.origin, grid.voxel_size, capacity=16384)
        return vx.merge_stats(grid._replace(count=grid.count * 0.98),
                              scan, capacity=grid.capacity)
    map_j = jax.jit(map_fn)
    _, t_map = timed("map update (build_grid 1.57M+merge)", map_j,
                     ins_q, ins_t, pts_local, msk, state2.map_grid)

    bg_j = jax.jit(functools.partial(vx.build_grid, capacity=16384))
    _, t_bg = timed("  build_grid 1.57M alone", bg_j,
                    pts_local.reshape(-1, 3), msk.reshape(-1),
                    state2.map_grid.origin, state2.map_grid.voxel_size)

    acc = (t_dec + t_comp + t_asm + t_sub + t_tgt + t_reg + t_map)
    print(f"\n# stage sum {acc*1e3:.0f} ms vs full {t_full*1e3:.0f} ms "
          f"(gap = fusion wins + dispatch floors)", flush=True)


if __name__ == "__main__":
    main()
