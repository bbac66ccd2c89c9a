"""Fine-grained wall profile of the full-SLAM finalize tail on the live
backend (VERDICT r4 #3): where do graph_solve / map_downdate / readback
actually spend their time?

Replicates bench.run_full_slam's measured run but times each finalize
sub-step individually:
  - stream execution (scalar sync after run_device)
  - finalize queue dispatch
  - sweep execution (first scalar readback after the queue)
  - per-leaf device->host transfer of the dev dict
  - ring slice reads (kf_pts / kf_msk / kf_desc)
  - host graph mirror loop
  - landmark extract / associate / solve
  - rebuild_map (chunk dispatch+readback vs host integrate split)

Run ONE per card at a time (a JAX process reserves most of its memory):
  timeout 900 python scripts/profile_finalize.py
"""
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax

    from bench import _make_drive, _slam_cfg
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline
    from veloslam_tpu.utils import compilecache
    compilecache.enable()

    duration_s = float(sys.argv[1]) if len(sys.argv) > 1 else 7.0
    t_all = time.perf_counter()
    SlamPipeline(_slam_cfg()).warmup_batched(duration_s=duration_s,
                                             batch=16384)
    print(f"# warmup {time.perf_counter()-t_all:.1f}s", flush=True)

    paths, seq = _make_drive(duration_s)
    pipe = SlamPipeline(_slam_cfg())
    T = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        T[name] = round(time.perf_counter() - t0, 3)
        return out

    t0_wall = time.perf_counter()
    # --- stream ---
    from veloslam_tpu.io.pcap import read_lidar_packets
    from veloslam_tpu.runtime.fullslam import FullSlam
    pkts, times, _ = read_lidar_packets(paths["pcap"])
    pipe.feed_ins_txt(paths["ins"])
    times = pipe._ground_offline_times(paths["pcap"], pkts, times)
    sc_, rc, gc = pipe.cfg.sensor, pipe.cfg.registration, pipe.cfg.graph
    eng = FullSlam(pipe.dcalib, model=sc_.model, n_beams=sc_.n_lasers,
                   voxel_size=rc.voxel_size, reg_points=rc.max_points,
                   reg_iterations=rc.max_iterations,
                   kf_capacity=gc.max_keyframes,
                   kf_dist_m=gc.keyframe_translation_m,
                   kf_rot_deg=gc.keyframe_rotation_deg,
                   use_dense=rc.use_dense_index,
                   reassociate_every=rc.reassociate_every,
                   frame_rate_hz=sc_.rpm / 60.0)
    # Instrument the feed loop: time each device_put and each feed()
    # dispatch separately (is the 169 s "dispatch" H2D, per-feed
    # blocking, or compile?).
    import veloslam_tpu.runtime.odometry as odmod
    orig_feed = type(eng).feed
    feed_times = []

    def timed_feed(self, pk, ts, w):
        t1 = time.perf_counter()
        orig_feed(self, pk, ts, w)
        feed_times.append(round(time.perf_counter() - t1, 3))

    type(eng).feed = timed_feed
    try:
        clock("stream_dispatch", lambda: eng.run_device(
            pkts, times, pipe.track, batch=16384))
    finally:
        type(eng).feed = orig_feed
    T["per_feed_s"] = feed_times
    # NOTE: no sync here — production queues the sweep before any readback.
    dev = clock("finalize_queue", lambda: eng.finalize_device(
        min_score=gc.sc_min_score, radius=gc.loop_closure_radius_m,
        min_gap=gc.loop_closure_min_gap,
        max_candidates=pipe._sweep_budget(
            eng, gc.max_closure_candidates_per_sweep),
        use_scan_context=gc.use_scan_context,
        gn_iterations=gc.gn_iterations, odom_info=gc.odom_edge_info,
        closure_info=gc.closure_edge_info, voxel_size=rc.voxel_size,
        capacity=rc.scan_voxel_capacity))
    # First scalar readback gates stream + sweep EXECUTION.
    n_kf = clock("exec_wait_first_scalar", lambda: int(dev["kf_n"]))
    # Per-leaf transfers.
    host = {}
    t0 = time.perf_counter()
    leaf_times = {}
    for k, v in dev.items():
        t1 = time.perf_counter()
        host[k] = np.asarray(v)
        leaf_times[k] = round(time.perf_counter() - t1, 3)
    T["leaf_transfers_total"] = round(time.perf_counter() - t0, 3)
    T["leaf_transfers"] = leaf_times
    r = eng.ring
    clock("ring_pts_slice", lambda: host.update(
        kf_pts=np.asarray(r.pts[:n_kf])))
    clock("ring_msk_desc_slice", lambda: host.update(
        kf_msk=np.asarray(r.msk[:n_kf]),
        kf_desc=np.asarray(r.desc[:n_kf])))
    T["ring_pts_MB"] = round(host["kf_pts"].nbytes / 1e6, 1)

    # Host mirror (graph bookkeeping): production loop on the
    # already-transferred dict (pipeline._mirror_device_results).
    clock("host_mirror",
          lambda: pipe._mirror_device_results(eng, host, defer_map=True))

    # finalize(): landmark stage + solve + rebuild, individually.
    clock("landmark_stage", pipe.add_landmark_observations)
    from veloslam_tpu.runtime import pipeline as pl

    if pipe.graph.n_obs > 0:
        out = clock("graph_solve_landmarks",
                    lambda: pipe._solve_graph_landmarks(pipe.graph.arrays()))
        # Steady-state cost (2nd call, same shapes): separates the
        # first-call compile from the per-solve cost.
        clock("graph_solve_landmarks_2nd",
              lambda: pipe._solve_graph_landmarks(pipe.graph.arrays()))
        pipe.graph.update_from(
            np.asarray(out.q)[:pipe.graph.n_poses],
            np.asarray(out.t)[:pipe.graph.n_poses],
            np.asarray(out.l_pos)[:pipe.graph.n_landmarks])
    clock("rebuild_map", pipe.rebuild_map)
    if pipe._kf_pose_at_creation:
        old_q = np.stack([q for q, _ in pipe._kf_pose_at_creation])
        old_t = np.stack([t for _, t in pipe._kf_pose_at_creation])
        clock("correct_trajectory",
              lambda: pipe._correct_trajectory(old_q, old_t))
    wall = time.perf_counter() - t0_wall

    res = pipe.results()
    ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                seq["ins_pos"])
    m = ate(res["positions"][:, :2], ref[:, :2], align=False)
    print(json.dumps({
        "wall_s": round(wall, 3),
        "x_realtime": round(res["n_frames"] / wall / 10.0, 2),
        "n_frames": res["n_frames"], "n_keyframes": res["n_keyframes"],
        "n_closures": res["n_closures"], "n_obs": res["n_landmark_obs"],
        "ate_rmse_m": round(m["rmse"], 4),
        "timings_s": T,
    }, indent=1), flush=True)


if __name__ == "__main__":
    main()
