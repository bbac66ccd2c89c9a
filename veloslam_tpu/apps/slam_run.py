"""CLI: run the SLAM pipeline over a pcap + INS log (or a simulated drive).

The SlamMain/SimpleHDLTester equivalent (reference SlamMain.cpp,
SimpleHDLTester.cxx) as a headless tool: decodes a sequence, runs
odometry/mapping/loop closure, writes the trajectory and metrics, and
optionally evaluates ATE/RPE against ground truth.

Usage:
  python -m veloslam_tpu.apps.slam_run --pcap drive.pcap --ins drive_ins.txt
  python -m veloslam_tpu.apps.slam_run --simulate 2.0 --out-dir /tmp/out
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcap", help="input pcap file")
    ap.add_argument("--ins", help="INS text log (reference format)")
    ap.add_argument("--model", default="hdl32",
                    choices=["hdl32", "vlp16", "hdl64"])
    ap.add_argument("--calibration", help="Velodyne XML calibration file")
    ap.add_argument("--lasers", metavar="SPEC",
                    help="laser selection: comma list of wire laser ids "
                         "and ranges, e.g. '0,2,4-15' (default: all)")
    ap.add_argument("--out-dir", default="slam_out")
    ap.add_argument("--max-packets", type=int)
    ap.add_argument("--simulate", type=float, metavar="SECONDS",
                    help="generate a synthetic drive instead of reading "
                         "files; also enables ATE evaluation")
    ap.add_argument("--ins-drift", type=float, default=0.0,
                    help="with --simulate: inject linear INS drift (m/s)")
    ap.add_argument("--checkpoint-dir", help="save a resumable checkpoint")
    ap.add_argument("--gt", help="ground-truth trajectory txt "
                                 "(t_us x y z per row) for ATE")
    ap.add_argument("--platform", choices=["cpu", "gpu", "default"],
                    default="default")
    ap.add_argument("--bev", nargs="?", const="bev.html", metavar="FILE",
                    help="write an interactive BEV trajectory artifact "
                         "(self-contained HTML; default bev.html in "
                         "--out-dir) — the headless SLAMViewer")
    ap.add_argument("--fast", action="store_true",
                    help="bulk odometry-only fast path: all frames of a "
                         "large packet batch register in one device "
                         "program (no keyframes/loop closure/map "
                         "patches); use for high-throughput odometry "
                         "replay")
    ap.add_argument("--batched", action="store_true",
                    help="FULL SLAM at bulk-replay rate: device-resident "
                         "keyframe ring + scan-context descriptors in the "
                         "odometry program, then loop closure + graph "
                         "solve + map rebuild at finalize "
                         "(SlamPipeline.run_offline_batched)")
    ap.add_argument("--batch", type=int, default=8192,
                    help="packets per device dispatch "
                         "(--fast / --batched modes)")
    args = ap.parse_args(argv)

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    from veloslam_tpu.utils import compilecache
    compilecache.enable()

    from veloslam_tpu.config import SensorConfig, SlamConfig
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions, rpe
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    os.makedirs(args.out_dir, exist_ok=True)
    laser_mask = None
    if args.lasers:
        ids = []
        for part in args.lasers.split(","):
            if "-" in part:
                a, b = part.split("-")
                ids.extend(range(int(a), int(b) + 1))
            else:
                ids.append(int(part))
        laser_mask = tuple(sorted(set(ids)))
    cfg = SlamConfig(sensor=SensorConfig(
        model=args.model, calibration_path=args.calibration,
        laser_mask=laser_mask))
    pipe = SlamPipeline(cfg, spill_dir=os.path.join(args.out_dir, "spill"))

    gt = None
    if args.simulate:
        from veloslam_tpu.io import simulate as sim
        print(f"simulating {args.simulate}s {args.model} drive ...")
        seq = sim.generate_sequence(duration_s=args.simulate,
                                    model=args.model)
        paths = sim.write_sequence(seq, args.out_dir, name="sim")
        gt = {"t_us": seq["ins_t_us"], "pos": seq["ins_pos"]}
        if args.ins_drift > 0:
            # corrupt the INS log with a linear drift for SLAM to correct
            from veloslam_tpu.io import packets as pkmod
            ins = pkmod.read_ins_txt(paths["ins"])
            ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
            drift = np.stack([args.ins_drift * ts,
                              0.5 * args.ins_drift * ts], -1)
            pkmod.write_ins_txt(paths["ins"], ins["t_us"],
                                ins["pos_xy"] + drift,
                                np.deg2rad(ins["yaw_deg"]),
                                speed=ins["speed"])
        pcap_path, ins_path = paths["pcap"], paths["ins"]
    else:
        if not args.pcap:
            ap.error("--pcap required (or use --simulate)")
        pcap_path, ins_path = args.pcap, args.ins

    if args.fast:
        import time as _time

        from veloslam_tpu.decode import calibration
        from veloslam_tpu.decode.decode import DeviceCalib
        from veloslam_tpu.io.pcap import read_lidar_packets
        from veloslam_tpu.runtime.odometry import (StreamingOdometry,
                                                   slots_for_batch)

        if ins_path:
            pipe.feed_ins_txt(ins_path)
        pkts, times, _ = read_lidar_packets(pcap_path, args.max_packets)
        calib_tbl = (calibration.from_xml(args.calibration)
                     if args.calibration
                     else calibration.default_for(args.model))
        slots = slots_for_batch(args.model, args.batch)
        odo = StreamingOdometry(
            DeviceCalib.from_host(calib_tbl,
                                  enabled=cfg.sensor.enabled_lasers()),
            model=args.model, n_beams=calib_tbl.n_lasers, batched=True)
        t0 = _time.perf_counter()
        res = odo.run(pkts, times, pipe.track, batch=args.batch)
        wall = _time.perf_counter() - t0
        res.update(registered_fraction=1.0, n_keyframes=0, n_closures=0,
                   map_patches=0,
                   timing={"wall_s": round(wall, 3),
                           "frames_per_s": round(res["n_frames"] / wall, 1)
                           if wall > 0 else None})
        print(f"fast path: {res['n_frames']} frames in {wall:.2f}s "
              f"({res['n_frames']/max(wall,1e-9):,.0f} frames/s, "
              f"batch={args.batch}, slots={slots})")
    elif args.batched:
        import time as _time
        t0 = _time.perf_counter()
        pipe.run_offline_batched(pcap_path, ins_path,
                                 max_packets=args.max_packets,
                                 batch=args.batch)
        res = pipe.finalize()
        wall = _time.perf_counter() - t0
        res["timing"] = dict(res["timing"], wall_s=round(wall, 3),
                             frames_per_s=round(
                                 res["n_frames"] / max(wall, 1e-9), 1))
        print(f"batched full SLAM: {res['n_frames']} frames, "
              f"{res['n_keyframes']} keyframes, {res['n_closures']} "
              f"closures, {res['n_landmarks']} landmarks in {wall:.2f}s "
              f"({res['n_frames']/max(wall,1e-9):,.0f} frames/s)")
    else:
        res = pipe.run_offline(pcap_path, ins_path,
                               max_packets=args.max_packets)

    traj_path = os.path.join(args.out_dir, "trajectory.txt")
    with open(traj_path, "w") as f:
        for t, p, q in zip(res["times_us"], res["positions"],
                           res["quaternions"]):
            f.write(f"{t} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    metrics = {k: v for k, v in res.items()
               if k in ("registered_fraction", "n_frames", "n_keyframes",
                        "n_closures", "map_patches", "timing")}

    if args.gt:
        raw = np.loadtxt(args.gt, ndmin=2)
        gt = {"t_us": raw[:, 0].astype(np.int64), "pos": raw[:, 1:4]}
    if gt is not None and res["n_frames"] > 2:
        ref = interpolate_positions(res["times_us"], gt["t_us"], gt["pos"])
        # planar metrics: the reference INS text format carries no z, so the
        # estimate's z datum is arbitrary
        metrics["ate"] = ate(res["positions"][:, :2], ref[:, :2],
                             align=False)
        metrics["rpe"] = rpe(res["positions"][:, :2], ref[:, :2])

    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2, default=str)

    if args.checkpoint_dir:
        pipe.save_checkpoint(args.checkpoint_dir)

    if args.bev:
        from veloslam_tpu.utils.viewer import write_bev_html
        occ_xy, posts_xy = pipe.map.bev_layers()
        ins_xy = (np.asarray([gt["pos"][i][:2]
                              for i in range(len(gt["t_us"]))])
                  if gt is not None else None)
        bev_path = (args.bev if os.path.isabs(args.bev)
                    else os.path.join(args.out_dir, args.bev))
        write_bev_html(bev_path, res, ins_xy=ins_xy,
                       landmarks_xy=posts_xy, occupancy_xy=occ_xy,
                       closures=pipe.closures,
                       title=f"veloslam_tpu — {os.path.basename(pcap_path)}")
        print(f"BEV artifact: {bev_path}")

    print(f"frames: {res['n_frames']}  keyframes: {res['n_keyframes']}  "
          f"closures: {res['n_closures']}  "
          f"registered: {res['registered_fraction']:.0%}")
    if "ate" in metrics:
        print(f"ATE rmse: {metrics['ate']['rmse']:.3f} m  "
              f"median: {metrics['ate']['median']:.3f} m")
    print(pipe.timers.report())
    print(f"outputs in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
