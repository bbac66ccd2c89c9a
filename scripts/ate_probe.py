"""ATE bisect probe (VERDICT r4 #2): run the bench full-SLAM drive on the
CPU backend (accuracy only — no perf claims) with config/code toggles, so
the r3→r4 ATE regression (0.0814 → 0.1366 m on the committed bench drive)
can be attributed to a specific change and gated.

Usage:
  JAX_PLATFORMS=cpu python scripts/ate_probe.py [--seed 3] [--duration 7]
      [--landmark-info X] [--no-landmarks] [--closure-info R T]
      [--gn-iters N] [--reassoc N] [--label tag]

Prints one JSON line: {"label":..., "ate_rmse_m":..., "n_closures":...,
"n_landmarks":..., "n_obs":...}.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

# Backend: the default platform (the GPU where there is one).  --cpu pins
# the CPU platform BEFORE any jax use.  A JAX process reserves most of a
# GPU's memory, so run ONE probe per card at a time.
if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--duration", type=float, default=7.0)
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--landmark-info", type=float, default=None)
    ap.add_argument("--no-landmarks", action="store_true")
    ap.add_argument("--closure-info", type=float, nargs=2, default=None,
                    help="rot trans")
    ap.add_argument("--odom-info", type=float, nargs=2, default=None)
    ap.add_argument("--gn-iters", type=int, default=None)
    ap.add_argument("--trim", type=float, default=None)
    ap.add_argument("--min-obs", type=int, default=None)
    ap.add_argument("--cluster-radius", type=float, default=None)
    ap.add_argument("--reassoc", type=int, default=None)
    ap.add_argument("--huber", type=float, default=None)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--label", default="default")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--verify-reassoc", type=int, default=None,
                    help="closure-verification re-association period "
                         "(r3 behavior = 1)")
    args = ap.parse_args()

    from veloslam_tpu.utils import compilecache
    compilecache.enable()
    if args.verify_reassoc is not None:
        from veloslam_tpu.runtime import devfinalize
        devfinalize.VERIFY_REASSOCIATE_EVERY = args.verify_reassoc

    from bench import _make_drive, _slam_cfg
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = _slam_cfg()
    gc = cfg.graph
    import dataclasses
    g_kw = {}
    if args.landmark_info is not None:
        g_kw["landmark_obs_info"] = args.landmark_info
    if args.no_landmarks:
        g_kw["use_landmarks"] = False
    if args.closure_info is not None:
        r, t = args.closure_info
        g_kw["closure_edge_info"] = (r,) * 3 + (t,) * 3
    if args.odom_info is not None:
        r, t = args.odom_info
        g_kw["odom_edge_info"] = (r,) * 3 + (t,) * 3
    if args.gn_iters is not None:
        g_kw["gn_iterations"] = args.gn_iters
    if args.trim is not None:
        g_kw["landmark_trim_residual_m"] = args.trim
    if args.min_obs is not None:
        g_kw["landmark_min_observations"] = args.min_obs
    if args.cluster_radius is not None:
        g_kw["landmark_cluster_radius_m"] = args.cluster_radius
    if g_kw:
        gc = dataclasses.replace(gc, **g_kw)
    rc = cfg.registration
    if args.reassoc is not None:
        rc = dataclasses.replace(rc, reassociate_every=args.reassoc)
    cfg = dataclasses.replace(cfg, graph=gc, registration=rc)
    if args.huber is not None:
        import veloslam_tpu.graph.optimize as opt
        import functools
        opt._assemble_landmark_terms = functools.partial(
            opt._assemble_landmark_terms, obs_huber_delta=args.huber)

    paths, seq = _make_drive(args.duration, seed=args.seed,
                             drift=args.drift)
    pipe = SlamPipeline(cfg)
    t0 = time.perf_counter()
    pipe.run_offline_batched(paths["pcap"], paths["ins"], batch=args.batch,
                             defer_map=True)
    res = pipe.finalize()
    wall = time.perf_counter() - t0
    ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                seq["ins_pos"])
    m = ate(res["positions"][:, :2], ref[:, :2], align=False)
    kf_ref = interpolate_positions(res["keyframe_times_us"],
                                   seq["ins_t_us"], seq["ins_pos"])
    mk = ate(res["keyframe_positions"][:, :2], kf_ref[:, :2], align=False)
    from veloslam_tpu.runtime.evaluate import rpe
    mr = rpe(res["positions"][:, :2], ref[:, :2], delta=10)
    g = pipe.graph
    print(json.dumps({
        "label": args.label,
        "ate_rmse_m": round(m["rmse"], 4),
        "ate_max_m": round(m["max"], 4),
        "kf_ate_rmse_m": round(mk["rmse"], 4),
        "rpe10_rmse_m": round(mr["rmse"], 4),
        "n_closures": res["n_closures"],
        "n_keyframes": res["n_keyframes"],
        "n_landmarks": res["n_landmarks"],
        "n_obs": res["n_landmark_obs"],
        "n_obs_trimmed": int((~g.o_ok[:g.n_obs]).sum()),
        "wall_s": round(wall, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
