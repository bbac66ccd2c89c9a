"""Run the SLAM main path once on a GPU, through the user entry points, and
check what comes out.

    python chip_smoke.py               # one GPU: phases 1-4 below
    python chip_smoke.py --four-gpus   # four GPUs: the multi-device path only

Phases (one GPU):
  1. device gate: a GPU or a non-zero exit; card name and power limit;
     compile-cache directory.
  2. bulk odometry at the bench shape (bench.run_bulk's static arguments):
     `odometry_step_batched` compiled for the card, its memory analysis and
     step time; then the same step on the in-process CPU device, compared
     per decoded point, per frame-slot pose and per matched count.
  3. full SLAM (`SlamPipeline.run_offline_batched` + `finalize`) on the
     bench's 20 s loop drive with drifting INS, checked against simulator
     ground truth: frame count, loop closures, ATE.
  4. streaming (`SlamPipeline.run_offline`, the 512-packet default) on a
     3 s drive with an ATE bound, and one live loopback at 1x sensor rate
     that must drop no packet.

`--four-gpus` runs only the multi-device path (__graft_entry__.run_multichip:
map-sharded and halo registration, the edge-sharded graph step, and the
two-owner DistributedSlamSession against its single-process oracle).

The last stdout line is {"ok": true, "device": {...}}; any failed check
raises, so the process exits non-zero and prints no such line.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# GPU-vs-CPU tolerances of the bulk step.  Decode is elementwise float32;
# poses come out of 16 Gauss-Newton iterations whose correspondences are
# discrete (a point can change voxel), so they get a physical bound.  On an
# H100 the bench step measured 7.6e-6 m (xyz), 5.3e-6 m and 4.8e-7 rad
# (poses) and 6.4e-5 (matched counts); the bounds keep 6-200x of headroom.
XYZ_TOL_M = 5e-5
POSE_T_TOL_M = 1e-3
POSE_R_TOL_RAD = 1e-4
MATCHED_REL_TOL = 2e-3
# Full-SLAM gate (the slow-tier test on the same drive,
# tests/test_fullslam.py::test_bench_drive_ate_gate).
FULL_ATE_MAX_M = 0.15
FULL_FRAMES = (180, 220)
# Streaming gate: the repository's bound for drifting-INS runs of the
# per-frame path (tests/test_pipeline.py::test_pipeline_corrects_ins_drift).
STREAM_ATE_MAX_M = 0.3


def log(msg: str) -> None:
    print(msg, flush=True)


def device_gate(count: int = 1):
    """Phase 1: the default JAX devices must be `count` GPUs.  Exits
    non-zero otherwise — the smoke never carries on on the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPU(s), JAX found "
                         f"{len(devs)} {devs[0].platform} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    from veloslam_tpu.utils import compilecache

    log(f"[gate] jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    for line in smi.stdout.strip().splitlines():
        log(f"[gate] nvidia-smi: {line}")
    log(f"[gate] compile cache: {compilecache.enable()}")
    return devs


def _ins_track(seq):
    """PoseTrack of the simulator's clean INS (ground truth pose feed)."""
    from veloslam_tpu.core import se3
    from veloslam_tpu.core.timeline import PoseTrack

    track = PoseTrack()
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        track.add(int(t_us),
                  q=se3.euler_deg_to_quat_np(0.0, 0.0,
                                             float(np.rad2deg(yaw))),
                  t=np.asarray(p, float), v=v)
    return track


def _bulk_batches(seq, batch_packets: int, n_batches: int):
    """Host inputs of consecutive bulk batches, in odometry-step argument
    order minus the state and the carried open-frame start."""
    from veloslam_tpu.runtime.odometry import StreamingOdometry

    track = _ins_track(seq)
    pkts, times = seq["packets"], seq["pkt_times_us"]
    assert len(pkts) >= n_batches * batch_packets, len(pkts)
    t0 = int(times[0])
    out = []
    for k in range(n_batches):
        sl = slice(k * batch_packets, (k + 1) * batch_packets)
        anchor = int(times[sl][0])
        w = StreamingOdometry._pad_window(
            track.window(anchor, int(times[sl][-1]), anchor_us=anchor))
        out.append(dict(
            pkts=pkts[sl], anchor=anchor,
            rel=((times[sl] - anchor) * 1e-6).astype(np.float32),
            batch_rel=np.float32((anchor - t0) * 1e-6),
            trk=(w["rel_s"], w["q"], w["t"], w["v"])))
    return out


def _run_chain(fn, state, batches, calib, device):
    """Feed `batches` through `fn` on `device`, carrying state and the
    open-frame start like StreamingOdometry.feed; returns every output."""
    import jax
    import jax.numpy as jnp

    put = lambda x: jax.device_put(x, device)     # noqa: E731
    state, calib = put(state), put(calib)
    open_dev, prev_anchor, outs = put(jnp.float32(0.0)), None, []
    for b in batches:
        shift = 0.0 if prev_anchor is None else (prev_anchor - b["anchor"])
        carry = open_dev + put(jnp.float32(shift * 1e-6))
        out = fn(state, put(b["pkts"]), calib, put(b["rel"]), carry,
                 put(b["batch_rel"]), *map(put, b["trk"]))
        state, open_dev = out[0], out[1]
        prev_anchor = b["anchor"]
        outs.append(out)
    return outs


def _quat_angle(qa, qb):
    """Rotation angle between unit quaternions (stable near zero, where
    2·arccos(|qa·qb|) loses float32 inputs' last bits to the arccos)."""
    qa, qb = (np.asarray(q, np.float64) for q in (qa, qb))
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    qb = qb * np.sign(np.sum(qa * qb, axis=-1, keepdims=True) + 1e-300)
    return 4.0 * np.arctan2(np.linalg.norm(qa - qb, axis=-1),
                            np.linalg.norm(qa + qb, axis=-1))


def bulk_phase(gpu, cpu, seq, *, batch_packets=None, max_frames_batch=None,
               reg_points=None, map_capacity=None, timed_steps=3):
    """Phase 2.  Sizes default to the bench's; smaller ones rehearse the
    phase on the CPU."""
    import functools

    import jax

    import bench
    from veloslam_tpu.decode import calibration
    from veloslam_tpu.decode.decode import DeviceCalib, decode_packets
    from veloslam_tpu.runtime import odometry as odo

    B = batch_packets or bench.BATCH_PACKETS
    kw = dict(model="hdl32", n_beams=32,
              reg_points=reg_points or bench.REG_POINTS,
              reg_iterations=bench.REG_ITERATIONS,
              max_frames_batch=max_frames_batch or bench.MAX_FRAMES_BATCH,
              use_dense=True, reassociate_every=bench.REASSOCIATE_EVERY,
              sample_assembly=bench.SAMPLE_ASSEMBLY,
              # odometry_step_batched's defaults, which bench.run_bulk keeps
              min_points=4, min_planarity=0.35)
    state0 = odo.init_state(32, map_capacity=map_capacity
                            or bench.MAP_CAPACITY,
                            voxel_size=bench.VOXEL_SIZE,
                            sample_assembly=bench.SAMPLE_ASSEMBLY)
    calib = DeviceCalib.from_host(calibration.hdl32())
    # Batch 1 builds the map from INS priors, batch 2 registers against it.
    batches = _bulk_batches(seq, B, 2)

    # The bench's program, compiled for the card.
    args1 = jax.device_put(
        (state0, batches[0]["pkts"], calib, batches[0]["rel"],
         np.float32(0.0), batches[0]["batch_rel"], *batches[0]["trk"]), gpu)
    t0 = time.perf_counter()
    step = odo.odometry_step_batched.lower(*args1, **kw).compile()
    log(f"[bulk] odometry_step_batched compiled in "
        f"{time.perf_counter() - t0:.1f} s for {gpu.device_kind}")
    log(f"[bulk] memory_analysis: {step.memory_analysis()}")
    outs = _run_chain(step, state0, batches, calib, gpu)
    state2 = jax.block_until_ready(outs[-1][0])
    args2 = (state2, *jax.device_put(
        (batches[1]["pkts"], calib, batches[1]["rel"], np.float32(0.0),
         batches[1]["batch_rel"], *batches[1]["trk"]), gpu))
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        out = step(*args2)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / timed_steps * 1e3
    log(f"[bulk] step: {ms:.3f} ms per {B}-packet batch "
        f"(mean of {timed_steps}, {gpu.device_kind})")

    # Same step body on both devices, with the per-slot results exposed.
    core = jax.jit(functools.partial(odo._batched_core, **kw))
    res = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        outs = _run_chain(core, state0, batches, calib, dev)
        st, _, slots = jax.device_get(outs[-1])
        log(f"[bulk] {name}: 2 batches (compile included) in "
            f"{time.perf_counter() - t0:.1f} s")
        dec = jax.device_get(jax.jit(decode_packets, static_argnames="model")(
            jax.device_put(batches[1]["pkts"], dev),
            jax.device_put(calib, dev), model="hdl32"))
        res[name] = (st, slots, dec)
    (sg, g, dg), (sc, c, dc) = res["gpu"], res["cpu"]

    assert np.array_equal(dg.valid, dc.valid), "decode masks differ"
    dxyz = float(np.abs(dg.xyz - dc.xyz)[dc.valid].max())
    log(f"[bulk] decoded xyz: {int(dc.valid.sum())} points, max |gpu-cpu| "
        f"{dxyz:.3e} m (tol {XYZ_TOL_M})")
    assert dxyz <= XYZ_TOL_M, dxyz
    assert np.array_equal(g.done, c.done), "completed frame slots differ"
    done = c.done
    assert done.sum() > 0 and int(sg.n_frames) == int(sc.n_frames)
    dt = np.linalg.norm(g.est_t - c.est_t, axis=-1)[done]
    dr = _quat_angle(g.est_q, c.est_q)[done]
    mg, mc = (g.n_matched[done].astype(np.int64),
              c.n_matched[done].astype(np.int64))
    dm = np.abs(mg - mc) / np.maximum(np.maximum(mg, mc), 1)
    log(f"[bulk] {int(done.sum())} registered slots: max |dt| "
        f"{dt.max():.3e} m (tol {POSE_T_TOL_M}), max |dR| {dr.max():.3e} "
        f"rad (tol {POSE_R_TOL_RAD}), matched {int(mc.min())}-"
        f"{int(mc.max())}, max rel diff {dm.max():.3e} "
        f"(tol {MATCHED_REL_TOL})")
    assert mc.min() > 500, "batch-2 slots did not register"
    assert dt.max() <= POSE_T_TOL_M, dt.max()
    assert dr.max() <= POSE_R_TOL_RAD, dr.max()
    assert dm.max() <= MATCHED_REL_TOL, dm.max()


def full_slam_phase(paths, seq, *, batch=4096, frames=FULL_FRAMES):
    """Phase 3: run twice on the same drive — the first run includes every
    compile, the second shows the warm stage times.  Both are checked."""
    import bench
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    for label in ("cold", "warm"):
        pipe = SlamPipeline(bench._slam_cfg())
        t0 = time.perf_counter()
        pipe.run_offline_batched(paths["pcap"], paths["ins"], batch=batch,
                                 defer_map=True)
        res = pipe.finalize()
        wall = time.perf_counter() - t0
        ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                    seq["ins_pos"])
        m = ate(res["positions"][:, :2], ref[:, :2], align=False)
        stage_s = {k: round(v["total_s"], 3)
                   for k, v in sorted(res["timing"].items())}
        log(f"[full] {label}: {res['n_frames']} frames, "
            f"{res['n_keyframes']} keyframes, {res['n_closures']} closures, "
            f"ATE {m['rmse']:.4f} m (max {FULL_ATE_MAX_M}), "
            f"wall {wall:.2f} s")
        log(f"[full] {label} stage_s: {json.dumps(stage_s)}")
        assert frames[0] <= res["n_frames"] <= frames[1], res["n_frames"]
        assert res["n_closures"] >= 1, "no loop closure"
        assert np.isfinite(res["positions"]).all()
        assert m["rmse"] <= FULL_ATE_MAX_M, m


def stream_phase(duration_s=3.0, live_s=5.0):
    """Phase 4: the per-frame streaming path and one live loopback."""
    import bench
    from veloslam_tpu.apps.replay import measure_live_loopback
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    paths, seq = bench._make_drive(duration_s)
    pipe = SlamPipeline()
    t0 = time.perf_counter()
    res = pipe.run_offline(paths["pcap"], paths["ins"])
    wall = time.perf_counter() - t0
    ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                seq["ins_pos"])
    m = ate(res["positions"][:, :2], ref[:, :2], align=False)
    log(f"[stream] run_offline: {res['n_frames']} frames, registered "
        f"{res['registered_fraction']:.2f}, ATE {m['rmse']:.4f} m "
        f"(max {STREAM_ATE_MAX_M}), wall {wall:.2f} s (compile included)")
    assert res["n_frames"] >= 0.8 * duration_s * 10, res["n_frames"]
    assert m["rmse"] <= STREAM_ATE_MAX_M, m

    live = measure_live_loopback(duration_s=live_s, rate=1.0)
    log(f"[live] {json.dumps(live)}")
    assert live["received_lidar"] > 0
    assert live["receiver_dropped"] == 0 and live["lost"] == 0, live


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-device path, on 4 GPUs")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    if args.four_gpus:
        devs = device_gate(4)[:4]
        import __graft_entry__

        out = __graft_entry__.run_multichip(devs)
        log(f"[multi] {json.dumps(out)}")
    else:
        devs = device_gate(1)[:1]
        import jax

        import bench

        t0 = time.perf_counter()
        paths, seq = bench._make_drive(20.0)
        log(f"[data] 20 s loop drive simulated in "
            f"{time.perf_counter() - t0:.1f} s")
        bulk_phase(devs[0], jax.devices("cpu")[0], seq)
        full_slam_phase(paths, seq)
        stream_phase()
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
