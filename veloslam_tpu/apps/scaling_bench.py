"""Scaling-efficiency harness: SLAM kernels across mesh sizes.

Measures the distributed registration + pose-graph steps on meshes of
1..N devices and reports throughput + efficiency vs the single-device
run (the BASELINE scaling methodology: 1 chip / 1 host / N hosts).

On a multi-GPU host this measures real interconnect scaling.  On a single
device it reports N=1 only.  On CPU with --virtual N it exercises the same
collective code paths over XLA's virtual host devices — useful for
regression-testing the communication structure, NOT a hardware scaling
number (virtual devices share one CPU).

`--processes N` spawns N CPU-only worker processes (Gloo collectives): each
worker pins the CPU platform before it touches JAX and never opens a GPU,
so the harness can run beside a process that holds the card.

Multi-host usage: run under `jax.distributed.initialize()` on every host;
the mesh then spans all global devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _timeit(fn, *args, iters=10):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _run_multiprocess(nprocs: int, argv_rest) -> int:
    """Spawn nprocs OS processes (1 CPU device each, Gloo collectives) and
    run the worker path in each — the single-machine approximation of N
    hosts."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    import os
    env = dict(os.environ, JAX_PLATFORMS="cpu")   # workers never open a GPU
    procs = [subprocess.Popen(
        [sys.executable, "-m", "veloslam_tpu.apps.scaling_bench",
         "--worker", f"{pid}:{nprocs}:{port}"] + list(argv_rest),
        env=env) for pid in range(nprocs)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def _worker_session(args) -> int:
    """Per-process body of --processes --session mode: drive the FULL
    DistributedSlamSession (tile-partitioned map, cached global ROI,
    shard_map registration) over a short simulated drive and report
    ms/frame + the register-stage share — the session-step cost VERDICT
    r2 asked to measure after the per-frame host loop was batched."""
    import jax

    from veloslam_tpu.config import (GraphConfig, PipelineConfig,
                                     RegistrationConfig, SlamConfig)
    from veloslam_tpu.core import se3
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.parallel import dist
    from veloslam_tpu.parallel.session import DistributedSlamSession

    cfg = SlamConfig(
        pipeline=PipelineConfig(packets_per_batch=128),
        registration=RegistrationConfig(max_points=args.points,
                                        max_iterations=args.iters),
        graph=GraphConfig(use_landmarks=False))
    seq = sim.generate_sequence(duration_s=args.session_s, model="hdl32",
                                seed=21, world=sim.World.demo(9))
    sess = DistributedSlamSession(cfg)
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        sess.feed_ins_pose(
            int(t_us),
            se3.euler_deg_to_quat_np(0.0, 0.0, float(np.rad2deg(yaw))),
            np.asarray(p, float), v)
    pkts, times_us = seq["packets"], seq["pkt_times_us"]
    B = cfg.pipeline.packets_per_batch
    n_b = (len(pkts) // B) * B
    # warm the compiled programs on the first third, measure the rest
    split = (n_b // B // 3) * B
    for s in range(0, split, B):
        sess.process_packets(pkts[s:s + B], times_us[s:s + B])
    warm_frames = len(sess.trajectory)
    t0 = time.perf_counter()
    for s in range(split, n_b, B):
        sess.process_packets(pkts[s:s + B], times_us[s:s + B])
    wall = time.perf_counter() - t0
    res = sess.results()
    frames = res["n_frames"] - warm_frames
    reg = res["timing"].get("register", {})
    if dist.process_index() == 0:
        print(json.dumps({
            "metric": "session_ms_per_frame",
            "processes": dist.process_count(),
            "frames_measured": frames,
            "ms_per_frame": round(wall / max(frames, 1) * 1e3, 2),
            "register_stage_ms_mean": round(reg.get("mean_ms", 0.0), 2),
            "registered_fraction": res["registered_fraction"],
            "roi_refresh_frames": sess.roi_refresh_frames,
        }))
    return 0


def _worker_bench(args) -> int:
    """Per-process body of --processes mode: partition the map by tile
    hash, run the SAME shard_map registration over the global mesh, time
    it; process 0 prints the JSON line."""
    import jax
    import jax.numpy as jnp

    from veloslam_tpu.core import se3
    from veloslam_tpu.parallel import dist, sharded
    from veloslam_tpu.registration import gicp

    rng = np.random.default_rng(0)
    pts = rng.uniform(-60, 60, (args.points, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 0.1
    mask = np.ones(args.points, bool)
    full = gicp.build_plane_grid(jnp.asarray(pts), jnp.asarray(mask),
                                 np.zeros(3), 1.0, capacity=args.capacity)

    n = dist.process_count()
    rows, origin, vs = dist.partition_plane_grid_rows(
        full, dist.process_index(), n)
    mesh = dist.global_mesh(data_axis=1)
    target = dist.assemble_global_plane_grid(mesh, rows, origin, vs)
    g_pts = dist.replicate(mesh, [pts])[0]
    g_mask = dist.replicate(mesh, [mask])[0]

    def run():
        return sharded.register_sharded(mesh, g_pts, g_mask, target,
                                        se3.Pose.identity(),
                                        iterations=args.iters)
    t = _timeit(run)
    if dist.process_index() == 0:
        print(json.dumps({
            "metric": "multiprocess_register_ms",
            "processes": n, "devices": jax.device_count(),
            "ms": round(t * 1e3, 3)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--virtual", type=int, metavar="N",
                    help="force CPU with N virtual devices")
    ap.add_argument("--processes", type=int, metavar="N",
                    help="spawn N OS processes (multi-host simulation; "
                         "Gloo collectives between processes)")
    ap.add_argument("--worker", metavar="PID:N:PORT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--capacity", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--session", action="store_true",
                    help="with --processes: time the full distributed "
                         "SLAM session (ms/frame) instead of the "
                         "registration kernel")
    ap.add_argument("--session-s", type=float, default=1.5,
                    help="simulated drive length for --session")
    args = ap.parse_args(argv)

    if args.processes:
        rest = []
        for k in ("points", "capacity", "iters"):
            rest += [f"--{k}", str(getattr(args, k))]
        if args.session:
            rest += ["--session", "--session-s", str(args.session_s)]
        return _run_multiprocess(args.processes, rest)

    def _force_cpu(jax):
        # A backend may already be initialized; update AND reset.
        import jax.extend.backend
        jax.config.update("jax_platforms", "cpu")
        jax.extend.backend.clear_backends()

    if args.worker:
        import jax
        _force_cpu(jax)
        pid, n, port = (int(x) for x in args.worker.split(":"))
        from veloslam_tpu.parallel import dist
        dist.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                              num_processes=n, process_id=pid)
        if args.session:
            return _worker_session(args)
        return _worker_bench(args)

    import os
    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}")
        import jax
        _force_cpu(jax)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from veloslam_tpu.utils import compilecache
    compilecache.enable()
    from veloslam_tpu.config import MeshConfig
    from veloslam_tpu.core import se3
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.parallel import halo
    from veloslam_tpu.parallel import mesh as mesh_mod
    from veloslam_tpu.parallel import sharded
    from veloslam_tpu.registration import gicp

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    print(f"devices: {n_dev} ({jax.devices()[0].platform})", file=sys.stderr)

    # Fixture: registration workload (replicated scan, shardable grid).
    world = sim.World.demo(seed=5)
    rng = np.random.default_rng(0)
    az = rng.uniform(0, 2 * np.pi, args.points)
    el = np.deg2rad(rng.uniform(-30, 10, args.points))
    dirs = np.stack([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                     np.sin(el)], -1)
    origins = np.broadcast_to([0.0, 0.0, 2.0], dirs.shape).copy()
    dist, _ = sim.raycast(world, origins, dirs)
    pts = (dirs * dist[:, None]).astype(np.float32)
    mask = jnp.asarray(dist > 0)
    pts = jnp.asarray(pts)
    grid = gicp.build_plane_grid(pts, mask, np.zeros(3), 1.0,
                                 capacity=args.capacity)

    results = []
    base_t = None
    for n in sizes:
        mesh = mesh_mod.make_mesh(MeshConfig(data_axis=1, map_axis=n))
        specs = sharded.plane_grid_specs("map")
        grid_sh = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            grid, specs)

        def run(p, m, g):
            return sharded.register_sharded(mesh, p, m, g,
                                            se3.Pose.identity(),
                                            iterations=args.iters)
        t = _timeit(run, pts, mask, grid_sh)
        if base_t is None:
            base_t = t
        speedup = base_t / t
        row = {"devices": n, "ms": round(t * 1e3, 3),
               "speedup": round(speedup, 3),
               # parallel efficiency = speedup / n (the BASELINE
               # ">=70% at >=2 hosts" criterion reads directly off
               # this column)
               "efficiency": round(speedup / n, 3)}

        # Halo variant: scan ALSO sharded (routed by key range), map
        # shards extended with ring-neighbor boundary bands — per-device
        # match work drops as 1/D in points and rows.
        keys_np = np.asarray(grid.grid.keys)
        h = 2 * halo.required_halo(keys_np, n) + 16 if n > 1 else 1
        p_r, m_r = halo.partition_points_by_key_ranges(
            keys_np, np.asarray(pts), np.asarray(mask), np.zeros(3), 1.0,
            n)

        def run_halo(p, m, g):
            return halo.register_halo_sharded(
                mesh, p, m, g, se3.Pose.identity(),
                iterations=args.iters, halo=h)
        t_h = _timeit(run_halo, jnp.asarray(p_r), jnp.asarray(m_r),
                      grid_sh)
        row["halo_ms"] = round(t_h * 1e3, 3)
        results.append(row)
        print(f"map={n}: {t*1e3:8.3f} ms  speedup {base_t/t:5.2f}x  "
              f"halo {t_h*1e3:8.3f} ms", file=sys.stderr)
    print(json.dumps({"metric": "map_sharded_register_scaling",
                      "platform": jax.devices()[0].platform,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
