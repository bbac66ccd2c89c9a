"""CLI: replay recorded/simulated sensor data over UDP.

The PacketFileSender + TestINSSender equivalents (reference
PacketFileSender.cxx:41-89, TestINSSender.cxx:52-76): stream a pcap's
LiDAR packets to the data port with fixed pacing, and/or an INS text log as
InsPVA structs at 100 Hz — the loopback fake-backend pattern the reference
uses for multi-node-free testing (SURVEY.md §4).

Usage:
  python -m veloslam_tpu.apps.replay --pcap drive.pcap [--loop]
  python -m veloslam_tpu.apps.replay --ins drive_ins.txt --origin 31 121.5 0
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def replay_ins_txt(path: str, dest_ip: str, port: int,
                   origin_llh_deg, rate_hz: float = 100.0) -> int:
    """Re-encode an INS text log as InsPVA UDP packets (TestINSSender
    parity: ENU → LLH re-encode, TestINSSender.cxx:52-76)."""
    from veloslam_tpu.core import geodesy, timesync
    from veloslam_tpu.io import packets as pk
    from veloslam_tpu.io.udp import send_struct

    ins = pk.read_ins_txt(path)
    origin = np.array([np.deg2rad(origin_llh_deg[0]),
                       np.deg2rad(origin_llh_deg[1]), origin_llh_deg[2]])
    org_xyz = geodesy.llh2xyz_np(origin)
    n = 0
    period = 1.0 / rate_hz
    for i in range(len(ins["t_us"])):
        enu = np.array([ins["pos_xy"][i, 0], ins["pos_xy"][i, 1], 0.0])
        llh = geodesy.enu2llh_np(enu, org_xyz)
        t_us = int(ins["t_us"][i])
        gps_us = t_us - timesync.GPS_EPOCH_UNIX_US
        week = gps_us // timesync.WEEK_US
        ms = (gps_us % timesync.WEEK_US) // 1000
        payload = pk.pack_inspva(
            int(week), int(ms), int(week),
            (gps_us % timesync.WEEK_US) / 1e6,
            (np.rad2deg(llh[0]), np.rad2deg(llh[1]), llh[2]),
            tuple(ins["speed"][i] * np.array(
                [np.cos(np.deg2rad(ins["yaw_deg"][i])),
                 np.sin(np.deg2rad(ins["yaw_deg"][i])), 0.0])),
            (ins["roll_deg"][i], ins["pitch_deg"][i], ins["yaw_deg"][i]))
        send_struct(payload, dest_ip, port)
        n += 1
        time.sleep(period)
    return n


def measure_live_loopback(duration_s: float = 5.0, rate: float = 1.0,
                          fast: bool = True, warm: bool = True,
                          origin=(31.0, 121.5, 0.0)) -> dict:
    """Measure live-mode ingest on THIS backend: loopback-replay a
    simulated drive at `rate`× the sensor's packet pacing through
    run_online and report sustained pkt/s, receiver drops, frames, and
    per-batch feed latency (the reference's pacing baseline is its
    5 kpkt/s replayer, PacketFileSender.cxx:78; the HDL-32 itself sends
    ≈1808 pkt/s).  `fast` uses the device-resident engine (zero
    readbacks while streaming)."""
    import socket
    import tempfile
    import threading

    from veloslam_tpu import constants as C
    from veloslam_tpu.config import GraphConfig, SlamConfig
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.io.pcap import read_lidar_packets
    from veloslam_tpu.io.udp import replay_packets
    from veloslam_tpu.runtime.odometry import packets_per_second
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = SlamConfig(graph=GraphConfig(use_landmarks=False))
    if warm:
        # Pre-compile the live-batch-size programs so the measured stream
        # pays no compilation.
        SlamPipeline(cfg).warmup_batched(
            duration_s=1.0, batch=cfg.pipeline.packets_per_batch)

    seq = sim.generate_sequence(duration_s=duration_s, model="hdl32",
                                seed=17, world=sim.World.demo(6))
    paths = sim.write_sequence(seq, tempfile.mkdtemp(), name="live")
    pkts, _, _ = read_lidar_packets(paths["pcap"])

    def free_port():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    lidar_port, ins_port, pos_port = (free_port() for _ in range(3))
    pace_us = max(int(1e6 / packets_per_second("hdl32") / rate), 1)
    sent = {}
    threads = []

    def start_senders():
        def send_lidar():
            sent["lidar"] = replay_packets(pkts, "127.0.0.1", lidar_port,
                                           pace_us)
        def send_ins():
            sent["ins"] = replay_ins_txt(paths["ins"], "127.0.0.1",
                                         ins_port, origin,
                                         rate_hz=100.0 * rate)
        for fn in (send_lidar, send_ins):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            threads.append(t)

    pipe = SlamPipeline(cfg)
    t0 = time.time()
    res = pipe.run_online(lidar_port=lidar_port, ins_port=ins_port,
                          position_port=pos_port,
                          origin_llh_deg=origin,
                          duration_s=duration_s / rate + 30.0,
                          idle_timeout_s=1.5, on_ready=start_senders,
                          fast=fast)
    wall = time.time() - t0
    for t in threads:
        t.join(timeout=5.0)
    st = res["live_stats"]
    rx = st["lidar_packets"]
    stream_s = len(pkts) * pace_us * 1e-6
    return {
        "rate_x_sensor": rate,
        "pace_us_per_packet": pace_us,
        "sent_lidar": sent.get("lidar", 0),
        "received_lidar": rx,
        "receiver_dropped": int(st.get("lidar_dropped", 0)),
        "lost": sent.get("lidar", 0) - rx,
        "sustained_pkt_per_s": round(rx / max(stream_s, 1e-9), 1),
        "n_frames": res["n_frames"],
        "n_keyframes": res["n_keyframes"],
        "batch_feed_ms_mean": st["batch_feed_ms_mean"],
        "batch_feed_ms_max": round(st["batch_feed_ms_max"], 3),
        "batch_period_ms": round(
            512 * pace_us * 1e-3, 1),
        "wall_s": round(wall, 2),
        "mode": "fast" if fast else "per-frame",
    }


def main(argv=None) -> int:
    from veloslam_tpu.utils import compilecache
    compilecache.enable()
    from veloslam_tpu import constants as C

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcap", help="pcap to replay to the LiDAR port")
    ap.add_argument("--ins", help="INS text log to replay as InsPVA")
    ap.add_argument("--dest", default="127.0.0.1")
    ap.add_argument("--lidar-port", type=int, default=C.LIDAR_DATA_PORT)
    ap.add_argument("--ins-port", type=int, default=C.INS_PORT)
    ap.add_argument("--pace-us", type=int, default=200,
                    help="µs between LiDAR packets (reference default 200)")
    ap.add_argument("--ins-rate", type=float, default=100.0)
    ap.add_argument("--origin", type=float, nargs=3,
                    default=(31.0, 121.5, 0.0),
                    metavar=("LAT", "LON", "H"),
                    help="ENU origin for INS LLH re-encode (deg, deg, m)")
    ap.add_argument("--loop", action="store_true",
                    help="repeat the pcap forever")
    args = ap.parse_args(argv)
    if not args.pcap and not args.ins:
        ap.error("need --pcap and/or --ins")

    import threading

    threads = []
    if args.ins:
        t = threading.Thread(target=replay_ins_txt, args=(
            args.ins, args.dest, args.ins_port, tuple(args.origin),
            args.ins_rate), daemon=True)
        t.start()
        threads.append(t)
    if args.pcap:
        from veloslam_tpu.io.pcap import read_lidar_packets
        from veloslam_tpu.io.udp import replay_packets
        pkts, times, _ = read_lidar_packets(args.pcap)
        print(f"replaying {len(pkts)} packets to "
              f"{args.dest}:{args.lidar_port} at {args.pace_us} µs/pkt")
        while True:
            sent = replay_packets(pkts, args.dest, args.lidar_port,
                                  args.pace_us)
            print(f"sent {sent}")
            if not args.loop:
                break
    for t in threads:
        t.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
