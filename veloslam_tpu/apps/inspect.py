"""CLI: inspect a recorded session — frames, beams, timing, debug dumps.

The SimpleHDLTester + aplayground + SimpleViewer equivalent (reference
SimpleHDLTester.cxx:6-45: fetch every frame, time it, count failures;
aplayground.cxx:8-29: per-beam point counts; simpleviewer beam
navigation) as a headless tool over a pipeline checkpoint directory.

Usage:
  python -m veloslam_tpu.apps.inspect --checkpoint /path/to/ckpt
  python -m veloslam_tpu.apps.inspect --pcap drive.pcap --frame 3 --bev out
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", help="pipeline checkpoint directory")
    ap.add_argument("--pcap", help="or: decode this pcap directly")
    ap.add_argument("--ins", help="INS log for motion compensation")
    ap.add_argument("--model", default="hdl32")
    ap.add_argument("--frame", type=int, help="inspect one frame index")
    ap.add_argument("--beams", action="store_true",
                    help="print per-beam point counts")
    ap.add_argument("--bev", metavar="PATH", help="dump BEV image")
    ap.add_argument("--pcd", metavar="PATH", help="dump PCD cloud")
    ap.add_argument("--txt", metavar="PATH", help="dump xyz text")
    ap.add_argument("--platform", choices=["cpu", "gpu", "default"],
                    default="cpu")
    args = ap.parse_args(argv)

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    from veloslam_tpu.utils import compilecache
    compilecache.enable()

    from veloslam_tpu.runtime.framestore import FrameStore
    from veloslam_tpu.utils import dumps

    frames = []
    if args.checkpoint:
        import os
        fs = FrameStore(capacity=16)
        fs.load_meta(os.path.join(args.checkpoint, "frames_meta.npz"),
                     spill_dir=os.path.join(args.checkpoint, "frames"))
        times, meta = fs.all_frame_meta()
        print(f"{len(times)} frames indexed; "
              f"span {(times[-1] - times[0]) / 1e6:.2f} s"
              if len(times) else "empty store")
        # SimpleHDLTester loop: fetch every frame, time it, count failures
        n_fail = 0
        fetch_ms = []
        for t in times:
            t0 = time.perf_counter()
            f = fs.get_frame_at(int(t))
            dt = (time.perf_counter() - t0) * 1e3
            if f is None:
                n_fail += 1
                continue
            fetch_ms.append(dt)
            frames.append((int(t), f))
        if fetch_ms:
            print(f"fetch: mean {np.mean(fetch_ms):.2f} ms  "
                  f"max {np.max(fetch_ms):.2f} ms  failures {n_fail}")
    elif args.pcap:
        from veloslam_tpu.config import SensorConfig, SlamConfig
        from veloslam_tpu.runtime.pipeline import SlamPipeline
        pipe = SlamPipeline(SlamConfig(sensor=SensorConfig(model=args.model)))
        if args.ins:
            pipe.feed_ins_txt(args.ins)
        from veloslam_tpu.io.pcap import read_lidar_packets
        pkts, times_us, _ = read_lidar_packets(args.pcap)
        B = pipe.cfg.pipeline.packets_per_batch
        collected = []
        orig = pipe._handle_frame

        def capture(frame, start_us):
            collected.append((start_us, frame))
        pipe._handle_frame = capture
        for s in range(0, (len(pkts) // B) * B, B):
            pipe.process_packets(pkts[s:s + B], times_us[s:s + B])
        frames = collected
        print(f"decoded {len(frames)} frames from {len(pkts)} packets")
    else:
        ap.error("need --checkpoint or --pcap")

    if not frames:
        return 0
    sel = frames if args.frame is None else [frames[args.frame]]
    for idx, (t, f) in enumerate(sel if args.frame is None else sel):
        n = int(f["mask"].sum())
        line = f"frame {idx if args.frame is None else args.frame}" \
               f" @ {t} us: {n} points"
        print(line)
        if args.beams:
            per_beam = f["mask"].sum(axis=1)
            for b, c in enumerate(per_beam):
                print(f"  beam {b:2d}: {int(c):5d} points")
    if args.frame is not None:
        t, f = frames[args.frame]
        if args.bev:
            print("bev ->", dumps.dump_bev(f, args.bev))
        if args.pcd:
            print(f"pcd -> {args.pcd} ({dumps.dump_pcd(f, args.pcd)} pts)")
        if args.txt:
            print(f"txt -> {args.txt} ({dumps.dump_txt(f, args.txt)} pts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
