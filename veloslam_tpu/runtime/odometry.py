"""Device-resident streaming odometry: one jitted step per packet batch.

The full SLAM pipeline (runtime.pipeline) orchestrates on the host —
flexible, but every frame crosses the device boundary.  This module is the
production fast path: decode → motion compensation → frame assembly →
scan-to-local-map GICP → local-map update run as ONE jitted function whose
state (assembly carry, rolling voxel map, correction transform, trajectory
buffer) never leaves the device.  The host only feeds packet batches and
INS windows, and reads the trajectory back once at the end of the stream.

Local map: a fixed-capacity voxel-Gaussian grid merged with each
registered scan under exponential forgetting (counts ×γ per frame, stale
voxels fall under the min-point gate).  Packed keys bound the odometry
area to ±512 voxels around the stream origin; for unbounded runs the host
rebases periodically (splitting streams), or the full pipeline's tiled
map takes over.

Estimation model matches runtime.pipeline: the INS provides compensation
and relative priors; registration maintains a correction
C = T_est ∘ T_ins⁻¹ so the prior for each new frame is C ∘ T_ins(start).

Batch-size guidance for the batched step: all frames of a batch register
against the batch-START map with the batch-start correction, so drift
correction chains once per batch.  With drift-free INS (offline replay of
surveyed data) batches of many seconds are exact to centimeters; with
drifting INS keep batches ≲0.5 s of data (≈512-1024 HDL-32 packets) so
per-frame corrections keep up with the drift rate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from veloslam_tpu import constants as C
from veloslam_tpu.core import se3
from veloslam_tpu.core.timeline import interpolate_poses
from veloslam_tpu.decode.decode import (DeviceCalib, compensate,
                                        decode_packets)
from veloslam_tpu.decode.frames import (AssemblyCarry, SampleCarry,
                                        assemble_frames, sample_frames)
from veloslam_tpu.registration import gicp
from veloslam_tpu.registration import voxel as vx

# Lateral-observability gate on the rolling-map target (see the gates
# below): registration output is trusted only when the map holds at least
# this many usable voxels with a NON-HORIZONTAL normal (|n_z| < 0.7).  A
# young map at subsampled density is mostly ground plane — an
# xy-unconstrained target against which GN slides laterally ~0.4 m while
# reporting thousands of matches.  Measured at 0.5 m voxels: a 1-scan map
# of a sparse scene has 0 wall-ish usable voxels, a geometry-rich scene
# has ~100 from the first scan (so rich scenes register immediately and
# sparse ones wait the few scans they genuinely need).
MIN_WALLISH_VOXELS = 30


class OdometryState(NamedTuple):
    carry: AssemblyCarry
    map_grid: vx.VoxelGrid          # rolling local map
    corr_q: jax.Array               # (4,) correction C = T_est ∘ T_ins⁻¹
    corr_t: jax.Array               # (3,)
    traj_q: jax.Array               # (T, 4) per-frame pose estimates
    traj_t: jax.Array               # (T, 3)
    traj_time: jax.Array            # (T,) float64-µs as two f32? — stored
                                    # as f32 seconds rel. to stream start
    n_frames: jax.Array             # () int32
    have_map: jax.Array             # () bool — first frame bootstraps
    # Running MIN of the dense-index window coverage (fraction of usable
    # map voxels inside the box; 1.0 when use_dense is off) — surfaces
    # silent window truncation on long/hilly drives (ADVICE r3).
    min_dense_cov: jax.Array = None
    # Constant-velocity model of the INS correction: the correction is
    # updated once per BATCH, so with a drifting INS the prior error of
    # late-batch frames grows by drift_rate × batch_duration — past the
    # ±1-voxel correspondence basin, registration degrades to the prior
    # (measured: 0.35 m relative errors at 1 m/s drift, batch 1.1 s).
    # Tracking d(corr_t)/dt between batch ends and extrapolating each
    # slot's prior keeps the within-batch prior error ~(drift
    # acceleration × dt²) instead of (drift rate × dt), at any batch
    # size.  (corr_time values are stream-relative f32 seconds.)
    corr_t_prev: jax.Array = None   # (3,)
    corr_time: jax.Array = None     # ()
    corr_time_prev: jax.Array = None  # ()


def init_state(n_beams: int, *, map_capacity: int = 32768,
               max_frames: int = 4096,
               max_firings: int = C.MAX_FIRINGS_PER_FRAME,
               voxel_size: float = 1.0,
               sample_assembly: bool = False) -> OdometryState:
    grid = vx.VoxelGrid(
        keys=jnp.full((map_capacity,), vx.INVALID_KEY, jnp.int32),
        count=jnp.zeros(map_capacity, jnp.float32),
        mean=jnp.zeros((map_capacity, 3), jnp.float32),
        cov=jnp.zeros((map_capacity, 3, 3), jnp.float32),
        origin=jnp.zeros(3, jnp.float32),
        voxel_size=jnp.asarray(voxel_size, jnp.float32))
    return OdometryState(
        carry=(SampleCarry.init(max_firings) if sample_assembly
               else AssemblyCarry.init(n_beams, max_firings)),
        map_grid=grid,
        corr_q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
        corr_t=jnp.zeros(3, jnp.float32),
        traj_q=jnp.zeros((max_frames, 4), jnp.float32),
        traj_t=jnp.zeros((max_frames, 3), jnp.float32),
        traj_time=jnp.zeros(max_frames, jnp.float32),
        n_frames=jnp.asarray(0, jnp.int32),
        have_map=jnp.asarray(False),
        min_dense_cov=jnp.asarray(1.0, jnp.float32),
        corr_t_prev=jnp.zeros(3, jnp.float32),
        corr_time=jnp.asarray(0.0, jnp.float32),
        corr_time_prev=jnp.asarray(0.0, jnp.float32))


def _subsample(frame_xyz, frame_mask, n_out: int):
    """Pick n_out valid points, spread across the whole frame.

    Valid-first ordering alone would take the first beams only (the frame
    layout is (beam, firing)) — a geometry-poor, ground-ring-heavy subset
    that under-constrains registration.  Instead the n_out valid points
    with the smallest multiplicative hash are selected sort-free via a
    65536-bin histogram + cumsum ranking, emitted in azimuth order, then
    scattered through a bit-reversal permutation so any power-of-two
    prefix of the output is again a uniform subsample (see inline
    comments for why each piece exists).
    """
    L, Fm = frame_mask.shape
    n = L * Fm
    xyz = frame_xyz.reshape(-1, 3)
    m = frame_mask.reshape(-1)
    # Select the n_out valid points with the SMALLEST multiplicative hash
    # — the set the original argsort formulation picked — found sort-free
    # with a 65536-bin histogram + cumsum instead of a per-frame argsort.
    # The multiplicative (Fibonacci) hash is chosen deliberately: its
    # k-smallest set is a LOW-DISCREPANCY quasi-lattice
    # (points ~evenly spaced at an irrational stride), which both covers
    # the frame uniformly (no Poisson clumps/gaps a full-avalanche hash
    # would produce — measured 2-8x worse odometry rmse) and cannot
    # phase-lock to the firing grid the way an integer-strided decimation
    # does (dotted scan rings snapping dot-to-dot one pitch off).
    h = ((jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761))
         >> 16).astype(jnp.int32)                         # 16-bit hash
    hist = jnp.zeros(65536, jnp.int32).at[
        jnp.where(m, h, 0)].add(m.astype(jnp.int32))
    cum = jnp.cumsum(hist)                                # (65536,)
    # Smallest bin b with count(h < b+1) >= n_out; all valid if fewer.
    b = jnp.searchsorted(cum, n_out, side="left").astype(jnp.int32)
    below = jnp.where(b > 0, cum[jnp.maximum(b - 1, 0)], 0)
    in_b = m & (h == b)
    rank_b = jnp.cumsum(in_b.astype(jnp.int32)) - 1
    pre = m & ((h < b) | (in_b & (rank_b < n_out - below)))
    dest = jnp.cumsum(pre.astype(jnp.int32)) - 1
    dest = jnp.where(pre & (dest < n_out), dest, n_out)
    # Bit-reverse the output slot so ANY power-of-two prefix of the result
    # is itself a uniform (strided) subsample of the frame.  The cumsum
    # compaction above emits points in ARRAY (azimuth) order; downstream
    # consumers that slice a prefix (keyframe scans take the first
    # scan_points rows, runtime/fullslam.py) would otherwise silently get
    # the first half of the revolution only — the r3 landmark-accuracy
    # regression was exactly that.
    if n_out & (n_out - 1) == 0:
        bits = n_out.bit_length() - 1
        rev = jnp.zeros_like(dest)
        for i in range(bits):
            rev = rev | (((dest >> i) & 1) << (bits - 1 - i))
        dest = jnp.where(dest < n_out, rev, n_out)
    out = jnp.zeros((n_out, 3), frame_xyz.dtype).at[dest].set(
        xyz, mode="drop")
    msk = jnp.zeros(n_out, bool).at[dest].set(pre, mode="drop")
    return out, msk


def _handle_frame(st: OdometryState, k, fb_xyz, fb_mask, starts, n_done,
                  batch_start_rel_stream_s, track_rel_s, track_q, track_t,
                  track_v, *, reg_points: int, reg_iterations: int,
                  min_points: int, min_planarity: float,
                  reassociate_every: int = 1,
                  map_decay: float = 0.98) -> OdometryState:
    """Register frame slot `k` (if k < n_done) and fold it into the state.

    Shared body of the fused `odometry_step` and the chained
    `frame_step`; `k` may be a Python int (fused, unrolled) or a traced
    device scalar (chained)."""

    def do(st: OdometryState) -> OdometryState:
        start_rel = starts[k]
        # INS pose at the frame start (batch time base).
        ins = interpolate_poses(track_rel_s, track_q, track_t, track_v,
                                start_rel[None])
        ins = se3.Pose(ins.q[0], ins.t[0])
        # Frame points (world/INS frame) → local (frame-start) frame.
        pts, msk = _subsample(fb_xyz[k], fb_mask[k], reg_points)
        pts_local = se3.apply(se3.inverse(ins), pts)
        prior = se3.compose(se3.Pose(st.corr_q, st.corr_t), ins)

        target = gicp.plane_grid_from(st.map_grid,
                                      min_points=min_points,
                                      min_planarity=min_planarity)
        res = gicp.register(pts_local, msk, target, prior,
                            iterations=reg_iterations,
                            reassociate_every=reassociate_every)
        # Lateral-observability gate: see _batched_core (a young map is
        # mostly ground plane and xy-unconstrained).
        wallish = jnp.sum(target.usable
                          & (jnp.abs(target.normal[:, 2]) < 0.7))
        healthy = (res.n_matched > 500) & jnp.all(
            jnp.isfinite(res.pose.t)) & st.have_map \
            & (wallish >= MIN_WALLISH_VOXELS)
        est = se3.Pose(jnp.where(healthy, res.pose.q, prior.q),
                       jnp.where(healthy, res.pose.t, prior.t))

        # Update correction and trajectory.
        corr = se3.compose(est, se3.inverse(ins))
        n = st.n_frames
        traj_q = st.traj_q.at[n].set(est.q)
        traj_t = st.traj_t.at[n].set(est.t)
        traj_time = st.traj_time.at[n].set(
            batch_start_rel_stream_s + start_rel)

        # Merge the registered scan into the rolling map with decay.
        pts_world = se3.apply(est, pts_local)
        # One frame occupies at most reg_points voxels; 8192 silently
        # dropped overflow at sub-meter voxel sizes.
        scan_grid = vx.build_grid(pts_world, msk, st.map_grid.origin,
                                  st.map_grid.voxel_size,
                                  capacity=reg_points)
        decayed = st.map_grid._replace(count=st.map_grid.count * map_decay)
        merged = vx.merge_stats(decayed, scan_grid,
                                capacity=st.map_grid.capacity)
        return st._replace(
            map_grid=merged, corr_q=corr.q, corr_t=corr.t,
            traj_q=traj_q, traj_t=traj_t, traj_time=traj_time,
            n_frames=n + 1, have_map=jnp.asarray(True))

    return jax.lax.cond(k < n_done, do, lambda s: s, st)


@functools.partial(jax.jit, static_argnames=(
    "model", "n_beams", "max_frames_batch"))
def assemble_step(carry: AssemblyCarry, pkts: jax.Array, calib: DeviceCalib,
                  pkt_rel_s: jax.Array, carry_start_rel_s: jax.Array,
                  track_rel_s: jax.Array, track_q: jax.Array,
                  track_t: jax.Array, track_v: jax.Array, *,
                  model: str, n_beams: int, max_frames_batch: int = 4):
    """Chained-path stage 1: decode + compensate + frame assembly."""
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    fb, n_done, starts, carry2, open_start = assemble_frames(
        dec, xyz_w, pkt_rel_s, carry, carry_start_rel_s,
        model=model, n_beams=n_beams, max_frames=max_frames_batch,
        lean=True)
    return fb.xyz, fb.mask, n_done, starts, carry2, open_start


@functools.partial(jax.jit, static_argnames=(
    "reg_points", "reg_iterations", "min_points", "min_planarity",
    "reassociate_every"))
def frame_step(state: OdometryState, k: jax.Array, fb_xyz: jax.Array,
               fb_mask: jax.Array, starts: jax.Array, n_done: jax.Array,
               batch_start_rel_stream_s: jax.Array,
               track_rel_s: jax.Array, track_q: jax.Array,
               track_t: jax.Array, track_v: jax.Array, *,
               reg_points: int = 16384, reg_iterations: int = 8,
               min_points: int = 4, min_planarity: float = 0.35,
               reassociate_every: int = 1) -> OdometryState:
    """Chained-path stage 2: register/integrate ONE frame slot.

    `k` is a device scalar so all slots share one executable; the
    k-vs-n_done gate stays on device (no readback)."""
    return _handle_frame(state, k, fb_xyz, fb_mask, starts, n_done,
                         batch_start_rel_stream_s, track_rel_s, track_q,
                         track_t, track_v, reg_points=reg_points,
                         reg_iterations=reg_iterations,
                         min_points=min_points, min_planarity=min_planarity)


@functools.partial(jax.jit, static_argnames=(
    "model", "n_beams", "reg_points", "reg_iterations", "max_frames_batch",
    "min_points", "min_planarity", "reassociate_every", "map_decay"))
def odometry_step(state: OdometryState, pkts: jax.Array, calib: DeviceCalib,
                  pkt_rel_s: jax.Array, carry_start_rel_s: jax.Array,
                  batch_start_rel_stream_s: jax.Array,
                  track_rel_s: jax.Array, track_q: jax.Array,
                  track_t: jax.Array, track_v: jax.Array, *,
                  model: str, n_beams: int, reg_points: int = 16384,
                  reg_iterations: int = 8, max_frames_batch: int = 4,
                  min_points: int = 4, min_planarity: float = 0.35,
                  reassociate_every: int = 1, map_decay: float = 0.98
                  ) -> Tuple[OdometryState, jax.Array]:
    """Fused single-program variant: consume one packet batch; returns
    (new state, open_start_rel_s).

    Times: `pkt_rel_s`/`carry_start_rel_s` are relative to this batch's
    anchor; `batch_start_rel_stream_s` is the anchor expressed relative to
    the stream start (for the trajectory time column).

    The throughput path is `odometry_step_batched` with
    `sample_assembly=True`.
    """
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    fb, n_done, starts, carry, open_start = assemble_frames(
        dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
        model=model, n_beams=n_beams, max_frames=max_frames_batch,
        lean=True)
    state = state._replace(carry=carry)

    # Unrolled over the (small, static) slot count: nesting the per-frame
    # work inside an outer lax.fori_loop serializes the whole body behind
    # a dynamic trip count; unrolling keeps each slot's cond at top level
    # where XLA schedules it properly.
    for k in range(max_frames_batch):
        state = _handle_frame(
            state, k, fb.xyz, fb.mask, starts, n_done,
            batch_start_rel_stream_s, track_rel_s, track_q, track_t,
            track_v, reg_points=reg_points, reg_iterations=reg_iterations,
            min_points=min_points, min_planarity=min_planarity,
            reassociate_every=reassociate_every, map_decay=map_decay)
    return state, open_start


class SlotResults(NamedTuple):
    """Per-frame-slot outputs of one batched odometry step (leading F)."""

    done: jax.Array        # (F,) bool — slot holds a completed frame
    est_q: jax.Array       # (F, 4) estimated world pose
    est_t: jax.Array       # (F, 3)
    start_rel_s: jax.Array  # (F,) frame start, batch time base
    pts_local: jax.Array   # (F, P, 3) subsampled scan, frame-local
    msk: jax.Array         # (F, P)
    n_matched: jax.Array   # (F,) int32


def _batched_core(state: OdometryState, pkts: jax.Array,
                  calib: DeviceCalib, pkt_rel_s: jax.Array,
                  carry_start_rel_s: jax.Array,
                  batch_start_rel_stream_s: jax.Array,
                  track_rel_s: jax.Array, track_q: jax.Array,
                  track_t: jax.Array, track_v: jax.Array, *,
                  model: str, n_beams: int, reg_points: int,
                  reg_iterations: int, max_frames_batch: int,
                  min_points: int, min_planarity: float,
                  use_dense: bool = False,
                  reassociate_every: int = 1,
                  sample_assembly: bool = False,
                  map_decay: float = 0.98
                  ) -> Tuple[OdometryState, jax.Array, SlotResults]:
    """Shared body of the batched odometry step; also returns per-slot
    results so callers (runtime.fullslam) can select keyframes without a
    second decode pass.

    `sample_assembly` selects the gather-based fast path
    (decode.frames.sample_frames): frames are contiguous firing-block
    ranges of the decode output, so per-slot points come from one strided
    row gather instead of the scatter-assembled dense frame tensors + the
    histogram subsample.  The state's carry type must match
    (init_state(sample_assembly=...))."""
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    F = max_frames_batch
    if sample_assembly:
        sf, n_done, starts, carry, open_start = sample_frames(
            dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
            model=model, max_frames=F, points_per_frame=reg_points)
        pts, msk = sf.xyz, sf.mask                         # (F,P,3), (F,P)
    else:
        fb, n_done, starts, carry, open_start = assemble_frames(
            dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
            model=model, n_beams=n_beams, max_frames=F, lean=True)
        # Subsample every slot (vmapped).
        sub = jax.vmap(functools.partial(_subsample, n_out=reg_points))
        pts, msk = sub(fb.xyz, fb.mask)
    state = state._replace(carry=carry)
    slot_done = jnp.arange(F) < n_done                     # (F,)
    msk &= slot_done[:, None]

    # Per-frame INS poses at frame starts (one batched interpolation).
    ins = interpolate_poses(track_rel_s, track_q, track_t, track_v, starts)
    pts_local = jax.vmap(
        lambda q, t, p: se3.apply(se3.inverse(se3.Pose(q, t)), p))(
            ins.q, ins.t, pts)

    corr = se3.Pose(state.corr_q, state.corr_t)
    priors = jax.vmap(
        lambda q, t: se3.compose(corr, se3.Pose(q, t)))(ins.q, ins.t)
    # Constant-velocity extrapolation of the correction translation (see
    # OdometryState.corr_t_prev): each slot's prior advances the batch-end
    # correction by its own time offset × the measured correction rate.
    # Active only at batch periods ≥ 0.4 s: below that the staleness it
    # corrects is smaller than the rate-estimate noise (corr carries
    # ~5 cm of registration noise; rate noise = 2ε/dt), and short-batch
    # paths measurably do better without it.  The RATE is clamped
    # (±3 m/s — any sane INS drift), which bounds the extrapolation to
    # 3·dt; an absolute clamp here would silently cap the correction on
    # long batches (measured: a ±1.5 m clamp at 1 m/s drift left
    # late-batch priors ~7 m wrong on 9-second batches and the 20 s
    # bench drive collapsed to 3.6 m ATE).
    abs_starts = batch_start_rel_stream_s + starts            # (F,)
    dt_cc = state.corr_time - state.corr_time_prev
    corr_rate = jnp.where(dt_cc > 0.4,
                          (state.corr_t - state.corr_t_prev)
                          / jnp.maximum(dt_cc, 1e-3), 0.0)
    corr_rate = jnp.clip(corr_rate, -3.0, 3.0)                # m/s bound
    extrap = (abs_starts - state.corr_time)[:, None] * corr_rate[None, :]
    priors = se3.Pose(priors.q, priors.t + extrap)

    target = gicp.plane_grid_from(state.map_grid, min_points=min_points,
                                  min_planarity=min_planarity)
    # Optional O(1) correspondence index (bench.py --ab measures both).
    if use_dense:
        dense = vx.build_dilated_index(state.map_grid, target.usable)
        cov = vx.window_coverage(state.map_grid, target.usable, dense.lo,
                                 dense.table.shape)
        state = state._replace(
            min_dense_cov=jnp.minimum(state.min_dense_cov, cov))
    else:
        dense = None
    res = gicp.register_batch(pts_local, msk, target, priors, dense,
                              iterations=reg_iterations,
                              reassociate_every=reassociate_every)
    # Lateral-observability gate (MIN_WALLISH_VOXELS): a ground-only
    # target is xy-unconstrained and GN slides while still reporting
    # thousands of matches (measured: frame 1 vs a single-scan sparse
    # map landed 0.55 m off with a CLEAN prior).
    mature = jnp.sum(target.usable
                     & (jnp.abs(target.normal[:, 2]) < 0.7)
                     ) >= MIN_WALLISH_VOXELS
    healthy = ((res.n_matched > 500)
               & jax.vmap(lambda t: jnp.all(jnp.isfinite(t)))(res.pose.t)
               & state.have_map & mature)                  # (F,)
    est_q = jnp.where(healthy[:, None], res.pose.q, priors.q)
    est_t = jnp.where(healthy[:, None], res.pose.t, priors.t)

    # Trajectory scatter: done slots land at n_frames + k, others drop.
    n = state.n_frames
    idx = jnp.where(slot_done, n + jnp.arange(F), state.traj_q.shape[0])
    traj_q = state.traj_q.at[idx].set(est_q, mode="drop")
    traj_t = state.traj_t.at[idx].set(est_t, mode="drop")
    traj_time = state.traj_time.at[idx].set(
        batch_start_rel_stream_s + starts, mode="drop")

    # Correction from the LAST completed (healthy) frame of the batch.
    corr_all = jax.vmap(lambda q, t, iq, it: se3.compose(
        se3.Pose(q, t), se3.inverse(se3.Pose(iq, it))))(
            est_q, est_t, ins.q, ins.t)
    last = jnp.maximum(n_done - 1, 0)
    upd = n_done > 0
    corr_q = jnp.where(upd, corr_all.q[last], state.corr_q)
    corr_t = jnp.where(upd, corr_all.t[last], state.corr_t)
    # Shift the correction history (rate estimate for the next batch).
    corr_t_prev = jnp.where(upd, state.corr_t, state.corr_t_prev)
    corr_time_prev = jnp.where(upd, state.corr_time,
                               state.corr_time_prev)
    corr_time = jnp.where(upd, abs_starts[last], state.corr_time)

    # Merge all completed frames into the rolling map in one grid build.
    # Capacity = the MAP's row budget, not a fixed 16384: a many-slot
    # batch at 0.5 m voxels occupies far more than 16k distinct voxels,
    # and a smaller scan grid silently drops the overflow (measured as a
    # map-quality regression when the voxel size halved).
    pts_world = jax.vmap(lambda q, t, p: se3.apply(se3.Pose(q, t), p))(
        est_q, est_t, pts_local)
    scan_grid = vx.build_grid(pts_world.reshape(-1, 3), msk.reshape(-1),
                              state.map_grid.origin,
                              state.map_grid.voxel_size,
                              capacity=state.map_grid.capacity)
    decay = jnp.power(jnp.asarray(map_decay, jnp.float32),
                      n_done.astype(jnp.float32))
    decayed = state.map_grid._replace(count=state.map_grid.count * decay)
    merged = vx.merge_stats(decayed, scan_grid,
                            capacity=state.map_grid.capacity)
    # Unbounded drives: packed keys cover ±2^9 voxels around the origin;
    # when the vehicle approaches the window edge, re-key the rolling map
    # around the current position (device-side sort, ~1/205 m of travel).
    pos = est_t[last]
    half_range_m = jnp.asarray(1 << 9, jnp.float32) * merged.voxel_size
    need_rebase = upd & (jnp.linalg.norm(pos - merged.origin)
                         > 0.4 * half_range_m)
    merged = jax.lax.cond(need_rebase,
                          lambda g: vx.rebase_grid(g, pos),
                          lambda g: g, merged)
    state = state._replace(
        map_grid=merged, corr_q=corr_q, corr_t=corr_t, traj_q=traj_q,
        traj_t=traj_t, traj_time=traj_time, n_frames=n + n_done,
        have_map=state.have_map | upd,
        corr_t_prev=corr_t_prev, corr_time=corr_time,
        corr_time_prev=corr_time_prev)
    slots = SlotResults(done=slot_done, est_q=est_q, est_t=est_t,
                        start_rel_s=starts, pts_local=pts_local, msk=msk,
                        n_matched=res.n_matched)
    return state, open_start, slots


@functools.partial(jax.jit, static_argnames=(
    "model", "n_beams", "reg_points", "reg_iterations", "max_frames_batch",
    "min_points", "min_planarity", "use_dense",
    "reassociate_every", "sample_assembly", "map_decay"))
def odometry_step_batched(state: OdometryState, pkts: jax.Array,
                          calib: DeviceCalib, pkt_rel_s: jax.Array,
                          carry_start_rel_s: jax.Array,
                          batch_start_rel_stream_s: jax.Array,
                          track_rel_s: jax.Array, track_q: jax.Array,
                          track_t: jax.Array, track_v: jax.Array, *,
                          model: str, n_beams: int, reg_points: int = 16384,
                          reg_iterations: int = 8,
                          max_frames_batch: int = 4, min_points: int = 4,
                          min_planarity: float = 0.35,
                          use_dense: bool = False,
                          reassociate_every: int = 1,
                          sample_assembly: bool = False,
                          map_decay: float = 0.98
                          ) -> Tuple[OdometryState, jax.Array]:
    """Throughput variant of `odometry_step`: ALL frame slots register in
    one vmapped GICP program against the batch-start map, then merge.

    Semantics vs the fused sequential step: each frame's prior is
    C ∘ T_ins(start) with the batch-start correction C (not the running
    per-frame correction), and the registration target excludes frames
    completed earlier in the same batch.  At HDL frame rate (≤0.4 s per
    4-frame batch) the local map barely changes within a batch, so the
    trajectories agree to centimeters (tests/test_odometry.py); in
    exchange the per-frame dispatch cost is paid once per batch.
    """
    state, open_start, _ = _batched_core(
        state, pkts, calib, pkt_rel_s, carry_start_rel_s,
        batch_start_rel_stream_s, track_rel_s, track_q, track_t, track_v,
        model=model, n_beams=n_beams, reg_points=reg_points,
        reg_iterations=reg_iterations, max_frames_batch=max_frames_batch,
        min_points=min_points, min_planarity=min_planarity,
        use_dense=use_dense, reassociate_every=reassociate_every,
        sample_assembly=sample_assembly, map_decay=map_decay)
    return state, open_start


def packets_per_second(model: str) -> float:
    """Sensor packet rate from the timing model (HDL-64 packets carry two
    32-laser blocks per firing, so its packet rate doubles)."""
    block_us = (C.VLP16_FIRING_BLOCK_US if model == "vlp16"
                else C.HDL32_FIRING_BLOCK_US)
    rate = 1e6 / block_us / C.HDL_FIRINGS_PER_PACKET
    return rate * 2.0 if model == "hdl64" else rate


def slots_for_batch(model: str, batch: int, frame_rate_hz: float = 10.0
                    ) -> int:
    """Frame slots a packet batch may complete (+margin)."""
    return max(4, int(np.ceil(batch / packets_per_second(model)
                              * frame_rate_hz)) + 4)


class StreamingOdometry:
    """Host driver: feeds batches, keeps int64 time anchors, reads the
    trajectory once at the end (no mid-stream readbacks)."""

    MAX_FRAMES_BATCH = 4

    def __init__(self, calib: DeviceCalib, *, model: str = "hdl32",
                 n_beams: int = 32, voxel_size: float = 1.0,
                 reg_points: int = 16384, reg_iterations: int = 8,
                 map_capacity: int = 32768, max_frames: int = 4096,
                 fused: bool = True, batched: bool = False,
                 use_dense: bool = False,
                 reassociate_every: int = 1,
                 sample_assembly: bool = None,
                 frame_rate_hz: float = 10.0,
                 map_decay: float = 0.98):
        self.calib = calib
        self.model = model
        # Revolution rate (rpm / 60): sizes frame slots per batch and the
        # trajectory buffers.  The sensor spins at a configured rpm
        # (SensorConfig.rpm; reference HDLManager.h:108 assumes 600), so
        # a 1200-rpm capture completes 20 frames/s, not 10.
        self.frame_rate_hz = float(frame_rate_hz)
        self.n_beams = n_beams
        self.reg_points = reg_points
        self.reg_iterations = reg_iterations
        self.fused = fused
        self.batched = batched
        self.use_dense = use_dense
        self.reassociate_every = reassociate_every
        self.map_decay = float(map_decay)
        # Gather-based assembly exists only for the batched path; default
        # it ON there (None -> follow `batched`).
        self.sample_assembly = (bool(batched) if sample_assembly is None
                                else sample_assembly)
        self.state = init_state(n_beams, map_capacity=map_capacity,
                                max_frames=max_frames,
                                voxel_size=voxel_size,
                                sample_assembly=self.sample_assembly)
        self._stream_t0_us: Optional[int] = None
        self._open_start_abs_us: Optional[float] = None
        # Slot count override for the current feed (bootstrap-ramp
        # batches use fewer slots than the steady batch; None = steady).
        self._feed_slots: Optional[int] = None
        # Per-slot index scalars uploaded once (chained path).
        self._slot_idx = [jnp.asarray(k, jnp.int32)
                          for k in range(self.MAX_FRAMES_BATCH)]

    def ensure_capacity(self, n_frames: int) -> None:
        """Grow the device trajectory buffers to hold at least `n_frames`
        (device-side pad, no readback).  Call before streaming a recording
        longer than the buffers — the .at[n].set scatter silently drops
        out-of-bounds writes otherwise."""
        st = self.state
        cur = st.traj_q.shape[0]
        if n_frames <= cur:
            return
        pad = n_frames - cur
        self.state = st._replace(
            traj_q=jnp.concatenate(
                [st.traj_q, jnp.zeros((pad, 4), jnp.float32)]),
            traj_t=jnp.concatenate(
                [st.traj_t, jnp.zeros((pad, 3), jnp.float32)]),
            traj_time=jnp.concatenate(
                [st.traj_time, jnp.zeros(pad, jnp.float32)]))

    def run(self, pkts: np.ndarray, times_us: np.ndarray, track,
            batch: int = 512) -> dict:
        """Stream a whole recording; returns trajectory dict (single
        readback at the end)."""
        if len(pkts) == 0:
            return {"times_us": np.zeros(0, np.int64),
                    "quaternions": np.zeros((0, 4), np.float32),
                    "positions": np.zeros((0, 3), np.float32),
                    "n_frames": 0}
        self.run_device(pkts, times_us, track, batch=batch)
        st = self.state
        n_frames = int(st.n_frames)          # single readback point
        return {
            "dense_index_min_coverage": float(st.min_dense_cov),
            # float64 before the epoch shift: f32 + 1.7e15 µs would round
            # to ~134 s granularity
            "times_us": (np.asarray(st.traj_time[:n_frames],
                                    np.float64) * 1e6
                         + self._stream_t0_us).astype(np.int64),
            "quaternions": np.asarray(st.traj_q[:n_frames]),
            "positions": np.asarray(st.traj_t[:n_frames]),
            "n_frames": n_frames,
        }

    def run_device(self, pkts: np.ndarray, times_us: np.ndarray, track,
                   batch: int = 512) -> None:
        """Stream a whole recording WITHOUT any device→host readback —
        state stays on device so callers can queue further device work
        (runtime.devfinalize) behind it before anything waits.

        Double-buffered device feed (the reference's hardDriveBuffer1/2
        idea, HDLManager.h:210-211, turned toward H2D): batch k+1 uploads
        asynchronously while the device computes batch k, so the stream
        never stalls on the host→device link.

        A trailing partial batch is padded with idle packets (no returns,
        frozen azimuth — decodes to nothing, closes no frame) up to the
        batch size, so short recordings and stream tails are processed
        through the same compiled fixed-shape program instead of being
        silently dropped."""
        if len(pkts) == 0:
            return
        # Frame slots per dispatch must cover the batch's revolutions.
        need = slots_for_batch(self.model, batch,
                               frame_rate_hz=self.frame_rate_hz)
        if need > self.MAX_FRAMES_BATCH:
            self.MAX_FRAMES_BATCH = need
            self._slot_idx = [jnp.asarray(k, jnp.int32)
                              for k in range(need)]
        # Trajectory capacity sized from the recording so long drives
        # never truncate (the .at[n].set scatter would drop silently);
        # rounded up to a 1024 bucket so nearby recording lengths share
        # one compiled program (shape-stable across e.g. a short warm
        # drive and the measured drive).
        need_cap = (int(len(pkts) / packets_per_second(self.model)
                        * self.frame_rate_hz * 1.2)
                    + 2 * self.MAX_FRAMES_BATCH + 16)
        # Host-known frame estimate for this recording — sizes the
        # end-of-stream closure-sweep budget (runtime/pipeline).
        self._est_frames = need_cap
        self.ensure_capacity(-(-need_cap // 1024) * 1024)
        # BOOTSTRAP RAMP (stream head only): the first batch of a fresh
        # stream registers against an EMPTY map, so every frame in it
        # falls back to its INS prior — at 16384 packets that imprints
        # ~9 s of raw INS drift into the rolling map, and all later
        # registration faithfully tracks the drifted map (measured on the
        # bench loop: ATE 0.33 m at batch 2048 vs 0.10 via the finalize
        # graph alone).  Doubling batches (256, 512, … batch/2) bound the
        # unregistered head to ~0.14 s and keep every later frame's
        # within-batch prior error inside the ±1-voxel correspondence
        # basin while the map is young.  Each ramp size compiles its own
        # (smaller-slot) program — warmed by warmup_batched, shared via
        # the persistent cache.
        segments = []
        off = 0
        if self.batched and self._stream_t0_us is None:
            b = 256
            while b < batch and off + b <= len(pkts):
                segments.append((off, b))
                off += b
                b *= 2
        tail = (len(pkts) - off) % batch
        if tail:
            from veloslam_tpu.io import packets as pkmod
            pad = batch - tail
            pkts = np.concatenate(
                [pkts, pkmod.idle_lidar_packets(pkts[-1], pad)])
            times_us = np.concatenate(
                [times_us, np.full(pad, times_us[-1], np.int64)])
        segments += [(s, batch) for s in range(off, len(pkts), batch)]
        next_dev = jax.device_put(pkts[segments[0][0]:sum(segments[0])]) \
            if segments else None
        for i, (s, n) in enumerate(segments):
            cur = next_dev
            if i + 1 < len(segments):
                s2, n2 = segments[i + 1]
                next_dev = jax.device_put(pkts[s2:s2 + n2])  # async H2D
            t0, t1 = int(times_us[s]), int(times_us[s + n - 1])
            w = track.window(t0, t1, anchor_us=t0)
            self._feed_slots = (slots_for_batch(
                self.model, n, frame_rate_hz=self.frame_rate_hz)
                if n < batch else None)
            try:
                self.feed(cur, times_us[s:s + n], w)
            finally:
                self._feed_slots = None

    WINDOW_LEN = 64      # static INS-window length (pose samples)

    @classmethod
    def _pad_window(cls, w: dict) -> dict:
        """Fix the window length so feed() never recompiles: subsample
        evenly or edge-pad (interpolation clamps at the edges, so repeated
        boundary samples are harmless).  Even subsampling — not head
        truncation — keeps priors accurate across the whole batch when a
        large packet batch spans more INS samples than WINDOW_LEN."""
        L = cls.WINDOW_LEN
        n = len(w["rel_s"])
        out = {}
        if n > L:
            idx = np.linspace(0, n - 1, L).round().astype(np.int64)
            for k, v in w.items():
                out[k] = v[idx]
        else:
            for k, v in w.items():
                pad = [(0, L - n)] + [(0, 0)] * (v.ndim - 1)
                out[k] = np.pad(v, pad, mode="edge")
        return out

    def feed(self, pkts, times_us, track_window) -> None:
        """Consume one packet batch.  The open-frame time anchor stays a
        DEVICE scalar (carried into the next call after a host-known
        anchor shift) so streaming performs no device→host readbacks."""
        track_window = self._pad_window(track_window)
        anchor = int(times_us[0])
        if self._stream_t0_us is None:
            self._stream_t0_us = anchor
            prev_anchor = anchor
            open_dev = jnp.asarray(0.0, jnp.float32)
        else:
            prev_anchor = self._open_anchor
            open_dev = self._open_start_dev
        carry_start = open_dev + jnp.asarray(
            (prev_anchor - anchor) * 1e-6, jnp.float32)
        rel = jnp.asarray((times_us - anchor) * 1e-6, jnp.float32)
        batch_rel = jnp.asarray((anchor - self._stream_t0_us) * 1e-6,
                                jnp.float32)
        trk = (jnp.asarray(track_window["rel_s"]),
               jnp.asarray(track_window["q"]),
               jnp.asarray(track_window["t"]),
               jnp.asarray(track_window["v"]))
        if self.batched:
            self.state, open_start = odometry_step_batched(
                self.state, jnp.asarray(pkts), self.calib, rel, carry_start,
                batch_rel, *trk,
                model=self.model, n_beams=self.n_beams,
                reg_points=self.reg_points,
                reg_iterations=self.reg_iterations,
                max_frames_batch=self._feed_slots or self.MAX_FRAMES_BATCH,
                use_dense=self.use_dense,
                reassociate_every=self.reassociate_every,
                sample_assembly=self.sample_assembly,
                map_decay=self.map_decay)
        elif self.fused:
            self.state, open_start = odometry_step(
                self.state, jnp.asarray(pkts), self.calib, rel, carry_start,
                batch_rel, *trk,
                model=self.model, n_beams=self.n_beams,
                reg_points=self.reg_points,
                reg_iterations=self.reg_iterations,
                max_frames_batch=self.MAX_FRAMES_BATCH,
                reassociate_every=self.reassociate_every,
                map_decay=self.map_decay)
        else:
            # Chained path: smaller programs that compile faster than the
            # fused step — useful for iteration.
            fb_xyz, fb_mask, n_done, starts, carry2, open_start = (
                assemble_step(self.state.carry, jnp.asarray(pkts),
                              self.calib, rel, carry_start, *trk,
                              model=self.model, n_beams=self.n_beams,
                              max_frames_batch=self.MAX_FRAMES_BATCH))
            self.state = self.state._replace(carry=carry2)
            for k_dev in self._slot_idx:
                self.state = frame_step(
                    self.state, k_dev, fb_xyz, fb_mask, starts, n_done,
                    batch_rel, *trk,
                    reg_points=self.reg_points,
                    reg_iterations=self.reg_iterations,
                    reassociate_every=self.reassociate_every)
        self._open_start_dev = open_start
        self._open_anchor = anchor
