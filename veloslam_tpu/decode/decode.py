"""Vectorized HDL packet decode — the array-program replacement for the
reference's per-point hot loop.

The reference decodes packet-by-packet, firing-by-firing, laser-by-laser
(reference HDLParser.cxx:980-1055 → processFiring 900-977 → pushFiringData
587-752, ~384 scalar iterations per packet).  Here a whole batch of packets
is decoded as one jitted program over dense (N, 12, 32) arrays:

  * byte-level field extraction via integer arithmetic on uint8 views,
  * per-packet azimuth-rate estimate (median of block diffs,
    HDLParser.cxx:1016-1026),
  * per-laser time/azimuth interpolation with the HDL-32/VLP-16 timing
    models (HDLParser.cxx:133-145, 945-962),
  * polar → Cartesian with the 5-term laser calibration
    (HDLParser.cxx:597-623),
  * crop-region filtering (HDLParser.cxx:629-639) as mask updates.

No sin/cos lookup tables: the reference's 36001-entry LUT
(HDLParser.cxx:755-768) is a CPU trick; on an accelerator evaluating the
transcendentals elementwise is cheaper than a 36001-wide gather.

Motion compensation interpolates an INS pose per firing (finer than the
reference's per-packet interpolation, HDLParser.cxx:989-1007) and applies a
full SE(3) transform per point — fixing the reference's translation-only
de-skew, which its own comment calls "not strictly accurate"
(HDLParser.cxx:249-254).  A `per_packet` parity mode reproduces the coarse
behavior for comparison tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from veloslam_tpu import constants as C
from veloslam_tpu.core import se3
from veloslam_tpu.core.timeline import interpolate_poses


class DeviceCalib(NamedTuple):
    """Device-resident per-laser calibration (see calibration.LaserCalib)."""

    rot_correction_deg: jax.Array   # (L,)
    sin_vert: jax.Array             # (L,)
    cos_vert: jax.Array             # (L,)
    dist_correction_m: jax.Array    # (L,)
    vert_offset_m: jax.Array        # (L,)
    horiz_offset_m: jax.Array       # (L,)
    laser_enabled: jax.Array        # (L,) bool — laser selection mask
    beam_row: jax.Array             # (L,) int32 — wire laser id → output
    # frame row.  Identity except HDL-64, whose wire order interleaves the
    # two 32-laser blocks; the reference re-sorts beams by vertical angle
    # at frame split (HDLParser.cxx:179-187, applied 880-893) so frames
    # read bottom beam → top beam.

    @classmethod
    def from_host(cls, calib, enabled=None, sort_beams=None) -> "DeviceCalib":
        """`enabled`: (L,) bool laser-selection mask (setLaserSelection
        parity, reference HDLParser.h:101-124).  `sort_beams`: order output
        frame rows by ascending vertical angle; default True for 64-laser
        calibrations (the reference's HDL64BeamLUT contract), False
        otherwise (wire order)."""
        import numpy as np
        L = calib.n_lasers
        en = np.ones(L, bool) if enabled is None else np.asarray(enabled, bool)
        if sort_beams is None:
            sort_beams = L == 64
        if sort_beams:
            rows = np.argsort(calib.beam_order())    # inverse permutation
        else:
            rows = np.arange(L)
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        return cls(f32(calib.rot_correction_deg), f32(calib.sin_vert),
                   f32(calib.cos_vert), f32(calib.dist_correction_m),
                   f32(calib.vert_offset_m), f32(calib.horiz_offset_m),
                   jnp.asarray(en), jnp.asarray(rows, jnp.int32))


class DecodedBatch(NamedTuple):
    """Dense decode of N packets: leading shape (N, 12, 32)."""

    xyz: jax.Array          # (N, 12, 32, 3) float32, sensor frame
    intensity: jax.Array    # (N, 12, 32) float32
    dist_m: jax.Array       # (N, 12, 32) float32
    valid: jax.Array        # (N, 12, 32) bool
    laser_id: jax.Array     # (N, 12, 32) int32 — output beam row (ordered
    #                         bottom→top for HDL-64 via calib.beam_row)
    az_ticks: jax.Array     # (N, 12) int32 — raw block azimuth [0, 36000)
    az_pt_ticks: jax.Array  # (N, 12, 32) float32 — interpolated per point
    dt_s: jax.Array         # (N, 12, 32) float32 — firing offset from packet
    is_upper: jax.Array     # (N, 12) bool — HDL-64 upper block (0xeeff)
    subfiring: jax.Array    # (N, 12, 32) int32 — VLP-16 sub-firing (0 or 1)


def _u16(lo, hi):
    return lo.astype(jnp.int32) | (hi.astype(jnp.int32) << 8)


def parse_packet_fields(pkts_u8: jax.Array):
    """Raw (N, 1206) uint8 → block/return field arrays.

    Packet layout (reference HDLParser.cxx:67-87): 12 × 100-byte firing
    blocks [u16 block id, u16 azimuth, 32 × (u16 distance, u8 intensity)],
    then u32 GPS µs-into-hour at byte 1200 and two status bytes.
    All multi-byte fields little-endian.
    """
    n = pkts_u8.shape[0]
    blocks = pkts_u8[:, :1200].reshape(n, C.HDL_FIRINGS_PER_PACKET,
                                       C.HDL_FIRING_BYTES)
    block_id = _u16(blocks[..., 0], blocks[..., 1])
    az_ticks = _u16(blocks[..., 2], blocks[..., 3]) % C.AZIMUTH_TICKS_PER_REV
    rets = blocks[:, :, 4:].reshape(n, C.HDL_FIRINGS_PER_PACKET,
                                    C.HDL_LASERS_PER_FIRING, 3)
    dist_raw = _u16(rets[..., 0], rets[..., 1])
    intensity = rets[..., 2].astype(jnp.float32)
    gps = pkts_u8[:, 1200:1204].astype(jnp.uint32)
    gps_us = (gps[:, 0] | (gps[:, 1] << 8) | (gps[:, 2] << 16)
              | (gps[:, 3] << 24))
    return block_id, az_ticks, dist_raw, intensity, gps_us


def _timing_model(model: str):
    """Per-(block, dsr) firing time offsets (µs) and azimuth-interpolation
    fraction within a block (reference HDLParser.cxx:945-962)."""
    blocks = jnp.arange(C.HDL_FIRINGS_PER_PACKET, dtype=jnp.float32)[:, None]
    dsr = jnp.arange(C.HDL_LASERS_PER_FIRING, dtype=jnp.float32)[None, :]
    if model == "hdl32":
        t = blocks * C.HDL32_FIRING_BLOCK_US + dsr * C.HDL32_LASER_US
        frac = (dsr * C.HDL32_LASER_US) / C.HDL32_FIRING_BLOCK_US
    elif model == "vlp16":
        laser = jnp.where(dsr >= 16, dsr - 16, dsr)
        sub = jnp.where(dsr >= 16, 1.0, 0.0)
        within = laser * C.VLP16_LASER_US + sub * C.VLP16_SUBFIRING_US
        t = blocks * C.VLP16_FIRING_BLOCK_US + within
        frac = within / C.VLP16_FIRING_BLOCK_US
    elif model == "hdl64":
        # The reference applies no intra-block interpolation for HDL-64
        # (HDLParser.cxx:946-960 leaves the adjustment at 0 when the
        # calibration reports 64 lasers).  Block pairs share a firing time.
        t = (blocks // 2) * C.HDL32_FIRING_BLOCK_US + dsr * 0.0
        frac = dsr * 0.0
    else:
        raise ValueError(f"unknown sensor model {model!r}")
    return t, frac  # each (12, 32)


@functools.partial(jax.jit, static_argnames=("model", "crop_region",
                                             "crop_inside", "points_skip"))
def decode_packets(pkts_u8: jax.Array, calib: DeviceCalib, *, model: str,
                   crop_region: Optional[Tuple[float, ...]] = None,
                   crop_inside: bool = False,
                   points_skip: int = 0) -> DecodedBatch:
    """Decode (N, 1206) uint8 packets into sensor-frame points + masks."""
    block_id, az_ticks, dist_raw, intensity, _ = parse_packet_fields(pkts_u8)
    n = pkts_u8.shape[0]

    # Per-packet azimuth step: sorted-index-6 of the 11 block diffs, matching
    # the reference's nth_element(begin+6) selection (HDLParser.cxx:1016-1026).
    diffs = (az_ticks[:, 1:] - az_ticks[:, :-1]) % C.AZIMUTH_TICKS_PER_REV
    az_step = jnp.sort(diffs, axis=-1)[:, C.HDL_FIRINGS_PER_PACKET // 2]

    t_us, frac = _timing_model(model)
    dt_s = jnp.broadcast_to(t_us * 1e-6, (n, *t_us.shape))

    # Interpolated per-point azimuth (ticks, float) — reference rounds the
    # adjustment to integer ticks (HDLParser.cxx:961); we keep it continuous.
    az_pt = az_ticks[..., None].astype(jnp.float32) + \
        az_step[:, None, None].astype(jnp.float32) * frac[None]

    # Laser-id mapping to global beam index.
    dsr = jnp.arange(C.HDL_LASERS_PER_FIRING, dtype=jnp.int32)
    is_upper = block_id == C.BLOCK_ID_0_TO_31
    if model == "vlp16":
        laser_id = jnp.broadcast_to(jnp.where(dsr >= 16, dsr - 16, dsr),
                                    dist_raw.shape)
        corr_id = laser_id
        subfiring = jnp.broadcast_to((dsr >= 16).astype(jnp.int32),
                                     dist_raw.shape)
    elif model == "hdl64":
        offset = jnp.where(is_upper, 0, 32).astype(jnp.int32)
        laser_id = offset[..., None] + dsr
        corr_id = laser_id
        subfiring = jnp.zeros_like(laser_id)
    else:
        laser_id = jnp.broadcast_to(dsr, dist_raw.shape)
        corr_id = laser_id
        subfiring = jnp.zeros_like(laser_id)

    # Per-point corrections (gather by corrected laser id).
    rot = calib.rot_correction_deg[corr_id]
    sin_v = calib.sin_vert[corr_id]
    cos_v = calib.cos_vert[corr_id]
    d_corr = calib.dist_correction_m[corr_id]
    v_off = calib.vert_offset_m[corr_id]
    h_off = calib.horiz_offset_m[corr_id]

    # Polar → Cartesian (reference HDLParser.cxx:597-623).
    az_rad = jnp.deg2rad(az_pt / C.AZIMUTH_TICKS_PER_DEG - rot)
    sin_a, cos_a = jnp.sin(az_rad), jnp.cos(az_rad)
    dist_m = dist_raw.astype(jnp.float32) * C.DISTANCE_UNIT_M + d_corr
    xy = dist_m * cos_v
    x = xy * sin_a - h_off * cos_a
    y = xy * cos_a + h_off * sin_a
    z = dist_m * sin_v + v_off
    xyz = jnp.stack([x, y, z], axis=-1)

    # Output frame row: wire id through the beam re-sort LUT (identity
    # unless the calibration orders rows by vertical angle — HDL-64).
    laser_id = calib.beam_row[corr_id]

    valid = (dist_raw != 0) & calib.laser_enabled[corr_id]
    if points_skip:
        # Keep every (points_skip+1)-th firing block (HDLParser.cxx:1042).
        keep = (jnp.arange(C.HDL_FIRINGS_PER_PACKET) % (points_skip + 1)) == 0
        valid &= keep[None, :, None]
    if crop_region is not None:
        x0, x1, y0, y1, z0, z1 = crop_region
        inside = ((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
                  & (z >= z0) & (z <= z1))
        # crop_inside drops the inside; otherwise keep only the inside
        # (reference HDLParser.cxx:629-639 semantics).
        valid &= jnp.where(crop_inside, ~inside, inside)

    return DecodedBatch(xyz=xyz, intensity=intensity, dist_m=dist_m,
                        valid=valid, laser_id=laser_id,
                        az_ticks=az_ticks.astype(jnp.int32),
                        az_pt_ticks=az_pt, dt_s=dt_s, is_upper=is_upper,
                        subfiring=subfiring)


def dual_return_flags(decoded: DecodedBatch):
    """Per-point dual-return classification (batch-local).

    Dual-return sensors emit each firing twice with identical azimuth; the
    reference detects this by comparing consecutive block azimuths
    (HDLParser.cxx:908) and tags points with near/far and high/low-
    intensity flags (mask constants HDLParser.h:75-81).  Vectorized over
    the flattened block axis:

    Returns (dist_flag, int_flag, is_dual) with shapes (N, 12, 32):
      dist_flag: -1 nearer return, +1 farther, 0 single/equal;
      int_flag:  +1 higher intensity, -1 lower, 0 single/equal;
      is_dual:   True on both members of a dual pair.
    Pairs spanning a batch boundary are treated as single returns (the
    pipeline's batch size makes this a ≤1-firing effect per batch).
    """
    n = decoded.xyz.shape[0]
    shape = (n * C.HDL_FIRINGS_PER_PACKET, C.HDL_LASERS_PER_FIRING)
    az = decoded.az_ticks.reshape(-1)
    dist = decoded.dist_m.reshape(shape)
    inten = decoded.intensity.reshape(shape)
    prev_az = jnp.concatenate([jnp.full((1,), -1, az.dtype), az[:-1]])
    next_az = jnp.concatenate([az[1:], jnp.full((1,), -1, az.dtype)])
    second = az == prev_az                    # this block repeats previous
    first = az == next_az                     # next block repeats this one
    is_dual = (first | second)[:, None] & jnp.ones(shape, bool)
    # a pair is only "dual" where both members actually returned —
    # otherwise the surviving member must count as a single return
    valid = decoded.valid.reshape(shape)
    other_valid = jnp.where(second[:, None], jnp.roll(valid, 1, axis=0),
                            jnp.roll(valid, -1, axis=0))
    is_dual &= valid & other_valid

    other_dist = jnp.where(second[:, None],
                           jnp.roll(dist, 1, axis=0),
                           jnp.roll(dist, -1, axis=0))
    other_int = jnp.where(second[:, None],
                          jnp.roll(inten, 1, axis=0),
                          jnp.roll(inten, -1, axis=0))
    dist_flag = jnp.where(~is_dual, 0,
                          jnp.where(dist < other_dist, -1,
                                    jnp.where(dist > other_dist, 1, 0)))
    int_flag = jnp.where(~is_dual, 0,
                         jnp.where(inten > other_int, 1,
                                   jnp.where(inten < other_int, -1, 0)))
    rs = lambda a: a.reshape(n, C.HDL_FIRINGS_PER_PACKET,
                             C.HDL_LASERS_PER_FIRING)
    return (rs(dist_flag.astype(jnp.int8)), rs(int_flag.astype(jnp.int8)),
            rs(is_dual))


def apply_dual_return_filter(decoded: DecodedBatch, mode: str
                             ) -> DecodedBatch:
    """Keep one member of each dual pair (setDualReturnFilter equivalent,
    HDLParser.h:101-124 config surface).

    mode: "near" | "far" | "high" | "low".  Single returns always pass;
    exact-duplicate pairs (equal distance and intensity) keep only their
    first member (reference duplicate-drop, HDLParser.cxx:659-663).
    """
    dist_flag, int_flag, is_dual = dual_return_flags(decoded)
    az = decoded.az_ticks.reshape(-1)
    prev_az = jnp.concatenate([jnp.full((1,), -1, az.dtype), az[:-1]])
    second = (az == prev_az).reshape(is_dual.shape[:2])[..., None]
    if mode == "near":
        keep = dist_flag == -1
    elif mode == "far":
        keep = dist_flag == 1
    elif mode == "high":
        keep = int_flag == 1
    elif mode == "low":
        keep = int_flag == -1
    else:
        raise ValueError(f"unknown dual-return filter {mode!r}")
    # ties (flag 0 within a dual pair): keep the first member only
    tie = is_dual & (dist_flag == 0) & (int_flag == 0)
    keep = jnp.where(tie, ~second, keep)
    valid = decoded.valid & jnp.where(is_dual, keep, True)
    return decoded._replace(valid=valid)


def frame_break_flags(az_ticks: jax.Array, last_azimuth: jax.Array):
    """Azimuth-wrap frame segmentation as a parallel comparison.

    The reference tracks `lastAzimuth` sequentially and splits when a block's
    azimuth decreases (HDLParser.cxx:1035-1039).  Vectorized: flatten blocks,
    prepend the carried last azimuth, and compare neighbors.

    Args:
      az_ticks: (N, 12) int32 block azimuths.
      last_azimuth: () int32 azimuth of the block before this batch
        (use -1 before the first batch — never triggers a break).
    Returns:
      (flags (N*12,) bool — True where a new frame starts at this block,
       new last_azimuth () int32).
    """
    flat = az_ticks.reshape(-1)
    prev = jnp.concatenate([last_azimuth[None], flat[:-1]])
    return flat < prev, flat[-1]


@functools.partial(jax.jit, static_argnames=("per_packet",))
def compensate(decoded: DecodedBatch, pkt_rel_s: jax.Array,
               track_rel_s: jax.Array, track_q: jax.Array,
               track_t: jax.Array, track_v: jax.Array,
               *, per_packet: bool = False):
    """Motion compensation: sensor-frame points → world (local ENU) frame.

    Interpolates the INS pose at each firing's absolute time and applies the
    full SE(3) sensor pose to every point.  `per_packet=True` reproduces the
    reference's coarser one-pose-per-packet behavior
    (HDLParser.cxx:989-1007).

    Args:
      pkt_rel_s: (N,) packet times, float32 seconds, same base as track_rel_s.
    Returns:
      (xyz_world (N, 12, 32, 3) float32, firing poses se3.Pose with leading
      shape (N, 12)).
    """
    n = decoded.xyz.shape[0]
    if per_packet:
        q_t = pkt_rel_s
        poses = interpolate_poses(track_rel_s, track_q, track_t, track_v, q_t)
        poses = jax.tree.map(
            lambda a: jnp.broadcast_to(
                a[:, None], (n, C.HDL_FIRINGS_PER_PACKET, *a.shape[1:])),
            poses)
    else:
        block_dt = decoded.dt_s[:, :, 0]                       # (N, 12)
        q_t = (pkt_rel_s[:, None] + block_dt).reshape(-1)
        poses = interpolate_poses(track_rel_s, track_q, track_t, track_v, q_t)
        poses = jax.tree.map(
            lambda a: a.reshape(n, C.HDL_FIRINGS_PER_PACKET, *a.shape[1:]),
            poses)
    xyz_w = se3.apply(se3.Pose(poses.q[:, :, None], poses.t[:, :, None]),
                      decoded.xyz)
    return xyz_w, poses
