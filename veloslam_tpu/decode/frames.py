"""Streaming frame assembly: decoded packet batches → dense per-beam frames.

A frame is one LiDAR revolution, stored as fixed-shape padded tensors
(the static-shape replacement for the reference's growable per-beam PCL
vectors, reference HDLFrame.h:13-47 / HDLParser.cxx:570-579):

    xyz       (L, MAX_F, 3) float32   L = beams, MAX_F = max points/beam
    intensity (L, MAX_F)    float32
    rel_s     (L, MAX_F)    float32   firing time relative to frame start
    azimuth   (L, MAX_F)    float32   interpolated azimuth ticks (PointMeta
                                      parity, reference type_defs.h:168-176)
    mask      (L, MAX_F)    bool

Assembly is a jitted, carry-threaded step: each call consumes one decoded
batch plus the open-frame carry and emits up to `max_frames` completed
frames (static slot count; `n_completed` says how many are real).  This
replaces the reference's sequential splitFrame state machine
(HDLParser.cxx:867-897, 1035-1039) with a parallel scan:
wrap flags → cumsum frame ids → one scatter.

Position bookkeeping per sensor model:
  * hdl32: one block = one firing of 32 lasers → position = block index
    within frame.
  * hdl64: an upper (0xeeff) + lower (0xddff) block pair is one 64-laser
    firing → position counts upper blocks only.
  * vlp16: one block holds two 16-laser sub-firings → position =
    2·block-index + sub-firing.

Time base: `pkt_rel_s` and `carry_start_rel_s` are float32 seconds in the
*current batch's* time base (host keeps absolute int64 µs anchors and
rebases the carry each batch); stored `rel_s` is frame-relative, which keeps
float32 precise (frames last ~0.1 s) and batch-invariant.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from veloslam_tpu import constants as C
from veloslam_tpu.decode.decode import DecodedBatch, frame_break_flags


class FrameBatch(NamedTuple):
    """`max_frames` padded frame slots (leading axis = slot)."""

    xyz: jax.Array        # (S, L, MAX_F, 3)
    intensity: jax.Array  # (S, L, MAX_F)
    rel_s: jax.Array      # (S, L, MAX_F) — relative to the frame start
    azimuth: jax.Array    # (S, L, MAX_F)
    mask: jax.Array       # (S, L, MAX_F)
    n_points: jax.Array   # (S,) int32


class AssemblyCarry(NamedTuple):
    """Open-frame state threaded between batches."""

    xyz: jax.Array        # (L, MAX_F, 3)
    intensity: jax.Array  # (L, MAX_F)
    rel_s: jax.Array      # (L, MAX_F) — frame-relative
    azimuth: jax.Array    # (L, MAX_F)
    mask: jax.Array       # (L, MAX_F)
    n_firings: jax.Array  # () int32 — firing positions already consumed
    last_azimuth: jax.Array  # () int32

    @staticmethod
    def init(n_beams: int, max_firings: int = C.MAX_FIRINGS_PER_FRAME
             ) -> "AssemblyCarry":
        L, F = n_beams, max_firings
        return AssemblyCarry(
            xyz=jnp.zeros((L, F, 3), jnp.float32),
            intensity=jnp.zeros((L, F), jnp.float32),
            rel_s=jnp.zeros((L, F), jnp.float32),
            azimuth=jnp.zeros((L, F), jnp.float32),
            mask=jnp.zeros((L, F), bool),
            n_firings=jnp.asarray(0, jnp.int32),
            last_azimuth=jnp.asarray(-1, jnp.int32),
        )


@functools.partial(jax.jit, static_argnames=("model", "n_beams", "max_frames",
                                             "max_firings", "lean"))
def assemble_frames(decoded: DecodedBatch, xyz_world: jax.Array,
                    pkt_rel_s: jax.Array, carry: AssemblyCarry,
                    carry_start_rel_s: jax.Array, *, model: str,
                    n_beams: int, max_frames: int = 8,
                    max_firings: int = C.MAX_FIRINGS_PER_FRAME,
                    lean: bool = False
                    ) -> Tuple[FrameBatch, jax.Array, jax.Array,
                               AssemblyCarry, jax.Array]:
    """One assembly step.

    Args:
      decoded: decode_packets output, (N, 12, 32) leading shape.
      xyz_world: compensated points (N, 12, 32, 3) (pass decoded.xyz to skip
        compensation).
      pkt_rel_s: (N,) packet times (float32 s, batch time base).
      carry: open-frame state from the previous call.
      carry_start_rel_s: () float32 — the open frame's start time expressed
        in *this* batch's time base (ignored when carry.n_firings == 0).
    Returns:
      (frames: FrameBatch with max_frames slots,
       n_completed: () int32 — valid slots (≤ max_frames; batches containing
         more completed frames than max_frames lose the excess — size
         max_frames for > packets·12/min-firings-per-rev),
       start_rel_s: (max_frames,) float32 — frame start per slot, batch base,
       new carry,
       open_start_rel_s: () float32 — the new open frame's start, batch base).

    `lean=True` skips the intensity / rel_s / azimuth scatters (three of
    the five big scatter programs) and returns zeros in those FrameBatch
    fields — the odometry fast path consumes only xyz + mask.
    A stream's lean flag is ALL-OR-NOTHING: a lean step zeroes those
    fields in the carried open frame too, so mixing lean and non-lean
    steps on the same carry would silently corrupt the boundary frame's
    intensity/rel_s/azimuth (every carry-threaded caller is uniformly
    lean or uniformly not).
    """
    lasers = C.HDL_LASERS_PER_FIRING
    N = decoded.xyz.shape[0]
    B = N * C.HDL_FIRINGS_PER_PACKET        # firing blocks in batch
    L, F, S = n_beams, max_firings, max_frames
    TRASH = S + 1                            # distinct slot for dropped writes
    ppb = 2 if model == "vlp16" else 1       # positions per block

    breaks, last_az = frame_break_flags(decoded.az_ticks, carry.last_azimuth)
    fid = jnp.cumsum(breaks.astype(jnp.int32))          # (B,) 0..K
    n_frames = fid[-1] + 1

    # Firing-position units per block (HDL-64 pairs share one position).
    flat_upper = decoded.is_upper.reshape(-1)
    if model == "hdl64":
        unit = flat_upper.astype(jnp.int32)
    else:
        unit = jnp.ones((B,), jnp.int32)
    cum = jnp.cumsum(unit)                              # inclusive count
    # Units consumed before each frame's first block.
    seg_base = jax.ops.segment_max(
        jnp.where(breaks, cum - unit, -1), fid, num_segments=S + 2,
        indices_are_sorted=True)
    base = jnp.where(fid == 0, -carry.n_firings, seg_base[jnp.minimum(fid, S + 1)])
    pos = jnp.maximum(cum - 1 - base, 0)                # block position

    # Block time (batch base) and per-frame start time.
    rel_block = pkt_rel_s.repeat(C.HDL_FIRINGS_PER_PACKET) + \
        decoded.dt_s[:, :, 0].reshape(-1)               # (B,)
    seg_start = jax.ops.segment_min(rel_block, fid, num_segments=S + 2,
                                    indices_are_sorted=True)
    start0 = jnp.where(carry.n_firings > 0, carry_start_rel_s, seg_start[0])
    seg_start = seg_start.at[0].set(start0)
    frame_start = seg_start[jnp.minimum(fid, S + 1)]    # (B,)

    # Per-point scatter indices: (slot, laser, position).
    slot_b = jnp.minimum(fid, TRASH)
    pos_pt = (pos[:, None] * ppb
              + decoded.subfiring.reshape(B, lasers))   # (B, 32)
    valid_pt = decoded.valid.reshape(B, lasers)
    ok = valid_pt & (pos_pt < F)
    sl = jnp.where(ok, slot_b[:, None], TRASH)
    pp = jnp.where(ok, jnp.minimum(pos_pt, F - 1), F - 1)
    lp = jnp.clip(decoded.laser_id.reshape(B, lasers), 0, L - 1)
    # Flat linear scatter indices: a computed flat index into a reshaped
    # buffer takes the single-axis scatter path instead of a
    # multi-dimensional one.
    flat_idx = ((sl * L + lp) * F + pp).reshape(-1)     # (B*32,)
    M = (S + 2) * L * F

    def scatter(carry_arr, vals, extra=()):
        buf = jnp.zeros((S + 2, L, F, *extra), carry_arr.dtype)
        buf = buf.at[0].set(carry_arr).reshape(M, *extra)
        out = buf.at[flat_idx].set(vals.reshape(-1, *extra), mode="drop")
        return out.reshape(S + 2, L, F, *extra)

    def zeros_like_buf(carry_arr, extra=()):
        return jnp.zeros((S + 2, L, F, *extra), carry_arr.dtype)

    xyz_buf = scatter(carry.xyz, xyz_world.reshape(B, lasers, 3), (3,))
    if lean:
        int_buf = zeros_like_buf(carry.intensity)
        rel_buf = zeros_like_buf(carry.rel_s)
        az_buf = zeros_like_buf(carry.azimuth)
    else:
        rel_pt = (rel_block[:, None] + (decoded.dt_s.reshape(B, lasers)
                                        - decoded.dt_s[:, :, :1].reshape(B, 1)))
        rel_frame_pt = rel_pt - frame_start[:, None]    # frame-relative
        int_buf = scatter(carry.intensity, decoded.intensity.reshape(B, lasers))
        rel_buf = scatter(carry.rel_s, rel_frame_pt)
        az_buf = scatter(carry.azimuth, decoded.az_pt_ticks.reshape(B, lasers))
    mask_buf = scatter(carry.mask, jnp.ones_like(ok))
    # Clear anything that landed in the trash slot's real rows.
    mask_buf = mask_buf.at[TRASH].set(False)

    # Per-slot bookkeeping.
    units_per_frame = jax.ops.segment_sum(unit, fid, num_segments=S + 2,
                                          indices_are_sorted=True)
    units_per_frame = units_per_frame.at[0].add(carry.n_firings)

    n_completed = jnp.minimum(n_frames - 1, S)
    open_slot = n_completed

    mask_out = mask_buf[:S]
    frames = FrameBatch(
        xyz=xyz_buf[:S], intensity=int_buf[:S], rel_s=rel_buf[:S],
        azimuth=az_buf[:S], mask=mask_out,
        n_points=mask_out.sum(axis=(1, 2)).astype(jnp.int32))

    def take_open(buf):
        return jax.lax.dynamic_index_in_dim(buf, open_slot, 0, keepdims=False)

    new_carry = AssemblyCarry(
        xyz=take_open(xyz_buf), intensity=take_open(int_buf),
        rel_s=take_open(rel_buf), azimuth=take_open(az_buf),
        mask=take_open(mask_buf),
        n_firings=jax.lax.dynamic_index_in_dim(
            units_per_frame, open_slot, 0, keepdims=False),
        last_azimuth=last_az)

    open_start = jax.lax.dynamic_index_in_dim(seg_start, open_slot, 0,
                                              keepdims=False)
    return frames, n_completed, seg_start[:S], new_carry, open_start


def frame_points(frame_xyz: jax.Array, frame_mask: jax.Array
                 ) -> Tuple[jax.Array, jax.Array]:
    """Flatten a frame's (L, MAX_F, 3)+mask into (L·MAX_F, 3)+mask."""
    return frame_xyz.reshape(-1, 3), frame_mask.reshape(-1)


# --- gather-based frame sampling (the odometry fast path) --------------------
#
# assemble_frames scatters every decoded point into dense (slot, laser,
# position) frame tensors — 4 channels x 6.3M writes per 16384-packet
# batch, followed by a histogram subsample that immediately throws 3/4 of
# the scattered points away.  But decode output is already
# FRAME-CONTIGUOUS: firing blocks are in time order, so a frame is a
# contiguous block range [start, end) of the (N*12, 32) array.  The
# odometry path only needs `reg_points` points per frame with masks —
# which is a strided GATHER of whole 32-laser block rows from the decode
# output (plus the open-frame carry), no scatters at all.

class SampleCarry(NamedTuple):
    """Open-frame compensated blocks carried between batches,
    RIGHT-ALIGNED: occupied rows are [Fc - n_blocks, Fc)."""

    xyz: jax.Array           # (Fc, 32, 3) float32, world frame
    valid: jax.Array         # (Fc, 32) bool
    laser: jax.Array         # (Fc, 32) int32 — output beam row (hash key)
    n_blocks: jax.Array      # () int32
    last_azimuth: jax.Array  # () int32

    @staticmethod
    def init(max_firings: int = C.MAX_FIRINGS_PER_FRAME) -> "SampleCarry":
        F = max_firings
        return SampleCarry(
            xyz=jnp.zeros((F, C.HDL_LASERS_PER_FIRING, 3), jnp.float32),
            valid=jnp.zeros((F, C.HDL_LASERS_PER_FIRING), bool),
            laser=jnp.zeros((F, C.HDL_LASERS_PER_FIRING), jnp.int32),
            n_blocks=jnp.asarray(0, jnp.int32),
            last_azimuth=jnp.asarray(-1, jnp.int32))


class SampledFrames(NamedTuple):
    """Per-slot sampled points (leading axis = frame slot)."""

    xyz: jax.Array      # (S, P, 3) float32 — world frame (compensated)
    mask: jax.Array     # (S, P) bool


def _bit_reverse(x: jax.Array, bits: int) -> jax.Array:
    r = jnp.zeros_like(x)
    for i in range(bits):
        r = r | (((x >> i) & 1) << (bits - 1 - i))
    return r


@functools.partial(jax.jit, static_argnames=(
    "model", "max_frames", "points_per_frame", "max_firings"))
def sample_frames(decoded: DecodedBatch, xyz_world: jax.Array,
                  pkt_rel_s: jax.Array, carry: SampleCarry,
                  carry_start_rel_s: jax.Array, *, model: str,
                  max_frames: int, points_per_frame: int,
                  max_firings: int = C.MAX_FIRINGS_PER_FRAME
                  ) -> Tuple[SampledFrames, jax.Array, jax.Array,
                             SampleCarry, jax.Array]:
    """Segment the batch into frames and select `points_per_frame` points
    per completed frame — the odometry fast path.

    Same contract as assemble_frames minus the dense frame tensors:
    returns (frames: SampledFrames, n_completed, start_rel_s (S,),
    new carry, open_start_rel_s).

    Selection law: per frame, the valid points with the SMALLEST
    multiplicative hash of their assembled flat index
    (laser·max_firings + firing position) — the SAME low-discrepancy set
    the histogram subsample picks from assembled frames
    (runtime/odometry._subsample), found here with one (slot, hash) key
    sort over the decode output + a rank gather, instead of the
    scatter-assembled frame tensors + per-slot histograms.  The output is
    ordered by ascending hash, so any prefix of the P axis is itself a
    uniform subsample (the keyframe / map-integration contract).  Selection-law fidelity is load-bearing:
    structured samplers (whole/partial firing blocks, coupled lattices)
    leave vertical point strings or laser-pinned azimuth bands whose
    voxel statistics break registration on observability-marginal scenes.

    Known deviation: ties inside one 16-bit hash bin break by decode
    order, not assembled-frame order (≈ tens of points per frame), and
    HDL-64 firing positions use block-pair index parity rather than the
    exact upper-block count, so its hash draw differs from the assembled
    path's (same distribution).

    Frames longer than `max_firings` firing positions contribute only
    their first `max_firings` positions (matches assemble_frames
    dropping positions ≥ MAX_F); the carry keeps the open frame's newest
    `max_firings` blocks.
    """
    lasers = C.HDL_LASERS_PER_FIRING
    N = decoded.xyz.shape[0]
    B = N * C.HDL_FIRINGS_PER_PACKET
    Fc, S = max_firings, max_frames
    P = points_per_frame
    ppb = 2 if model == "vlp16" else 1

    breaks, last_az = frame_break_flags(decoded.az_ticks, carry.last_azimuth)
    fid = jnp.cumsum(breaks.astype(jnp.int32))              # (B,)
    n_frames = fid[-1] + 1
    n_completed = jnp.minimum(n_frames - 1, S)
    fid_c = jnp.minimum(fid, S + 1)

    row = jnp.arange(B, dtype=jnp.int32) + Fc               # block units
    seg_first = jax.ops.segment_min(row, fid_c, num_segments=S + 2,
                                    indices_are_sorted=True)
    seg_last = jax.ops.segment_max(row, fid_c, num_segments=S + 2,
                                   indices_are_sorted=True)
    # Frame 0 may extend back into the carry (and may even be carry-ONLY
    # when the batch's first block opens a new frame — then the batch
    # segment 0 is empty and seg_last must still cover the carry rows).
    has_carry = carry.n_blocks > 0
    first0 = Fc - jnp.minimum(carry.n_blocks, Fc)
    seg_first = seg_first.at[0].set(
        jnp.where(has_carry, first0, seg_first[0]))
    seg_last = seg_last.at[0].set(
        jnp.where(has_carry, jnp.maximum(seg_last[0], Fc - 1), seg_last[0]))

    rel_block = pkt_rel_s.repeat(C.HDL_FIRINGS_PER_PACKET) + \
        decoded.dt_s[:, :, 0].reshape(-1)                   # (B,)
    seg_start = jax.ops.segment_min(rel_block, fid_c, num_segments=S + 2,
                                    indices_are_sorted=True)
    seg_start = seg_start.at[0].set(
        jnp.where(has_carry, carry_start_rel_s, seg_start[0]))

    # --- per-point hash keys over the CONCAT (carry ++ batch) order ----------
    # Firing position within the frame, in block(-pair) units.
    first_of = seg_first[jnp.minimum(fid_c, S + 1)]         # (B,)
    blk_in_frame = row - first_of
    if model == "hdl64":
        pos_b = blk_in_frame // 2
    else:
        pos_b = blk_in_frame
    pos_pt = (pos_b[:, None] * ppb
              + decoded.subfiring.reshape(B, lasers))       # (B, 32)
    # Beam rows go to 63 on HDL-64; the hash key only needs distinctness.
    las_b = jnp.clip(decoded.laser_id.reshape(B, lasers), 0, 63)
    ok_b = decoded.valid.reshape(B, lasers) & (pos_pt < Fc)

    # Carry points: frame 0, position = row − first0 (block units).
    crow = jnp.arange(Fc, dtype=jnp.int32)
    cpos_b = crow - first0
    if model == "hdl64":
        cpos_b = cpos_b // 2
    if model == "vlp16":
        csub = (jnp.arange(lasers, dtype=jnp.int32) // 16)[None, :]
    else:
        csub = jnp.zeros((1, lasers), jnp.int32)
    cpos_pt = cpos_b[:, None] * ppb + csub
    ok_c = carry.valid & (cpos_pt >= 0) & (cpos_pt < Fc)

    flat_c = carry.laser * Fc + jnp.clip(cpos_pt, 0, Fc - 1)
    flat_b = las_b * Fc + jnp.clip(pos_pt, 0, Fc - 1)
    slot_c = jnp.zeros((Fc, lasers), jnp.int32)
    slot_b = jnp.broadcast_to(fid_c[:, None], (B, lasers))
    flat = jnp.concatenate([flat_c.reshape(-1), flat_b.reshape(-1)])
    slot = jnp.concatenate([slot_c.reshape(-1), slot_b.reshape(-1)])
    ok = jnp.concatenate([ok_c.reshape(-1), ok_b.reshape(-1)])
    # 16-bit hash, identical to _subsample's.
    h = ((flat.astype(jnp.uint32) * jnp.uint32(2654435761)) >> 16
         ).astype(jnp.int32)
    # Sort key: (slot | hash); invalid points sort last (slot sentinel).
    key = jnp.where(ok, (jnp.minimum(slot, S + 1) << 16) | h,
                    jnp.int32((S + 2) << 16))
    Ncat = (Fc + B) * lasers
    src = jnp.arange(Ncat, dtype=jnp.int32)
    skeys, order = jax.lax.sort((key, src), num_keys=1)     # stable

    # Slot boundaries in the sorted key space.
    slot_starts = jnp.searchsorted(
        skeys, jnp.arange(S + 1, dtype=jnp.int32) << 16).astype(jnp.int32)
    counts = slot_starts[1:] - slot_starts[:-1]             # (S,)
    slot_done = jnp.arange(S) < n_completed
    r = jnp.arange(P, dtype=jnp.int32)
    take = slot_starts[:S, None] + r[None, :]               # (S, P)
    sel_ok = (r[None, :] < jnp.minimum(counts[:, None], P)) \
        & slot_done[:, None]
    take = jnp.clip(take, 0, Ncat - 1)
    pick = order[take]                                      # (S, P)

    cat_xyz = jnp.concatenate(
        [carry.xyz.reshape(Fc * lasers, 3),
         xyz_world.reshape(B * lasers, 3)])
    pts = cat_xyz[pick]                                     # (S, P, 3)
    frames = SampledFrames(xyz=pts, mask=sel_ok)

    # New carry: the open frame's BLOCKS, right-aligned into (Fc,) buffers.
    open_id = jnp.minimum(n_frames - 1, S + 1)
    open_first_blk = jax.lax.dynamic_index_in_dim(
        seg_first, open_id, 0, keepdims=False)
    open_first_blk = jnp.maximum(open_first_blk, B)   # newest Fc blocks only
    cat_valid_blk = jnp.concatenate(
        [carry.valid, decoded.valid.reshape(B, lasers)])
    cat_laser_blk = jnp.concatenate(
        [carry.laser, las_b.reshape(B, lasers)])
    cat_xyz_blk = cat_xyz.reshape(Fc + B, lasers, 3)
    tail_xyz = jax.lax.dynamic_slice_in_dim(cat_xyz_blk, B, Fc)
    tail_valid = jax.lax.dynamic_slice_in_dim(cat_valid_blk, B, Fc)
    tail_laser = jax.lax.dynamic_slice_in_dim(cat_laser_blk, B, Fc)
    keep = (jnp.arange(Fc, dtype=jnp.int32) + B) >= open_first_blk
    new_carry = SampleCarry(
        xyz=tail_xyz, valid=tail_valid & keep[:, None], laser=tail_laser,
        n_blocks=(Fc + B) - open_first_blk,
        last_azimuth=last_az)
    open_start = jax.lax.dynamic_index_in_dim(seg_start, open_id, 0,
                                              keepdims=False)
    return frames, n_completed, seg_start[:S], new_carry, open_start
