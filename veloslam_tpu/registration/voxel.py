"""Device voxel statistics grids — the array-program substitute for kd-trees.

The reference never implements correspondence search (its map layer is
data-structures-only, SURVEY.md §0); classic CPU SLAM uses kd-trees, which
do not map to static-shaped accelerator programs.  Instead, scans and
maps are summarized as voxel Gaussians (count / mean / covariance per
occupied voxel) built with a sort + segment-reduce — fully batched,
static shapes — and queried by binary search over sorted packed keys.
This is the standard voxelized-GICP / NDT data structure, built the
XLA-friendly way.

Key packing: quantized (x, y, z) voxel coordinates are offset into
[0, 2^bits) and packed into one int32 (default 10 bits per axis → ±512
voxels around the origin).  Out-of-range points are dropped via a sentinel
key that sorts last.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Sentinel for missing/invalid voxel keys.  Deliberately a Python int, NOT
# a module-level jnp scalar: importing the module must not create device
# arrays (that would initialize a backend at import time).
INVALID_KEY = 2**31 - 1


class VoxelGrid(NamedTuple):
    """Fixed-capacity voxel-Gaussian table, sorted by packed key.

    Padding rows have key == INVALID_KEY and count == 0.
    """

    keys: jax.Array       # (V,) int32, sorted ascending
    count: jax.Array      # (V,) float32
    mean: jax.Array       # (V, 3) float32
    cov: jax.Array        # (V, 3, 3) float32 (population covariance)
    origin: jax.Array     # (3,) float32 — key-space origin (world coords)
    voxel_size: jax.Array  # () float32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def occupied(self) -> jax.Array:
        return self.keys != INVALID_KEY


def pack_keys(pts: jax.Array, mask: jax.Array, origin: jax.Array,
              voxel_size: jax.Array, bits: int = 10) -> jax.Array:
    """Points (..., 3) → packed int32 voxel keys; masked/out-of-range →
    INVALID_KEY."""
    half = 2 ** (bits - 1)
    g = jnp.floor((pts - origin) / voxel_size).astype(jnp.int32) + half
    in_range = jnp.all((g >= 0) & (g < 2 ** bits), axis=-1)
    key = (g[..., 0] << (2 * bits)) | (g[..., 1] << bits) | g[..., 2]
    return jnp.where(mask & in_range, key, INVALID_KEY)


def unpack_keys(keys: jax.Array, origin: jax.Array, voxel_size: jax.Array,
                bits: int = 10) -> jax.Array:
    """Packed keys → voxel center coordinates (..., 3)."""
    half = 2 ** (bits - 1)
    mask_axis = (1 << bits) - 1
    gx = (keys >> (2 * bits)) & mask_axis
    gy = (keys >> bits) & mask_axis
    gz = keys & mask_axis
    g = jnp.stack([gx, gy, gz], -1).astype(jnp.float32) - half
    return origin + (g + 0.5) * voxel_size


@functools.partial(jax.jit, static_argnames=("capacity", "bits"))
def build_grid(pts: jax.Array, mask: jax.Array, origin: jax.Array,
               voxel_size, *, capacity: int, bits: int = 10) -> VoxelGrid:
    """Build a voxel-Gaussian grid from (P, 3) points + validity mask.

    Sort by key → segment boundaries → segment-reduce count/sum/outer.
    Voxels beyond `capacity` (in key order) are dropped; size capacity for
    the expected occupied-voxel count (≈ a few thousand per LiDAR scan at
    1 m voxels).
    """
    voxel_size = jnp.asarray(voxel_size, jnp.float32)
    origin = jnp.asarray(origin, jnp.float32)
    keys = pack_keys(pts, mask, origin, voxel_size, bits)
    order = jnp.argsort(keys)
    sk = keys[order]
    valid = sk != INVALID_KEY
    # Accumulate moments relative to each point's own voxel center: keeps
    # float32 covariances well-conditioned at map-scale coordinates
    # (E[x²]−E[x]² on ~100 m values loses ~all cov precision in fp32).
    centers = unpack_keys(sk, origin, voxel_size, bits)
    sp = pts[order] - centers

    new_seg = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]]) & valid
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1       # (P,) 0-based
    seg_id = jnp.where(valid, jnp.minimum(seg_id, capacity), capacity)

    # ONE fused (P, 13) segment_sum for count + first + second moments:
    # scatter cost scales with input size × channel count, and one wide
    # row scatter replaces three separate 1/3/9-channel ones.
    w = valid.astype(jnp.float32)
    outer = sp[:, :, None] * sp[:, None, :]
    payload = jnp.concatenate(
        [w[:, None], sp * w[:, None],
         outer.reshape(-1, 9) * w[:, None]], axis=1)         # (P, 13)
    sums = jax.ops.segment_sum(payload, seg_id, num_segments=capacity + 1,
                               indices_are_sorted=True)[:capacity]
    seg_keys = jax.ops.segment_min(jnp.where(valid, sk, INVALID_KEY), seg_id,
                                   num_segments=capacity + 1,
                                   indices_are_sorted=True)

    count = sums[:, 0]
    seg_keys = seg_keys[:capacity].astype(jnp.int32)
    denom = jnp.maximum(count, 1.0)[:, None]
    mean_rel = sums[:, 1:4] / denom
    cov = sums[:, 4:13].reshape(-1, 3, 3) / denom[..., None] \
        - mean_rel[:, :, None] * mean_rel[:, None, :]
    mean = mean_rel + unpack_keys(seg_keys, origin, voxel_size, bits)
    return VoxelGrid(keys=seg_keys, count=count, mean=mean, cov=cov,
                     origin=origin, voxel_size=voxel_size)


def lookup(grid: VoxelGrid, query_keys: jax.Array) -> jax.Array:
    """Indices of query keys in the grid (−1 where absent).  O(log V)
    batched binary search — replaces pointer-chasing tree lookups."""
    idx = jnp.searchsorted(grid.keys, query_keys)
    idx = jnp.clip(idx, 0, grid.capacity - 1)
    hit = grid.keys[idx] == query_keys
    return jnp.where(hit & (query_keys != INVALID_KEY), idx, -1)


def lookup_nearest(grid: VoxelGrid, pts: jax.Array, mask: jax.Array,
                   usable: jax.Array, bits: int = 10) -> jax.Array:
    """Index of the nearest usable voxel Gaussian among a point's own voxel
    and its 6 face neighbors (−1 if none).

    Querying only the containing voxel (plain VGICP) loses correspondences
    for points near voxel boundaries — catastrophically so for planar
    structure aligned with the grid.  Seven batched binary searches +
    a mean-distance argmin fix that while staying gather-only (no trees).
    Key-space wrap-around at the ±2^(bits-1) grid edge can alias a distant
    voxel; the distance argmin and the caller's residual gating make such
    aliases harmless.
    """
    keys = pack_keys(pts, mask, grid.origin, grid.voxel_size, bits)
    offsets = jnp.asarray([0, 1, -1, 1 << bits, -(1 << bits),
                           1 << (2 * bits), -(1 << (2 * bits))], jnp.int32)
    cand = jnp.where((keys == INVALID_KEY)[None, :], INVALID_KEY,
                     keys[None, :] + offsets[:, None])       # (7, P)
    idx7 = jax.vmap(lambda k: lookup(grid, k))(cand)         # (7, P)
    ok7 = (idx7 >= 0) & usable[jnp.maximum(idx7, 0)]
    mu7 = grid.mean[jnp.maximum(idx7, 0)]                    # (7, P, 3)
    d2 = jnp.sum((pts[None] - mu7) ** 2, axis=-1)
    d2 = jnp.where(ok7, d2, jnp.inf)
    best = jnp.argmin(d2, axis=0)                            # (P,)
    idx = jnp.take_along_axis(idx7, best[None], axis=0)[0]
    any_ok = jnp.any(ok7, axis=0)
    return jnp.where(any_ok, idx, -1)


def merge_stats(grid: VoxelGrid, other: VoxelGrid, *,
                capacity: int) -> VoxelGrid:
    """Merge two grids' sufficient statistics into a new grid of the given
    capacity (used by the incremental map, see veloslam_tpu.map)."""
    def moments(g: VoxelGrid):
        # Voxel-center-relative moments (same conditioning trick as
        # build_grid); padding rows contribute zero via count == 0.
        c = g.count[:, None]
        m_rel = g.mean - unpack_keys(g.keys, g.origin, g.voxel_size)
        s1 = m_rel * c
        s2 = (g.cov + m_rel[:, :, None] * m_rel[:, None, :]) * c[..., None]
        return s1, s2

    s1a, s2a = moments(grid)
    s1b, s2b = moments(other)
    keys = jnp.concatenate([grid.keys, other.keys])
    count = jnp.concatenate([grid.count, other.count])
    s1 = jnp.concatenate([s1a, s1b])
    s2 = jnp.concatenate([s2a, s2b])

    order = jnp.argsort(keys)
    sk = keys[order]
    valid = sk != INVALID_KEY
    new_seg = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]]) & valid
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    seg_id = jnp.where(valid, jnp.minimum(seg_id, capacity), capacity)

    cnt = jax.ops.segment_sum(count[order], seg_id,
                              num_segments=capacity + 1)[:capacity]
    s1m = jax.ops.segment_sum(s1[order], seg_id,
                              num_segments=capacity + 1)[:capacity]
    s2m = jax.ops.segment_sum(s2[order], seg_id,
                              num_segments=capacity + 1)[:capacity]
    seg_keys = jax.ops.segment_min(
        jnp.where(valid, sk, INVALID_KEY), seg_id,
        num_segments=capacity + 1)[:capacity]
    seg_keys = seg_keys.astype(jnp.int32)
    denom = jnp.maximum(cnt, 1.0)[:, None]
    mean_rel = s1m / denom
    cov = s2m / denom[..., None] - mean_rel[:, :, None] * mean_rel[:, None, :]
    mean = mean_rel + unpack_keys(seg_keys, grid.origin, grid.voxel_size)
    return VoxelGrid(keys=seg_keys, count=cnt, mean=mean,
                     cov=cov, origin=grid.origin, voxel_size=grid.voxel_size)


@functools.partial(jax.jit, static_argnames=("bits",))
def rebase_grid(grid: VoxelGrid, new_center: jax.Array,
                bits: int = 10) -> VoxelGrid:
    """Shift the grid's key-space origin to (voxel-aligned) `new_center`,
    re-keying every voxel on device.

    Packed keys bound the grid to ±2^(bits−1) voxels around the origin;
    a long drive walks out of that window and new points start dropping
    to INVALID_KEY.  Rebasing translates the integer coordinates by the
    origin delta (voxels that leave the window are dropped — they are
    behind the vehicle) and re-sorts so binary-search lookups stay valid.
    Statistics (count/mean/cov, world coordinates) are unchanged.
    """
    d = jnp.round((new_center - grid.origin) / grid.voxel_size
                  ).astype(jnp.int32)                         # (3,) voxels
    new_origin = grid.origin + d.astype(jnp.float32) * grid.voxel_size
    half = 1 << (bits - 1)
    axis_mask = (1 << bits) - 1
    keys = grid.keys
    g = jnp.stack([(keys >> (2 * bits)) & axis_mask,
                   (keys >> bits) & axis_mask,
                   keys & axis_mask], -1) - d                 # shifted
    ok = grid.occupied & jnp.all((g >= 0) & (g < (1 << bits)), axis=-1)
    gc = jnp.clip(g, 0, axis_mask)
    new_keys = jnp.where(
        ok, (gc[:, 0] << (2 * bits)) | (gc[:, 1] << bits) | gc[:, 2],
        INVALID_KEY)
    order = jnp.argsort(new_keys)
    return VoxelGrid(
        keys=new_keys[order],
        count=jnp.where(ok, grid.count, 0.0)[order],
        mean=grid.mean[order], cov=grid.cov[order],
        origin=new_origin, voxel_size=grid.voxel_size)


# --- dense spatial index (O(1) lookup) ---------------------------------------

class DenseIndex(NamedTuple):
    """Direct-mapped 3-D occupancy index over a grid's bounding box.

    `table[x, y, z]` holds the row index into the VoxelGrid arrays (or −1).
    Replaces the 7 binary searches of `lookup_nearest` with 7 direct
    gathers — the registration inner loop becomes O(1) per point.  Memory:
    prod(shape)·4 B in HBM (8 MB at the default 256×256×32 box: ±128 m
    xy, ±16 m z around the occupied-voxel median at 1 m voxels — the
    build cost is proportional to the box, and the z span of a drive is
    small; window truncation is observable via `window_coverage`).
    """

    table: jax.Array     # (X, Y, Z) int32
    lo: jax.Array        # (3,) int32 — key-space coords of table[0,0,0]


@functools.partial(jax.jit, static_argnames=("shape", "bits"))
def build_dense_index(grid: VoxelGrid, *, shape=(256, 256, 32),
                      bits: int = 10) -> DenseIndex:
    """Scatter the grid's occupied rows into a dense box centered on the
    occupied voxels' median coordinate."""
    half = 1 << (bits - 1)
    axis_mask = (1 << bits) - 1
    keys = grid.keys
    occ = grid.occupied
    g = jnp.stack([(keys >> (2 * bits)) & axis_mask,
                   (keys >> bits) & axis_mask,
                   keys & axis_mask], -1)                    # (V, 3)
    # Center the box on the median occupied coordinate (outliers don't
    # shift the window); empty grids degrade gracefully to lo = center.
    med = jnp.median(jnp.where(occ[:, None], g, half), axis=0)
    lo = (med.astype(jnp.int32)
          - jnp.asarray(shape, jnp.int32) // 2)
    rel = g - lo
    inside = occ & jnp.all((rel >= 0) & (rel < jnp.asarray(shape)), axis=-1)
    rows = jnp.arange(grid.capacity, dtype=jnp.int32)
    # Outside rows get an out-of-bounds x index and are dropped.
    table = jnp.full(shape, -1, jnp.int32).at[
        jnp.where(inside, rel[:, 0], shape[0]),
        jnp.where(inside, rel[:, 1], 0),
        jnp.where(inside, rel[:, 2], 0)].set(rows, mode="drop")
    return DenseIndex(table=table, lo=lo)


def lookup_nearest_dense(grid: VoxelGrid, dense: DenseIndex, pts: jax.Array,
                         mask: jax.Array, usable: jax.Array,
                         bits: int = 10,
                         approx_centers: bool = False) -> jax.Array:
    """lookup_nearest via the dense index: direct gathers, no searches.

    Lowering notes: single-axis gathers from a FLAT table lower to the
    simplest gather XLA has, unlike 3-D advanced indexing or
    take_along_axis of the same data — so candidate cells are flattened
    to linear indices by arithmetic, and the winning arm is extracted
    with a 7-way select instead of a gather.  `approx_centers` picks the
    nearest arm by distance to voxel CENTERS (pure arithmetic) instead of
    gathered voxel means — one fewer 7P-row gather for a ≤½-voxel
    approximation in the tie-break only (which voxel plane a boundary
    point matches; the residual gate downstream bounds the effect).
    """
    half = 1 << (bits - 1)
    g = (jnp.floor((pts - grid.origin) / grid.voxel_size).astype(jnp.int32)
         + half - dense.lo)                                   # (P, 3)
    X, Y, Z = dense.table.shape
    shape = jnp.asarray((X, Y, Z), jnp.int32)
    offsets = jnp.asarray([[0, 0, 0], [0, 0, 1], [0, 0, -1], [0, 1, 0],
                           [0, -1, 0], [1, 0, 0], [-1, 0, 0]], jnp.int32)
    cand = g[None, :, :] + offsets[:, None, :]                # (7, P, 3)
    inside = jnp.all((cand >= 0) & (cand < shape), axis=-1) & mask[None, :]
    cc = jnp.clip(cand, 0, shape - 1)
    flat = (cc[..., 0] * Y + cc[..., 1]) * Z + cc[..., 2]     # (7, P)
    idx7 = dense.table.reshape(-1)[flat]                      # (7, P)
    ok7 = inside & (idx7 >= 0) & usable[jnp.maximum(idx7, 0)]
    if approx_centers:
        # Voxel-center coordinates in world units, no gathers.
        ctr = ((cand + dense.lo - half).astype(jnp.float32) + 0.5) \
            * grid.voxel_size + grid.origin
        d2 = jnp.sum((pts[None] - ctr) ** 2, axis=-1)
    else:
        mu7 = grid.mean[jnp.maximum(idx7, 0)]                 # (7, P, 3)
        d2 = jnp.sum((pts[None] - mu7) ** 2, axis=-1)
    d2 = jnp.where(ok7, d2, jnp.inf)
    best = jnp.argmin(d2, axis=0)                             # (P,)
    sel = best[None, :] == jnp.arange(7, dtype=best.dtype)[:, None]
    idx = jnp.sum(jnp.where(sel, idx7, 0), axis=0)
    return jnp.where(jnp.any(ok7, axis=0), idx, -1)


def window_coverage(grid: VoxelGrid, usable: jax.Array, lo: jax.Array,
                    shape, bits: int = 10) -> jax.Array:
    """Fraction of USABLE voxels that fall inside a dense-index window
    [lo, lo+shape).  The dense/dilated tables silently drop voxels
    outside their box (ADVICE r3: on long or hilly drives the scan can
    outrun the box and registration quietly degrades to the INS prior) —
    this makes that truncation observable.  Returns 1.0 for empty grids.
    """
    half = 1 << (bits - 1)
    axis_mask = (1 << bits) - 1
    keys = grid.keys
    g = jnp.stack([(keys >> (2 * bits)) & axis_mask,
                   (keys >> bits) & axis_mask,
                   keys & axis_mask], -1)
    rel = g - lo
    want = grid.occupied & usable
    inside = want & jnp.all((rel >= 0) & (rel < jnp.asarray(shape)), -1)
    denom = jnp.maximum(want.sum(), 1)
    return jnp.where(want.any(),
                     inside.sum().astype(jnp.float32)
                     / denom.astype(jnp.float32), 1.0)


class DilatedIndex(NamedTuple):
    """Dense direct-mapped index whose cells are PRE-DILATED over the
    7-cell face neighborhood: `table[x, y, z]` holds the row of a usable
    voxel in the cell itself or (fixed-priority: self, ±z, ±y, ±x) one of
    its face neighbors, or −1.

    This moves the entire neighbor search out of the per-point path: one
    association pass is ONE computed-index gather per point instead of 7
    gathers + usable gathers + a distance argmin.  The build is 13 shifted
    selects over the (X, Y, Z) int32/bool tables — contiguous VPU work,
    no gathers — plus one table-sized usable gather, and is amortized over
    every association pass against the same target (2 per batch at
    reassociate_every=8).

    Semantics vs lookup_nearest_dense: when the point's own voxel is
    usable both pick it (the distance argmin virtually always prefers the
    containing voxel); when it is not, the dilated table falls back to a
    fixed-priority neighbor instead of the nearest-mean neighbor.  The
    point-to-plane residual gate (max_dist) bounds the effect of the
    different tie-break.
    """

    table: jax.Array     # (X, Y, Z) int32 — usable row for the cell, or −1
    lo: jax.Array        # (3,) int32 — key-space coords of table[0,0,0]


def _shift_fill(a: jax.Array, axis: int, d: int, fill) -> jax.Array:
    """Shift along `axis` by d (±1) filling the vacated edge (no wrap)."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 0) if d > 0 else (0, 1)
    padded = jnp.pad(a, pad, constant_values=fill)
    start = [0] * a.ndim
    if d < 0:
        start[axis] = 1
    return jax.lax.dynamic_slice(padded, start, a.shape)


@functools.partial(jax.jit, static_argnames=("shape", "bits"))
def build_dilated_index(grid: VoxelGrid, usable: jax.Array, *,
                        shape=(256, 256, 32), bits: int = 10
                        ) -> DilatedIndex:
    """Build a DilatedIndex for the USABLE voxels of `grid` (usable is the
    per-row gate from gicp.plane_grid_from)."""
    base = build_dense_index(grid, shape=shape, bits=bits)
    t = base.table
    ok = (t >= 0) & usable[jnp.maximum(t, 0)]
    src = jnp.where(ok, t, -1)     # usable cells only (dilation source)
    sel_t = src
    sel_ok = ok
    # ±z first: vertical neighbors usually continue the same surface.
    for axis, d in ((2, 1), (2, -1), (1, 1), (1, -1), (0, 1), (0, -1)):
        ct = _shift_fill(src, axis, d, -1)
        cok = _shift_fill(ok, axis, d, False)
        take = (~sel_ok) & cok
        sel_t = jnp.where(take, ct, sel_t)
        sel_ok = sel_ok | take
    return DilatedIndex(table=sel_t, lo=base.lo)


def lookup_dilated(grid: VoxelGrid, dil: DilatedIndex, pts: jax.Array,
                   mask: jax.Array, bits: int = 10) -> jax.Array:
    """Index of a usable voxel for each point via the pre-dilated table:
    one flat gather per point (−1 for misses; usable gating is baked into
    the table at build time)."""
    half = 1 << (bits - 1)
    g = (jnp.floor((pts - grid.origin) / grid.voxel_size).astype(jnp.int32)
         + half - dil.lo)                                     # (P, 3)
    X, Y, Z = dil.table.shape
    shape = jnp.asarray((X, Y, Z), jnp.int32)
    inside = jnp.all((g >= 0) & (g < shape), axis=-1) & mask
    cc = jnp.clip(g, 0, shape - 1)
    flat = (cc[..., 0] * Y + cc[..., 1]) * Z + cc[..., 2]     # (P,)
    idx = dil.table.reshape(-1)[flat]
    return jnp.where(inside, idx, -1)


# --- closed-form 3x3 symmetric eigen-analysis --------------------------------

def eigvals3(cov: jax.Array, eps: float = 1e-12):
    """Cardano eigenvalues of batched symmetric (..., 3, 3), descending
    (λ1 ≥ λ2 ≥ λ3)."""
    a = cov
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    b = a - q[..., None, None] * jnp.eye(3, dtype=cov.dtype)
    p2 = jnp.sum(b * b, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, eps * eps))
    r = jnp.clip(jnp.linalg.det(b) / (2.0 * p ** 3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l1 = q + 2.0 * p * jnp.cos(phi)
    l3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    return l1, l2, l3


def _nullspace_dir(c: jax.Array) -> jax.Array:
    """Largest row-cross-product of (..., 3, 3) — approximate null direction
    (unnormalized)."""
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = jnp.stack([jnp.cross(r0, r1), jnp.cross(r0, r2),
                       jnp.cross(r1, r2)], axis=-2)
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    return jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1),
                               axis=-2)[..., 0, :]


def clamped_inverse(cov: jax.Array, floor_ratio: float = 0.01,
                    eps: float = 1e-9) -> jax.Array:
    """Eigenvalue-clamped inverse for NDT weighting (Magnusson-style
    conditioning): W = Σᵢ vᵢvᵢᵀ / max(λᵢ, floor_ratio·λ₁).

    Caps the condition number at 1/floor_ratio so pancake voxels weight
    their normal direction ~1/floor_ratio× stronger than in-plane — strong
    surface attraction without the centroid-pull bias of scalar Tikhonov
    regularization.  Fully closed-form; degenerate spectra (λ1≈λ2 or
    λ2≈λ3) are safe because equal clamped eigenvalues make the ill-defined
    eigenvector directions irrelevant to the reconstructed W.
    """
    ident = jnp.eye(3, dtype=cov.dtype)
    l1, l2, l3 = eigvals3(cov)
    l1 = jnp.maximum(l1, eps)
    v3 = smallest_eigenvector(cov)
    v1 = _nullspace_dir(cov - l1[..., None, None] * ident)
    # Orthogonalize v1 against v3; fall back to any perpendicular.
    v1 = v1 - jnp.sum(v1 * v3, -1, keepdims=True) * v3
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    alt = jnp.cross(v3, jnp.where(
        jnp.abs(v3[..., :1]) < 0.9,
        jnp.broadcast_to(jnp.array([1.0, 0, 0], cov.dtype), v3.shape),
        jnp.broadcast_to(jnp.array([0, 1.0, 0], cov.dtype), v3.shape)))
    alt = alt / jnp.linalg.norm(alt, axis=-1, keepdims=True)
    v1 = jnp.where(n1 > 1e-12, v1 / jnp.maximum(n1, 1e-12), alt)
    v2 = jnp.cross(v3, v1)

    floor = floor_ratio * l1
    w1 = 1.0 / jnp.maximum(l1, floor)
    w2 = 1.0 / jnp.maximum(l2, floor)
    w3 = 1.0 / jnp.maximum(l3, floor)

    def op(v, w):
        return w[..., None, None] * v[..., :, None] * v[..., None, :]

    return op(v1, w1) + op(v2, w2) + op(v3, w3)


def normalized_cov(cov: jax.Array, floor: float = 1e-3,
                   plane_inflation: float = 100.0) -> jax.Array:
    """Scale-normalized covariance for D2D weighting: eigenvalues remapped
    to max(λᵢ/λ₁, floor) + planarity²·plane_inflation (in-plane only),
    eigenvectors kept.

    Two problems with raw covariances under the mean-matching D2D cost:
      1. Scale: in-plane weight 1/λ ≈ 12/voxel_size² is large in absolute
         terms; normalizing by λ₁ makes it scale-free (fast-GICP/VGICP
         (1,1,ε) regularization, anisotropy-preserving variant).
      2. Bias: a voxel MEAN's in-plane position reflects the sampling
         density, not the surface — and LiDAR sampling density is
         anisotropic and moves with the sensor, so against an accumulated
         map every ground voxel's in-plane residual points coherently
         backward (measured: a −0.35 m/frame drag).  For plane-like voxels
         the in-plane mean carries no geometric information, so their
         in-plane eigenvalues are inflated by planarity²·plane_inflation —
         planar voxels degrade gracefully to point-to-plane behavior while
         corner/edge voxels (low planarity) keep their full 3-D structure,
         which is the whole point of D2D.
    """
    l1, l2, l3 = eigvals3(cov)
    l1 = jnp.maximum(l1, 1e-12)
    v3 = smallest_eigenvector(cov)
    v1 = _nullspace_dir(cov - l1[..., None, None]
                        * jnp.eye(3, dtype=cov.dtype))
    v1 = v1 - jnp.sum(v1 * v3, -1, keepdims=True) * v3
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    alt = jnp.cross(v3, jnp.where(
        jnp.abs(v3[..., :1]) < 0.9,
        jnp.broadcast_to(jnp.array([1.0, 0, 0], cov.dtype), v3.shape),
        jnp.broadcast_to(jnp.array([0, 1.0, 0], cov.dtype), v3.shape)))
    alt = alt / jnp.linalg.norm(alt, axis=-1, keepdims=True)
    v1 = jnp.where(n1 > 1e-12, v1 / jnp.maximum(n1, 1e-12), alt)
    v2 = jnp.cross(v3, v1)

    def op(v, lam):
        return lam[..., None, None] * v[..., :, None] * v[..., None, :]

    planarity = jnp.clip((l2 - l3) / l1, 0.0, 1.0)
    infl = planarity * planarity * plane_inflation
    return (op(v1, jnp.maximum(l1 / l1, floor) + infl)
            + op(v2, jnp.maximum(l2 / l1, floor) + infl)
            + op(v3, jnp.maximum(l3 / l1, floor)))


def structure_usable(grid: VoxelGrid, *, min_points: float = 4.0,
                     max_linearity: float = 0.9) -> jax.Array:
    """Structure-aware target gate for distribution-matching costs
    (D2D / NDT): occupied, enough points, and NOT line-like.

    Line-like voxels (linearity (λ₁−λ₂)/λ₁ ≈ 1) are scan-ring arcs — 1-D
    sampling curves on a 2-D surface whose voxel mean follows the SENSOR
    (ring radius), not the surface; their two near-zero eigenvalues get
    maximal weight in exactly the sampling-biased directions, producing a
    coherent ~0.4 m/frame backward drag against accumulated maps
    (measured).  The planarity gate in gicp.build_plane_grid rejects the
    same voxels for the same reason.
    """
    l1, l2, _ = eigvals3(grid.cov)
    linearity = (l1 - l2) / jnp.maximum(l1, 1e-12)
    return (grid.occupied & (grid.count >= min_points)
            & (linearity < max_linearity))


def smallest_eigenvector(cov: jax.Array, eps: float = 1e-9) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue for batched symmetric
    (..., 3, 3) matrices — the plane normal of a voxel Gaussian.

    Closed-form (Cardano eigenvalues + cross-product eigenvectors): avoids
    batched jnp.linalg.eigh, which is slow for many small problems.
    """
    a = cov + eps * jnp.eye(3, dtype=cov.dtype)
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    b = a - q[..., None, None] * jnp.eye(3, dtype=cov.dtype)
    p2 = jnp.sum(b * b, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detb = jnp.linalg.det(b)
    r = jnp.clip(detb / (2.0 * p ** 3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # Eigenvalues: q + 2p cos(phi + 2πk/3); smallest at k=1 (phi + 2π/3).
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    c = a - lam_min[..., None, None] * jnp.eye(3, dtype=cov.dtype)
    # Null-space direction: the largest cross product of two rows of c.
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = jnp.stack([jnp.cross(r0, r1), jnp.cross(r0, r2),
                       jnp.cross(r1, r2)], axis=-2)
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1),
                            axis=-2)[..., 0, :]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    # Degenerate (isotropic) voxels: fall back to +z.
    fallback = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], cov.dtype),
                                v.shape)
    v = jnp.where(n > 1e-12, v / jnp.maximum(n, 1e-12), fallback)
    return v


def regularized_inverse(cov: jax.Array, eps: float = 1e-3) -> jax.Array:
    """Batched (Σ + εI)⁻¹ for (..., 3, 3) via the closed-form adjugate."""
    a = cov + eps * jnp.eye(3, dtype=cov.dtype)
    det = jnp.linalg.det(a)
    adj = jnp.stack([
        a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
        a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
        a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
        a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
        a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
        a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
        a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
        a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
        a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
    ], axis=-1).reshape(*a.shape)
    return adj / det[..., None, None]
