"""Scan-context global descriptors — drift-independent place recognition.

Position-based loop-closure proposal (graph/loopclosure.find_candidates)
fails under exactly the drift loop closure exists to fix: after 15 m of
accumulated error a revisit no longer lies within the search radius.  The
reference has nothing here (its SLAM layer is unimplemented,
reference README.md:25-26); this module adds an appearance-based proposal
channel shaped as dense matrix products:

  * each keyframe scan is summarized as a polar BEV descriptor
    (rings × sectors, max-height per cell — the classic "scan context"),
    one fully-batched scatter-max program per keyframe batch;
  * candidate proposal is batched all-pairs matching: cosine similarity
    maximized over sector shifts (rotation invariance about z), computed
    as S_sector (K, RS)·(RS, K) matmuls inside one jitted fori_loop —
    all-pairs place recognition as matrix products instead of a kd-tree
    of ring-key vectors;
  * the argmax sector shift doubles as the yaw initialization for the
    geometric verifier (GICP + observability gate, graph/loopclosure),
    making verification independent of the drifted pose estimates too.

Descriptors live in the sensor/local frame of each keyframe (z-rotation
of the vehicle = sector shift; translation within a cell-size is absorbed
by the coarse binning).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

N_RINGS = 16
N_SECTORS = 60


@functools.partial(jax.jit, static_argnames=("n_rings", "n_sectors"))
def scan_context(pts: jax.Array, mask: jax.Array, *,
                 n_rings: int = N_RINGS, n_sectors: int = N_SECTORS,
                 max_range: float = 80.0, z_floor: float = -2.0
                 ) -> jax.Array:
    """One scan (P, 3) + mask → (n_rings, n_sectors) max-height descriptor.

    Cell value = max(z − z_floor, 0) over the cell's points; empty cells
    are 0.  Works for (..., P, 3) batches via vmap (see
    scan_context_batch).
    """
    r = jnp.linalg.norm(pts[..., :2], axis=-1)
    ring = jnp.floor(r / (max_range / n_rings)).astype(jnp.int32)
    sector = jnp.floor((jnp.arctan2(pts[..., 1], pts[..., 0]) + jnp.pi)
                       / (2.0 * jnp.pi / n_sectors)).astype(jnp.int32)
    sector = jnp.clip(sector, 0, n_sectors - 1)
    ok = mask & (ring < n_rings)
    cell = jnp.where(ok, ring * n_sectors + sector, n_rings * n_sectors)
    h = jnp.maximum(pts[..., 2] - z_floor, 0.0)
    out = jnp.zeros(n_rings * n_sectors + 1, jnp.float32)
    out = out.at[cell].max(jnp.where(ok, h, 0.0))
    return out[:-1].reshape(n_rings, n_sectors)


def scan_context_batch(pts: jax.Array, mask: jax.Array, **kw) -> jax.Array:
    """(F, P, 3) + (F, P) → (F, R, S)."""
    return jax.vmap(lambda p, m: scan_context(p, m, **kw))(pts, mask)


@jax.jit
def descriptor_scores(desc: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """All-pairs rotation-invariant similarity of (K, R, S) descriptors.

    Returns (scores (K, K) float32 in [−1, 1], shifts (K, K) int32): the
    max-over-sector-shift cosine similarity and its argmax shift.
    scores[i, j] uses roll(desc[i], shift, sectors) vs desc[j]; see
    `relative_yaw` for the yaw convention.  Zero-norm (empty) descriptors
    score 0 against everything.
    """
    K, R, S = desc.shape
    flat = desc.reshape(K, R * S)
    norm = jnp.linalg.norm(flat, axis=-1)
    denom = jnp.maximum(norm[:, None] * norm[None, :], 1e-9)

    def body(s, carry):
        best, arg = carry
        rolled = jnp.roll(desc, s, axis=2).reshape(K, R * S)
        # Full float32: on an H100 the reduced (TF32) default moved scores
        # by up to 1.5e-4 and flipped one of 2220 pairs across the 0.55
        # proposal gate, for ~1-2 ms saved per all-pairs call — not worth
        # a device-dependent closure set.
        sim = jnp.matmul(rolled, flat.T,
                         precision=jax.lax.Precision.HIGHEST) / denom
        upd = sim > best
        return jnp.where(upd, sim, best), jnp.where(upd, s, arg)

    best0 = jnp.full((K, K), -jnp.inf, jnp.float32)
    arg0 = jnp.zeros((K, K), jnp.int32)
    best, arg = jax.lax.fori_loop(0, S, body, (best0, arg0))
    ok = (norm[:, None] > 1e-6) & (norm[None, :] > 1e-6)
    return jnp.where(ok, best, 0.0), arg


def relative_yaw(shift, n_sectors: int = N_SECTORS):
    """Yaw of T_i⁻¹ ∘ T_j implied by the best sector shift of
    scores[i, j].

    Matching roll(desc_i, shift) ≈ desc_j means scan j's content sits
    `shift` sectors counter-clockwise of scan i's, i.e. the world rotated
    by +shift·Δ in j's local frame — the vehicle heading rotated by
    −shift·Δ.  Wrapped to (−π, π]."""
    yaw = -np.asarray(shift) * (2.0 * np.pi / n_sectors)
    return (yaw + np.pi) % (2.0 * np.pi) - np.pi


def propose(scores: np.ndarray, shifts: np.ndarray, *, n_valid: int,
            min_score: float = 0.6, min_gap: int = 20,
            max_per_keyframe: int = 1,
            max_candidates: Optional[int] = None,
            exclude=()) -> List[Tuple[int, int, float, int]]:
    """Host-side proposal from an all-pairs score matrix.

    Returns [(i, j, score, shift)] with i < j − min_gap, best-first,
    at most `max_per_keyframe` uses of any keyframe, skipping `exclude`
    pairs.  `n_valid` bounds the real keyframes (the matrix is padded to
    ring capacity)."""
    s = np.asarray(scores[:n_valid, :n_valid])
    ii, jj = np.nonzero(np.triu(np.ones_like(s, bool), k=max(min_gap, 1))
                        & (s >= min_score))
    order = np.argsort(-s[ii, jj])
    taken = np.zeros(n_valid, np.int64)
    excl = set(exclude)
    out: List[Tuple[int, int, float, int]] = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if (i, j) in excl:
            continue
        if taken[i] >= max_per_keyframe or taken[j] >= max_per_keyframe:
            continue
        taken[i] += 1
        taken[j] += 1
        out.append((i, j, float(s[i, j]), int(shifts[i, j])))
        if max_candidates is not None and len(out) >= max_candidates:
            break
    return out
