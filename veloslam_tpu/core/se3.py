"""Batched quaternion / SE(3) math, jit- and vmap-friendly.

The reference stores rotations as Euler angles in degrees and interpolates
them component-wise (reference type_defs.h:102-131, TransformManager.cxx:
168-176) — fragile across the ±180° wrap.  Here rotations are unit
quaternions (w, x, y, z) and interpolation is slerp; `euler_deg_to_quat`
reproduces the reference's Euler convention (Ry(roll)·Rx(pitch)·Rz(yaw),
degrees — reference type_defs.h:134-146) so poses remain comparable.

All functions broadcast over leading batch dimensions.  A pose is the pair
(q, t): quaternion (..., 4) and translation (..., 3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Pose(NamedTuple):
    """SE(3) element: unit quaternion (..., 4) wxyz + translation (..., 3)."""

    q: jax.Array
    t: jax.Array

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Pose":
        q = jnp.zeros((*batch_shape, 4), dtype).at[..., 0].set(1.0)
        t = jnp.zeros((*batch_shape, 3), dtype)
        return Pose(q, t)


# --- quaternions -------------------------------------------------------------

def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(a, b):
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_from_axis_angle(axis, angle):
    half = 0.5 * angle[..., None]
    return jnp.concatenate(
        [jnp.cos(half), axis * jnp.sin(half)], axis=-1)


def quat_to_matrix(q):
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(*m.shape[:-1], 3, 3)


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> quaternion, Shepperd's branchless form."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the numerically best per element.
    qw = jnp.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    diag = jnp.stack([tr, m00, m11, m22], -1)
    best = jnp.argmax(diag, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], -2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1),
                            axis=-2)[..., 0, :]
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


def _safe_norm(v, eps=1e-24):
    """Norm with finite autodiff at v == 0 (jnp.linalg.norm has NaN grads
    there, which poisons jacfwd/jacrev through exp/log at the identity)."""
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    return jnp.sqrt(jnp.maximum(sq, eps))


def quat_exp(rotvec):
    """so(3) rotation vector (..., 3) -> unit quaternion (AD-safe at 0)."""
    angle = _safe_norm(rotvec)
    small = angle < 1e-6
    k = jnp.where(small, 0.5 - angle * angle / 48.0,
                  jnp.sin(0.5 * angle) / angle)
    return jnp.concatenate([jnp.cos(0.5 * angle), k * rotvec], axis=-1)


def quat_log(q):
    """Unit quaternion -> so(3) rotation vector (..., 3) (AD-safe at
    identity)."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # take the short way round
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn = _safe_norm(q[..., 1:])
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-6
    k = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), angle / vn)
    return k * q[..., 1:]


def quat_slerp(q0, q1, u):
    """Spherical interpolation; u (...,) in [0, 1]."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    # nlerp fallback when nearly parallel
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_t = jnp.sin(theta)
    near = sin_t < 1e-6
    u = u[..., None]
    w0 = jnp.where(near, 1.0 - u, jnp.sin((1.0 - u) * theta) / jnp.where(near, 1.0, sin_t))
    w1 = jnp.where(near, u, jnp.sin(u * theta) / jnp.where(near, 1.0, sin_t))
    return quat_normalize(w0 * q0 + w1 * q1)


# --- reference Euler convention ---------------------------------------------

def euler_deg_to_quat(roll_deg, pitch_deg, yaw_deg):
    """Reference pose convention: R = Ry(roll)·Rx(pitch)·Rz(yaw), degrees.

    This mirrors `PoseTransform::getMatrix()` (reference type_defs.h:134-146)
    where R[0] rotates about +Y, R[1] about +X and R[2] about +Z, applied in
    that order.
    """
    r = jnp.deg2rad(jnp.asarray(roll_deg))
    p = jnp.deg2rad(jnp.asarray(pitch_deg))
    y = jnp.deg2rad(jnp.asarray(yaw_deg))
    zero = jnp.zeros_like(r)
    one = jnp.ones_like(r)
    qy = quat_from_axis_angle(jnp.stack([zero, one, zero], -1), r)
    qx = quat_from_axis_angle(jnp.stack([one, zero, zero], -1), p)
    qz = quat_from_axis_angle(jnp.stack([zero, zero, one], -1), y)
    return quat_mul(qy, quat_mul(qx, qz))


def euler_deg_to_quat_np(roll_deg, pitch_deg, yaw_deg) -> "np.ndarray":
    """Pure-numpy `euler_deg_to_quat` for HOST-side code (INS ingestion,
    PoseTrack building, test fixtures).

    Host paths should not touch the device: the jnp variant would cost
    one dispatch and one device→host readback per converted pose on the
    ingest path."""
    import numpy as np

    def axis_angle(ax, ang):
        half = 0.5 * ang
        return np.concatenate([np.cos(half)[..., None],
                               np.sin(half)[..., None] * ax], -1)

    def mul(a, b):
        w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
        w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
        return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                         w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)

    r = np.deg2rad(np.asarray(roll_deg, np.float64))
    p = np.deg2rad(np.asarray(pitch_deg, np.float64))
    y = np.deg2rad(np.asarray(yaw_deg, np.float64))
    zero, one = np.zeros_like(r), np.ones_like(r)
    qy = axis_angle(np.stack([zero, one, zero], -1), r)
    qx = axis_angle(np.stack([one, zero, zero], -1), p)
    qz = axis_angle(np.stack([zero, zero, one], -1), y)
    q = mul(qy, mul(qx, qz))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def quat_mul_np(a: "np.ndarray", b: "np.ndarray") -> "np.ndarray":
    """Batched numpy Hamilton product (host paths; see
    euler_deg_to_quat_np for why host code must not touch the device)."""
    import numpy as np
    w1, x1, y1, z1 = np.moveaxis(np.asarray(a), -1, 0)
    w2, x2, y2, z2 = np.moveaxis(np.asarray(b), -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_rotate_np(q: "np.ndarray", v: "np.ndarray") -> "np.ndarray":
    """Batched numpy quaternion rotation of vectors (..., 3)."""
    import numpy as np
    q = np.asarray(q)
    v = np.asarray(v)
    u = q[..., 1:]
    w = q[..., :1]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def compose_np(qa, ta, qb, tb):
    """Batched numpy pose composition a ∘ b → (q, t)."""
    import numpy as np
    q = quat_mul_np(qa, qb)
    t = np.asarray(ta) + quat_rotate_np(qa, tb)
    return q, t


def inverse_np(q, t):
    """Batched numpy pose inverse → (q, t)."""
    import numpy as np
    q = np.asarray(q)
    qc = np.concatenate([q[..., :1], -q[..., 1:]], -1)
    return qc, -quat_rotate_np(qc, np.asarray(t))


# --- SE(3) -------------------------------------------------------------------

def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(quat_mul(a.q, b.q), a.t + quat_rotate(a.q, b.t))


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(qi, -quat_rotate(qi, p.t))


def apply(p: Pose, pts):
    """Transform points (..., 3)."""
    return quat_rotate(p.q, pts) + p.t


def relative(a: Pose, b: Pose) -> Pose:
    """a^-1 ∘ b."""
    return compose(inverse(a), b)


def interp(a: Pose, b: Pose, u) -> Pose:
    """Slerp/lerp interpolation between poses at fraction u in [0, 1]."""
    u = jnp.asarray(u)
    return Pose(quat_slerp(a.q, b.q, u), a.t + u[..., None] * (b.t - a.t))


def exp(tangent) -> Pose:
    """se(3)-style exponential of (..., 6) = (rotvec, translation).

    Uses the decoupled SO(3)×R^3 retraction (rotation exp, translation as-is)
    — the standard choice for GN on pose graphs.
    """
    return Pose(quat_exp(tangent[..., :3]), tangent[..., 3:])


def log(p: Pose):
    """Inverse of `exp`: (..., 6) tangent (rotvec, translation)."""
    return jnp.concatenate([quat_log(p.q), p.t], axis=-1)


def retract(p: Pose, delta) -> Pose:
    """Left-multiplicative update: exp(delta) ∘ p (delta: (..., 6))."""
    return compose(exp(delta), p)


def to_matrix(p: Pose):
    """Pose -> homogeneous (..., 4, 4) matrix."""
    R = quat_to_matrix(p.q)
    top = jnp.concatenate([R, p.t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], R.dtype), (*top.shape[:-2], 1, 4))
    return jnp.concatenate([top, bottom], axis=-2)
