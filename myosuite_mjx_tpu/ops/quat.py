"""Batched quaternion / rotation math for the engine.

Conventions follow MuJoCo: quaternions are ``[w, x, y, z]``, rotation matrices
are 3x3 row-major, euler angles are extrinsic XYZ by default (MuJoCo's
``eulerseq="xyz"``). All functions broadcast over leading batch dimensions and
are jit/vmap/grad-safe (no data-dependent Python control flow).

Capability parity with the reference's JAX math kernel library
(/root/reference/myosuite/mjx/quat_math.py:9-258) and its NumPy twin
(/root/reference/myosuite/utils/quat_math.py), re-implemented from first
principles in a branchless, batch-first style.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def normalize(v: jax.Array, axis: int = -1) -> jax.Array:
  """Safe unit-normalization along ``axis`` (zero vectors map to zero)."""
  n = jnp.linalg.norm(v, axis=axis, keepdims=True)
  return v / jnp.maximum(n, _EPS)


def quat_identity(shape=(), dtype=jnp.float32) -> jax.Array:
  q = jnp.zeros(tuple(shape) + (4,), dtype=dtype)
  return q.at[..., 0].set(1.0)


def quat_mul(u: jax.Array, v: jax.Array) -> jax.Array:
  """Hamilton product ``u * v`` (composition of rotations)."""
  uw, ux, uy, uz = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
  vw, vx, vy, vz = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
  return jnp.stack(
      [
          uw * vw - ux * vx - uy * vy - uz * vz,
          uw * vx + ux * vw + uy * vz - uz * vy,
          uw * vy - ux * vz + uy * vw + uz * vx,
          uw * vz + ux * vy - uy * vx + uz * vw,
      ],
      axis=-1,
  )


def quat_conj(q: jax.Array) -> jax.Array:
  """Conjugate (= inverse for unit quaternions)."""
  return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
  """Rotate vector(s) ``v`` by unit quaternion(s) ``q``.

  Uses the expanded 15-mul form rather than q*v*q' to stay cheap on the VPU.
  """
  w = q[..., :1]
  u = q[..., 1:]
  uv = jnp.cross(u, v)
  return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_rotate_inv(q: jax.Array, v: jax.Array) -> jax.Array:
  """Rotate ``v`` by the inverse of ``q``."""
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: jax.Array) -> jax.Array:
  """Unit quaternion -> 3x3 rotation matrix (batched)."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  wx, wy, wz = w * x, w * y, w * z
  xy, xz, yz = x * y, x * z, y * z
  m = jnp.stack(
      [
          1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
          2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
          2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
      ],
      axis=-1,
  )
  return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: jax.Array) -> jax.Array:
  """3x3 rotation matrix -> unit quaternion, w >= 0.

  Branchless: builds all four Shepperd candidates and selects the one keyed to
  the largest of (trace, m00, m11, m22), which keeps every divisor well
  conditioned under vmap (the reference used a 4-way ``lax.cond``,
  /root/reference/myosuite/mjx/quat_math.py:157-166).
  """
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  tr = m00 + m11 + m22

  # Four candidate 4*|q_k|^2 values; the largest is numerically safest.
  k0 = 1.0 + tr
  k1 = 1.0 + m00 - m11 - m22
  k2 = 1.0 - m00 + m11 - m22
  k3 = 1.0 - m00 - m11 + m22
  ks = jnp.stack([k0, k1, k2, k3], axis=-1)
  best = jnp.argmax(ks, axis=-1)

  def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, _EPS))

  s0 = safe_sqrt(k0)
  q0 = jnp.stack(
      [s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
  s1 = safe_sqrt(k1)
  q1 = jnp.stack(
      [(m21 - m12) / s1, s1, (m10 + m01) / s1, (m02 + m20) / s1], axis=-1)
  s2 = safe_sqrt(k2)
  q2 = jnp.stack(
      [(m02 - m20) / s2, (m10 + m01) / s2, s2, (m21 + m12) / s2], axis=-1)
  s3 = safe_sqrt(k3)
  q3 = jnp.stack(
      [(m10 - m01) / s3, (m02 + m20) / s3, (m21 + m12) / s3, s3], axis=-1)

  cands = jnp.stack([q0, q1, q2, q3], axis=-2)  # [..., 4, 4]
  q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32),
                          axis=-2)[..., 0, :]
  q = normalize(q)
  # Canonical sign: w >= 0.
  return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: jax.Array, angle: jax.Array) -> jax.Array:
  """Unit ``axis`` and ``angle`` (rad) -> quaternion."""
  half = 0.5 * angle
  s = jnp.sin(half)
  return jnp.concatenate(
      [jnp.cos(half)[..., None], axis * s[..., None]], axis=-1)


def quat_to_axis_angle(q: jax.Array) -> tuple[jax.Array, jax.Array]:
  """Quaternion -> (unit axis, angle in [0, 2pi))."""
  sin_half = jnp.linalg.norm(q[..., 1:], axis=-1)
  angle = 2.0 * jnp.arctan2(sin_half, q[..., 0])
  axis = q[..., 1:] / jnp.maximum(sin_half, _EPS)[..., None]
  # Degenerate (identity) rotation: pick a fixed axis.
  default = jnp.zeros_like(axis).at[..., 0].set(1.0)
  axis = jnp.where(sin_half[..., None] < 1e-9, default, axis)
  return axis, angle


def quat_to_vel(q: jax.Array, dt: jax.Array | float = 1.0) -> jax.Array:
  """Rotation expressed as angular velocity over ``dt`` (expmap / dt).

  Matches mju_quat2Vel semantics (reference quat2Vel,
  /root/reference/myosuite/mjx/quat_math.py).
  """
  axis, angle = quat_to_axis_angle(q)
  # Shortest path: angles > pi wrap to negative.
  angle = jnp.where(angle > jnp.pi, angle - 2.0 * jnp.pi, angle)
  return axis * (angle / dt)[..., None]


def quat_sub(qa: jax.Array, qb: jax.Array) -> jax.Array:
  """Velocity-space difference: 3D rotation taking ``qb`` to ``qa``.

  Equals mju_subQuat(qa, qb): vel = quat2Vel(qb^-1 * qa).
  """
  return quat_to_vel(quat_mul(quat_conj(qb), qa))


def quat_diff(qa: jax.Array, qb: jax.Array) -> jax.Array:
  """Quaternion taking ``qa`` into ``qb`` (reference diffQuat: qa^-1 * qb)."""
  return quat_mul(quat_conj(qa), qb)


def quat_diff_vel(qa: jax.Array, qb: jax.Array,
                  dt: jax.Array | float = 1.0) -> jax.Array:
  """Angular velocity that carries ``qa`` to ``qb`` over ``dt``."""
  return quat_to_vel(quat_diff(qa, qb), dt)


def quat_integrate(q: jax.Array, omega: jax.Array,
                   dt: jax.Array | float) -> jax.Array:
  """Integrate local-frame angular velocity: q <- q * exp(omega * dt / 2).

  MuJoCo semantics (mju_quatIntegrate): omega is in the child/local frame for
  ball joints and free-joint orientation.
  """
  angle = jnp.linalg.norm(omega, axis=-1) * dt
  axis = normalize(omega)
  dq = axis_angle_to_quat(axis, angle)
  return normalize(quat_mul(q, dq))


def euler_to_quat(euler: jax.Array) -> jax.Array:
  """Intrinsic XYZ euler angles (rad) -> quaternion.

  Matches MuJoCo's default ``eulerseq="xyz"`` (verified against the MJCF
  compiler's body_quat output): q = qx * qy * qz.
  """
  half = 0.5 * euler
  c = jnp.cos(half)
  s = jnp.sin(half)
  cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
  sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
  return jnp.stack(
      [
          cx * cy * cz - sx * sy * sz,
          sx * cy * cz + cx * sy * sz,
          cx * sy * cz - sx * cy * sz,
          cx * cy * sz + sx * sy * cz,
      ],
      axis=-1,
  )


def euler_to_mat(euler: jax.Array) -> jax.Array:
  """Intrinsic XYZ euler -> rotation matrix."""
  return quat_to_mat(euler_to_quat(euler))


def mat_to_euler(m: jax.Array) -> jax.Array:
  """Rotation matrix -> intrinsic XYZ euler angles.

  R = Rx(ex) @ Ry(ey) @ Rz(ez); gimbal-locked pitch clamps cleanly.
  """
  ey = jnp.arcsin(jnp.clip(m[..., 0, 2], -1.0, 1.0))
  cy = jnp.cos(ey)
  safe = jnp.abs(cy) > 1e-6
  ex = jnp.where(
      safe,
      jnp.arctan2(-m[..., 1, 2], m[..., 2, 2]),
      jnp.arctan2(m[..., 2, 1], m[..., 1, 1]),
  )
  ez = jnp.where(safe, jnp.arctan2(-m[..., 0, 1], m[..., 0, 0]), 0.0)
  return jnp.stack([ex, ey, ez], axis=-1)


def quat_to_euler(q: jax.Array) -> jax.Array:
  return mat_to_euler(quat_to_mat(q))


def euler_intrinsic_to_quat(euler: jax.Array) -> jax.Array:
  """Intrinsic roll-pitch-yaw -> quat (reference intrinsic_euler2quat,
  /root/reference/myosuite/utils/quat_math.py:247-273)."""
  hr, hp, hy = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
  sr, cr = jnp.sin(hr), jnp.cos(hr)
  sp, cp = jnp.sin(hp), jnp.cos(hp)
  sy, cy = jnp.sin(hy), jnp.cos(hy)
  return jnp.stack([
      cr * cp * cy + sr * sp * sy,
      sr * cp * cy - cr * sp * sy,
      cr * sp * cy + sr * cp * sy,
      cr * cp * sy - sr * sp * cy,
  ], axis=-1)


def quat_to_euler_intrinsic(q: jax.Array) -> jax.Array:
  """Quat -> intrinsic roll-pitch-yaw (reference quat2euler_intrinsic,
  /root/reference/myosuite/utils/quat_math.py:214-244; branchless pitch
  saturation)."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
  pitch = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
  yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
  return jnp.stack([roll, pitch, yaw], axis=-1)


# --- small vector helpers used across the engine ---


def cross_matrix(v: jax.Array) -> jax.Array:
  """Skew-symmetric matrix [v]x such that [v]x @ u = v x u."""
  x, y, z = v[..., 0], v[..., 1], v[..., 2]
  zero = jnp.zeros_like(x)
  m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
  return m.reshape(m.shape[:-1] + (3, 3))


def orthogonals(a: jax.Array) -> tuple[jax.Array, jax.Array]:
  """Two unit vectors orthogonal to unit vector ``a`` (branchless)."""
  # Pick the world axis least aligned with a, Gram-Schmidt it.
  ref = jnp.where(
      (jnp.abs(a[..., 1:2]) < 0.9),
      jnp.zeros_like(a).at[..., 1].set(1.0),
      jnp.zeros_like(a).at[..., 2].set(1.0),
  )
  b = normalize(jnp.cross(a, ref))
  c = jnp.cross(a, b)
  return b, c
