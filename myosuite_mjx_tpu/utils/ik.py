"""Inverse kinematics: damped-least-squares ``qpos_from_site_pose``.

Capability parity with the reference's dm_control-derived solver
(/root/reference/myosuite/utils/inverse_kinematics.py:40-283): find joint
positions such that a named site reaches a target position and/or
orientation, with L2 regularization while the error is large, an update
norm clamp, and a progress-based early halt.

Shape: the whole solve is one ``lax.while_loop`` over pure
engine functions (kinematics -> site pose + point Jacobian -> damped LS
step -> quaternion-aware position integration), so it jits, vmaps over
batches of targets, and differentiates. There is no mutable Physics/mjData
in the loop -- state is just ``(qpos, err_norm, steps, halt)``.

Differences from the reference (deliberate):
  * the reference switches between ``np.linalg.solve`` (regularized) and
    ``lstsq`` (unregularized); we always solve the regularized normal
    equations with a tiny floor so the iteration is branchless;
  * ``steps``/``success`` are device scalars in the returned ``IKResult``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine import forward as eforward
from myosuite_mjx_tpu.engine import smooth
from myosuite_mjx_tpu.engine.model import Model
from myosuite_mjx_tpu.ops import quat as qmath

_REG_FLOOR = 1e-10


class IKResult(NamedTuple):
  qpos: jax.Array       # (nq,)
  err_norm: jax.Array   # scalar: |err_pos| + rot_weight * |err_rot|
  steps: jax.Array      # scalar int: iterations performed
  success: jax.Array    # scalar bool: err_norm < tol


def _dof_mask(m: Model, joint_names: Sequence[str] | None) -> np.ndarray:
  """Static 0/1 mask over nv selecting manipulable dofs.

  Mirrors the reference's ``dof_indices`` gather
  (inverse_kinematics.py:151-164) as a mask so shapes stay static.
  """
  if joint_names is None:
    return np.ones((m.nv,), np.float64)
  mask = np.zeros((m.nv,), np.float64)
  for name in joint_names:
    j = m.name2id("joint", name)
    adr, jtype = int(m.jnt_dofadr[j]), int(m.jnt_type[j])
    ndof = {0: 6, 1: 3, 2: 1, 3: 1}[jtype]  # free/ball/slide/hinge
    mask[adr:adr + ndof] = 1.0
  return mask


def qpos_from_site_pose(
    m: Model,
    site_name: str,
    target_pos: jax.Array | None = None,
    target_quat: jax.Array | None = None,
    qpos0: jax.Array | None = None,
    joint_names: Sequence[str] | None = None,
    tol: float = 1e-10,
    rot_weight: float = 1.0,
    regularization_threshold: float = 0.1,
    regularization_strength: float = 3e-2,
    max_update_norm: float = 2.0,
    progress_thresh: float = 20.0,
    max_steps: int = 100,
) -> IKResult:
  """Solve IK for one site. Jit/vmap-safe; target arrays may be traced.

  Args mirror the reference solver (inverse_kinematics.py:40-54). At least
  one of ``target_pos`` / ``target_quat`` is required (static check).
  ``qpos0`` seeds the iteration (defaults to the model's qpos0).
  """
  if target_pos is None and target_quat is None:
    raise ValueError(
        "At least one of `target_pos` or `target_quat` must be specified.")

  sid = m.name2id("site", site_name)
  sbody = int(m.site_bodyid[sid])
  dtype = jnp.asarray(m.qpos0).dtype if qpos0 is None else qpos0.dtype
  q = jnp.asarray(m.qpos0, dtype) if qpos0 is None else qpos0
  dtype = q.dtype
  mask = jnp.asarray(_dof_mask(m, joint_names), dtype)
  # mocap bodies at the Data default (data.py:134-136)
  mocap_pos = jnp.zeros((m.nmocap, 3), dtype)
  mocap_quat = jnp.tile(qmath.quat_identity(dtype=dtype), (m.nmocap, 1))

  def site_pose_and_jac(qpos):
    kin = smooth.kinematics(m, qpos, mocap_pos, mocap_quat)
    _, _, cdof = smooth.com_pos(m, kin)
    sp = kin["site_xpos"][sid]
    sm = kin["site_xmat"][sid]
    jacp, jacr = smooth.point_jacobian(m, cdof, sp, sbody)
    return sp, sm, jacp, jacr

  def residual(qpos):
    sp, sm, jacp, jacr = site_pose_and_jac(qpos)
    rows, errs, norm = [], [], jnp.asarray(0.0, dtype)
    if target_pos is not None:
      err_pos = jnp.asarray(target_pos, dtype) - sp
      rows.append(jacp)
      errs.append(err_pos)
      norm = norm + jnp.linalg.norm(err_pos)
    if target_quat is not None:
      site_quat = qmath.mat_to_quat(sm)
      err_rot = qmath.quat_to_vel(
          qmath.quat_mul(jnp.asarray(target_quat, dtype),
                         qmath.quat_conj(site_quat)))
      rows.append(jacr)
      errs.append(err_rot)
      norm = norm + rot_weight * jnp.linalg.norm(err_rot)
    return jnp.concatenate(rows, axis=0), jnp.concatenate(errs), norm

  def cond(state):
    _, err_norm, steps, halt = state
    return (steps < max_steps) & (err_norm >= tol) & ~halt

  def body(state):
    qpos, _, steps, _ = state
    jac, err, err_norm = residual(qpos)
    jac = jac * mask[None, :]
    # damped least squares on the normal equations
    # (inverse_kinematics.py:256-283; Buss 2004)
    # floor scales with dtype: 1e-10 at f64, ~1e-4 at f32 — below f32
    # resolution the normal-equations solve goes singular and NaNs
    floor = max(float(jnp.finfo(dtype).eps) * 1e3, _REG_FLOOR)
    reg = jnp.where(err_norm > regularization_threshold,
                    regularization_strength, floor)
    hess = jac.T @ jac + reg * jnp.eye(m.nv, dtype=dtype)
    dq = jnp.linalg.solve(hess, jac.T @ err) * mask
    update_norm = jnp.linalg.norm(dq)
    # progress heuristic: halt when err/update explodes
    # (inverse_kinematics.py:204-214)
    halt = err_norm / jnp.maximum(update_norm, 1e-30) > progress_thresh
    scale = jnp.minimum(1.0, max_update_norm / jnp.maximum(
        update_norm, 1e-30))
    qnew = eforward._integrate_pos(m, qpos, dq * scale, 1.0)
    qpos = jnp.where(halt, qpos, qnew)
    return qpos, err_norm, steps + 1, halt

  init = (q, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32),
          jnp.asarray(False))
  qpos, _, steps, _ = jax.lax.while_loop(cond, body, init)
  _, _, err_norm = residual(qpos)
  return IKResult(qpos=qpos, err_norm=err_norm, steps=steps,
                  success=err_norm < tol)


def nullspace_method(jac_joints: jax.Array, delta: jax.Array,
                     regularization_strength: float = 0.0) -> jax.Array:
  """Damped-LS joint update (inverse_kinematics.py:256-283), traceable."""
  hess = jac_joints.T @ jac_joints
  rhs = jac_joints.T @ delta
  reg = jnp.maximum(regularization_strength, _REG_FLOOR)
  return jnp.linalg.solve(
      hess + reg * jnp.eye(hess.shape[0], dtype=hess.dtype), rhs)
