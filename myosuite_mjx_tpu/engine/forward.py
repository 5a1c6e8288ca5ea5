"""Forward dynamics pipeline and integration.

Pure functions ``forward(m, d) -> d`` and ``step(m, d) -> d`` (the batched
equivalent of the reference's `sim.forward()` / `sim.advance()` surface,
/root/reference/myosuite/physics/sim_scene.py:167-208). The pipeline mirrors
MuJoCo's stage order — position, velocity, actuation, acceleration,
constraint, integrate — with every stage a pure JAX function of (Model, Data).

Constraint handling lives in engine/solver.py; when a model has no active
constraints the smooth acceleration is used directly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from myosuite_mjx_tpu.engine import muscle as muscle_mod
from myosuite_mjx_tpu.engine import smooth
from myosuite_mjx_tpu.engine import tendon as tendon_mod
from myosuite_mjx_tpu.engine.data import Data
from myosuite_mjx_tpu.engine.model import (
    DSBL_ACTUATION, DSBL_CLAMPCTRL, DSBL_GRAVITY, DSBL_PASSIVE,
    BiasType, DynType, GainType, IntegratorType, JointType, Model, TrnType,
)


# ---------------------------------------------------------------------------
# position stage
# ---------------------------------------------------------------------------


def fwd_position(m: Model, d: Data) -> Data:
  kin = smooth.kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat, d.overlay)
  subtree_com, cinert, cdof = smooth.com_pos(m, kin, d.overlay)
  ten_length, ten_J = tendon_mod.tendon(m, kin, cdof)
  if m.ntendon:
    ten_length = ten_length + tendon_mod.fixed_tendon_length(m, d.qpos)
  qM = smooth.crb(m, cinert, cdof)
  qLD = smooth.factor_m(qM)
  act_length, act_moment = _transmission(m, d.qpos, ten_length, ten_J)
  return d.replace(
      xpos=kin["xpos"], xquat=kin["xquat"], xmat=kin["xmat"],
      xipos=kin["xipos"], ximat=kin["ximat"], xanchor=kin["xanchor"],
      xaxis=kin["xaxis"], site_xpos=kin["site_xpos"],
      site_xmat=kin["site_xmat"], geom_xpos=kin["geom_xpos"],
      geom_xmat=kin["geom_xmat"], subtree_com=subtree_com, cinert=cinert,
      cdof=cdof, ten_length=ten_length, ten_J=ten_J, qM=qM, qLD=qLD,
      actuator_length=act_length, actuator_moment=act_moment)


def _transmission(m: Model, qpos: jax.Array, ten_length: jax.Array,
                  ten_J: jax.Array):
  """Actuator lengths/moments, vectorized per transmission type."""
  dtype = qpos.dtype
  if m.nu == 0:
    return jnp.zeros((0,), dtype), jnp.zeros((0, m.nv), dtype)
  import numpy as np
  trn = np.asarray(m.actuator_trntype)
  gear = jnp.asarray(m.actuator_gear[:, 0], dtype)          # [nu]
  tid = np.asarray(m.actuator_trnid[:, 0])
  bad = set(np.unique(trn)) - {int(TrnType.JOINT), int(TrnType.TENDON)}
  if bad:
    raise NotImplementedError(f"transmission types {sorted(bad)}")

  lengths = jnp.zeros((m.nu,), dtype)
  moments = jnp.zeros((m.nu, m.nv), dtype)
  is_j = trn == TrnType.JOINT
  if is_j.any():
    ju = np.where(is_j)[0]
    jts = m.jnt_type[tid[ju]]
    if not np.isin(jts, (JointType.HINGE, JointType.SLIDE)).all():
      raise NotImplementedError("joint transmission on ball/free joints")
    qadr = m.jnt_qposadr[tid[ju]]
    dadr = m.jnt_dofadr[tid[ju]]
    lengths = lengths.at[ju].set(gear[ju] * qpos[qadr])
    moments = moments.at[ju, dadr].set(gear[ju])
  is_t = trn == TrnType.TENDON
  if is_t.any():
    tu = np.where(is_t)[0]
    lengths = lengths.at[tu].set(gear[tu] * ten_length[tid[tu]])
    moments = moments.at[tu].set(gear[tu, None] * ten_J[tid[tu]])
  return lengths, moments


# ---------------------------------------------------------------------------
# velocity stage
# ---------------------------------------------------------------------------


def fwd_velocity(m: Model, d: Data) -> Data:
  cvel, cdof_dot = smooth.com_vel(m, d.cdof, d.qvel)
  qfrc_bias = smooth.rne(m, d.cinert, d.cdof, cdof_dot, cvel, d.qvel)
  ten_velocity = d.ten_J @ d.qvel if m.ntendon else d.ten_velocity
  actuator_velocity = d.actuator_moment @ d.qvel
  return d.replace(
      cvel=cvel, cdof_dot=cdof_dot, qfrc_bias=qfrc_bias,
      ten_velocity=ten_velocity, actuator_velocity=actuator_velocity)


# ---------------------------------------------------------------------------
# actuation
# ---------------------------------------------------------------------------


def _fill(base: jax.Array, idx, vals: jax.Array) -> jax.Array:
  """Static-index scatter; identity when idx covers base in order."""
  import numpy as np
  if len(idx) == base.shape[0] and (np.asarray(idx) == np.arange(
      base.shape[0])).all():
    return vals.astype(base.dtype)
  return base.at[jnp.asarray(np.asarray(idx))].set(vals)


def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces, vectorized per static (dyntype, gaintype, biastype)
  group instead of a per-actuator Python loop (39x smaller HLO on the
  hand; muscle_* ops are batched over each group)."""
  import numpy as np
  dtype = d.qpos.dtype
  if m.nu == 0 or (m.opt.disableflags & DSBL_ACTUATION):
    return d.replace(
        actuator_force=jnp.zeros((m.nu,), dtype),
        qfrc_actuator=jnp.zeros((m.nv,), dtype),
        act_dot=jnp.zeros((m.na,), dtype))

  ctrl = d.ctrl
  if not (m.opt.disableflags & DSBL_CLAMPCTRL):
    limited = jnp.asarray(m.actuator_ctrllimited)
    lo = jnp.asarray(m.actuator_ctrlrange[:, 0], dtype)
    hi = jnp.asarray(m.actuator_ctrlrange[:, 1], dtype)
    ctrl = jnp.where(limited, jnp.clip(ctrl, lo, hi), ctrl)

  dyn = np.asarray(m.actuator_dyntype)
  aadr = np.asarray(m.actuator_actadr)
  known = {int(DynType.NONE), int(DynType.MUSCLE), int(DynType.INTEGRATOR),
           int(DynType.FILTER), int(DynType.FILTEREXACT)}
  bad = set(np.unique(dyn)) - known
  if bad:
    raise NotImplementedError(f"dyntype {sorted(bad)}")

  # per-actuator activation (stateless actuators read ctrl directly)
  if m.na:
    a_u = d.act[jnp.asarray(np.where(aadr >= 0, aadr, 0))]
  else:
    a_u = jnp.zeros((m.nu,), dtype)
  act_input = jnp.where(jnp.asarray(dyn == DynType.NONE), ctrl, a_u)

  # activation dynamics (muscle / integrator / filter), grouped
  act_dot = jnp.zeros((m.na,), dtype)
  if m.na:
    ad = jnp.zeros((m.nu,), dtype)
    mus = np.where(dyn == DynType.MUSCLE)[0]
    if mus.size:
      ad = _fill(ad, mus, muscle_mod.muscle_dynamics(
          ctrl[jnp.asarray(mus)], a_u[jnp.asarray(mus)],
          jnp.asarray(m.actuator_dynprm[mus, :3], dtype)))
    integ = np.where(dyn == DynType.INTEGRATOR)[0]
    if integ.size:
      ad = _fill(ad, integ, ctrl[jnp.asarray(integ)])
    filt = np.where((dyn == DynType.FILTER)
                    | (dyn == DynType.FILTEREXACT))[0]
    if filt.size:
      tau = jnp.asarray(
          np.maximum(np.asarray(m.actuator_dynprm)[filt, 0], 1e-15), dtype)
      fj = jnp.asarray(filt)
      ad = _fill(ad, filt, (ctrl[fj] - a_u[fj]) / tau)
    has = np.where(aadr >= 0)[0]
    act_dot = act_dot.at[jnp.asarray(aadr[has])].set(ad[jnp.asarray(has)])

  # gains / biases, grouped by static type. The actuator-gain DR overlay
  # (SimRandomizer.randomize_actuators, physics/randomize.py:209-250)
  # substitutes full-size prm arrays.
  length = d.actuator_length
  vel = d.actuator_velocity
  if "actuator_gainprm" in d.overlay:
    gp_all = jnp.asarray(d.overlay["actuator_gainprm"], dtype)[:, :9]
  else:
    gp_all = jnp.asarray(m.actuator_gainprm[:, :9], dtype)
  if "actuator_biasprm" in d.overlay:
    bp_all = jnp.asarray(d.overlay["actuator_biasprm"], dtype)[:, :9]
  else:
    bp_all = jnp.asarray(m.actuator_biasprm[:, :9], dtype)
  lr_all = jnp.asarray(m.actuator_lengthrange, dtype)
  acc0_all = jnp.asarray(m.actuator_acc0, dtype)

  gt = np.asarray(m.actuator_gaintype)
  bt = np.asarray(m.actuator_biastype)
  bad = set(np.unique(gt)) - {int(GainType.FIXED), int(GainType.AFFINE),
                              int(GainType.MUSCLE)}
  if bad:
    raise NotImplementedError(f"gaintype {sorted(bad)}")
  bad = set(np.unique(bt)) - {int(BiasType.NONE), int(BiasType.AFFINE),
                              int(BiasType.MUSCLE)}
  if bad:
    raise NotImplementedError(f"biastype {sorted(bad)}")

  gain = jnp.zeros((m.nu,), dtype)
  g = np.where(gt == GainType.FIXED)[0]
  if g.size:
    gain = _fill(gain, g, gp_all[jnp.asarray(g), 0])
  g = np.where(gt == GainType.AFFINE)[0]
  if g.size:
    gj = jnp.asarray(g)
    gain = _fill(gain, g, (gp_all[gj, 0] + gp_all[gj, 1] * length[gj]
                           + gp_all[gj, 2] * vel[gj]))
  g = np.where(gt == GainType.MUSCLE)[0]
  if g.size:
    gj = jnp.asarray(g)
    gain = _fill(gain, g, muscle_mod.muscle_gain(
        length[gj], vel[gj], lr_all[gj], acc0_all[gj], gp_all[gj]))

  bias = jnp.zeros((m.nu,), dtype)
  b = np.where(bt == BiasType.AFFINE)[0]
  if b.size:
    bj = jnp.asarray(b)
    bias = _fill(bias, b, (bp_all[bj, 0] + bp_all[bj, 1] * length[bj]
                           + bp_all[bj, 2] * vel[bj]))
  b = np.where(bt == BiasType.MUSCLE)[0]
  if b.size:
    bj = jnp.asarray(b)
    bias = _fill(bias, b, muscle_mod.muscle_bias(
        length[bj], lr_all[bj], acc0_all[bj], bp_all[bj]))

  force = gain * act_input + bias

  limited = jnp.asarray(m.actuator_forcelimited)
  flo = jnp.asarray(m.actuator_forcerange[:, 0], dtype)
  fhi = jnp.asarray(m.actuator_forcerange[:, 1], dtype)
  force = jnp.where(limited, jnp.clip(force, flo, fhi), force)

  qfrc_actuator = d.actuator_moment.T @ force
  return d.replace(actuator_force=force, qfrc_actuator=qfrc_actuator,
                   act_dot=act_dot)


# ---------------------------------------------------------------------------
# passive forces
# ---------------------------------------------------------------------------


def fwd_passive(m: Model, d: Data) -> Data:
  dtype = d.qpos.dtype
  if m.opt.disableflags & DSBL_PASSIVE:
    return d.replace(qfrc_passive=jnp.zeros((m.nv,), dtype))

  # joint dampers (dof_damping DR overlay: SimRandomizer.randomize_dofs,
  # physics/randomize.py:170-207)
  if "dof_damping" in d.overlay:
    damping = jnp.asarray(d.overlay["dof_damping"], dtype)
  else:
    damping = jnp.asarray(m.dof_damping, dtype)
  qfrc = -damping * d.qvel

  # joint springs (hinge/slide dofs; ball/free springs unsupported for now)
  import numpy as np
  sprung = np.where(np.asarray(m.jnt_stiffness) != 0.0)[0]
  if sprung.size:
    if not np.isin(np.asarray(m.jnt_type)[sprung],
                   (JointType.HINGE, JointType.SLIDE)).all():
      raise NotImplementedError("spring on ball/free joint")
    qadr = np.asarray(m.jnt_qposadr)[sprung]
    dadr = np.asarray(m.jnt_dofadr)[sprung]
    k = jnp.asarray(np.asarray(m.jnt_stiffness)[sprung], dtype)
    spring = jnp.asarray(np.asarray(m.qpos_spring)[qadr], dtype)
    qfrc = qfrc.at[jnp.asarray(dadr)].add(
        -k * (d.qpos[jnp.asarray(qadr)] - spring))

  # tendon springs/dampers
  if m.ntendon:
    k = jnp.asarray(m.tendon_stiffness, dtype)
    c = jnp.asarray(m.tendon_damping, dtype)
    lo = jnp.asarray(m.tendon_lengthspring[:, 0], dtype)
    hi = jnp.asarray(m.tendon_lengthspring[:, 1], dtype)
    L = d.ten_length
    stretch = jnp.where(L > hi, L - hi, jnp.where(L < lo, L - lo, 0.0))
    frc = -k * stretch - c * d.ten_velocity
    qfrc = qfrc + d.ten_J.T @ frc

  return d.replace(qfrc_passive=qfrc)


# ---------------------------------------------------------------------------
# acceleration + constraint
# ---------------------------------------------------------------------------


def fwd_acceleration(m: Model, d: Data) -> Data:
  # applied cartesian wrenches -> generalized forces (vectorized over bodies)
  qfrc_applied = d.qfrc_applied
  if m.nbody > 1:
    import numpy as np
    bodies = np.arange(1, m.nbody)
    lin_rows = smooth.point_jac_dir(
        m, d.cdof, d.xipos[1:], bodies, d.xfrc_applied[1:, :3])  # [B, nv]
    mask = jnp.asarray(smooth.body_dof_mask(m), d.qpos.dtype)[bodies]
    rot_rows = jnp.einsum(
        "nk,bk->bn", d.cdof[:, :3], d.xfrc_applied[1:, 3:]) * mask
    qfrc_applied = qfrc_applied + (lin_rows + rot_rows).sum(axis=0)
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                 + qfrc_applied)
  # solve against qM directly (not the qLD factor): with qLD then
  # unconsumed inside the substep scan XLA dead-code-eliminates the
  # separate factor entirely (qLD is still materialized for the last
  # substep's Data, mjData parity)
  from myosuite_mjx_tpu.ops import linalg
  qacc_smooth = linalg.spd_solve(d.qM, qfrc_smooth)
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def forward(m: Model, d: Data, constraint: bool = True) -> Data:
  """Full forward dynamics at the current state.

  ``constraint=False`` skips collision + the Newton solve and takes the
  smooth acceleration (contact/limit forces zero, contact slots inactive).
  Used by env resets of contact-light tasks where neither obs nor reward
  reads contact state: the autoreset path folds a full reset into EVERY
  env step, so its forward's cost is on the hot path (mj_forward with
  mjSTAGE semantics is the reference analogue, robot.py:573-598 always
  pays the full pipeline).
  """
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_passive(m, d)
  d = fwd_acceleration(m, d)
  from myosuite_mjx_tpu.engine import solver  # cycle-free late import
  if not constraint:
    return solver.smooth_only(m, d)
  d = solver.fwd_constraint(m, d)
  return d


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def _integrate_pos(m: Model, qpos: jax.Array, qvel: jax.Array,
                   dt) -> jax.Array:
  """qpos += dt * qvel; hinge/slide joints in one vectorized scatter-add,
  quaternion joints (ball/free — rare in Myo models) individually."""
  import numpy as np
  from myosuite_mjx_tpu.ops import quat as qmath
  out = qpos
  jt_all = np.asarray(m.jnt_type)
  hs = np.where(np.isin(jt_all, (JointType.HINGE, JointType.SLIDE)))[0]
  if hs.size:
    qadr = jnp.asarray(np.asarray(m.jnt_qposadr)[hs])
    vadr = jnp.asarray(np.asarray(m.jnt_dofadr)[hs])
    out = out.at[qadr].add(dt * qvel[vadr])
  for j in np.where(~np.isin(jt_all, (JointType.HINGE, JointType.SLIDE)))[0]:
    jt = int(jt_all[j])
    qadr = int(m.jnt_qposadr[j])
    vadr = int(m.jnt_dofadr[j])
    if jt == JointType.FREE:
      out = out.at[qadr:qadr + 3].add(dt * qvel[vadr:vadr + 3])
      q = qmath.quat_integrate(
          qpos[qadr + 3:qadr + 7], qvel[vadr + 3:vadr + 6], dt)
      out = out.at[qadr + 3:qadr + 7].set(q)
    else:  # BALL
      q = qmath.quat_integrate(qpos[qadr:qadr + 4], qvel[vadr:vadr + 3], dt)
      out = out.at[qadr:qadr + 4].set(q)
  return out


def _clamp_act(m: Model, act: jax.Array) -> jax.Array:
  """Activation clamping as one clip against static per-slot bounds."""
  if m.na == 0:
    return act
  import numpy as np
  lo = np.full(m.na, -np.inf)
  hi = np.full(m.na, np.inf)
  for u in range(m.nu):  # static numpy loop: runs at trace time only
    aadr = int(m.actuator_actadr[u])
    if aadr < 0:
      continue
    if int(m.actuator_dyntype[u]) == DynType.MUSCLE:
      lo[aadr], hi[aadr] = 0.0, 1.0
    elif bool(m.actuator_actlimited[u]):
      lo[aadr] = m.actuator_actrange[u, 0]
      hi[aadr] = m.actuator_actrange[u, 1]
  if np.isneginf(lo).all() and np.isposinf(hi).all():
    return act
  return jnp.clip(act, jnp.asarray(lo, act.dtype), jnp.asarray(hi, act.dtype))


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (MuJoCo Euler).

  Damping is integrated implicitly: (M + h D) qacc = qfrc_smooth +
  qfrc_constraint, which keeps stiff tendon-driven models stable at the
  reference's 2 ms timestep.
  """
  dt = m.opt.timestep
  dtype = d.qpos.dtype
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  if "dof_damping" in d.overlay:
    damping = jnp.asarray(d.overlay["dof_damping"], dtype)
  elif float(abs(m.dof_damping).sum()) > 0:
    damping = jnp.asarray(m.dof_damping, dtype)
  else:
    damping = None
  if damping is not None:
    # M + h*D is SPD: Cholesky solve (ops/linalg)
    from myosuite_mjx_tpu.ops import linalg
    mhb = d.qM + dt * jnp.diag(damping)
    qacc = linalg.spd_solve(mhb, qfrc)
  else:
    qacc = d.qacc
  qvel = d.qvel + dt * qacc
  act = _clamp_act(m, d.act + dt * d.act_dot)
  qpos = _integrate_pos(m, d.qpos, qvel, dt)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + dt)


def step(m: Model, d: Data) -> Data:
  """One physics step: forward dynamics + integrate."""
  d = forward(m, d)
  integ = int(m.opt.integrator)
  if integ == IntegratorType.EULER:
    return euler(m, d)
  raise NotImplementedError(f"integrator {integ}")
