"""Constraint row construction (efc system).

Assembles the fixed-size constraint system consumed by the Newton solver:
equality couplings, joint/tendon limits, and contacts, as dense blocks
J [nefc, nv] with reference acceleration ``aref`` and inverse regularizer
``D`` derived from MuJoCo's solref/solimp impedance semantics (so solver
fixed points match the reference engine's).

All limit rows are materialized statically (vectorized over the model's
limited joints/tendons) and masked by activity; contacts arrive pre-culled
from engine.collision. Shapes are static per model — the batched
replacement for MuJoCo's dynamically-sized efc arrays.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine.data import Data
from myosuite_mjx_tpu.engine.model import (
    DSBL_CONSTRAINT, DSBL_CONTACT, DSBL_EQUALITY, DSBL_LIMIT,
    EqType, JointType, Model,
)

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


def kbi(m: Model, solref: jax.Array, solimp: jax.Array, pos: jax.Array):
  """Stiffness k, damping b, impedance imp from solref/solimp and violation.

  Implements MuJoCo's standard impedance model (positive solref) and the
  direct (negative solref) form; `refsafe` clamps timeconst to 2*timestep.
  """
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  dmin = jnp.clip(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = jnp.clip(solimp[..., 1], _MINIMP, _MAXIMP)
  width = jnp.maximum(solimp[..., 2], _MINVAL)
  mid = jnp.clip(solimp[..., 3], _MINIMP, _MAXIMP)
  power = jnp.maximum(solimp[..., 4], 1.0)

  tc = jnp.maximum(timeconst, 2.0 * m.opt.timestep)
  k_std = 1.0 / jnp.maximum(dmax * dmax * tc * tc * dampratio * dampratio,
                            _MINVAL)
  b_std = 2.0 / jnp.maximum(dmax * tc, _MINVAL)
  direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
  k = jnp.where(direct, -solref[..., 0] / jnp.maximum(dmax * dmax, _MINVAL),
                k_std)
  b = jnp.where(direct, -solref[..., 1] / jnp.maximum(dmax, _MINVAL), b_std)

  x = jnp.abs(pos) / width
  ya = jnp.power(x / jnp.maximum(mid, _MINVAL), power) * mid
  yb = 1.0 - jnp.power((1.0 - x) / jnp.maximum(1.0 - mid, _MINVAL),
                       power) * (1.0 - mid)
  y = jnp.where(x < mid, ya, yb)
  imp = dmin + y * (dmax - dmin)
  imp = jnp.clip(imp, dmin, dmax)
  imp = jnp.where(x > 1.0, dmax, imp)
  return k, b, imp


@dataclasses.dataclass(frozen=True)
class _LimitSpec:
  """Static layout of limit/equality rows (numpy index arrays)."""
  jl_qadr: np.ndarray     # [LJ] qpos address of limited hinge/slide joints
  jl_dadr: np.ndarray     # [LJ]
  jl_range: np.ndarray    # [LJ, 2]
  jl_margin: np.ndarray   # [LJ]
  jl_invw: np.ndarray     # [LJ]
  jl_solref: np.ndarray   # [LJ, 2]
  jl_solimp: np.ndarray   # [LJ, 5]
  tl_idx: np.ndarray      # [LT] limited tendon ids
  eq_j1: np.ndarray       # [E] joint-equality obj ids
  eq_j2: np.ndarray       # [E] (-1 for constant)


def _limit_spec(m: Model) -> _LimitSpec:
  from myosuite_mjx_tpu.engine.model import derived_cache
  return derived_cache(m, "limit_spec", _build_limit_spec)


def _build_limit_spec(m: Model) -> _LimitSpec:
  qadr, dadr, rng, mrg, invw, sr, si = [], [], [], [], [], [], []
  for j in range(m.njnt):
    if not bool(m.jnt_limited[j]):
      continue
    if int(m.jnt_type[j]) not in (JointType.HINGE, JointType.SLIDE):
      raise NotImplementedError("ball joint limits")
    qadr.append(int(m.jnt_qposadr[j]))
    dadr.append(int(m.jnt_dofadr[j]))
    rng.append(m.jnt_range[j])
    mrg.append(float(m.jnt_margin[j]))
    invw.append(float(m.dof_invweight0[int(m.jnt_dofadr[j])]))
    sr.append(m.jnt_solref[j])
    si.append(m.jnt_solimp[j])
  tl = [t for t in range(m.ntendon) if bool(m.tendon_limited[t])]
  eq_j1, eq_j2 = [], []
  for e in range(m.neq):
    if int(m.eq_type[e]) not in (EqType.JOINT, EqType.TENDON):
      raise NotImplementedError(f"equality type {int(m.eq_type[e])}")
    if bool(m.eq_active0[e]):
      eq_j1.append(int(m.eq_obj1id[e]))
      eq_j2.append(int(m.eq_obj2id[e]))
  spec = _LimitSpec(
      jl_qadr=np.asarray(qadr, np.int32), jl_dadr=np.asarray(dadr, np.int32),
      jl_range=np.asarray(rng).reshape(-1, 2), jl_margin=np.asarray(mrg),
      jl_invw=np.asarray(invw), jl_solref=np.asarray(sr).reshape(-1, 2),
      jl_solimp=np.asarray(si).reshape(-1, 5),
      tl_idx=np.asarray(tl, np.int32),
      eq_j1=np.asarray(eq_j1, np.int32), eq_j2=np.asarray(eq_j2, np.int32))
  return spec


def make_efc(m: Model, d: Data, contact_blocks: dict | None):
  """Assemble the dense constraint system.

  Returns (J, aref, D, is_eq, pos, meta) or None when no constraints can
  exist. Row order: equality, joint limits, tendon limits, contacts.
  meta carries the joint-limit block layout for per-joint limit-force
  diagnostics: {"jl_offset", "jl_dadr", "jl_sign"} (sign is the traced
  nearest-side sign of each row, so sign * force is the signed dof force
  — the quantity the reference reads back via mj_mulJacTVec for its pain
  metric, run_track_v0.py:662-678).
  """
  dtype = d.qpos.dtype
  dsbl = m.opt.disableflags
  if dsbl & DSBL_CONSTRAINT:
    return None
  spec = _limit_spec(m)
  meta = {"jl_offset": 0, "jl_dadr": spec.jl_dadr,
          "jl_sign": jnp.zeros((len(spec.jl_dadr),), dtype)}

  Js, poss, invws, srs, sis, eqs = [], [], [], [], [], []

  # --- joint/tendon-coupling equality rows ---
  if len(spec.eq_j1) and not (dsbl & DSBL_EQUALITY):
    for e in range(m.neq):
      if not bool(m.eq_active0[e]):
        continue
      if int(m.eq_type[e]) == EqType.TENDON:
        t1 = int(m.eq_obj1id[e])
        t2 = int(m.eq_obj2id[e])
        data = m.eq_data[e]
        c0, c1, c2, c3, c4 = (float(x) for x in data[:5])
        L1_0 = float(m.tendon_length0[t1])
        if t2 < 0:
          pos = d.ten_length[t1] - L1_0 - c0
          J = d.ten_J[t1]
          iw = float(m.tendon_invweight0[t1])
        else:
          L2_0 = float(m.tendon_length0[t2])
          dif = d.ten_length[t2] - L2_0
          poly = c0 + c1 * dif + c2 * dif**2 + c3 * dif**3 + c4 * dif**4
          dpoly = c1 + 2 * c2 * dif + 3 * c3 * dif**2 + 4 * c4 * dif**3
          pos = d.ten_length[t1] - L1_0 - poly
          J = d.ten_J[t1] - dpoly * d.ten_J[t2]
          iw = float(m.tendon_invweight0[t1] + m.tendon_invweight0[t2])
        Js.append(J[None])
        poss.append(pos[None])
        invws.append(jnp.asarray([iw], dtype))
        srs.append(jnp.asarray(m.eq_solref[e], dtype)[None])
        sis.append(jnp.asarray(m.eq_solimp[e], dtype)[None])
        eqs.append(np.array([True]))
        continue
      if int(m.eq_type[e]) != EqType.JOINT:
        continue
      j1 = int(m.eq_obj1id[e])
      j2 = int(m.eq_obj2id[e])
      data = m.eq_data[e]
      q1adr, d1adr = int(m.jnt_qposadr[j1]), int(m.jnt_dofadr[j1])
      if j2 < 0:
        pos = d.qpos[q1adr] - float(m.qpos0[q1adr]) - float(data[0])
        J = jnp.zeros(m.nv, dtype).at[d1adr].set(1.0)
        iw = float(m.dof_invweight0[d1adr])
      else:
        q2adr, d2adr = int(m.jnt_qposadr[j2]), int(m.jnt_dofadr[j2])
        dif = d.qpos[q2adr] - float(m.qpos0[q2adr])
        c0, c1, c2, c3, c4 = (float(x) for x in data[:5])
        poly = c0 + c1 * dif + c2 * dif**2 + c3 * dif**3 + c4 * dif**4
        dpoly = c1 + 2 * c2 * dif + 3 * c3 * dif**2 + 4 * c4 * dif**3
        pos = d.qpos[q1adr] - float(m.qpos0[q1adr]) - poly
        J = jnp.zeros(m.nv, dtype).at[d1adr].set(1.0).at[d2adr].set(-dpoly)
        iw = float(m.dof_invweight0[d1adr] + m.dof_invweight0[d2adr])
      Js.append(J[None])
      poss.append(pos[None])
      invws.append(jnp.asarray([iw], dtype))
      srs.append(jnp.asarray(m.eq_solref[e], dtype)[None])
      sis.append(jnp.asarray(m.eq_solimp[e], dtype)[None])
      eqs.append(np.array([True]))

  if not (dsbl & DSBL_LIMIT):
    # --- joint limits (vectorized over limited joints) ---
    LJ = len(spec.jl_qadr)
    if LJ:
      q = d.qpos[spec.jl_qadr]
      lo = jnp.asarray(spec.jl_range[:, 0], dtype)
      hi = jnp.asarray(spec.jl_range[:, 1], dtype)
      dist_lo = q - lo
      dist_hi = hi - q
      sign = jnp.where(dist_lo < dist_hi, 1.0, -1.0)
      dist = jnp.minimum(dist_lo, dist_hi)
      meta["jl_offset"] = sum(int(x.shape[0]) for x in Js)
      meta["jl_sign"] = sign
      J = jnp.zeros((LJ, m.nv), dtype).at[np.arange(LJ),
                                          spec.jl_dadr].set(sign)
      Js.append(J)
      poss.append(dist - jnp.asarray(spec.jl_margin, dtype))
      invws.append(jnp.asarray(spec.jl_invw, dtype))
      srs.append(jnp.asarray(spec.jl_solref, dtype))
      sis.append(jnp.asarray(spec.jl_solimp, dtype))
      eqs.append(np.zeros(LJ, bool))

    # --- tendon limits ---
    LT = len(spec.tl_idx)
    if LT:
      tl = spec.tl_idx
      L = d.ten_length[tl]
      lo = jnp.asarray(m.tendon_range[tl, 0], dtype)
      hi = jnp.asarray(m.tendon_range[tl, 1], dtype)
      dist_lo = L - lo
      dist_hi = hi - L
      sign = jnp.where(dist_lo < dist_hi, 1.0, -1.0)
      dist = jnp.minimum(dist_lo, dist_hi)
      Js.append(sign[:, None] * d.ten_J[tl])
      poss.append(dist - jnp.asarray(m.tendon_margin[tl], dtype))
      invws.append(jnp.asarray(m.tendon_invweight0[tl], dtype))
      srs.append(jnp.asarray(m.tendon_solref_lim[tl], dtype))
      sis.append(jnp.asarray(m.tendon_solimp_lim[tl], dtype))
      eqs.append(np.zeros(LT, bool))

  if contact_blocks is not None and not (dsbl & DSBL_CONTACT):
    Js.append(contact_blocks["J"])
    poss.append(contact_blocks["pos"])
    invws.append(contact_blocks["invweight"])
    srs.append(contact_blocks["solref"])
    sis.append(contact_blocks["solimp"])
    eqs.append(np.zeros(contact_blocks["J"].shape[0], bool))

  if not Js:
    return None

  J = jnp.concatenate(Js)
  pos = jnp.concatenate(poss)
  invweight = jnp.concatenate(invws)
  solref = jnp.concatenate(srs)
  solimp = jnp.concatenate(sis)
  is_eq = jnp.asarray(np.concatenate(eqs))

  k, b, imp = kbi(m, solref, solimp, pos)
  vel = J @ d.qvel
  aref = -b * vel - k * imp * pos
  r = jnp.maximum(invweight * (1.0 - imp) / jnp.maximum(imp, _MINVAL),
                  _MINVAL)
  D = 1.0 / r
  # inequality rows participate only while violated (pos < 0)
  D = jnp.where(is_eq | (pos < 0), D, 0.0)
  return J, aref, D, is_eq, pos, meta
