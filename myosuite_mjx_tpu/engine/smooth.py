"""Smooth (unconstrained) dynamics: FK, composite inertia, CRB, RNE.

Replaces the MuJoCo C smooth-dynamics stage the reference consumes through
dm_control (/root/reference/myosuite/physics/mj_sim_scene.py:51-65). Design is
batch-first rather than a translation:

* The kinematic tree is **statically unrolled** at trace time (nbody is tiny,
  <= ~30 for myoHand): every tree gather becomes a static index, so XLA sees
  straight-line dense math it can fuse; the batch axis (vmap over envs) is the
  parallel axis.
* Spatial algebra uses 6D motion/force vectors in a **world-origin frame**
  ([angular; linear-at-origin]) — one global frame for the whole tree keeps
  every pairwise product a plain dense op, vs MuJoCo's
  per-tree com-centered frames.
* The mass matrix is built densely: M = mask * (F @ cdof^T) with
  F_i = I_subtree(body(i)) @ cdof_i — a single [nv,6]x[6,nv] contraction.

Functions are single-env; batching is vmap at the step/env layer.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine.model import JointType, Model
from myosuite_mjx_tpu.ops import quat as qmath


# ---------------------------------------------------------------------------
# spatial algebra (world-origin frame): u = [angular(3); linear(3)]
# ---------------------------------------------------------------------------


def motion_cross(u: jax.Array, v: jax.Array) -> jax.Array:
  """Spatial cross product of motion vectors: u x_m v."""
  ang = jnp.cross(u[..., :3], v[..., :3])
  lin = jnp.cross(u[..., :3], v[..., 3:]) + jnp.cross(u[..., 3:], v[..., :3])
  return jnp.concatenate([ang, lin], axis=-1)


def force_cross(u: jax.Array, f: jax.Array) -> jax.Array:
  """Spatial cross product applied to a force vector: u x_f f."""
  ang = jnp.cross(u[..., :3], f[..., :3]) + jnp.cross(u[..., 3:], f[..., 3:])
  lin = jnp.cross(u[..., :3], f[..., 3:])
  return jnp.concatenate([ang, lin], axis=-1)


def spatial_inertia(mass: jax.Array, inertia_diag: jax.Array,
                    com: jax.Array, imat: jax.Array) -> jax.Array:
  """Compact world-origin spatial inertia, 10 components (mjData.cinert
  layout idea): (Ixx, Iyy, Izz, Ixy, Ixz, Iyz, hx, hy, hz, m) where
  h = m * com and I = R D R^T + m (|c|^2 E - c c^T).

  Deliberately elementwise: a 6x6 form built from [..., 3, 3] matmuls
  turns into many tiny padded dot_generals plus layout-conversion copies,
  where elementwise products fuse.

  mass: [...], inertia_diag: [..., 3], com: [..., 3], imat: [..., 3, 3].
  """
  R = imat
  D = inertia_diag
  c = com

  def ic(a, b):
    return (R[..., a, 0] * D[..., 0] * R[..., b, 0]
            + R[..., a, 1] * D[..., 1] * R[..., b, 1]
            + R[..., a, 2] * D[..., 2] * R[..., b, 2])

  c2 = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]
  comp = [
      ic(0, 0) + mass * (c2 - c[..., 0] * c[..., 0]),
      ic(1, 1) + mass * (c2 - c[..., 1] * c[..., 1]),
      ic(2, 2) + mass * (c2 - c[..., 2] * c[..., 2]),
      ic(0, 1) - mass * c[..., 0] * c[..., 1],
      ic(0, 2) - mass * c[..., 0] * c[..., 2],
      ic(1, 2) - mass * c[..., 1] * c[..., 2],
      mass * c[..., 0],
      mass * c[..., 1],
      mass * c[..., 2],
      mass * jnp.ones_like(c2),
  ]
  return jnp.stack(comp, axis=-1)


def inert_mul(c10: jax.Array, v: jax.Array) -> jax.Array:
  """f = I v for compact spatial inertia c10 [..., 10] and motion vector
  v = [w; u] [..., 6]: f_ang = I w + h x u, f_lin = m u - h x w."""
  Ixx, Iyy, Izz = c10[..., 0], c10[..., 1], c10[..., 2]
  Ixy, Ixz, Iyz = c10[..., 3], c10[..., 4], c10[..., 5]
  h = c10[..., 6:9]
  mass = c10[..., 9]
  w, u = v[..., :3], v[..., 3:]
  iw = jnp.stack([
      Ixx * w[..., 0] + Ixy * w[..., 1] + Ixz * w[..., 2],
      Ixy * w[..., 0] + Iyy * w[..., 1] + Iyz * w[..., 2],
      Ixz * w[..., 0] + Iyz * w[..., 1] + Izz * w[..., 2],
  ], axis=-1)
  ang = iw + jnp.cross(h, u)
  lin = mass[..., None] * u - jnp.cross(h, w)
  return jnp.concatenate([ang, lin], axis=-1)


# ---------------------------------------------------------------------------
# forward kinematics (level-wise vectorized)
# ---------------------------------------------------------------------------


class _TreeSpec:
  """Static tree layout: bodies grouped by depth, joints grouped by slot
  position within their body and by type — so FK runs as ~depth batched
  quaternion ops instead of one op chain per body."""

  def __init__(self, m: Model):
    nb = m.nbody
    depth = np.zeros(nb, np.int64)
    for i in range(1, nb):
      depth[i] = depth[int(m.body_parentid[i])] + 1
    self.levels = []          # [(body_ids, parent_ids)] by depth
    for dlv in range(1, int(depth.max()) + 1 if nb > 1 else 1):
      ids = np.where(depth == dlv)[0]
      if len(ids):
        self.levels.append((ids, m.body_parentid[ids]))
    # joint slots: slot k = each body's (k+1)-th joint, grouped by type
    maxslots = int(m.body_jntnum.max()) if m.njnt else 0
    self.slots = []           # [{jtype: (body_ids, jnt_ids)}]
    for k in range(maxslots):
      has = np.where(m.body_jntnum > k)[0]
      jids = m.body_jntadr[has] + k
      groups = {}
      for jt in np.unique(m.jnt_type[jids]):
        sel = m.jnt_type[jids] == jt
        groups[int(jt)] = (has[sel], jids[sel])
      self.slots.append(groups)
    free = np.where(m.jnt_type == JointType.FREE)[0]
    self.free_jids = free
    self.free_bids = m.jnt_bodyid[free]
    self.free_qadr = m.jnt_qposadr[free]
    self.mocap_bids = np.where(m.body_mocapid >= 0)[0]
    self.mocap_ids = m.body_mocapid[self.mocap_bids]
    # world position of a joint = parent-body pose ∘ anchor_rel
    self.jnt_parentbid = m.body_parentid[m.jnt_bodyid]


def _tree_spec(m: Model) -> _TreeSpec:
  from myosuite_mjx_tpu.engine.model import derived_cache
  return derived_cache(m, "tree_spec", _TreeSpec)


def kinematics(m: Model, qpos: jax.Array, mocap_pos: jax.Array,
               mocap_quat: jax.Array, overlay: dict | None = None):
  """Body/joint/site/geom world poses. Mirrors mj_kinematics semantics.

  Level-wise vectorized: per-body local transforms (body offset composed
  with that body's joints) are computed for all bodies at once, then
  composed down the tree one depth level at a time — sequential depth is
  the tree height (~10 for myoHand), not the body count.

  ``overlay['body_pos']`` (nbody, 3) overrides local body offsets per
  episode (SimRandomizer.randomize_bodies, physics/randomize.py:64-91).
  """
  dtype = qpos.dtype
  spec = _tree_spec(m)
  nb = m.nbody

  if overlay and "body_pos" in overlay:
    t_loc = jnp.asarray(overlay["body_pos"], dtype)
  else:
    t_loc = jnp.asarray(m.body_pos, dtype)
  q_loc = jnp.asarray(m.body_quat, dtype)
  if len(spec.mocap_bids):
    t_loc = t_loc.at[spec.mocap_bids].set(mocap_pos[spec.mocap_ids])
    q_loc = q_loc.at[spec.mocap_bids].set(mocap_quat[spec.mocap_ids])

  anchor_rel = jnp.zeros((max(m.njnt, 1), 3), dtype)
  axis_rel = jnp.zeros((max(m.njnt, 1), 3), dtype)

  # fold each body's joints into its parent-frame local transform, one
  # joint slot at a time (bodies have <= ~3 joints), vectorized per type
  for groups in spec.slots:
    for jt, (bids, jids) in groups.items():
      if jt == JointType.FREE:
        continue   # absolute pose, applied in the level pass
      t = t_loc[bids]
      q = q_loc[bids]
      jpos = jnp.asarray(m.jnt_pos[jids], dtype)
      jaxis = jnp.asarray(m.jnt_axis[jids], dtype)
      qadr = m.jnt_qposadr[jids]
      anch = t + qmath.quat_rotate(q, jpos)
      axr = qmath.quat_rotate(q, jaxis)
      anchor_rel = anchor_rel.at[jids].set(anch)
      axis_rel = axis_rel.at[jids].set(axr)
      if jt == JointType.HINGE:
        ang = qpos[qadr] - jnp.asarray(m.qpos0[qadr], dtype)
        qn = qmath.quat_mul(q, qmath.axis_angle_to_quat(jaxis, ang))
        tn = anch - qmath.quat_rotate(qn, jpos)
      elif jt == JointType.SLIDE:
        disp = qpos[qadr] - jnp.asarray(m.qpos0[qadr], dtype)
        tn = t + axr * disp[:, None]
        qn = q
      elif jt == JointType.BALL:
        qloc = qmath.normalize(qpos[qadr[:, None] + np.arange(4)])
        qn = qmath.quat_mul(q, qloc)
        tn = anch - qmath.quat_rotate(qn, jpos)
      else:
        raise NotImplementedError(f"joint type {jt}")
      t_loc = t_loc.at[bids].set(tn)
      q_loc = q_loc.at[bids].set(qn)

  # free-joint bodies carry an absolute world pose
  if len(spec.free_bids):
    fq = spec.free_qadr
    fpos = qpos[fq[:, None] + np.arange(3)]
    fquat = qmath.normalize(qpos[fq[:, None] + 3 + np.arange(4)])
  else:
    fpos = fquat = None

  # level-wise composition down the tree
  xpos = jnp.zeros((nb, 3), dtype)
  xquat = jnp.tile(qmath.quat_identity(dtype=dtype), (nb, 1))
  for ids, parents in spec.levels:
    xp = xpos[parents] + qmath.quat_rotate(xquat[parents], t_loc[ids])
    xq = qmath.quat_mul(xquat[parents], q_loc[ids])
    xpos = xpos.at[ids].set(xp)
    xquat = xquat.at[ids].set(xq)
    if fpos is not None:
      lvl = np.isin(spec.free_bids, ids)
      if lvl.any():
        fb = spec.free_bids[lvl]
        xpos = xpos.at[fb].set(fpos[lvl])
        xquat = xquat.at[fb].set(fquat[lvl])
  xquat = qmath.normalize(xquat)
  xmat = qmath.quat_to_mat(xquat)

  # world joint anchors/axes from the parent-frame relatives
  if m.njnt:
    pb = spec.jnt_parentbid
    xanchor = xpos[pb] + qmath.quat_rotate(xquat[pb], anchor_rel[:m.njnt])
    xaxis = qmath.quat_rotate(xquat[pb], axis_rel[:m.njnt])
    if len(spec.free_jids):
      fj = spec.free_jids
      xanchor = xanchor.at[fj].set(xpos[spec.free_bids])
      xaxis = xaxis.at[fj].set(jnp.asarray(m.jnt_axis[fj], dtype))
  else:
    xanchor = jnp.zeros((0, 3), dtype)
    xaxis = jnp.zeros((0, 3), dtype)

  # inertial frames / sites / geoms — all composed in quaternion space
  # (quat_mul + quat_rotate + quat_to_mat are elementwise; [..., 3, 3]
  # matmuls become tiny padded dot_generals and layout copies)
  ipos = jnp.asarray(m.body_ipos, dtype)
  iquat = jnp.asarray(m.body_iquat, dtype)
  xipos = xpos + qmath.quat_rotate(xquat, ipos)
  ximat = qmath.quat_to_mat(qmath.quat_mul(xquat, iquat))

  sb = m.site_bodyid
  site_xpos = xpos[sb] + qmath.quat_rotate(
      xquat[sb], jnp.asarray(m.site_pos, dtype))
  site_xmat = qmath.quat_to_mat(
      qmath.quat_mul(xquat[sb], jnp.asarray(m.site_quat, dtype)))
  gb = m.geom_bodyid
  geom_xpos = xpos[gb] + qmath.quat_rotate(
      xquat[gb], jnp.asarray(m.geom_pos, dtype))
  geom_xmat = qmath.quat_to_mat(
      qmath.quat_mul(xquat[gb], jnp.asarray(m.geom_quat, dtype)))

  return dict(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      xanchor=xanchor, xaxis=xaxis, site_xpos=site_xpos, site_xmat=site_xmat,
      geom_xpos=geom_xpos, geom_xmat=geom_xmat)


# ---------------------------------------------------------------------------
# com-level quantities: subtree com, spatial inertia, dof axes
# ---------------------------------------------------------------------------


def com_pos(m: Model, kin: dict, overlay: dict | None = None):
  """subtree_com, cinert (world-origin compact [nbody, 10]), cdof.

  ``overlay['body_mass']`` (domain randomization) overrides the static
  masses; inertia tensors stay nominal, matching the reference's
  setConst-skipping approximation (baoding_v1.py:364).
  """
  xipos, ximat = kin["xipos"], kin["ximat"]
  dtype = xipos.dtype
  spec = _tree_spec(m)
  if overlay and "body_mass" in overlay:
    mass = jnp.asarray(overlay["body_mass"], dtype)
  else:
    mass = jnp.asarray(m.body_mass, dtype)

  # subtree com by reverse level-wise accumulation (duplicate parent
  # indices in .add are summed, so one scatter-add per level)
  wsum = mass[:, None] * xipos
  msum = mass
  for ids, parents in reversed(spec.levels):
    wsum = wsum.at[parents].add(wsum[ids])
    msum = msum.at[parents].add(msum[ids])
  subtree_com = wsum / jnp.maximum(msum, 1e-12)[:, None]

  inertia = jnp.asarray(m.body_inertia, dtype)
  cinert = spatial_inertia(mass, inertia, xipos, ximat)

  # dof motion axes at world origin, vectorized by joint type
  cdof = jnp.zeros((max(m.nv, 1), 6), dtype)
  xanchor, xaxis, xmat = kin["xanchor"], kin["xaxis"], kin["xmat"]
  jt_all = np.asarray(m.jnt_type)
  for jt in np.unique(jt_all):
    jids = np.where(jt_all == jt)[0]
    vadr = m.jnt_dofadr[jids]
    anch = xanchor[jids]
    if jt == JointType.HINGE:
      ax = xaxis[jids]
      rows = jnp.concatenate([ax, jnp.cross(anch, ax)], axis=-1)
      cdof = cdof.at[vadr].set(rows)
    elif jt == JointType.SLIDE:
      ax = xaxis[jids]
      rows = jnp.concatenate([jnp.zeros_like(ax), ax], axis=-1)
      cdof = cdof.at[vadr].set(rows)
    elif jt == JointType.BALL:
      w = jnp.swapaxes(xmat[m.jnt_bodyid[jids]], -1, -2)   # [J, 3(k), 3]
      rows = jnp.concatenate(
          [w, jnp.cross(anch[:, None, :], w)], axis=-1)    # [J, 3, 6]
      idx = (vadr[:, None] + np.arange(3)).reshape(-1)
      cdof = cdof.at[idx].set(rows.reshape(-1, 6))
    elif jt == JointType.FREE:
      # 3 world-aligned translations + 3 child-frame rotations
      eye = jnp.eye(3, dtype=dtype)
      tr = jnp.concatenate([jnp.zeros((3, 3), dtype), eye], axis=-1)
      w = jnp.swapaxes(xmat[m.jnt_bodyid[jids]], -1, -2)
      rot = jnp.concatenate(
          [w, jnp.cross(anch[:, None, :], w)], axis=-1)
      idx_t = (vadr[:, None] + np.arange(3)).reshape(-1)
      idx_r = (vadr[:, None] + 3 + np.arange(3)).reshape(-1)
      cdof = cdof.at[idx_t].set(jnp.tile(tr, (len(jids), 1)))
      cdof = cdof.at[idx_r].set(rot.reshape(-1, 6))
    else:
      raise NotImplementedError(f"joint type {jt}")
  cdof = cdof[:m.nv] if m.nv else jnp.zeros((0, 6), dtype)
  return subtree_com, cinert, cdof


# ---------------------------------------------------------------------------
# CRB mass matrix + dense factorization
# ---------------------------------------------------------------------------


def _ancestor_mask(m: Model) -> np.ndarray:
  """mask[i, j] = 1 where dof j is dof i or an ancestor of dof i (static)."""
  mask = np.zeros((m.nv, m.nv), dtype=np.float64)
  for i in range(m.nv):
    j = i
    while j >= 0:
      mask[i, j] = 1.0
      j = int(m.dof_parentid[j])
  return mask


def crb(m: Model, cinert: jax.Array, cdof: jax.Array) -> jax.Array:
  """Dense joint-space mass matrix via composite rigid bodies."""
  dtype = cdof.dtype
  spec = _tree_spec(m)
  # composite (subtree) inertia per body: reverse level-wise accumulation
  csub = cinert
  for ids, parents in reversed(spec.levels):
    csub = csub.at[parents].add(csub[ids])
  # F_i = I_subtree(body(dof_i)) @ cdof_i  -> [nv, 6]
  F = inert_mul(csub[m.dof_bodyid], cdof)
  # unrolled 6-contraction: sum_k F[:, k] outer cdof[:, k] — stays
  # elementwise/fusible instead of a tiny-contraction dot_general
  lower = sum(F[..., k, None] * cdof[..., k][None, :] for k in range(6))
  lower = lower * jnp.asarray(_ancestor_mask(m), dtype)
  qM = lower + lower.T - jnp.diag(jnp.diag(lower))
  return qM + jnp.diag(jnp.asarray(m.dof_armature, dtype))


def factor_m(qM: jax.Array) -> jax.Array:
  """Cholesky factor (lower) of the mass matrix (unrolled; ops/linalg)."""
  from myosuite_mjx_tpu.ops import linalg
  return linalg.chol_factor(qM)


def solve_m(qLD: jax.Array, x: jax.Array) -> jax.Array:
  """Solve M y = x given the Cholesky factor (supports vector or matrix x)."""
  from myosuite_mjx_tpu.ops import linalg
  return linalg.cho_solve(qLD, x)


# ---------------------------------------------------------------------------
# velocity products
# ---------------------------------------------------------------------------


def com_vel(m: Model, cdof: jax.Array, qvel: jax.Array):
  """Body spatial velocities and dof-axis time derivatives (mj_comVel).

  Level-wise: parent velocities propagate one tree level at a time; each
  body's own-joint contributions and the cdof_dot cross products are
  vectorized per joint slot/type within the level pass.
  """
  dtype = cdof.dtype
  spec = _tree_spec(m)
  nb = m.nbody
  contrib = cdof * qvel[:, None] if m.nv else cdof[:0]

  cvel = jnp.zeros((nb, 6), dtype)
  cdof_dot = jnp.zeros((max(m.nv, 1), 6), dtype)

  # per-body cumulative own-dof contributions, resolved slot by slot so the
  # before/after-own-joint velocity semantics per type are kept exactly
  jt_all = np.asarray(m.jnt_type)
  for ids, parents in spec.levels:
    v = cvel[parents]          # [L, 6] velocity entering the level bodies
    vcur = cvel.at[ids].set(v)  # running per-body velocity during the fold
    for groups in spec.slots:
      for jt, (bids, jids) in groups.items():
        sel = np.isin(bids, ids)
        if not sel.any():
          continue
        b = bids[sel]
        j = jids[sel]
        vadr = m.jnt_dofadr[j]
        vb = vcur[b]
        if jt in (JointType.HINGE, JointType.SLIDE):
          # axis invariant under own motion: derivative vs pre-joint vel
          cdof_dot = cdof_dot.at[vadr].set(
              motion_cross(vb, cdof[vadr]))
          vcur = vcur.at[b].add(contrib[vadr])
        elif jt == JointType.BALL:
          idx = vadr[:, None] + np.arange(3)
          vnew = vb + contrib[idx].sum(axis=1)
          cdof_dot = cdof_dot.at[idx.reshape(-1)].set(
              motion_cross(vnew[:, None, :], cdof[idx]).reshape(-1, 6))
          vcur = vcur.at[b].set(vnew)
        elif jt == JointType.FREE:
          idx_t = vadr[:, None] + np.arange(3)
          idx_r = vadr[:, None] + 3 + np.arange(3)
          vnew = (vb + contrib[idx_t].sum(axis=1)
                  + contrib[idx_r].sum(axis=1))
          cdof_dot = cdof_dot.at[idx_r.reshape(-1)].set(
              motion_cross(vnew[:, None, :], cdof[idx_r]).reshape(-1, 6))
          vcur = vcur.at[b].set(vnew)
    cvel = vcur

  cdof_dot = cdof_dot[:m.nv] if m.nv else jnp.zeros((0, 6), dtype)
  return cvel, cdof_dot


def rne(m: Model, cinert: jax.Array, cdof: jax.Array, cdof_dot: jax.Array,
        cvel: jax.Array, qvel: jax.Array) -> jax.Array:
  """Bias force C(q, qvel) via recursive Newton-Euler (qacc = 0)."""
  dtype = cdof.dtype
  gravity = jnp.asarray(m.opt.gravity, dtype)
  from myosuite_mjx_tpu.engine.model import DSBL_GRAVITY
  if m.opt.disableflags & DSBL_GRAVITY:
    gravity = jnp.zeros(3, dtype)

  spec = _tree_spec(m)
  nb = m.nbody
  # per-body sum of own-dof cdof_dot * qvel (one segment scatter-add)
  dotsum = jnp.zeros((nb, 6), dtype)
  if m.nv:
    dotsum = dotsum.at[m.dof_bodyid].add(cdof_dot * qvel[:, None])

  cacc = jnp.zeros((nb, 6), dtype)
  cacc = cacc.at[0].set(
      jnp.concatenate([jnp.zeros(3, dtype), -gravity]))
  for ids, parents in spec.levels:
    cacc = cacc.at[ids].set(cacc[parents] + dotsum[ids])

  mom = inert_mul(cinert, cvel)
  cfrc = inert_mul(cinert, cacc) + force_cross(cvel, mom)
  cfrc = cfrc.at[0].set(0.0)
  for ids, parents in reversed(spec.levels):
    keep = parents > 0
    if keep.any():
      cfrc = cfrc.at[parents[keep]].add(cfrc[ids[keep]])

  if not m.nv:
    return jnp.zeros((0,), dtype)
  return jnp.einsum("nk,nk->n", cdof, cfrc[m.dof_bodyid])


# ---------------------------------------------------------------------------
# jacobians
# ---------------------------------------------------------------------------


def _build_body_dof_mask(m: Model) -> np.ndarray:
  mask = np.zeros((m.nbody, m.nv))
  for b in range(m.nbody):
    i = b
    while i > 0:
      da, dn = int(m.body_dofadr[i]), int(m.body_dofnum[i])
      mask[b, da:da + dn] = 1.0
      i = int(m.body_parentid[i])
  return mask


def body_dof_mask(m: Model) -> np.ndarray:
  """[nbody, nv] mask: dofs on the ancestor chain of each body (static)."""
  from myosuite_mjx_tpu.engine.model import derived_cache
  return derived_cache(m, "body_dof_mask", _build_body_dof_mask)


def point_jac_dir(m: Model, cdof: jax.Array, points: jax.Array,
                  bodyids, dirs: jax.Array) -> jax.Array:
  """Directional point jacobians, vectorized: rows (jacp(p_i, b_i)^T d_i).

  points: [S, 3], bodyids: [S] (static numpy or traced int array),
  dirs: [S, 3]. Returns [S, nv] — the generalized-coordinate gradient of
  each point's displacement along its direction. One fused computation for
  all tendon segments / contacts instead of per-point unrolled jacobians.
  """
  mask = jnp.asarray(body_dof_mask(m), cdof.dtype)[bodyids]      # [S, nv]
  ang = cdof[:, :3]                                              # [nv, 3]
  lin = cdof[:, 3:]
  # v(point) = lin + ang x point per dof; projecting on dir uses the scalar
  # triple product (ang x p) . d = ang . (p x d), so the [S, nv, 3] cross
  # intermediate never materializes — two [S,3]x[3,nv] matmuls instead
  pc = jnp.cross(points, dirs)                                   # [S, 3]
  proj = dirs @ lin.T + pc @ ang.T                               # [S, nv]
  return proj * mask


def rot_jac_dir(m: Model, cdof: jax.Array, bodyids,
                dirs: jax.Array) -> jax.Array:
  """Rotational analogue of point_jac_dir: rows (jacr(b_i)^T d_i)."""
  mask = jnp.asarray(body_dof_mask(m), cdof.dtype)[bodyids]      # [S, nv]
  proj = jnp.einsum("nk,sk->sn", cdof[:, :3], dirs)
  return proj * mask


def point_jacobian(m: Model, cdof: jax.Array, point: jax.Array,
                   bodyid: int) -> tuple[jax.Array, jax.Array]:
  """(jacp, jacr): translational/rotational Jacobian of a world point on a
  body. Static ancestor chain -> dense [3, nv] with a static mask."""
  dtype = cdof.dtype
  mask = np.zeros((m.nv,), np.float64)
  b = int(bodyid)
  while b > 0:
    da, dn = int(m.body_dofadr[b]), int(m.body_dofnum[b])
    mask[da:da + dn] = 1.0
    b = int(m.body_parentid[b])
  maskj = jnp.asarray(mask, dtype)
  ang = cdof[:, :3] * maskj[:, None]      # [nv, 3]
  lin0 = cdof[:, 3:] * maskj[:, None]
  # velocity of the point: v(point) = lin0 + ang x point
  jacp = (lin0 + jnp.cross(ang, point[None, :])).T
  jacr = ang.T
  return jacp, jacr
