"""Constraint solver: primal Newton with exact piecewise-quadratic line search.

Minimizes MuJoCo's convex primal objective over accelerations

  cost(qacc) = 0.5 ||qacc - qacc_smooth||^2_M
             + 0.5 sum_i D_i [active_i] (J_i qacc - aref_i)^2

where inequality rows are active only while accelerating into the
constraint (jar < 0). Matches the reference's solver configuration space
(mjSOL_NEWTON, iterations, ls_iterations —
the reference's myosuite/mjx/myodm_v0.py:38-41) with batch-friendly structure:
fixed-shape dense rows, batch-uniform control flow.

Speed-of-light choices (all batch-uniform under vmap):
* warm start from the previous step's qacc (``Data.qacc_warmstart``,
  MuJoCo mj_forward semantics) — picks the cheaper of {warmstart,
  qacc_smooth} by primal cost, so Newton usually starts within one
  basin-hop of the optimum;
* Newton loop is a ``lax.while_loop`` with MuJoCo's scaled termination
  (improvement / gradient < opt.tolerance, scale = 1/(meaninertia * nv)),
  capped at the model-requested opt.iterations — no silent fidelity cap;
  under vmap the batch exits when its slowest member converges;
* the 1D line search solves phi'(alpha) = 0 exactly: phi is piecewise
  quadratic in alpha, so a bracketed 1D Newton (bisection-safeguarded)
  converges in a handful of evaluations instead of a fixed
  16-expand + 25-bisect schedule.

The Hessian M + J' diag(w) J is dense [nv, nv] (nv <= ~40 for Myo models)
— batched Cholesky factorizations are one XLA op under vmap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from myosuite_mjx_tpu.engine import constraint
from myosuite_mjx_tpu.engine.data import Data
from myosuite_mjx_tpu.engine.model import Model
from myosuite_mjx_tpu.ops import linalg


def _newton_solve(m: Model, d: Data, J, aref, D, is_eq,
                  iterations: int, ls_iterations: int):
  qM = d.qM
  x0 = d.qacc_smooth
  dtype = x0.dtype
  # MuJoCo terminates when scale*(cost_prev - cost) < tolerance with
  # scale = 1/(meaninertia * max(1, nv)); fold the scale into the bound
  tol = jnp.asarray(
      m.opt.tolerance * max(m.opt.meaninertia, 1e-12) * max(m.nv, 1), dtype)
  ls_tol = jnp.asarray(m.opt.ls_tolerance, dtype)

  def weights(jar):
    active = is_eq | (jar < 0)
    return D * active

  def cost(qacc):
    jar = J @ qacc - aref
    w = weights(jar)
    dx = qacc - x0
    return 0.5 * (dx @ (qM @ dx) + jnp.sum(w * jar * jar))

  def linesearch(p, jar, qMdx, mp):
    """Exact-ish 1D minimization of the piecewise-quadratic along p.

    Every evaluation returns (phi', phi'') in ONE pass over the constraint
    rows (they share jar_a and the active-set weights), halving the row
    traffic of separate dphi/ddphi calls — the line search runs ~12 row
    passes per Newton iteration and was the solver's dominant cost.
    """
    jp = J @ p
    pmx = p @ qMdx
    pmp = jnp.maximum(p @ mp, 1e-15)

    def dphi_ddphi(alpha):
      jar_a = jar + alpha * jp
      wjp = weights(jar_a) * jp
      return (pmx + alpha * pmp + jnp.sum(wjp * jar_a),
              pmp + jnp.sum(wjp * jp))

    # initial guess: unconstrained-quadratic minimizer along p
    d0, dd0 = dphi_ddphi(jnp.zeros((), dtype))
    a0 = jnp.maximum(-d0 / dd0, jnp.asarray(1e-10, dtype))
    df0, ddf0 = dphi_ddphi(a0)

    # bracket [lo, hi] with dphi(lo) <= 0 <= dphi(hi): phi' is monotone
    # nondecreasing (phi convex); expand hi by 16x while needed (unrolled,
    # masked — loop primitives cost a sync per iteration)
    hi = a0
    dfh = df0
    for _ in range(4):
      grow = dfh < 0
      hi = jnp.where(grow, hi * 16.0, hi)
      dfh = jnp.where(grow, dphi_ddphi(hi)[0], dfh)
    lo = jnp.where(df0 < 0, a0, jnp.zeros((), dtype))
    hi = jnp.where(df0 < 0, hi, a0)

    # safeguarded 1D Newton on phi' (bisection fallback keeps the bracket),
    # statically unrolled with a converged mask
    alpha, df, ddf = a0, df0, ddf0
    # phi' is piecewise LINEAR in alpha (weights flip at row breakpoints,
    # otherwise affine), so safeguarded Newton lands exactly after crossing
    # the few active breakpoints — 6 evals cover warmstarted solves
    n_1d = min(ls_iterations, 6)
    for _ in range(n_1d):
      live = jnp.abs(df) > ls_tol * pmp
      step = alpha - df / jnp.maximum(ddf, 1e-15)
      mid = 0.5 * (lo + hi)
      nxt = jnp.where((step > lo) & (step < hi), step, mid)
      nxt = jnp.where(live, nxt, alpha)
      dfn, ddfn = dphi_ddphi(nxt)
      dfn = jnp.where(live, dfn, df)
      ddf = jnp.where(live, ddfn, ddf)
      lo = jnp.where(live & (dfn < 0), nxt, lo)
      hi = jnp.where(live & (dfn >= 0), nxt, hi)
      alpha, df = nxt, dfn
    return alpha, jp, mp

  # ---- warm start: cheaper of {previous solution, smooth acceleration} ----
  ws = d.qacc_warmstart
  start = jnp.where(cost(ws) < cost(x0), ws, x0)

  def nt_cond(carry):
    qacc, jar, qMdx, prev_cost, improvement, it = carry
    return (it < iterations) & (improvement > tol)

  # jar = J qacc - aref and qMdx = M (qacc - x0) are carried across Newton
  # iterations (updated incrementally from the line-search direction
  # products) so each iteration does exactly one J matvec (J p) and one M
  # matvec (M p) instead of three
  def nt_iter(carry):
    qacc, jar, qMdx, prev_cost, _, it = carry
    w = weights(jar)
    grad = qMdx + J.T @ (w * jar)
    H = qM + (J.T * w) @ J
    p = -linalg.spd_solve(H, grad)
    alpha, jp, mp = linesearch(p, jar, qMdx, qM @ p)
    improved = jnp.dot(grad, p) < -1e-16
    alpha = jnp.where(improved, alpha, 0.0)
    qacc_new = qacc + alpha * p
    jar_new = jar + alpha * jp
    qMdx_new = qMdx + alpha * mp
    w_new = weights(jar_new)
    new_cost = 0.5 * ((qacc_new - x0) @ qMdx_new
                      + jnp.sum(w_new * jar_new * jar_new))
    improvement = prev_cost - new_cost
    take = improvement > 0
    return (jnp.where(take, qacc_new, qacc),
            jnp.where(take, jar_new, jar),
            jnp.where(take, qMdx_new, qMdx),
            jnp.where(take, new_cost, prev_cost),
            improvement,
            it + 1)

  # 2 Newton iterations per while trip (statically unrolled block): the
  # per-env update masks make extra iterations past convergence no-ops, so
  # block-unrolling only changes how often the batch-wide exit test runs.
  # Warmstarted batched solves at the bench state converge in <= 4
  # iterations with the tail at 8 (all 4096 envs), so a
  # block of 2 usually stops half the work a block of 4 would burn.
  _BLOCK = 2

  def nt_body(carry):
    for _ in range(_BLOCK):
      carry = nt_iter(carry)
    return carry

  jar0 = J @ start - aref
  qMdx0 = qM @ (start - x0)
  c0 = 0.5 * ((start - x0) @ qMdx0 + jnp.sum(weights(jar0) * jar0 * jar0))
  qacc, jar, _, _, _, niter = jax.lax.while_loop(
      nt_cond, nt_body,
      (start, jar0, qMdx0, c0, jnp.full((), jnp.inf, dtype),
       jnp.zeros((), jnp.int32)))
  force = -weights(jar) * jar
  return qacc, force, niter


def smooth_only(m: Model, d: Data) -> Data:
  """Constraint-free acceleration: qacc = qacc_smooth, no contact forces.

  The cheap tail of the forward pipeline for callers that skip collision
  + the Newton solve (see forward.forward(constraint=False))."""
  return d.replace(
      qfrc_constraint=jnp.zeros_like(d.qfrc_smooth),
      qacc=d.qacc_smooth,
      qacc_warmstart=d.qacc_smooth)


def fwd_constraint(m: Model, d: Data) -> Data:
  """Solve for constraint forces and the constrained acceleration."""
  from myosuite_mjx_tpu.engine import collision
  contact_blocks, contact_info = collision.contacts(m, d)
  efc = constraint.make_efc(m, d, contact_blocks)
  if efc is None:
    return d.replace(
        qfrc_constraint=jnp.zeros_like(d.qfrc_smooth),
        qacc=d.qacc_smooth,
        qacc_warmstart=d.qacc_smooth)
  J, aref, D, is_eq, _pos, meta = efc
  iterations = int(m.opt.solver_iterations)
  ls_iterations = int(m.opt.ls_iterations)
  qacc, force, _niter = _newton_solve(m, d, J, aref, D, is_eq,
                                      iterations, ls_iterations)
  out = d.replace(qfrc_constraint=J.T @ force, qacc=qacc,
                  qacc_warmstart=qacc)
  nl = len(meta["jl_dadr"])
  if nl:
    # signed per-limited-joint dof force (pain-metric diagnostic)
    jl = force[meta["jl_offset"]:meta["jl_offset"] + nl]
    # jl_sign is host-side float64; cast back so an f32 Data under
    # jax_enable_x64 is not promoted mid-scan (ne_active-class hazard)
    out = out.replace(efc_force_limit=(meta["jl_sign"] * jl).astype(
        d.efc_force_limit.dtype))
  from myosuite_mjx_tpu.engine.model import DSBL_CONTACT
  if contact_info is not None and not (m.opt.disableflags & DSBL_CONTACT):
    # normal force per contact: pyramid rows have unit normal coefficient,
    # so the slot's normal force is the sum of its row forces
    ncon = contact_info.dist.shape[0]
    nrows_contact = contact_blocks["J"].shape[0]
    rows_per = nrows_contact // max(ncon, 1)
    lam = force[-nrows_contact:].reshape(ncon, rows_per)   # [ncon, rows]
    cforce = lam.sum(axis=1)
    # full 3D world-frame contact force on body2 (force-sensor input,
    # mjData.cfrc_ext analogue): pyramid rows jn +- mu jf recombine to
    # f_n = sum lam, f_ti = mu_i (lam_i+ - lam_i-); only the two
    # translational friction dims carry force (rot rows carry torque)
    fr = contact_info.frame                                # [ncon, 3, 3]
    f_local = [cforce]
    for i in range(min(rows_per // 2, 2)):
      f_local.append(contact_info.friction[:, i]
                     * (lam[:, 2 * i] - lam[:, 2 * i + 1]))
    while len(f_local) < 3:
      f_local.append(jnp.zeros_like(cforce))
    fvec = jnp.stack(f_local, axis=1)                      # [ncon, 3]
    force_world = jnp.einsum("cd,cdk->ck", fvec, fr)
    out = out.replace(contact=contact_info,
                      contact_force=cforce,
                      contact_force_vec=force_world,
                      ne_active=jnp.sum(contact_info.dist < 0,
                                        dtype=jnp.int32),
                      ncon_dropped=contact_blocks["dropped"])
  return out
