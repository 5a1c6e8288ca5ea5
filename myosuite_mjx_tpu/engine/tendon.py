"""Tendon kinematics: lengths and moment arms, including wrap geometry.

This is what makes muscles muscles (SURVEY.md hard-part #2): spatial tendons
route through sites, wrap over sphere/cylinder geoms (with optional side
sites), and split over pulleys. Lengths and dense moment-arm rows
(ten_J: [ntendon, nv]) are computed branchlessly — the wrap/no-wrap decision
is a ``jnp.where`` over both branches so the whole path stays vmap-uniform.

Moment arms use the stationarity of the wrapped path: only straight segments
contribute, with wrap tangent points treated as attached to the wrap geom's
body (the same property MuJoCo's C implementation exploits).

Capability replaced: MuJoCo C spatial-tendon stage consumed by the reference
via its muscle models (e.g. tendon paths in
/root/reference/myosuite/simhive/myo_sim/finger/finger_v0.xml).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine.model import GeomType, Model, WrapType
from myosuite_mjx_tpu.engine import smooth

_EPS = 1e-12


# ---------------------------------------------------------------------------
# 2D circle wrap (shared by sphere and cylinder wraps)
# ---------------------------------------------------------------------------


def _perp(p: jax.Array) -> jax.Array:
  return jnp.stack([-p[..., 1], p[..., 0]], axis=-1)


def _tangent_point(p: jax.Array, r: jax.Array, sign: jax.Array) -> jax.Array:
  """Tangent point on circle of radius r from external 2D point p."""
  d2 = jnp.maximum(jnp.sum(p * p, axis=-1), _EPS)
  l = jnp.sqrt(jnp.maximum(d2 - r * r, _EPS))
  return (r / d2)[..., None] * (r[..., None] * p
                                + sign[..., None] * l[..., None] * _perp(p))


def _arc_angle(t0: jax.Array, t1: jax.Array, sign: jax.Array) -> jax.Array:
  """Angle travelled from t0 to t1 going counter-clockwise if sign=+1."""
  a0 = jnp.arctan2(t0[..., 1], t0[..., 0])
  a1 = jnp.arctan2(t1[..., 1], t1[..., 0])
  d = (a1 - a0) * sign
  return jnp.mod(d, 2.0 * jnp.pi)


def _candidate(p0, p1, r, sign):
  """Tangent pair + arc for travelling around the circle ccw if sign=+1.

  Departure tangent point from p0 needs (t0-p0) parallel to +sign*perp(t0)
  (continuing in the travel direction), which selects the +sign tangent root;
  the arrival point t1 symmetrically selects the -sign root.
  """
  t0 = _tangent_point(p0, r, sign)
  t1 = _tangent_point(p1, r, -sign)
  ang = _arc_angle(t0, t1, sign)
  return t0, t1, ang


def wrap_circle(p0: jax.Array, p1: jax.Array, sd: jax.Array | None,
                r: jax.Array):
  """2D circle wrap.

  Returns (wrapped, t0, t1, arclen). Both wrap directions are evaluated and
  the winner selected branchlessly: the shorter total path when there is no
  side site, else the side the side site lies on (MuJoCo sidesite semantics).
  """
  d0 = jnp.linalg.norm(p0, axis=-1)
  d1 = jnp.linalg.norm(p1, axis=-1)
  seg = p1 - p0
  a = jnp.maximum(jnp.sum(seg * seg, axis=-1), _EPS)
  t = jnp.clip(-jnp.sum(p0 * seg, axis=-1) / a, 0.0, 1.0)
  closest = p0 + t[..., None] * seg
  dmin = jnp.linalg.norm(closest, axis=-1)

  endpoints_outside = (d0 > r) & (d1 > r)
  intersects = dmin < r
  if sd is None:
    must_wrap = intersects
  else:
    # MuJoCo sidesite semantics (verified empirically vs mju_wrap): the
    # tendon must pass on the side site's side — wrap also when the straight
    # segment's closest point to the center lies on the opposite side.
    opposite = jnp.sum(closest * sd, axis=-1) < 0
    must_wrap = intersects | opposite
  wrapped = endpoints_outside & must_wrap

  one = jnp.ones_like(r)
  t0p, t1p, angp = _candidate(p0, p1, r, one)
  t0m, t1m, angm = _candidate(p0, p1, r, -one)

  if sd is None:
    # minimal detour: shorter total 2D path wins
    lenp = jnp.linalg.norm(p0 - t0p) + r * angp + jnp.linalg.norm(p1 - t1p)
    lenm = jnp.linalg.norm(p0 - t0m) + r * angm + jnp.linalg.norm(p1 - t1m)
    pick_p = lenp <= lenm
  else:
    # pass on the side site's side: compare arc midpoints against sd
    def midpt(t0, ang, sign):
      a0 = jnp.arctan2(t0[..., 1], t0[..., 0]) + sign * 0.5 * ang
      return jnp.stack([jnp.cos(a0), jnp.sin(a0)], axis=-1)
    mp = midpt(t0p, angp, 1.0)
    mm = midpt(t0m, angm, -1.0)
    sdn = sd / jnp.maximum(jnp.linalg.norm(sd, axis=-1, keepdims=True), _EPS)
    pick_p = jnp.sum(mp * sdn, axis=-1) >= jnp.sum(mm * sdn, axis=-1)

  t0 = jnp.where(pick_p, t0p, t0m)
  t1 = jnp.where(pick_p, t1p, t1m)
  arclen = r * jnp.where(pick_p, angp, angm)
  return wrapped, t0, t1, arclen


def wrap_inside_circle(p0: jax.Array, p1: jax.Array, r: jax.Array,
                       iters: int = 10):
  """Inside wrap (side site inside the geom): tendon threads the ring.

  When the straight segment misses the circle, the path catches on the near
  edge at the single point T minimizing |p0-T| + |T-p1| — no closed form, so
  Newton on the circle angle with a fixed iteration count (MuJoCo solves
  this iteratively as well; cf. the wrap_inside additions the reference
  needed from MJX, /root/reference/gotcha.md).
  Returns (wrapped, t0, t1, arclen) with t0 == t1 == T and arclen == 0.
  """
  d0 = jnp.linalg.norm(p0, axis=-1)
  d1 = jnp.linalg.norm(p1, axis=-1)
  seg = p1 - p0
  a = jnp.maximum(jnp.sum(seg * seg, axis=-1), _EPS)
  t = jnp.clip(-jnp.sum(p0 * seg, axis=-1) / a, 0.0, 1.0)
  closest = p0 + t[..., None] * seg
  dmin = jnp.linalg.norm(closest, axis=-1)
  wrapped = (dmin >= r) & (d0 > r) & (d1 > r)

  theta0 = jnp.arctan2(closest[..., 1], closest[..., 0])

  def body(_, th):
    c = r[..., None] * jnp.stack([jnp.cos(th), jnp.sin(th)], axis=-1)
    tv = r[..., None] * jnp.stack([-jnp.sin(th), jnp.cos(th)], axis=-1)
    v0 = p0 - c
    v1 = p1 - c
    n0 = jnp.maximum(jnp.linalg.norm(v0, axis=-1), _EPS)
    n1 = jnp.maximum(jnp.linalg.norm(v1, axis=-1), _EPS)
    u0 = v0 / n0[..., None]
    u1 = v1 / n1[..., None]
    grad = -jnp.sum(tv * (u0 + u1), axis=-1)

    def curv(u, n):
      tu = jnp.sum(tv * u, axis=-1)
      return (jnp.sum(tv * tv, axis=-1) - tu * tu) / n

    hess = jnp.sum(c * (u0 + u1), axis=-1) + curv(u0, n0) + curv(u1, n1)
    return th - grad / jnp.maximum(jnp.abs(hess), _EPS) * jnp.sign(
        jnp.where(hess == 0, 1.0, hess))

  theta = theta0
  for _ in range(iters):  # statically unrolled: fusible straight-line code
    theta = body(None, theta)
  T = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
  return wrapped, T, T, jnp.zeros_like(r)


# ---------------------------------------------------------------------------
# 3D wrap over sphere / cylinder geoms
# ---------------------------------------------------------------------------


def wrap_geom(x0: jax.Array, x1: jax.Array, gpos: jax.Array, gmat: jax.Array,
              radius: jax.Array, geom_type: int, side: jax.Array | None,
              inside: bool = False):
  """Wrap a straight path x0 -> x1 over a sphere or cylinder.

  Returns (wrapped, w0, w1, arclen) with w0/w1 the world-frame wrap points.
  When not wrapped, w0 = w1 = segment midpoint and arclen = 0, which keeps
  lengths and (by construction) moment arms exact in the straight case.
  """
  # into geom-local frame
  p0 = gmat.T @ (x0 - gpos)
  p1 = gmat.T @ (x1 - gpos)
  ps = gmat.T @ (side - gpos) if side is not None else None

  if geom_type == GeomType.SPHERE:
    # 2D basis in the plane through the origin containing p0, p1
    e0 = p0 / jnp.maximum(jnp.linalg.norm(p0), _EPS)
    p1_perp = p1 - jnp.dot(p1, e0) * e0
    nrm = jnp.linalg.norm(p1_perp)
    # degenerate (colinear with center): pick any orthogonal
    alt = jnp.where(jnp.abs(e0[0]) < 0.9,
                    jnp.array([1.0, 0.0, 0.0], p0.dtype),
                    jnp.array([0.0, 1.0, 0.0], p0.dtype))
    alt_perp = alt - jnp.dot(alt, e0) * e0
    e1 = jnp.where(nrm > 1e-9, p1_perp / jnp.maximum(nrm, _EPS),
                   alt_perp / jnp.maximum(jnp.linalg.norm(alt_perp), _EPS))
    q0 = jnp.stack([jnp.dot(p0, e0), jnp.dot(p0, e1)])
    q1 = jnp.stack([jnp.dot(p1, e0), jnp.dot(p1, e1)])
    qs = (jnp.stack([jnp.dot(ps, e0), jnp.dot(ps, e1)])
          if ps is not None else None)
    if inside:
      wrapped, t0, t1, arclen = wrap_inside_circle(q0, q1, radius)
    else:
      wrapped, t0, t1, arclen = wrap_circle(q0, q1, qs, radius)
    w0_local = t0[0] * e0 + t0[1] * e1
    w1_local = t1[0] * e0 + t1[1] * e1
  elif geom_type == GeomType.CYLINDER:
    # project on the xy-plane (local z = cylinder axis)
    q0, q1 = p0[:2], p1[:2]
    qs = ps[:2] if ps is not None else None
    if inside:
      wrapped, t0, t1, arc2d = wrap_inside_circle(q0, q1, radius)
    else:
      wrapped, t0, t1, arc2d = wrap_circle(q0, q1, qs, radius)
    # distribute the z travel along the 2D path length (helical wrap)
    l0 = jnp.linalg.norm(t0 - q0)
    l1 = jnp.linalg.norm(q1 - t1)
    total2d = jnp.maximum(l0 + arc2d + l1, _EPS)
    dz = p1[2] - p0[2]
    z0 = p0[2] + dz * l0 / total2d
    z1 = p0[2] + dz * (l0 + arc2d) / total2d
    w0_local = jnp.concatenate([t0, z0[None]])
    w1_local = jnp.concatenate([t1, z1[None]])
    arclen = jnp.sqrt(arc2d * arc2d + (z1 - z0) * (z1 - z0))
  else:
    raise NotImplementedError(f"wrap geom type {geom_type}")

  w0 = gpos + gmat @ w0_local
  w1 = gpos + gmat @ w1_local
  mid = 0.5 * (x0 + x1)
  w0 = jnp.where(wrapped, w0, mid)
  w1 = jnp.where(wrapped, w1, mid)
  arclen = jnp.where(wrapped, arclen, 0.0)
  return wrapped, w0, w1, arclen


# ---------------------------------------------------------------------------
# tendon path compilation (static, host-side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _WrapTriple:
  site0: int
  geom: int
  sideid: int   # -1 if none
  site1: int
  divisor: float
  inside: bool = False


def _side_inside_geom(m: Model, geomid: int, sideid: int) -> bool:
  """Static inside-wrap detection: side site inside the wrap geom.

  Requires site and geom on the same body (true for every Myo model); a
  moving side site crossing the surface at runtime is not supported.
  """
  if sideid < 0:
    return False
  if int(m.site_bodyid[sideid]) != int(m.geom_bodyid[geomid]):
    return False
  # pure numpy (host-side static structure; must not stage under jit)
  w, x, y, z = np.asarray(m.geom_quat[geomid])
  rot = np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])
  rel = rot.T @ np.asarray(m.site_pos[sideid] - m.geom_pos[geomid])
  r = float(m.geom_size[geomid, 0])
  if int(m.geom_type[geomid]) == 5:  # cylinder: full 3D containment
    half = float(m.geom_size[geomid, 1])
    return bool(np.linalg.norm(rel[:2]) < r and abs(rel[2]) < half)
  return bool(np.linalg.norm(rel) < r)


@dataclasses.dataclass(frozen=True)
class _Straight:
  site0: int
  site1: int
  divisor: float


def _compile_spatial(m: Model, t: int) -> list:
  """Turn a tendon's wrap array slice into straight/wrap elements."""
  adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
  elems = []
  divisor = 1.0
  i = adr
  end = adr + num
  prev_site = None
  while i < end:
    wt = int(m.wrap_type[i])
    if wt == WrapType.PULLEY:
      divisor = float(m.wrap_prm[i])
      prev_site = None
      i += 1
      continue
    if wt == WrapType.SITE:
      sid = int(m.wrap_objid[i])
      if prev_site is not None:
        elems.append(_Straight(prev_site, sid, divisor))
      prev_site = sid
      i += 1
      continue
    if wt in (WrapType.SPHERE, WrapType.CYLINDER):
      assert prev_site is not None and i + 1 < end, "wrap geom needs sites"
      assert int(m.wrap_type[i + 1]) == WrapType.SITE
      nxt = int(m.wrap_objid[i + 1])
      sideid = int(round(float(m.wrap_prm[i])))
      gid = int(m.wrap_objid[i])
      elems.append(_WrapTriple(prev_site, gid, sideid, nxt, divisor,
                               _side_inside_geom(m, gid, sideid)))
      prev_site = nxt
      i += 2
      continue
    raise NotImplementedError(f"wrap type {wt} in spatial tendon")
  return elems


@dataclasses.dataclass(frozen=True)
class _TendonSpec:
  """Static vectorized tendon layout: index arrays grouped for batched ops."""
  straight_s0: np.ndarray     # [S] site ids
  straight_s1: np.ndarray
  straight_div: np.ndarray    # [S] float
  straight_tidx: np.ndarray   # [S] tendon index
  # wrap groups keyed by (geom_type, inside, has_side): each a dict of
  # numpy arrays site0/geom/side/site1/div/tidx
  wrap_groups: tuple


def _tendon_spec(m: Model) -> _TendonSpec:
  from myosuite_mjx_tpu.engine.model import derived_cache
  return derived_cache(m, "tendon_spec", _build_tendon_spec)


def _build_tendon_spec(m: Model) -> _TendonSpec:
  s0, s1, sdiv, stidx = [], [], [], []
  groups: dict[tuple, dict[str, list]] = {}
  for t in range(m.ntendon):
    if int(m.wrap_type[int(m.tendon_adr[t])]) == WrapType.JOINT:
      continue
    for e in _compile_spatial(m, t):
      if isinstance(e, _Straight):
        s0.append(e.site0)
        s1.append(e.site1)
        sdiv.append(e.divisor)
        stidx.append(t)
      else:
        gt = int(m.geom_type[e.geom])
        gkey = (gt, e.inside, e.sideid >= 0)
        g = groups.setdefault(gkey, dict(
            site0=[], geom=[], side=[], site1=[], div=[], tidx=[]))
        g["site0"].append(e.site0)
        g["geom"].append(e.geom)
        g["side"].append(max(e.sideid, 0))
        g["site1"].append(e.site1)
        g["div"].append(e.divisor)
        g["tidx"].append(t)
  wrap_groups = tuple(
      (k, {n: np.asarray(v) for n, v in g.items()})
      for k, g in sorted(groups.items()))
  spec = _TendonSpec(
      straight_s0=np.asarray(s0, np.int32),
      straight_s1=np.asarray(s1, np.int32),
      straight_div=np.asarray(sdiv),
      straight_tidx=np.asarray(stidx, np.int32),
      wrap_groups=wrap_groups)
  return spec


def tendon(m: Model, kin: dict, cdof: jax.Array):
  """ten_length [ntendon] and dense ten_J [ntendon, nv], fully vectorized.

  All straight segments across all tendons are one fused computation; wrap
  elements are vmapped per (geom-type, inside, sidesite) group; length and
  moment-arm contributions land via static scatter-adds.
  """
  dtype = cdof.dtype
  if m.ntendon == 0:
    return jnp.zeros((0,), dtype), jnp.zeros((0, m.nv), dtype)

  site_xpos = kin["site_xpos"]
  geom_xpos = kin["geom_xpos"]
  geom_xmat = kin["geom_xmat"]
  spec = _tendon_spec(m)

  # collect directed segments: (p_start, b_start, p_end, b_end, div, tidx)
  p_start, b_start, p_end, b_end, divs, tidxs = [], [], [], [], [], []

  if len(spec.straight_s0):
    p_start.append(site_xpos[spec.straight_s0])
    b_start.append(m.site_bodyid[spec.straight_s0])
    p_end.append(site_xpos[spec.straight_s1])
    b_end.append(m.site_bodyid[spec.straight_s1])
    divs.append(spec.straight_div)
    tidxs.append(spec.straight_tidx)

  ten_length = jnp.zeros((m.ntendon,), dtype)

  for (gt, inside, has_side), g in spec.wrap_groups:
    x0 = site_xpos[g["site0"]]
    x1 = site_xpos[g["site1"]]
    gp = geom_xpos[g["geom"]]
    gmt = geom_xmat[g["geom"]]
    radius = jnp.asarray(m.geom_size[g["geom"], 0], dtype)
    side = site_xpos[g["side"]] if has_side else None
    fn = lambda a0, a1, q, qm, r, sd: wrap_geom(
        a0, a1, q, qm, r, gt, sd, inside=inside)
    if has_side:
      _, w0, w1, arclen = jax.vmap(fn)(x0, x1, gp, gmt, radius, side)
    else:
      _, w0, w1, arclen = jax.vmap(
          lambda a0, a1, q, qm, r: fn(a0, a1, q, qm, r, None))(
              x0, x1, gp, gmt, radius)
    ten_length = ten_length.at[g["tidx"]].add(
        (arclen / g["div"]).astype(dtype))
    gb = m.geom_bodyid[g["geom"]]
    sb0 = m.site_bodyid[g["site0"]]
    sb1 = m.site_bodyid[g["site1"]]
    p_start += [x0, w1]
    b_start += [sb0, gb]
    p_end += [w0, x1]
    b_end += [gb, sb1]
    divs += [g["div"], g["div"]]
    tidxs += [g["tidx"], g["tidx"]]

  if p_start:
    ps = jnp.concatenate(p_start)
    pe = jnp.concatenate(p_end)
    bs = np.concatenate(b_start)
    be = np.concatenate(b_end)
    div_np = np.concatenate([np.asarray(v, np.float64) for v in divs])
    tidx = np.concatenate(tidxs)
    S = len(tidx)

    d = pe - ps
    ln = jnp.linalg.norm(d, axis=-1)
    u = d / jnp.maximum(ln, _EPS)[:, None]
    # segment -> tendon accumulation as a static selection matmul instead
    # of a scatter-add (scatters serialize, a [ntendon, S] dense dot is
    # one matmul). sel folds 1/div; the signed variant folds the
    # end-minus-start difference so BOTH jacobian endpoint contributions
    # come from ONE fused point_jac_dir call over the 2S stacked points.
    sel = np.zeros((m.ntendon, S))
    sel[tidx, np.arange(S)] = 1.0 / div_np
    ten_length = ten_length + jnp.asarray(sel, dtype) @ ln

    p2 = jnp.concatenate([pe, ps])
    b2 = np.concatenate([be, bs])
    u2 = jnp.concatenate([u, u])
    rows = smooth.point_jac_dir(m, cdof, p2, b2, u2)       # [2S, nv]
    sel2 = np.concatenate([sel, -sel], axis=1)             # [ntendon, 2S]
    ten_J = jnp.asarray(sel2, dtype) @ rows
  else:
    ten_J = jnp.zeros((m.ntendon, m.nv), dtype)

  # fixed (joint-coefficient) tendon moment rows
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    if int(m.wrap_type[adr]) != WrapType.JOINT:
      continue
    for i in range(adr, adr + num):
      dofadr = int(m.jnt_dofadr[int(m.wrap_objid[i])])
      ten_J = ten_J.at[t, dofadr].add(float(m.wrap_prm[i]))

  return ten_length, ten_J


def fixed_tendon_length(m: Model, qpos: jax.Array) -> jax.Array:
  """Additive length for fixed (joint-coef) tendons; zero for spatial."""
  out = jnp.zeros((m.ntendon,), qpos.dtype)
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    if int(m.wrap_type[adr]) != WrapType.JOINT:
      continue
    L = jnp.zeros((), qpos.dtype)
    for i in range(adr, adr + num):
      j = int(m.wrap_objid[i])
      L = L + float(m.wrap_prm[i]) * qpos[int(m.jnt_qposadr[j])]
    out = out.at[t].set(L)
  return out
