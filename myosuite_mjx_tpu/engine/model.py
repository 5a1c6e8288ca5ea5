"""Device-side physics model: MJCF -> immutable host Model.

The MJCF compiler is host-side tooling: we compile XML with the CPU ``mujoco``
package (exactly as the reference does before shipping models to XLA,
/root/reference/myosuite/mjx/play.py:8-11) and then lift the compiled constants
into our own flat representation. Everything downstream — forward dynamics,
muscle-tendon actuation, contacts — is implemented in this repo in pure JAX.
``mujoco`` is imported only by the functions that compile MJCF: a Model
saved with ``save_model`` loads from its ``.npz`` with numpy alone.

``Model`` is a plain frozen dataclass of host numpy arrays. Jitted step
functions close over it, so model constants fold into the XLA program (zero
per-step transfer, maximal constant propagation). Fields that need domain
randomization are exposed separately via an overlay pytree (see
engine/randomize.py).
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any

import numpy as np


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class WrapType(enum.IntEnum):
  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class SensorType(enum.IntEnum):
  """MuJoCo sensor enum values we recognize (subset; others pass through)."""
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  JOINTPOS = 8
  JOINTVEL = 9
  TENDONPOS = 10
  TENDONVEL = 11
  ACTUATORPOS = 12
  ACTUATORVEL = 13
  ACTUATORFRC = 14


# mjtDisableBit values (bitmask in opt.disableflags)
DSBL_CONSTRAINT = 1 << 0
DSBL_EQUALITY = 1 << 1
DSBL_FRICTIONLOSS = 1 << 2
DSBL_LIMIT = 1 << 3
DSBL_CONTACT = 1 << 4
DSBL_PASSIVE = 1 << 5
DSBL_GRAVITY = 1 << 6
DSBL_CLAMPCTRL = 1 << 7
DSBL_ACTUATION = 1 << 10


@dataclasses.dataclass(frozen=True)
class Option:
  """Simulation options (mirrors the mjOption fields our pipeline consumes)."""
  timestep: float
  gravity: np.ndarray
  integrator: int
  cone: int
  solver_iterations: int
  ls_iterations: int
  tolerance: float
  ls_tolerance: float
  impratio: float
  disableflags: int
  density: float
  viscosity: float
  meaninertia: float = 1.0   # mjStatistic.meaninertia (solver cost scaling)


@dataclasses.dataclass(frozen=True)
class Model:
  """Flat immutable physics model (host numpy; closed over by jitted fns)."""
  # sizes
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  ntendon: int
  nwrap: int
  neq: int
  nsensor: int
  nsensordata: int
  nmocap: int

  opt: Option

  # bodies
  body_parentid: np.ndarray      # (nbody,) int
  body_rootid: np.ndarray        # (nbody,) int
  body_weldid: np.ndarray        # (nbody,) int
  body_jntadr: np.ndarray        # (nbody,) int
  body_jntnum: np.ndarray        # (nbody,) int
  body_dofadr: np.ndarray        # (nbody,) int
  body_dofnum: np.ndarray        # (nbody,) int
  body_pos: np.ndarray           # (nbody, 3)
  body_quat: np.ndarray          # (nbody, 4)
  body_ipos: np.ndarray          # (nbody, 3)
  body_iquat: np.ndarray         # (nbody, 4)
  body_mass: np.ndarray          # (nbody,)
  body_inertia: np.ndarray       # (nbody, 3)
  body_mocapid: np.ndarray       # (nbody,) int, -1 if not mocap
  body_subtreemass: np.ndarray   # (nbody,)

  # joints
  jnt_type: np.ndarray           # (njnt,) int
  jnt_qposadr: np.ndarray        # (njnt,) int
  jnt_dofadr: np.ndarray         # (njnt,) int
  jnt_bodyid: np.ndarray         # (njnt,) int
  jnt_limited: np.ndarray        # (njnt,) bool
  jnt_axis: np.ndarray           # (njnt, 3)
  jnt_pos: np.ndarray            # (njnt, 3)
  jnt_range: np.ndarray          # (njnt, 2)
  jnt_stiffness: np.ndarray      # (njnt,)
  jnt_margin: np.ndarray         # (njnt,)
  jnt_solref: np.ndarray         # (njnt, 2)
  jnt_solimp: np.ndarray         # (njnt, 5)

  # dofs
  dof_bodyid: np.ndarray         # (nv,) int
  dof_jntid: np.ndarray          # (nv,) int
  dof_parentid: np.ndarray       # (nv,) int (-1 for root)
  dof_armature: np.ndarray       # (nv,)
  dof_damping: np.ndarray        # (nv,)
  dof_frictionloss: np.ndarray   # (nv,)
  dof_solref: np.ndarray         # (nv, 2)
  dof_solimp: np.ndarray         # (nv, 5)

  # geoms
  geom_type: np.ndarray          # (ngeom,) int
  geom_bodyid: np.ndarray        # (ngeom,) int
  geom_pos: np.ndarray           # (ngeom, 3)
  geom_quat: np.ndarray          # (ngeom, 4)
  geom_size: np.ndarray          # (ngeom, 3)
  geom_friction: np.ndarray      # (ngeom, 3)
  geom_contype: np.ndarray       # (ngeom,) int
  geom_conaffinity: np.ndarray   # (ngeom,) int
  geom_condim: np.ndarray        # (ngeom,) int
  geom_priority: np.ndarray      # (ngeom,) int
  geom_solmix: np.ndarray        # (ngeom,)
  geom_solref: np.ndarray        # (ngeom, 2)
  geom_solimp: np.ndarray        # (ngeom, 5)
  geom_margin: np.ndarray        # (ngeom,)
  geom_gap: np.ndarray           # (ngeom,)
  geom_rbound: np.ndarray        # (ngeom,)

  # sites
  site_bodyid: np.ndarray        # (nsite,) int
  site_pos: np.ndarray           # (nsite, 3)
  site_quat: np.ndarray          # (nsite, 4)

  # tendons
  tendon_adr: np.ndarray         # (ntendon,) int
  tendon_num: np.ndarray         # (ntendon,) int
  tendon_limited: np.ndarray     # (ntendon,) bool
  tendon_range: np.ndarray       # (ntendon, 2)
  tendon_margin: np.ndarray      # (ntendon,)
  tendon_stiffness: np.ndarray   # (ntendon,)
  tendon_damping: np.ndarray     # (ntendon,)
  tendon_frictionloss: np.ndarray  # (ntendon,)
  tendon_lengthspring: np.ndarray  # (ntendon, 2)
  tendon_length0: np.ndarray     # (ntendon,)
  tendon_solref_lim: np.ndarray  # (ntendon, 2)
  tendon_solimp_lim: np.ndarray  # (ntendon, 5)
  wrap_type: np.ndarray          # (nwrap,) int
  wrap_objid: np.ndarray         # (nwrap,) int
  wrap_prm: np.ndarray           # (nwrap,)

  # actuators
  actuator_trntype: np.ndarray   # (nu,) int
  actuator_dyntype: np.ndarray   # (nu,) int
  actuator_gaintype: np.ndarray  # (nu,) int
  actuator_biastype: np.ndarray  # (nu,) int
  actuator_trnid: np.ndarray     # (nu, 2) int
  actuator_actadr: np.ndarray    # (nu,) int (-1 if stateless)
  actuator_actnum: np.ndarray    # (nu,) int
  actuator_ctrllimited: np.ndarray  # (nu,) bool
  actuator_forcelimited: np.ndarray  # (nu,) bool
  actuator_actlimited: np.ndarray    # (nu,) bool
  actuator_ctrlrange: np.ndarray  # (nu, 2)
  actuator_forcerange: np.ndarray  # (nu, 2)
  actuator_actrange: np.ndarray  # (nu, 2)
  actuator_dynprm: np.ndarray    # (nu, 10)
  actuator_gainprm: np.ndarray   # (nu, 10)
  actuator_biasprm: np.ndarray   # (nu, 10)
  actuator_gear: np.ndarray      # (nu, 6)
  actuator_lengthrange: np.ndarray  # (nu, 2)
  actuator_acc0: np.ndarray      # (nu,)

  # equality constraints
  eq_type: np.ndarray            # (neq,) int
  eq_obj1id: np.ndarray          # (neq,) int
  eq_obj2id: np.ndarray          # (neq,) int
  eq_active0: np.ndarray         # (neq,) bool
  eq_solref: np.ndarray          # (neq, 2)
  eq_solimp: np.ndarray          # (neq, 5)
  eq_data: np.ndarray            # (neq, 11)

  # sensors
  sensor_type: np.ndarray        # (nsensor,) int
  sensor_objid: np.ndarray       # (nsensor,) int
  sensor_adr: np.ndarray         # (nsensor,) int
  sensor_dim: np.ndarray         # (nsensor,) int

  # constraint regularization weights (precomputed by the compiler at qpos0)
  dof_invweight0: np.ndarray     # (nv,)
  body_invweight0: np.ndarray    # (nbody, 2) [translation, rotation]
  tendon_invweight0: np.ndarray  # (ntendon,)

  # explicit contact pairs / excludes
  npair: int
  nexclude: int
  pair_dim: np.ndarray           # (npair,) int
  pair_geom1: np.ndarray         # (npair,) int
  pair_geom2: np.ndarray         # (npair,) int
  pair_solref: np.ndarray        # (npair, 2)
  pair_solreffriction: np.ndarray  # (npair, 2)
  pair_solimp: np.ndarray        # (npair, 5)
  pair_margin: np.ndarray        # (npair,)
  pair_gap: np.ndarray           # (npair,)
  pair_friction: np.ndarray      # (npair, 5)
  exclude_signature: np.ndarray  # (nexclude,) int (body1<<16 | body2)

  # defaults / references
  qpos0: np.ndarray              # (nq,)
  qpos_spring: np.ndarray        # (nq,)
  key_qpos: np.ndarray           # (nkey, nq)
  key_qvel: np.ndarray           # (nkey, nv)
  key_ctrl: np.ndarray           # (nkey, nu)

  # meshes (collision hulls precomputed at convert time)
  geom_dataid: np.ndarray        # (ngeom,) int mesh id or -1
  mesh_hull_tris: dict           # mesh id -> (F, 3, 3) hull triangles
  mesh_hull_verts: dict          # mesh id -> (V, 3) hull vertices

  # heightfields
  nhfield: int
  hfield_size: np.ndarray        # (nhfield, 4) x, y, z_top, z_bottom
  hfield_nrow: np.ndarray        # (nhfield,) int
  hfield_ncol: np.ndarray        # (nhfield,) int
  hfield_data: np.ndarray        # (sum nrow*ncol,) normalized heights
  hfield_adr: np.ndarray         # (nhfield,) int

  # name maps (host-only metadata)
  names: dict[str, dict[str, int]]

  # ---- convenience lookups (host-side, mirror *_name2id) ----

  def name2id(self, kind: str, name: str) -> int:
    """Lookup like the reference's monkey-patched ``*_name2id`` accessors
    (/root/reference/myosuite/physics/mj_sim_scene.py:110-171)."""
    try:
      return self.names[kind][name]
    except KeyError:
      raise KeyError(f"no {kind} named {name!r}") from None

  def id2name(self, kind: str, idx: int) -> str:
    for name, i in self.names[kind].items():
      if i == idx:
        return name
    raise KeyError(f"no {kind} with id {idx}")


def derived_cache(m, name: str, builder):
  """Per-Model derived-data cache whose lifetime is tied to the instance.

  Stored on the Model object itself (frozen dataclass, so via
  ``object.__setattr__``) instead of an ``id(m)``-keyed module dict: a
  garbage-collected Model's id can be reused by a new Model with a
  different topology, which would silently serve a stale layout.
  ``dataclasses.replace``'d copies carry no cache and recompute.
  """
  key = "_derived_" + name
  d = m.__dict__
  if key not in d:
    object.__setattr__(m, key, builder(m))
  return d[key]


def _mesh_hulls(mj: "mujoco.MjModel", dtype) -> tuple[dict, dict]:
  """Convex hull triangles + vertices for every mesh used by a collidable
  geom. MuJoCo itself collides the convex hull of a mesh; we precompute the
  hull with scipy at convert time (host-side)."""
  import mujoco
  tris: dict[int, np.ndarray] = {}
  verts: dict[int, np.ndarray] = {}
  needed = set()
  for g in range(mj.ngeom):
    if (int(mj.geom_type[g]) == int(mujoco.mjtGeom.mjGEOM_MESH)
        and (mj.geom_contype[g] or mj.geom_conaffinity[g])):
      needed.add(int(mj.geom_dataid[g]))
  # explicit <pair> entries collide regardless of contype/conaffinity
  for p in range(mj.npair):
    for g in (int(mj.pair_geom1[p]), int(mj.pair_geom2[p])):
      if int(mj.geom_type[g]) == int(mujoco.mjtGeom.mjGEOM_MESH):
        needed.add(int(mj.geom_dataid[g]))
  if needed:
    from scipy.spatial import ConvexHull
    for mid in needed:
      va, vn = int(mj.mesh_vertadr[mid]), int(mj.mesh_vertnum[mid])
      v = np.asarray(mj.mesh_vert[va:va + vn], dtype=dtype)
      try:
        hull = ConvexHull(v)
        hv = v[hull.vertices]
        tris[mid] = v[hull.simplices]      # (F, 3, 3)
      except Exception:
        hv = v
        tris[mid] = np.zeros((0, 3, 3), dtype)
      verts[mid] = hv
  return tris, verts


def _name_map(mj: "mujoco.MjModel") -> dict[str, dict[str, int]]:
  import mujoco
  kinds = {
      "body": mujoco.mjtObj.mjOBJ_BODY,
      "joint": mujoco.mjtObj.mjOBJ_JOINT,
      "geom": mujoco.mjtObj.mjOBJ_GEOM,
      "site": mujoco.mjtObj.mjOBJ_SITE,
      "tendon": mujoco.mjtObj.mjOBJ_TENDON,
      "actuator": mujoco.mjtObj.mjOBJ_ACTUATOR,
      "sensor": mujoco.mjtObj.mjOBJ_SENSOR,
      "camera": mujoco.mjtObj.mjOBJ_CAMERA,
      "equality": mujoco.mjtObj.mjOBJ_EQUALITY,
  }
  counts = {
      "body": mj.nbody, "joint": mj.njnt, "geom": mj.ngeom,
      "site": mj.nsite, "tendon": mj.ntendon, "actuator": mj.nu,
      "sensor": mj.nsensor, "camera": mj.ncam, "equality": mj.neq,
  }
  out: dict[str, dict[str, int]] = {}
  for kind, objtype in kinds.items():
    table = {}
    for i in range(counts[kind]):
      name = mujoco.mj_id2name(mj, objtype, i)
      if name:
        table[name] = i
    out[kind] = table
  return out


def from_mj(mj: "mujoco.MjModel", dtype=np.float64) -> Model:
  """Convert a compiled MjModel into our flat Model (host numpy)."""
  f = lambda a: np.asarray(a, dtype=dtype).copy()
  i = lambda a: np.asarray(a, dtype=np.int32).copy()
  b = lambda a: np.asarray(a, dtype=bool).copy()
  hull_tris, hull_verts = _mesh_hulls(mj, dtype)

  opt = Option(
      timestep=float(mj.opt.timestep),
      gravity=f(mj.opt.gravity),
      integrator=int(mj.opt.integrator),
      cone=int(mj.opt.cone),
      solver_iterations=int(mj.opt.iterations),
      ls_iterations=int(mj.opt.ls_iterations),
      tolerance=float(mj.opt.tolerance),
      ls_tolerance=float(mj.opt.ls_tolerance),
      impratio=float(mj.opt.impratio),
      disableflags=int(mj.opt.disableflags),
      density=float(mj.opt.density),
      viscosity=float(mj.opt.viscosity),
      meaninertia=float(mj.stat.meaninertia),
  )

  return Model(
      nq=mj.nq, nv=mj.nv, nu=mj.nu, na=mj.na, nbody=mj.nbody, njnt=mj.njnt,
      ngeom=mj.ngeom, nsite=mj.nsite, ntendon=mj.ntendon, nwrap=mj.nwrap,
      neq=mj.neq, nsensor=mj.nsensor, nsensordata=mj.nsensordata,
      nmocap=mj.nmocap,
      opt=opt,
      body_parentid=i(mj.body_parentid),
      body_rootid=i(mj.body_rootid),
      body_weldid=i(mj.body_weldid),
      body_jntadr=i(mj.body_jntadr),
      body_jntnum=i(mj.body_jntnum),
      body_dofadr=i(mj.body_dofadr),
      body_dofnum=i(mj.body_dofnum),
      body_pos=f(mj.body_pos),
      body_quat=f(mj.body_quat),
      body_ipos=f(mj.body_ipos),
      body_iquat=f(mj.body_iquat),
      body_mass=f(mj.body_mass),
      body_inertia=f(mj.body_inertia),
      body_mocapid=i(mj.body_mocapid),
      body_subtreemass=f(mj.body_subtreemass),
      jnt_type=i(mj.jnt_type),
      jnt_qposadr=i(mj.jnt_qposadr),
      jnt_dofadr=i(mj.jnt_dofadr),
      jnt_bodyid=i(mj.jnt_bodyid),
      jnt_limited=b(mj.jnt_limited),
      jnt_axis=f(mj.jnt_axis),
      jnt_pos=f(mj.jnt_pos),
      jnt_range=f(mj.jnt_range),
      jnt_stiffness=f(mj.jnt_stiffness),
      jnt_margin=f(mj.jnt_margin),
      jnt_solref=f(mj.jnt_solref),
      jnt_solimp=f(mj.jnt_solimp),
      dof_bodyid=i(mj.dof_bodyid),
      dof_jntid=i(mj.dof_jntid),
      dof_parentid=i(mj.dof_parentid),
      dof_armature=f(mj.dof_armature),
      dof_damping=f(mj.dof_damping),
      dof_frictionloss=f(mj.dof_frictionloss),
      dof_solref=f(mj.dof_solref),
      dof_solimp=f(mj.dof_solimp),
      geom_type=i(mj.geom_type),
      geom_bodyid=i(mj.geom_bodyid),
      geom_pos=f(mj.geom_pos),
      geom_quat=f(mj.geom_quat),
      geom_size=f(mj.geom_size),
      geom_friction=f(mj.geom_friction),
      geom_contype=i(mj.geom_contype),
      geom_conaffinity=i(mj.geom_conaffinity),
      geom_condim=i(mj.geom_condim),
      geom_priority=i(mj.geom_priority),
      geom_solmix=f(mj.geom_solmix),
      geom_solref=f(mj.geom_solref),
      geom_solimp=f(mj.geom_solimp),
      geom_margin=f(mj.geom_margin),
      geom_gap=f(mj.geom_gap),
      geom_rbound=f(mj.geom_rbound),
      site_bodyid=i(mj.site_bodyid),
      site_pos=f(mj.site_pos),
      site_quat=f(mj.site_quat),
      tendon_adr=i(mj.tendon_adr),
      tendon_num=i(mj.tendon_num),
      tendon_limited=b(mj.tendon_limited),
      tendon_range=f(mj.tendon_range),
      tendon_margin=f(mj.tendon_margin),
      tendon_stiffness=f(mj.tendon_stiffness),
      tendon_damping=f(mj.tendon_damping),
      tendon_frictionloss=f(mj.tendon_frictionloss),
      tendon_lengthspring=f(mj.tendon_lengthspring),
      tendon_length0=f(mj.tendon_length0),
      tendon_solref_lim=f(mj.tendon_solref_lim),
      tendon_solimp_lim=f(mj.tendon_solimp_lim),
      wrap_type=i(mj.wrap_type),
      wrap_objid=i(mj.wrap_objid),
      wrap_prm=f(mj.wrap_prm),
      actuator_trntype=i(mj.actuator_trntype),
      actuator_dyntype=i(mj.actuator_dyntype),
      actuator_gaintype=i(mj.actuator_gaintype),
      actuator_biastype=i(mj.actuator_biastype),
      actuator_trnid=i(mj.actuator_trnid),
      actuator_actadr=i(mj.actuator_actadr),
      actuator_actnum=i(mj.actuator_actnum),
      actuator_ctrllimited=b(mj.actuator_ctrllimited),
      actuator_forcelimited=b(mj.actuator_forcelimited),
      actuator_actlimited=b(mj.actuator_actlimited),
      actuator_ctrlrange=f(mj.actuator_ctrlrange),
      actuator_forcerange=f(mj.actuator_forcerange),
      actuator_actrange=f(mj.actuator_actrange),
      actuator_dynprm=f(mj.actuator_dynprm),
      actuator_gainprm=f(mj.actuator_gainprm),
      actuator_biasprm=f(mj.actuator_biasprm),
      actuator_gear=f(mj.actuator_gear),
      actuator_lengthrange=f(mj.actuator_lengthrange),
      actuator_acc0=f(mj.actuator_acc0),
      eq_type=i(mj.eq_type),
      eq_obj1id=i(mj.eq_obj1id),
      eq_obj2id=i(mj.eq_obj2id),
      eq_active0=b(mj.eq_active0),
      eq_solref=f(mj.eq_solref),
      eq_solimp=f(mj.eq_solimp),
      eq_data=f(mj.eq_data),
      dof_invweight0=f(mj.dof_invweight0),
      body_invweight0=f(mj.body_invweight0),
      tendon_invweight0=f(mj.tendon_invweight0),
      npair=mj.npair,
      nexclude=mj.nexclude,
      pair_dim=i(mj.pair_dim),
      pair_geom1=i(mj.pair_geom1),
      pair_geom2=i(mj.pair_geom2),
      pair_solref=f(mj.pair_solref),
      pair_solreffriction=f(mj.pair_solreffriction),
      pair_solimp=f(mj.pair_solimp),
      pair_margin=f(mj.pair_margin),
      pair_gap=f(mj.pair_gap),
      pair_friction=f(mj.pair_friction),
      exclude_signature=i(mj.exclude_signature),
      sensor_type=i(mj.sensor_type),
      sensor_objid=i(mj.sensor_objid),
      sensor_adr=i(mj.sensor_adr),
      sensor_dim=i(mj.sensor_dim),
      geom_dataid=i(mj.geom_dataid),
      nhfield=mj.nhfield,
      hfield_size=f(mj.hfield_size),
      hfield_nrow=i(mj.hfield_nrow),
      hfield_ncol=i(mj.hfield_ncol),
      hfield_data=f(mj.hfield_data),
      hfield_adr=i(mj.hfield_adr),
      mesh_hull_tris=hull_tris,
      mesh_hull_verts=hull_verts,
      qpos0=f(mj.qpos0),
      qpos_spring=f(mj.qpos_spring),
      key_qpos=f(mj.key_qpos) if mj.nkey else np.zeros((0, mj.nq), dtype),
      key_qvel=f(mj.key_qvel) if mj.nkey else np.zeros((0, mj.nv), dtype),
      key_ctrl=f(mj.key_ctrl) if mj.nkey else np.zeros((0, mj.nu), dtype),
      names=_name_map(mj),
  )


_model_cache: dict[tuple, Model] = {}

_HEADER = "__header__"


def save_model(m: Model, path: str) -> None:
  """Write ``m`` as one ``.npz``: every array field under its name, mesh
  hulls as ``<field>/<mesh id>``, and the sizes, ``opt`` and ``names`` as
  a JSON header. ``load_model(path)`` reads it back without ``mujoco``."""
  arrays, header = {}, {}
  for f in dataclasses.fields(m):
    v = getattr(m, f.name)
    if isinstance(v, np.ndarray):
      arrays[f.name] = v
    elif f.name in ("mesh_hull_tris", "mesh_hull_verts"):
      header[f.name] = sorted(int(k) for k in v)
      arrays.update({f"{f.name}/{k}": a for k, a in v.items()})
    elif isinstance(v, Option):
      header[f.name] = {k: (x.tolist() if isinstance(x, np.ndarray) else x)
                        for k, x in dataclasses.asdict(v).items()}
    else:
      header[f.name] = v
  arrays[_HEADER] = np.asarray(json.dumps(header))
  np.savez_compressed(path, **arrays)


def _load_npz(path: str, dtype) -> Model:
  def cast(a):
    return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

  with np.load(path, allow_pickle=False) as z:
    header = json.loads(str(z[_HEADER]))
    kw = {}
    for f in dataclasses.fields(Model):
      if f.name == "opt":
        o = dict(header["opt"])
        o["gravity"] = np.asarray(o["gravity"], dtype)
        kw["opt"] = Option(**o)
      elif f.name in ("mesh_hull_tris", "mesh_hull_verts"):
        kw[f.name] = {k: cast(z[f"{f.name}/{k}"]) for k in header[f.name]}
      elif f.name in header:
        kw[f.name] = header[f.name]
      else:
        kw[f.name] = cast(z[f.name])
  return Model(**kw)


def load_model(path_or_xml: str, dtype=np.float64,
               assets: dict[str, Any] | None = None) -> Model:
  """Load a Model from a ``save_model`` ``.npz``, or compile an MJCF file
  or XML string and convert it.

  Results are cached per (source, dtype): Model is an immutable frozen
  dataclass of host numpy constants, so sharing across env instances is
  safe and makes constructing the ~190 MyoDM variants (49 distinct scene
  XMLs) cheap.
  """
  if assets:
    import hashlib
    h = hashlib.sha256()
    for name in sorted(assets):
      v = assets[name]
      h.update(name.encode())
      h.update(v if isinstance(v, bytes) else str(v).encode())
    akey = h.hexdigest()
  else:
    akey = None
  key = (path_or_xml, np.dtype(dtype).name, akey)
  if key not in _model_cache:
    if path_or_xml.endswith(".npz"):
      _model_cache[key] = _load_npz(path_or_xml, dtype)
    else:
      mj = load_mj_model(path_or_xml, assets)
      _model_cache[key] = from_mj(mj, dtype=dtype)
  return _model_cache[key]


def load_mj_model(path_or_xml: str,
                  assets: dict[str, Any] | None = None) -> "mujoco.MjModel":
  """Compile MJCF with the host MuJoCo compiler (also the parity oracle)."""
  import mujoco
  if os.path.exists(path_or_xml):
    return mujoco.MjModel.from_xml_path(path_or_xml)
  return mujoco.MjModel.from_xml_string(path_or_xml, assets or {})
