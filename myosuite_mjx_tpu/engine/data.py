"""Dynamic simulation state: the ``Data`` pytree.

One ``Data`` holds a single environment's state; batching is ``jax.vmap`` over
a stacked Data (the batched replacement for the reference's per-process
MjData, /root/reference/myosuite/physics/sim_scene.py:145-165). All leaves are
jnp arrays so Data is jit/vmap/shard_map-transparent.

Forward-pass intermediates (mass matrix, bias forces, tendon Jacobians, ...)
are carried in Data so tasks and tests can consume them, mirroring MjData's
role as the single source of truth.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine.model import Model
from myosuite_mjx_tpu.utils import pytree


@pytree.dataclass
class Contact:
  """Fixed-size contact set (padded; ``dist > 0`` entries are inactive)."""
  dist: jax.Array        # (ncon,)
  pos: jax.Array         # (ncon, 3)
  frame: jax.Array       # (ncon, 3, 3) rows: normal, tangent1, tangent2
  friction: jax.Array    # (ncon, 5)
  solref: jax.Array      # (ncon, 2)
  solimp: jax.Array      # (ncon, 5)
  geom1: jax.Array       # (ncon,) int (static pairing, but kept for obs)
  geom2: jax.Array       # (ncon,) int
  includemargin: jax.Array  # (ncon,)


@pytree.dataclass
class Data:
  # ---- state ----
  time: jax.Array        # ()
  qpos: jax.Array        # (nq,)
  qvel: jax.Array        # (nv,)
  act: jax.Array         # (na,)
  ctrl: jax.Array        # (nu,)
  qacc: jax.Array        # (nv,)
  qacc_warmstart: jax.Array  # (nv,) previous step's solution (mjData parity)
  act_dot: jax.Array     # (na,)
  qfrc_applied: jax.Array   # (nv,)
  xfrc_applied: jax.Array   # (nbody, 6)
  mocap_pos: jax.Array   # (nmocap, 3)
  mocap_quat: jax.Array  # (nmocap, 4)

  # ---- position-dependent products ----
  xpos: jax.Array        # (nbody, 3)
  xquat: jax.Array       # (nbody, 4)
  xmat: jax.Array        # (nbody, 3, 3)
  xipos: jax.Array       # (nbody, 3)
  ximat: jax.Array       # (nbody, 3, 3)
  xanchor: jax.Array     # (njnt, 3)
  xaxis: jax.Array       # (njnt, 3)
  site_xpos: jax.Array   # (nsite, 3)
  site_xmat: jax.Array   # (nsite, 3, 3)
  geom_xpos: jax.Array   # (ngeom, 3)
  geom_xmat: jax.Array   # (ngeom, 3, 3)
  subtree_com: jax.Array  # (nbody, 3)
  cinert: jax.Array      # (nbody, 10) compact world-origin spatial inertia
  #                          (Ixx, Iyy, Izz, Ixy, Ixz, Iyz, hx, hy, hz, m)
  cdof: jax.Array        # (nv, 6) dof motion axes, world-origin frame
  ten_length: jax.Array  # (ntendon,)
  ten_J: jax.Array       # (ntendon, nv)
  actuator_length: jax.Array   # (nu,)
  actuator_moment: jax.Array   # (nu, nv)
  qM: jax.Array          # (nv, nv) dense mass matrix
  qLD: jax.Array         # (nv, nv) Cholesky factor of qM

  # ---- velocity-dependent products ----
  cvel: jax.Array        # (nbody, 6)
  cdof_dot: jax.Array    # (nv, 6)
  ten_velocity: jax.Array      # (ntendon,)
  actuator_velocity: jax.Array  # (nu,)
  qfrc_bias: jax.Array   # (nv,)

  # ---- actuation / forces ----
  actuator_force: jax.Array    # (nu,)
  qfrc_actuator: jax.Array     # (nv,)
  qfrc_passive: jax.Array      # (nv,)
  qfrc_smooth: jax.Array       # (nv,)
  qacc_smooth: jax.Array       # (nv,)
  qfrc_constraint: jax.Array   # (nv,)

  # ---- constraints ----
  contact: Contact
  contact_force: jax.Array     # (ncon,) normal force per contact slot
  contact_force_vec: jax.Array  # (ncon, 3) world-frame force on body2
  #                                (normal + translational friction rows
  #                                 recombined; force-sensor input)
  efc_force_limit: jax.Array   # (nlimit,) diagnostic
  ne_active: jax.Array         # () number of active contacts (diagnostic)
  ncon_dropped: jax.Array      # () in-margin candidates discarded by the
  #                                  top-k contact cull this step; nonzero
  #                                  means max_contacts is too small for
  #                                  this scene (fidelity loss diagnostic)

  # ---- sensors ----
  sensordata: jax.Array  # (nsensordata,)

  # ---- model overlay (per-env domain randomization) ----
  # optional per-instance overrides of model constants; recognized keys:
  # "body_mass" (nbody,), "geom_size" (ngeom, 3), "geom_friction" (ngeom, 3)
  overlay: dict


def make_data(m: Model, dtype=jnp.float32, ncon: int | None = None) -> Data:
  """Fresh Data at qpos0 (call engine.forward to populate derived fields)."""
  if ncon is None:
    from myosuite_mjx_tpu.engine import collision
    ncon = collision.contact_slot_count(m)
  z = lambda *shape: jnp.zeros(shape, dtype=dtype)
  ident_quat = jnp.tile(
      jnp.array([1, 0, 0, 0], dtype=dtype), (m.nbody, 1))
  eye3 = jnp.tile(jnp.eye(3, dtype=dtype), (m.nbody, 1, 1))
  contact = Contact(
      dist=jnp.full((ncon,), 1e10, dtype=dtype),
      pos=z(ncon, 3),
      frame=jnp.tile(jnp.eye(3, dtype=dtype), (ncon, 1, 1)),
      friction=jnp.ones((ncon, 5), dtype=dtype),
      solref=jnp.tile(jnp.array([0.02, 1.0], dtype=dtype), (ncon, 1)),
      solimp=jnp.tile(
          jnp.array([0.9, 0.95, 0.001, 0.5, 2.0], dtype=dtype), (ncon, 1)),
      geom1=jnp.zeros((ncon,), jnp.int32),
      geom2=jnp.zeros((ncon,), jnp.int32),
      includemargin=z(ncon),
  )
  return Data(
      time=jnp.zeros((), dtype=dtype),
      qpos=jnp.asarray(m.qpos0, dtype=dtype),
      qvel=z(m.nv),
      act=z(m.na),
      ctrl=z(m.nu),
      qacc=z(m.nv),
      qacc_warmstart=z(m.nv),
      act_dot=z(m.na),
      qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6),
      mocap_pos=z(m.nmocap, 3),
      mocap_quat=jnp.tile(jnp.array([1, 0, 0, 0], dtype=dtype),
                          (m.nmocap, 1)),
      xpos=z(m.nbody, 3),
      xquat=ident_quat,
      xmat=eye3,
      xipos=z(m.nbody, 3),
      ximat=eye3,
      xanchor=z(m.njnt, 3),
      xaxis=z(m.njnt, 3),
      site_xpos=z(m.nsite, 3),
      site_xmat=jnp.tile(jnp.eye(3, dtype=dtype), (m.nsite, 1, 1)),
      geom_xpos=z(m.ngeom, 3),
      geom_xmat=jnp.tile(jnp.eye(3, dtype=dtype), (m.ngeom, 1, 1)),
      subtree_com=z(m.nbody, 3),
      cinert=z(m.nbody, 10),
      cdof=z(m.nv, 6),
      ten_length=z(m.ntendon),
      ten_J=z(m.ntendon, m.nv),
      actuator_length=z(m.nu),
      actuator_moment=z(m.nu, m.nv),
      qM=z(m.nv, m.nv),
      qLD=z(m.nv, m.nv),
      cvel=z(m.nbody, 6),
      cdof_dot=z(m.nv, 6),
      ten_velocity=z(m.ntendon),
      actuator_velocity=z(m.nu),
      qfrc_bias=z(m.nv),
      actuator_force=z(m.nu),
      qfrc_actuator=z(m.nv),
      qfrc_passive=z(m.nv),
      qfrc_smooth=z(m.nv),
      qacc_smooth=z(m.nv),
      qfrc_constraint=z(m.nv),
      contact=contact,
      contact_force=z(ncon),
      contact_force_vec=z(ncon, 3),
      efc_force_limit=z(int(np.sum(m.jnt_limited))),
      ne_active=jnp.zeros((), jnp.int32),
      ncon_dropped=jnp.zeros((), jnp.int32),
      sensordata=z(m.nsensordata),
      overlay={},
  )
