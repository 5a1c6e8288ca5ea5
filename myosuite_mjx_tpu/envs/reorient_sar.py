"""SAR reorient family: in-hand reorientation of per-episode random objects.

Behavior parity with ProprioceptiveEnvV0 and its Geometries8/100 and
In/OutofDistribution subclasses (/root/reference/myosuite/envs/myo/myobase/
reorient_sar_v0.py:15-2581). Each episode the reference mutates the object
geom's *type* (capsule/ellipsoid/cylinder/box), size, marker positions, the
object mass (1.2 kg) and the target body orientation on the host model.

Batched realization: geom type is static under XLA, so the scene carries
all four candidate geoms on the Object body (models/assets.py:sar_scene_xml)
and the per-episode ``Data.overlay`` sets the active geom's size from the
task's geometry table while shrinking the inactive three to epsilon (points
strictly interior to the active geom, hence contact-free). The "top"/"bot"
marker geoms the reference repositions per episode reduce analytically: both
markers sit on the object's local z-axis at ±off(type, size), so

    obj_rot      = (x_top - x_bot) / pen_length = (2 off / 0.07) R_obj e_z
    obj_des_rot  = (2 off / 0.07) R(euler2quat(desired)) e_z

(pen_length/tar_length are frozen at setup from the pristine model's marker
spacing 0.07, reorient_sar_v0.py:86-93 — the reference never recomputes
them, so the obs vectors are NOT unit length; we reproduce that exactly).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.engine.data import Data
from myosuite_mjx_tpu.envs import sar_geometries as geo
from myosuite_mjx_tpu.envs.base import MyoEnv
from myosuite_mjx_tpu.ops import quat as qmath

_PEN_LENGTH = 0.07  # pristine marker spacing (myohand_sar.xml top/bot at ∓.035)


class SAREnvBase(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_jnt", "obj_pos", "obj_vel", "obj_rot", "obj_des_rot",
      "obj_err_pos", "obj_err_rot", "mlen", "mvel", "mforce",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_align": 1.0,
      "rot_align": 1.0,
      "act_reg": 5.0,
      "drop": 5.0,
      "bonus": 10.0,
  }

  TABLES: tuple = ()  # (caps, ellips, cyl, box) size arrays, set per task

  def _setup(self, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.obj_bid = m.name2id("body", "Object")
    self.eps_ball_sid = m.name2id("site", "eps_ball")
    self.obj_gids = [m.name2id("geom", n) for n in
                     ("obj_caps", "obj_ellip", "obj_cyl", "obj_box")]
    # fully-open palm-up init (reorient_sar_v0.py:112-113)
    self.init_qpos[:-6] *= 0
    self.init_qpos[0] = -1.5
    # per-type tables padded to a common length for traced indexing
    n = max(len(t) for t in self.TABLES)
    padded = np.zeros((4, n, 3), np.float64)
    counts = np.zeros((4,), np.int32)
    for i, t in enumerate(self.TABLES):
      padded[i, :len(t)] = t
      counts[i] = len(t)
    self._sizes = padded
    self._counts = counts

  # marker offset along local z per type (reorient_sar_v0.py:209-232)
  @staticmethod
  def _marker_off(type_idx, size):
    return jnp.where(
        type_idx == 0, 1.3 * size[1],           # capsule
        jnp.where(type_idx == 1, size[2],       # ellipsoid
                  jnp.where(type_idx == 2, size[1],   # cylinder
                            size[2])))          # box

  def reset_aux(self, rng: jax.Array) -> dict:
    k_type, k_idx, k_eul = jax.random.split(rng, 3)
    type_idx = jax.random.randint(k_type, (), 0, 4)
    count = jnp.asarray(self._counts)[type_idx]
    idx = jax.random.randint(k_idx, (), 0, count)
    size = jnp.asarray(self._sizes, self.dtype)[type_idx, idx]
    off = self._marker_off(type_idx, size)
    e = jnp.stack([
        jax.random.uniform(k_eul, (), self.dtype, -1.0, 1.0),
        jax.random.uniform(jax.random.fold_in(k_eul, 1), (), self.dtype,
                           -0.8, 1.2),
        jnp.zeros((), self.dtype)])
    q_des = qmath.euler_to_quat(e)
    axis = qmath.quat_rotate(
        q_des, jnp.array([0.0, 0.0, 1.0], self.dtype))
    scale = 2.0 * off / _PEN_LENGTH
    return {"type_idx": type_idx, "size": size, "scale": scale,
            "des_rot": axis * scale}

  def reset_overlay(self, rng: jax.Array, aux: dict) -> dict:
    m = self.model
    eps = jnp.asarray(1e-5, self.dtype)
    sizes = jnp.asarray(m.geom_size, self.dtype)
    for i, gid in enumerate(self.obj_gids):
      row = jnp.where(aux["type_idx"] == i, aux["size"],
                      jnp.full((3,), eps, self.dtype))
      sizes = sizes.at[gid].set(row)
    mass = jnp.asarray(m.body_mass, self.dtype).at[self.obj_bid].set(1.2)
    return {"geom_size": sizes, "body_mass": mass}

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    obj_pos = data.xpos[self.obj_bid]
    des_pos = data.site_xpos[self.eps_ball_sid]
    obj_rot = data.xmat[self.obj_bid][:, 2] * aux["scale"]
    return {
        "time": jnp.atleast_1d(data.time),
        "hand_jnt": data.qpos[:-6],
        "obj_pos": obj_pos,
        "obj_des_pos": des_pos,
        "obj_vel": data.qvel[-6:] * self.dt,
        "obj_rot": obj_rot,
        "obj_des_rot": aux["des_rot"],
        "obj_err_pos": obj_pos - des_pos,
        "obj_err_rot": obj_rot - aux["des_rot"],
        "act": data.act,
        "mlen": data.actuator_length,
        "mvel": data.actuator_velocity,
        "mforce": data.actuator_force,
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    pos_align = jnp.linalg.norm(obs_dict["obj_err_pos"], axis=-1)
    a, b = obs_dict["obj_rot"], obs_dict["obj_des_rot"]
    rot_align = jnp.sum(a * b, axis=-1) / jnp.maximum(
        jnp.linalg.norm(a) * jnp.linalg.norm(b), 1e-12)
    dropped = pos_align > 0.075
    act_mag = jnp.linalg.norm(obs_dict["act"], axis=-1) / self.model.na
    return {
        "pos_align": -1.0 * pos_align,
        "rot_align": rot_align,
        "act_reg": -1.0 * act_mag,
        "drop": -1.0 * dropped,
        "bonus": 1.0 * (rot_align > 0.9) * (pos_align < 0.075)
                 + 5.0 * (rot_align > 0.95) * (pos_align < 0.075),
        "sparse": -1.0 * pos_align + rot_align,
        "solved": (rot_align > 0.95) & (~dropped),
        "done": dropped,
    }


class Geometries8Env(SAREnvBase):
  TABLES = geo.G8


class Geometries100Env(SAREnvBase):
  TABLES = geo.G100


class InDistributionEnv(SAREnvBase):
  TABLES = geo.ID


class OutOfDistributionEnv(SAREnvBase):
  TABLES = geo.OOD
