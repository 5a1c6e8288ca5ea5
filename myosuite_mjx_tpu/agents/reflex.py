"""Reflex-based walking controller for the 80-muscle myoLeg.

Pure-JAX port of the reference's physiological locomotion baseline
(/root/reference/myosuite/agents/baseline_Reflex/reflexCtr.py:1-629 — the
Song & Geyer 2015 spinal-feedback circuitry — and its myoLeg wiring,
ReflexCtrInterface.py:21-649). The reference is a stateful Python object
with nested dict state and branchy phase logic; here the controller is a
pure function over a flat ``ReflexState`` pytree — jit/vmap-compatible, so
thousands of reflex walkers (e.g. a CMA-ES population over the 46 gains)
batch on one chip.

Pathway structure kept exactly: 11 muscle groups/leg (HAB HAD HFL GLU HAM
RF VAS BFSH GAS SOL TA), the 9 stance/swing phase flags with the
touch/lift edge transitions, the brain layer (target leg angle from
forward speed + swing-leg selection), and the M1-M10 stimulation laws
(including the reference's BFSH_8_PG-reads-the-BFSH_8_DG-param quirk, kept
for behavior parity). Default params = ones(46) reproduces the reference's
nominal Song-&-Geyer gains.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from myosuite_mjx_tpu.engine import data as data_mod
from myosuite_mjx_tpu.engine import forward as forward_mod
from myosuite_mjx_tpu.engine import model as model_mod
from myosuite_mjx_tpu.engine import sensors
from myosuite_mjx_tpu.ops import quat as quat_ops
from myosuite_mjx_tpu.envs.registry import asset
from myosuite_mjx_tpu.utils import pytree

D2R = np.pi / 180.0

# muscle groups -> myolegs actuator names (ReflexCtrInterface.py:274-500)
MUSCLE_GROUPS = {
    "HAB": ["piri", "sart", "glmed1", "glmed2", "glmin1", "glmin2",
            "glmin3"],
    "HAD": ["addbrev", "addlong", "addmagDist", "addmagIsch", "addmagMid",
            "addmagProx", "grac"],
    "HFL": ["psoas", "iliacus"],
    "GLU": ["glmax1", "glmax2", "glmax3", "glmed3"],
    "HAM": ["semimem", "semiten", "bflh"],
    "RF": ["recfem"],
    "VAS": ["vasint", "vaslat", "vasmed"],
    "BFSH": ["bfsh"],
    "GAS": ["gaslat", "gasmed"],
    "SOL": ["soleus", "perbrev", "perlong", "tibpost"],
    "TA": ["tibant"],
}
M_KEYS = ["HAB", "HAD", "HFL", "GLU", "HAM", "RF", "VAS", "BFSH", "GAS",
          "SOL", "TA"]

# control parameter scalings (reflexCtr.py:225-318): cp = p * scale + off
CP_SPEC = [
    ("theta_tgt", 10 * D2R, 0.0),
    ("c0", 20 * D2R, 55 * D2R),
    ("cv", 2 * D2R, 0.0),
    ("alpha_delta", 5 * D2R, 0.0),
    ("knee_sw_tgt", 20 * D2R, 120 * D2R),
    ("knee_tgt", 15 * D2R, 160 * D2R),
    ("knee_off_st", 10 * D2R, 165 * D2R),
    ("ankle_tgt", 20 * D2R, 60 * D2R),
    ("HFL_3_PG", 2.0, 0.0), ("HFL_3_DG", 1.0, 0.0),
    ("HFL_6_PG", 1.0, 0.0), ("HFL_6_DG", 0.1, 0.0),
    ("HFL_10_PG", 1.0, 0.0),
    ("GLU_3_PG", 2.0, 0.0), ("GLU_3_DG", 0.5, 0.0),
    ("GLU_6_PG", 1.0, 0.0), ("GLU_6_DG", 0.1, 0.0),
    ("GLU_10_PG", 0.5, 0.0),
    ("HAM_3_GLU", 1.0, 0.0), ("HAM_9_PG", 2.0, 0.0),
    ("RF_1_FG", 0.3, 0.0), ("RF_8_DG_knee", 0.1, 0.0),
    ("VAS_1_FG", 1.0, 0.0), ("VAS_2_PG", 2.0, 0.0),
    ("VAS_10_PG", 0.3, 0.0),
    ("BFSH_2_PG", 2.0, 0.0), ("BFSH_7_DG_alpha", 0.2, 0.0),
    ("BFSH_7_PG", 2.0, 0.0), ("BFSH_8_DG", 1.0, 0.0),
    ("BFSH_8_PG", 1.0, 0.0),  # reference reads BFSH_8_DG's param (quirk)
    ("BFSH_9_G_HAM", 2.0, 0.0), ("BFSH_9_HAM0", 0.3, 0.0),
    ("BFSH_10_PG", 2.0, 0.0),
    ("GAS_2_FG", 1.2, 0.0), ("SOL_1_FG", 1.2, 0.0),
    ("TA_5_PG", 2.0, 0.0), ("TA_5_G_SOL", 0.5, 0.0),
    ("theta_tgt_f", 5 * D2R, 0.0),
    ("c0_f", 20 * D2R, 60 * D2R),
    ("cv_f", 10 * D2R, 0.0),
    ("HAB_3_PG", 10.0, 0.0), ("HAB_3_DG", 1.0, 0.0),
    ("HAB_6_PG", 2.0, 0.0),
    ("HAD_3_PG", 2.0, 0.0), ("HAD_3_DG", 0.3, 0.0),
    ("HAD_6_PG", 2.0, 0.0),
]
N_PARAMS = 46
CP_IDX = {name: i for i, (name, _, _) in enumerate(CP_SPEC)}

# the reference quirk: cp["BFSH_8_PG"] is filled from params[BFSH_8_DG]
_PARAM_SOURCE = {i: i for i in range(len(CP_SPEC))}
_PARAM_SOURCE[CP_IDX["BFSH_8_PG"]] = CP_IDX["BFSH_8_DG"]

DEFAULT_INIT_POSE = {
    # ReflexCtrInterface.py:23-38
    "pitch": 15 * D2R,
    "height": 0.92,
    "joint_angles": {
        "hip_flexion_r": (180 - 190) * D2R,
        "hip_flexion_l": (180 - 155) * D2R,
        "knee_angle_r": (180 - 165) * D2R,
        "knee_angle_l": (180 - 180) * D2R,
        "ankle_angle_r": (90 - 90) * D2R,
        "ankle_angle_l": (90 - 100) * D2R,
    },
    "forward_velocity": 1.5,
}


def baseline_params() -> np.ndarray:
  """The tuned 46-gain walking parameter set shipped by the reference
  (docs/source/tutorials/4b_reflex/baseline_params.txt, loaded by the
  MyoReflex tutorial)."""
  import os
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "reflex_baseline_params.txt")
  return np.loadtxt(path)


def expand_params(params) -> jax.Array:
  """46 normalized params -> control-parameter vector (scale + offset)."""
  p = jnp.asarray(params, jnp.float32)
  src = jnp.asarray([_PARAM_SOURCE[i] for i in range(len(CP_SPEC))])
  scale = jnp.asarray([s for _, s, _ in CP_SPEC], jnp.float32)
  off = jnp.asarray([o for _, _, o in CP_SPEC], jnp.float32)
  return p[src] * scale + off


@pytree.dataclass
class ReflexState:
  """Per-leg phase flags, row 0 = right leg, row 1 = left leg."""
  in_contact: jax.Array    # (2,) bool
  ph_st: jax.Array         # (2,) bool — stance
  ph_st_csw: jax.Array     # (2,) bool — stance & contra swing
  ph_st_sw0: jax.Array     # (2,) bool — stance, initiate swing
  ph_st_st: jax.Array      # (2,) bool — stance, keep stance
  ph_sw: jax.Array         # (2,) bool — swing
  ph_sw_flex_k: jax.Array  # (2,) bool — swing: flex knee
  ph_sw_hold_k: jax.Array  # (2,) bool — swing: hold knee
  ph_sw_stop_l: jax.Array  # (2,) bool — swing: stop leg
  ph_sw_hold_l: jax.Array  # (2,) bool — swing: hold leg


def init_state() -> ReflexState:
  """Reference reset: right leg swinging, left leg in stance
  (reflexCtr.py:181-205)."""
  f = jnp.zeros(2, bool)
  return ReflexState(
      in_contact=jnp.array([False, True]),
      ph_st=jnp.array([False, True]),
      ph_st_csw=f, ph_st_sw0=f, ph_st_st=f,
      ph_sw=jnp.array([True, False]),
      ph_sw_flex_k=jnp.array([True, False]),
      ph_sw_hold_k=f, ph_sw_stop_l=f, ph_sw_hold_l=f)


def reflex_update(cp: jax.Array, state: ReflexState, sens: dict):
  """One control tick: sensors -> (new phase state, stim [2, 11]).

  ``sens`` holds stacked per-leg arrays (row 0 = r_leg) and body scalars;
  see ReflexWalker._sensor_data for the exact fields. Direct branchless
  transcription of reflexCtr.py:363-629.
  """
  c = lambda name: cp[CP_IDX[name]]
  sign_f = jnp.array([1.0, -1.0])            # frontal sign per leg
  flip = jnp.array([1, 0])                   # contra-leg index

  # ---- brain control (reflexCtr.py:345-392) ----
  theta_roll, theta_pitch = sens["theta"][0], sens["theta"][1]
  alpha_tgt_f = (c("c0_f") + sign_f * c("cv_f") * sens["d_pos"][1]
                 - sign_f * theta_roll)
  alpha_tgt = (c("c0") - c("cv") * sens["d_pos"][0]) - theta_pitch  # (2,)?
  alpha_tgt = jnp.broadcast_to(alpha_tgt, (2,))
  alpha_delta = c("alpha_delta")
  knee_sw_tgt = c("knee_sw_tgt")
  knee_tgt = c("knee_tgt")
  hip_tgt = alpha_tgt + 0.5 * knee_tgt

  both = sens["contact_ipsi"][0] & sens["contact_ipsi"][1]
  delta = sens["alpha"] - alpha_tgt
  r_first = delta[0] > delta[1]
  swing_init = jnp.where(
      both, jnp.array([True, False]) == r_first, jnp.zeros(2, bool))

  # ---- phase transitions (reflexCtr.py:404-471) ----
  ci = sens["contact_ipsi"]
  touch = ~state.in_contact & ci
  lift = state.in_contact & ~ci

  st = jnp.where(touch, True, state.ph_st)
  sw = jnp.where(touch, False, state.ph_sw)
  flex = jnp.where(touch, False, state.ph_sw_flex_k)
  holdk = jnp.where(touch, False, state.ph_sw_hold_k)
  stop = jnp.where(touch, False, state.ph_sw_stop_l)
  holdl = jnp.where(touch, False, state.ph_sw_hold_l)

  st_csw = jnp.where(st, ~ci[flip], state.ph_st_csw)
  st_sw0 = jnp.where(st, swing_init, state.ph_st_sw0)
  st_st = jnp.where(st, ~st_sw0, state.ph_st_st)

  st = jnp.where(lift, False, st)
  st_csw = jnp.where(lift, False, st_csw)
  st_sw0 = jnp.where(lift, False, st_sw0)
  st_st = jnp.where(lift, False, st_st)
  sw = jnp.where(lift, True, sw)
  flex = jnp.where(lift, True, flex)

  in_flex = sw & flex
  knee_done = sens["phi_knee"] < knee_sw_tgt
  else_br = sw & ~flex                      # evaluated on entry value
  flex = jnp.where(in_flex & knee_done, False, flex)
  holdk = jnp.where(in_flex & knee_done, True, holdk)
  holdk = jnp.where(else_br & holdk & (sens["alpha"] < alpha_tgt),
                    False, holdk)
  stop = jnp.where(else_br & (sens["alpha"] < alpha_tgt + alpha_delta),
                   True, stop)
  holdl = jnp.where(else_br & stop & (sens["dalpha"] > 0), True, holdl)

  new_state = ReflexState(
      in_contact=ci, ph_st=st, ph_st_csw=st_csw, ph_st_sw0=st_sw0,
      ph_st_st=st_st, ph_sw=sw, ph_sw_flex_k=flex, ph_sw_hold_k=holdk,
      ph_sw_stop_l=stop, ph_sw_hold_l=holdl)

  # ---- stimulation laws (reflexCtr.py:473-629) ----
  f = lambda b: b.astype(jnp.float32)
  ph_st, ph_st_sw0, ph_st_st = f(st), f(st_sw0), f(st_st)
  ph_sw, ph_sw_flex_k = f(sw), f(flex)
  ph_sw_hold_k, ph_sw_stop_l, ph_sw_hold_l = f(holdk), f(stop), f(holdl)

  load_i, load_c = sens["load_ipsi"], sens["load_contra"]
  alpha, dalpha, alpha_f = sens["alpha"], sens["dalpha"], sens["alpha_f"]
  phi_hip, phi_knee = sens["phi_hip"], sens["phi_knee"]
  phi_ankle, dphi_knee = sens["phi_ankle"], sens["dphi_knee"]
  theta = theta_pitch
  dtheta = sens["dtheta"][1]
  theta_f = sign_f * theta_roll
  dtheta_f = sign_f * sens["dtheta"][0]
  theta_tgt = c("theta_tgt")
  theta_tgt_f = c("theta_tgt_f")
  knee_off_st = c("knee_off_st")
  ankle_tgt = c("ankle_tgt")
  pre = 0.01
  relu = lambda x: jnp.maximum(x, 0.0)

  S_HAB_3 = ph_st * load_i * relu(
      -c("HAB_3_PG") * (theta_f - theta_tgt_f) - c("HAB_3_DG") * dtheta_f)
  S_HAB_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      c("HAB_6_PG") * (alpha_f - alpha_tgt_f))
  HAB = S_HAB_3 + S_HAB_6

  S_HAD_3 = ph_st * load_i * relu(
      c("HAD_3_PG") * (theta_f - theta_tgt_f) + c("HAD_3_DG") * dtheta_f)
  S_HAD_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      -c("HAD_6_PG") * (alpha_f - alpha_tgt_f))
  HAD = S_HAD_3 + S_HAD_6

  S_HFL_3 = ph_st * load_i * relu(
      -c("HFL_3_PG") * (theta - theta_tgt) - c("HFL_3_DG") * dtheta)
  S_HFL_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      c("HFL_6_PG") * (alpha - alpha_tgt) + c("HFL_6_DG") * dalpha)
  S_HFL_10 = ph_sw_hold_l * relu(c("HFL_10_PG") * (phi_hip - hip_tgt))
  HFL = pre + S_HFL_3 + S_HFL_6 + S_HFL_10

  S_GLU_3 = ph_st * load_i * relu(
      c("GLU_3_PG") * (theta - theta_tgt) + c("GLU_3_DG") * dtheta)
  S_GLU_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      -c("GLU_6_PG") * (alpha - alpha_tgt) - c("GLU_6_DG") * dalpha)
  S_GLU_10 = ph_sw_hold_l * relu(-c("GLU_10_PG") * (phi_hip - hip_tgt))
  GLU = pre + S_GLU_3 + S_GLU_6 + S_GLU_10

  S_HAM_3 = c("HAM_3_GLU") * S_GLU_3
  S_HAM_9 = ph_sw_stop_l * relu(
      -c("HAM_9_PG") * (alpha - (alpha_tgt + alpha_delta)))
  HAM = pre + S_HAM_3 + S_HAM_9

  st_load = ph_st_st + ph_st_sw0 * (1.0 - load_c)
  S_RF_1 = st_load * relu(c("RF_1_FG") * sens["F_RF"])
  S_RF_8 = ph_sw_hold_k * relu(-c("RF_8_DG_knee") * dphi_knee)
  RF = pre + S_RF_1 + S_RF_8

  S_VAS_1 = st_load * relu(c("VAS_1_FG") * sens["F_VAS"])
  S_VAS_2 = -st_load * relu(c("VAS_2_PG") * (phi_knee - knee_off_st))
  S_VAS_10 = ph_sw_hold_l * relu(-c("VAS_10_PG") * (phi_knee - knee_tgt))
  VAS = pre + S_VAS_1 + S_VAS_2 + S_VAS_10

  S_BFSH_2 = st_load * relu(c("BFSH_2_PG") * (phi_knee - knee_off_st))
  S_BFSH_7 = (ph_st_sw0 * load_c + ph_sw_flex_k) * relu(
      -c("BFSH_7_DG_alpha") * dalpha
      + c("BFSH_7_PG") * (phi_knee - knee_sw_tgt))
  S_BFSH_8 = ph_sw_hold_k * relu(
      c("BFSH_8_DG") * dphi_knee * c("BFSH_8_PG") * (alpha - alpha_tgt))
  S_BFSH_9 = relu(c("BFSH_9_G_HAM") * (S_HAM_9 - c("BFSH_9_HAM0")))
  S_BFSH_10 = ph_sw_hold_l * relu(c("BFSH_10_PG") * (phi_knee - knee_tgt))
  BFSH = pre + S_BFSH_2 + S_BFSH_7 + S_BFSH_8 + S_BFSH_9 + S_BFSH_10

  GAS = pre + ph_st * relu(c("GAS_2_FG") * sens["F_GAS"])
  S_SOL_1 = ph_st * relu(c("SOL_1_FG") * sens["F_SOL"])
  SOL = pre + S_SOL_1
  S_TA_5 = relu(c("TA_5_PG") * (phi_ankle - ankle_tgt))
  TA = pre + S_TA_5 - ph_st * relu(c("TA_5_G_SOL") * S_SOL_1)

  stim = jnp.stack(
      [HAB, HAD, HFL, GLU, HAM, RF, VAS, BFSH, GAS, SOL, TA], axis=1)
  return new_state, jnp.clip(stim, 0.01, 1.0)


class ReflexWalker:
  """Reflex controller wired to the engine's myoLeg (80 MTUs).

  ``step(data, state, cp)`` advances one 10 ms control tick (5 physics
  substeps at the model's 2 ms timestep) under jit; ``rollout`` scans it.
  """

  def __init__(self, model_path: str | None = None,
               control_dt: float = 0.01):
    path = model_path or asset("simhive/myo_sim/leg/myolegs.xml")
    # f32 like the Data it steps: an f64 model under jax_enable_x64 (the
    # test harness) promotes qvel/qacc mid-scan and breaks the carry
    self.model = model_mod.load_model(path, dtype=np.float32)
    m = self.model
    self.substeps = max(1, int(round(control_dt / float(m.opt.timestep))))
    self.pelvis_bid = m.name2id("body", "pelvis")
    self.touch = {s: int(m.sensor_objid[m.name2id("sensor", s)])
                  for s in ("r_foot", "r_toes", "l_foot", "l_toes")}
    self.total_weight = float(np.sum(m.body_mass) * 9.8)

    def jadr(name):
      j = m.name2id("joint", name)
      return int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])

    self.hip = [jadr("hip_flexion_r"), jadr("hip_flexion_l")]
    self.knee = [jadr("knee_angle_r"), jadr("knee_angle_l")]
    self.ankle = [jadr("ankle_angle_r"), jadr("ankle_angle_l")]
    self.abd = [jadr("hip_adduction_r"), jadr("hip_adduction_l")]

    self.groups = {}      # (leg, key) -> actuator index array
    self.fmax = {}
    for li, leg in enumerate("rl"):
      for key, names in MUSCLE_GROUPS.items():
        idx = np.array([m.name2id("actuator", f"{n}_{leg}")
                        for n in names])
        self.groups[(li, key)] = idx
        self.fmax[(li, key)] = np.asarray(m.actuator_biasprm[idx, 2],
                                          np.float64)

  # ---- sensor translation (ReflexCtrInterface.py:122-246) ----------------

  def _sensor_data(self, d) -> dict:
    m = self.model
    e = quat_ops.quat_to_euler(d.xquat[self.pelvis_bid])
    roll = e[0] - 0.5 * jnp.pi
    pitch = -e[2]
    yaw = -e[1]
    cv = d.cvel[self.pelvis_bid]
    vel = cv[3:] + jnp.cross(cv[:3], d.xpos[self.pelvis_bid])
    dx = jnp.cos(yaw) * vel[0] - jnp.sin(yaw) * vel[1]
    dy = jnp.sin(yaw) * vel[0] + jnp.cos(yaw) * vel[1]

    def grf(leg):
      return (sensors.touch_sensor(m, d, self.touch[f"{leg}_foot"])
              + sensors.touch_sensor(m, d, self.touch[f"{leg}_toes"]))

    load = jnp.stack([grf("r"), grf("l")]) / self.total_weight
    qp = lambda pairs: jnp.stack([d.qpos[pairs[0][0]], d.qpos[pairs[1][0]]])
    qv = lambda pairs: jnp.stack([d.qvel[pairs[0][1]], d.qvel[pairs[1][1]]])
    phi_hip = jnp.pi - qp(self.hip)
    phi_knee = jnp.pi - qp(self.knee)
    phi_ankle = 0.5 * jnp.pi - qp(self.ankle)
    dphi_knee = -qv(self.knee)
    dphi_hip = -qv(self.hip)
    alpha = phi_hip - 0.5 * phi_knee
    dalpha = dphi_hip - 0.5 * dphi_knee
    alpha_f = qp(self.abd) + 0.5 * jnp.pi

    def mforce(key):
      out = []
      for li in range(2):
        idx = self.groups[(li, key)]
        fm = jnp.asarray(self.fmax[(li, key)], d.qpos.dtype)
        out.append(-jnp.mean(d.actuator_force[idx] / fm))
      return jnp.stack(out)

    flip = jnp.array([1, 0])
    return {
        "theta": jnp.stack([roll, pitch]),
        "d_pos": jnp.stack([dx, dy]),
        "dtheta": cv[:3][:2],
        "contact_ipsi": load > 0.1,
        "contact_contra": (load > 0.1)[flip],
        "load_ipsi": load,
        "load_contra": load[flip],
        "alpha": alpha, "dalpha": dalpha, "alpha_f": alpha_f,
        "phi_hip": phi_hip, "phi_knee": phi_knee, "phi_ankle": phi_ankle,
        "dphi_knee": dphi_knee,
        "F_RF": mforce("RF"), "F_VAS": mforce("VAS"),
        "F_GAS": mforce("GAS"), "F_SOL": mforce("SOL"),
    }

  def _stim_to_ctrl(self, stim: jax.Array) -> jax.Array:
    ctrl = jnp.zeros((self.model.nu,), stim.dtype)
    for li in range(2):
      for ki, key in enumerate(M_KEYS):
        idx = self.groups[(li, key)]
        ctrl = ctrl.at[idx].set(stim[li, ki])
    return ctrl

  # ---- rollout surface ---------------------------------------------------

  def reset(self, init: dict | None = None):
    """Initial (Data, ReflexState) at the reference's walking start pose
    (ReflexCtrInterface.py:546-600: pitched trunk, bent right leg,
    1.5 m/s forward push)."""
    init = dict(DEFAULT_INIT_POSE, **(init or {}))
    m = self.model
    qpos = np.array(m.qpos0, np.float64)
    # free-root orientation: the reference's euler2quat ([0, pitch, 0],
    # quat_math.py:77-93) reduces to a +y rotation by +pitch
    half = init["pitch"] / 2
    qpos[3:7] = [np.cos(half), 0.0, np.sin(half), 0.0]
    for name, val in init["joint_angles"].items():
      j = m.name2id("joint", name)
      qpos[int(m.jnt_qposadr[j])] = val
    qpos[0:2] = 0.0
    qpos[2] = init["height"]
    qvel = np.zeros(m.nv)
    qvel[0] = init["forward_velocity"]

    d = data_mod.make_data(m, dtype=jnp.float32)
    d = d.replace(qpos=jnp.asarray(qpos, jnp.float32),
                  qvel=jnp.asarray(qvel, jnp.float32))
    with jax.default_matmul_precision("highest"):  # see step()
      d = forward_mod.forward(m, d)
    return d, init_state()

  def step(self, d, state: ReflexState, cp: jax.Array):
    """One control tick: sense -> stim -> 5 physics substeps.

    Matmul precision is pinned to f32 like MyoEnv.step: this path calls
    the engine directly, and reduced-precision matmuls (TF32, the GPU's
    f32 default) are too coarse for the leg's implicit-damping/Newton
    solves."""
    with jax.default_matmul_precision("highest"):
      sens = self._sensor_data(d)
      state, stim = reflex_update(cp, state, sens)
      # cast: the gain tables are host float64 scalars, which under
      # jax_enable_x64 are strong types and would promote ctrl -> the
      # whole physics carry to f64
      d = d.replace(ctrl=self._stim_to_ctrl(stim).astype(d.qpos.dtype))

      def sub(dd, _):
        return forward_mod.step(self.model, dd), ()

      d, _ = jax.lax.scan(sub, d, (), length=self.substeps)
      return d, state

  def rollout(self, n_steps: int, params=None, init: dict | None = None):
    """Scan ``n_steps`` control ticks; returns (final Data, trajectory
    dict with pelvis height/x and footstep count)."""
    cp = expand_params(np.ones(N_PARAMS) if params is None else params)
    d0, s0 = self.reset(init)

    def tick(carry, _):
      d, s = carry
      d, s = self.step(d, s, cp)
      out = {
          "height": d.xpos[self.pelvis_bid, 2],
          "x": d.xpos[self.pelvis_bid, 0],
          "contact": s.in_contact,
      }
      return (d, s), out

    (d, s), traj = jax.lax.scan(tick, (d0, s0), (), length=n_steps)
    # footsteps: rising contact edges across the trajectory
    c = np.asarray(traj["contact"])
    steps = int(np.sum(c[1:] & ~c[:-1]))
    return d, {"height": np.asarray(traj["height"]),
               "x": np.asarray(traj["x"]), "footsteps": steps}
