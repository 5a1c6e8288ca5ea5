"""Engine parity against CPU MuJoCo on the committed synthetic hand scene.

The scene (models/synthetic) has myoHand's widths: 23 limited hinges, 39
muscles on spatial tendons with sphere and cylinder wraps, capsule geoms,
a free sphere in the palm and a floor. It ships with the repository, so
these checks run wherever the tests do. float64 throughout (conftest).
"""
import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from myosuite_mjx_tpu.engine import data as edata
from myosuite_mjx_tpu.engine import forward
from myosuite_mjx_tpu.engine import model as emodel
from myosuite_mjx_tpu.engine import smooth, tendon
from myosuite_mjx_tpu.models import synthetic


@pytest.fixture(scope="module")
def fx():
  mj = emodel.load_mj_model(synthetic.XML_PATH)
  m = emodel.load_model(synthetic.NPZ_PATH)
  return mj, m, mujoco.MjData(mj)


def _random_hinges(mj, rng):
  qpos = mj.qpos0.copy()
  for j in np.where(mj.jnt_type == mujoco.mjtJoint.mjJNT_HINGE)[0]:
    qpos[mj.jnt_qposadr[j]] = rng.uniform(*mj.jnt_range[j])
  return qpos


def _mj_lengths(mj, d, qpos):
  d.qpos[:] = qpos
  mujoco.mj_forward(mj, d)
  return d.ten_length.copy()


@pytest.mark.parametrize("seed", range(4))
def test_tendon_lengths_and_moment_arms(fx, seed):
  """Lengths to machine precision; moment arms (ten_J) against central
  differences of MuJoCo's lengths along every dof."""
  mj, m, d = fx
  qpos = _random_hinges(mj, np.random.default_rng(seed))
  kin = smooth.kinematics(m, qpos, np.zeros((0, 3)), np.zeros((0, 4)))
  _, _, cdof = smooth.com_pos(m, kin)
  length, ten_j = tendon.tendon(m, kin, cdof)
  want = _mj_lengths(mj, d, qpos)
  assert (d.ten_wrapnum > 3).sum() > 0   # some wraps are engaged
  np.testing.assert_allclose(np.asarray(length), want, atol=1e-12)
  eps = 1e-7
  fd = np.zeros((mj.ntendon, mj.nv))
  for k in range(mj.nv):
    dq = np.zeros(mj.nv)
    dq[k] = eps
    qp, qm = qpos.copy(), qpos.copy()
    mujoco.mj_integratePos(mj, qp, dq, 1)
    mujoco.mj_integratePos(mj, qm, dq, -1)
    fd[:, k] = (_mj_lengths(mj, d, qp) - _mj_lengths(mj, d, qm)) / (2 * eps)
  np.testing.assert_allclose(np.asarray(ten_j), fd, atol=1e-6)


def _states(mj, d, nsteps=150, every=25):
  """qpos0 (sphere resting in the palm) and states reached under random
  muscle ctrl."""
  rng = np.random.default_rng(0)
  mujoco.mj_resetData(mj, d)
  d.ctrl[:] = rng.uniform(0, 1, mj.nu)
  mujoco.mj_forward(mj, d)
  yield d
  for t in range(nsteps):
    d.ctrl[:] = rng.uniform(0, 1, mj.nu)
    mujoco.mj_step(mj, d)
    if (t + 1) % every == 0:
      mujoco.mj_forward(mj, d)
      yield d


def test_forward_parity_with_contacts(fx):
  """Actuator force, bias, constraint force and qacc with contacts and
  joint limits active, at qpos0 and at reached states."""
  mj, m, dref = fx
  template = edata.make_data(m, dtype=jnp.float64)
  fwd = jax.jit(functools.partial(forward.forward, m))
  full_m = np.zeros((mj.nv, mj.nv))
  ncon = []
  for dr in _states(mj, dref):
    d = fwd(template.replace(
        qpos=jnp.asarray(dr.qpos.copy()), qvel=jnp.asarray(dr.qvel.copy()),
        ctrl=jnp.asarray(dr.ctrl.copy()), act=jnp.asarray(dr.act.copy())))
    assert int(d.ne_active) == dr.ncon
    ncon.append(dr.ncon)
    np.testing.assert_allclose(np.asarray(d.ten_length), dr.ten_length,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.actuator_length),
                               dr.actuator_length, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.actuator_force),
                               dr.actuator_force, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d.qfrc_actuator),
                               dr.qfrc_actuator, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d.qfrc_bias), dr.qfrc_bias,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.qfrc_constraint),
                               dr.qfrc_constraint, atol=1e-9)
    mujoco.mj_fullM(mj, dr, full_m)
    np.testing.assert_allclose(full_m @ (np.asarray(d.qacc) - dr.qacc),
                               0.0, atol=1e-9)
  assert ncon[0] > 0, "the sphere must rest on the palm at qpos0"


def test_step_parity_one_control_step(fx):
  """frame_skip=10 physics steps from qpos0 under constant ctrl."""
  mj, m, dref = fx
  mujoco.mj_resetData(mj, dref)
  ctrl = np.random.default_rng(3).uniform(0, 1, mj.nu)
  d = edata.make_data(m, dtype=jnp.float64).replace(ctrl=jnp.asarray(ctrl))
  step = jax.jit(functools.partial(forward.step, m))
  for _ in range(10):
    dref.ctrl[:] = ctrl
    mujoco.mj_step(mj, dref)
    d = step(d)
  np.testing.assert_allclose(np.asarray(d.qpos), dref.qpos, atol=1e-9)
  np.testing.assert_allclose(np.asarray(d.qvel), dref.qvel, atol=1e-6)
  np.testing.assert_allclose(np.asarray(d.act), dref.act, atol=1e-10)
