"""float32 production-path robustness (VERDICT r1 weak #6).

The whole test suite runs in x64 for oracle parity; the production path
is float32. This suite steps the contact-rich flagship scenes in f32 for a
long horizon asserting no NaN and bounded drift vs the f64 trajectory —
the fragility called out at engine/api.py (f32 needs matmul-precision
pinning) gets a regression test here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myosuite_mjx_tpu.engine import data as edata
from myosuite_mjx_tpu.engine import forward
from myosuite_mjx_tpu.engine import model as emodel

FINGER = ("/root/reference/myosuite/simhive/myo_sim/finger/"
          "myofinger_v0.xml")
HAND = "/root/reference/myosuite/simhive/myo_sim/hand/myohand.xml"


def _rollout(path, dtype, steps, ctrl_fn):
  m = emodel.load_model(path, dtype=np.float64)
  d = edata.make_data(m, dtype=dtype)

  def stepper(d, c):
    with jax.default_matmul_precision("highest"):
      return forward.step(m, d.replace(ctrl=c)), ()

  step = jax.jit(lambda d, c: stepper(d, c)[0])
  traj = []
  for t in range(steps):
    d = step(d, jnp.asarray(ctrl_fn(t), dtype))
    if t % 25 == 0:
      traj.append(np.asarray(d.qpos, np.float64))
  return np.asarray(d.qpos, np.float64), traj


def test_finger_f32_long_rollout_no_nan():
  rng = np.random.default_rng(0)
  m = emodel.load_model(FINGER, dtype=np.float64)
  ctrls = rng.uniform(0, 1, size=(200, m.nu))
  q32, tr32 = _rollout(FINGER, jnp.float32, 200, lambda t: ctrls[t])
  assert np.isfinite(q32).all()
  q64, tr64 = _rollout(FINGER, jnp.float64, 200, lambda t: ctrls[t])
  # bounded drift vs the f64 trajectory (chaotic divergence accumulates;
  # the bound guards magnitude blow-ups and NaN, not ulp closeness)
  assert np.linalg.norm(q32 - q64) < 0.5
  for a, b in zip(tr32, tr64):
    assert np.isfinite(a).all()


@pytest.mark.slow
def test_hand_f32_long_rollout_no_nan():
  rng = np.random.default_rng(1)
  m = emodel.load_model(HAND, dtype=np.float64)
  ctrls = rng.uniform(0, 1, size=(200, m.nu))
  q32, _ = _rollout(HAND, jnp.float32, 200, lambda t: ctrls[t])
  assert np.isfinite(q32).all()
  # joint positions stay within (slightly padded) joint ranges
  lo = m.jnt_range[:, 0].min() - 1.0
  hi = m.jnt_range[:, 1].max() + 1.0
  assert q32.min() > lo and q32.max() < hi


@pytest.mark.slow
def test_objhold_f32_contact_rollout_no_nan():
  from myosuite_mjx_tpu import envs
  env = envs.make("myoHandObjHoldFixed-v0")   # default dtype: float32
  assert env.dtype == jnp.float32
  st = env.reset(jax.random.PRNGKey(0))
  step = jax.jit(env.step)
  close = jnp.full((env.action_dim,), 0.4)
  for _ in range(20):   # 20 env steps x frame_skip substeps, contact-rich
    st = step(st, close)
  assert np.isfinite(np.asarray(st.obs)).all()
  assert np.isfinite(float(st.reward))
  assert int(st.data.ne_active) > 0
