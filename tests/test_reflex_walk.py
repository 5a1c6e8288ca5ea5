"""Tuned reflex gains actually locomote in-engine (round-4 ask #3).

The reference ships a reflex controller whose published gains predate the
current myolegs.xml and collapse in ~0.3 s — reproducibly with the
reference's own controller (agents/reflex.py docstring). The checked-in
``train_artifacts/reflex_gains.npz`` is re-tuned against the shipped
model by CEM (tools/tune_reflex.py); this test replays it and floors
survival + forward progress ~30% under the tuned result, so a physics or
controller regression that breaks the gait fails loudly while seed/
platform noise does not.

Fast lane: a 150-tick slice. The full-horizon check is slow-lane.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

GAINS = os.path.join(os.path.dirname(__file__), os.pardir,
                     "train_artifacts", "reflex_gains.npz")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(GAINS), reason="no tuned reflex gains checked in")


def _rollout(params, ticks):
  from myosuite_mjx_tpu.agents import reflex
  walker = reflex.ReflexWalker()
  d0, s0 = walker.reset()
  pelvis = walker.pelvis_bid
  up_axis = jnp.asarray(
      np.asarray(d0.xmat[pelvis]).T @ np.array([0.0, 0.0, 1.0]),
      jnp.float32)
  cp = reflex.expand_params(jnp.asarray(params, jnp.float32))

  def tick(carry, _):
    d, s, alive, fall_x, t_alive = carry
    prev_x = d.xpos[pelvis, 0]
    d, s = walker.step(d, s, cp)
    h = d.xpos[pelvis, 2]
    up = d.xmat[pelvis, 2, :] @ up_axis
    sane = (jnp.all(jnp.isfinite(d.qvel))
            & (jnp.max(jnp.abs(d.qvel)) < 100.0)
            & (jnp.abs(d.xpos[pelvis, 0] - prev_x) < 0.1))
    ok = (h > 0.65) & (h < 1.25) & (up > 0.5) & sane
    alive = alive & ok
    fall_x = jnp.where(alive, d.xpos[pelvis, 0], fall_x)
    t_alive = t_alive + alive
    return (d, s, alive, fall_x, t_alive), None

  init = (d0, s0, jnp.asarray(True), jnp.asarray(0.0, jnp.float32),
          jnp.asarray(0, jnp.int32))
  (d, s, alive, fall_x, t_alive), _ = jax.jit(
      lambda c: jax.lax.scan(tick, c, (), length=ticks))(init)
  return float(fall_x), int(t_alive)


def test_tuned_gains_beat_nominal_slice():
  """150 ticks (1.5 s): tuned gains must stay up the whole slice where
  the nominal Song & Geyer gains collapse at ~0.42 s on this model."""
  params = np.load(GAINS)["params"]
  dist, t_alive = _rollout(params, 150)
  assert t_alive >= 130, (dist, t_alive)
  assert dist > 0.8, (dist, t_alive)
  # the documented nominal-gain collapse still reproduces (guards against
  # accidentally trivializing the task, e.g. by softening the fall gate)
  _, t_nominal = _rollout(np.ones_like(params), 150)
  assert t_nominal < 80, t_nominal


@pytest.mark.slow
def test_tuned_gains_full_horizon():
  """Floors under the CPU figure: the tuned gains walk 1.75 s / 3.05 m
  on CPU XLA (a chaotic gait: other backends reduce in another order and
  land elsewhere), so the floor sits under it — still 3-4x the
  nominal-gain collapse."""
  params = np.load(GAINS)["params"]
  dist, t_alive = _rollout(params, 1000)
  assert t_alive >= 130, (dist, t_alive)
  assert dist >= 1.5, (dist, t_alive)
