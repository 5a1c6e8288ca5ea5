"""Minimum-jerk joint-space trajectory generation.

Capability parity with the reference planner
(/root/reference/myosuite/utils/min_jerk.py:5-62): quintic 0->1 profile
with zero start/goal velocity and acceleration, scaled between start and
goal joint vectors.

Shape: returns a dict of stacked arrays (time [N], position
[N, D], velocity, acceleration) instead of the reference's list of
per-step dicts, so the whole trajectory is one device tensor usable under
jit/vmap (e.g. as a reference for tracking rewards). ``as_waypoint_list``
converts to the reference's list-of-dicts form for host-side tooling.
"""
from __future__ import annotations

import jax.numpy as jnp


def min_jerk_spaces(n_steps: int, time_to_go: float):
  """1-D min-jerk profile 0->1 over ``n_steps`` in ``time_to_go`` seconds.

  Returns (p, pd, pdd), each [n_steps]. Mirrors _min_jerk_spaces
  (min_jerk.py:6-27).
  """
  if n_steps <= 1:
    raise ValueError("Number of planning steps must be larger than 1.")
  t = jnp.linspace(0.0, 1.0, n_steps)
  p = 10 * t**3 - 15 * t**4 + 6 * t**5
  pd = (30 * t**2 - 60 * t**3 + 30 * t**4) / time_to_go
  pdd = (60 * t - 180 * t**2 + 120 * t**3) / (time_to_go**2)
  return p, pd, pdd


def generate_joint_space_min_jerk(start, goal, time_to_go: float, dt: float):
  """Joint-space min-jerk plan (min_jerk.py:30-62) as stacked arrays.

  Returns {"time_from_start": [N], "position": [N, D], "velocity": [N, D],
  "acceleration": [N, D]} with N = int(time_to_go / dt).
  """
  start = jnp.asarray(start)
  goal = jnp.asarray(goal)
  n_steps = int(time_to_go / dt)
  p, pd, pdd = min_jerk_spaces(n_steps, time_to_go)
  delta = goal - start
  return {
      "time_from_start": dt * jnp.arange(n_steps, dtype=p.dtype),
      "position": start[None, :] + delta[None, :] * p[:, None],
      "velocity": delta[None, :] * pd[:, None],
      "acceleration": delta[None, :] * pdd[:, None],
  }


def as_waypoint_list(traj: dict):
  """Convert a stacked trajectory to the reference's list-of-dicts form."""
  n = traj["position"].shape[0]
  return [
      {
          "time_from_start": float(traj["time_from_start"][i]),
          "position": traj["position"][i],
          "velocity": traj["velocity"][i],
          "acceleration": traj["acceleration"][i],
      }
      for i in range(n)
  ]
