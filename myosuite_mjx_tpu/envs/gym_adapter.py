"""Gymnasium-compatible adapter over the batched JAX envs.

The reference's product surface is the gym API: ``gym.make(id)`` then the
5-tuple ``step`` contract with Box spaces (MujocoEnv subclasses gym.Env,
/root/reference/myosuite/envs/env_base.py:31, spaces at :100-113,
:168-176; gym/gymnasium tri-compat via implement_for, :351-365). A user
switching from the reference gets the same interaction model here:

    from myosuite_mjx_tpu.envs import gym_make
    env = gym_make("myoHandPose0Fixed-v0", seed=0)
    obs, info = env.reset()
    obs, reward, terminated, truncated, info = env.step(env.action_space.sample())

Shape: the adapter is a thin host loop around the pure jitted
``reset``/``step`` (compiled once, cached); all physics stays on device,
only obs/reward scalars cross to numpy. ``num_envs > 1`` exposes the
vectorized surface (SB3 VecEnv / gymnasium VectorEnv shape: batched obs
and autoreset on done, sb3_job_script.py:49).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

try:
  import gymnasium
  from gymnasium import spaces as gym_spaces
  _GYM_BASE = gymnasium.Env
except ImportError:          # keep the package importable without gymnasium
  gymnasium = None
  gym_spaces = None
  _GYM_BASE = object

from myosuite_mjx_tpu.envs import registry
from myosuite_mjx_tpu.envs.base import BatchedEnv, MyoEnv


class GymEnv(_GYM_BASE):
  """Single-env gymnasium.Env over a MyoEnv."""

  metadata = {"render_modes": []}

  def __init__(self, env: MyoEnv, seed: int = 0):
    self._env = env
    self._rng = jax.random.PRNGKey(seed)
    self._reset_fn = jax.jit(env.reset)
    self._step_fn = jax.jit(env.step)
    self._state = None
    obs_dim = int(self._reset_fn(self._rng).obs.shape[0])
    if gym_spaces is not None:
      self.action_space = gym_spaces.Box(
          low=-1.0, high=1.0, shape=(env.action_dim,), dtype=np.float32)
      self.observation_space = gym_spaces.Box(
          low=-np.inf, high=np.inf, shape=(obs_dim,), dtype=np.float32)

  @property
  def unwrapped_myo(self) -> MyoEnv:
    return self._env

  # ---- pickling (reference pickles whole envs, tests/test_envs.py) ------

  def __getstate__(self):
    state = dict(self.__dict__)
    # jitted callables are rebuilt on load
    state.pop("_reset_fn", None)
    state.pop("_step_fn", None)
    return state

  def __setstate__(self, state):
    self.__dict__.update(state)
    self._reset_fn = jax.jit(self._env.reset)
    self._step_fn = jax.jit(self._env.step)

  @property
  def horizon(self) -> int:
    return self._env.horizon

  def reset(self, *, seed: int | None = None, options=None):
    if seed is not None:
      self._rng = jax.random.PRNGKey(seed)
    self._rng, k = jax.random.split(self._rng)
    self._state = self._reset_fn(k)
    return np.asarray(self._state.obs), self._info()

  def step(self, action):
    st = self._step_fn(self._state, jnp.asarray(action))
    self._state = st
    terminated = bool(st.done)
    truncated = bool(st.steps >= self._env.horizon) and not terminated
    return (np.asarray(st.obs), float(st.reward), terminated, truncated,
            self._info())

  def _info(self):
    st = self._state
    return {k: np.asarray(v) for k, v in st.info.items()}

  def close(self):
    pass


class GymVecEnv:
  """Vectorized surface: batched obs/reward with brax-style autoreset.

  Replaces SB3's subprocess vec-envs (make_vec_env(n_envs),
  sb3_job_script.py:49) with one on-device vmapped program.
  """

  def __init__(self, env: MyoEnv, num_envs: int, seed: int = 0):
    self._benv = BatchedEnv(env, num_envs)
    self._env = env
    self.num_envs = num_envs
    self._rng = jax.random.PRNGKey(seed)
    self._state = None
    obs_dim = None
    if gym_spaces is not None:
      obs_dim = int(jax.eval_shape(
          env.reset, jax.random.PRNGKey(0)).obs.shape[0])
      self.single_action_space = gym_spaces.Box(
          low=-1.0, high=1.0, shape=(env.action_dim,), dtype=np.float32)
      self.single_observation_space = gym_spaces.Box(
          low=-np.inf, high=np.inf, shape=(obs_dim,), dtype=np.float32)
      self.action_space = gym_spaces.Box(
          low=-1.0, high=1.0, shape=(num_envs, env.action_dim),
          dtype=np.float32)
      self.observation_space = gym_spaces.Box(
          low=-np.inf, high=np.inf, shape=(num_envs, obs_dim),
          dtype=np.float32)

  def reset(self, *, seed: int | None = None):
    if seed is not None:
      self._rng = jax.random.PRNGKey(seed)
    self._rng, k = jax.random.split(self._rng)
    keys = jax.random.split(k, self.num_envs)
    self._state = self._benv.reset(keys)
    return np.asarray(self._state.obs), {}

  def step(self, actions):
    st = self._benv.step(self._state, jnp.asarray(actions))
    self._state = st
    # pre-autoreset episode-boundary flags (MyoEnv.autoreset_step preserves
    # them; obs/physics are already the fresh episode's)
    done = np.asarray(st.info["terminated"])
    trunc = np.asarray(st.info["truncated"])
    return (np.asarray(st.obs), np.asarray(st.reward), done, trunc,
            {k: np.asarray(v) for k, v in st.info.items()})


def gym_make(env_id: str, seed: int = 0, num_envs: int = 1, **kwargs):
  """gym.make-equivalent over the registry (reference surface parity)."""
  env = registry.make(env_id, **kwargs)
  if num_envs == 1:
    return GymEnv(env, seed=seed)
  return GymVecEnv(env, num_envs, seed=seed)
