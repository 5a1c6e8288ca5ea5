"""SAC learner: off-policy soft actor-critic, fully on-device.

In-repo replacement for the reference's SB3 SAC path
(/root/reference/myosuite/agents/sb3_job_script.py:31-131, algorithm
selected by config). Defaults mirror SB3's: twin Q critics, tanh-squashed
Gaussian actor, polyak target updates (tau 0.005), automatic entropy
tuning to -act_dim, lr 3e-4, batch 256.

Shape: the replay buffer is a device-resident ring (dict of
fixed arrays), collection is a lax.scan over the vmapped env, and one
jitted train_step = collect num_envs transitions + `updates_per_step`
gradient steps on uniform samples. No host round-trips inside training.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from myosuite_mjx_tpu.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu.utils import nn, pytree

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


class Actor:
  """ReLU MLP with separate mean (``Dense_{L}``) and clipped log-std
  (``Dense_{L+1}``) heads on the last hidden layer."""

  def __init__(self, act_dim: int, hidden: tuple = (256, 256)):
    self.act_dim = act_dim
    self.hidden = tuple(hidden)

  def init(self, key, obs):
    n = len(self.hidden)
    sizes = (obs.shape[-1],) + self.hidden
    return {"params": {
        **nn.mlp_init(key, sizes),
        **nn.mlp_init(key, (sizes[-1], self.act_dim), first=n),
        **nn.mlp_init(key, (sizes[-1], self.act_dim), first=n + 1)}}

  def apply(self, params, obs):
    p = params["params"]
    n = len(self.hidden)
    x = jax.nn.relu(nn.mlp(p, obs, n, jax.nn.relu))
    mean = nn.dense(p[f"Dense_{n}"], x)
    log_std = jnp.clip(nn.dense(p[f"Dense_{n + 1}"], x),
                       _LOG_STD_MIN, _LOG_STD_MAX)
    return mean, log_std


class TwinQ:
  """Two independent ReLU-MLP critics on [obs, act]."""

  def __init__(self, hidden: tuple = (256, 256)):
    self.hidden = tuple(hidden)

  def init(self, key, obs, act):
    sizes = (obs.shape[-1] + act.shape[-1],) + self.hidden + (1,)
    n = len(sizes) - 1
    return {"params": {**nn.mlp_init(key, sizes),
                       **nn.mlp_init(key, sizes, first=n)}}

  def apply(self, params, obs, act):
    p = params["params"]
    n = len(self.hidden) + 1
    xin = jnp.concatenate([obs, act], axis=-1)
    return (nn.mlp(p, xin, n, jax.nn.relu)[..., 0],
            nn.mlp(p, xin, n, jax.nn.relu, first=n)[..., 0])


def _sample_tanh(mean, log_std, key):
  """Tanh-squashed Gaussian sample + log-prob (SAC appendix C)."""
  std = jnp.exp(log_std)
  eps = jax.random.normal(key, mean.shape)
  pre = mean + std * eps
  act = jnp.tanh(pre)
  logp = jnp.sum(
      -0.5 * (eps ** 2 + 2 * log_std + jnp.log(2 * jnp.pi))
      - jnp.log(jnp.maximum(1.0 - act ** 2, 1e-6)), axis=-1)
  return act, logp


@dataclasses.dataclass(frozen=True)
class SACConfig:
  num_envs: int = 32
  buffer_size: int = 1 << 17
  batch_size: int = 256
  learning_rate: float = 3e-4
  gamma: float = 0.99
  tau: float = 0.005
  updates_per_step: int = 1      # gradient steps per collected env-step row
  learning_starts: int = 1000    # env steps before updates begin
  hidden: tuple = (256, 256)


@pytree.dataclass
class SACState:
  actor_params: Any
  q_params: Any
  q_target: Any
  log_alpha: jax.Array
  actor_opt: Any
  q_opt: Any
  alpha_opt: Any
  buffer: dict                   # obs/act/rew/next_obs/done rings
  buf_pos: jax.Array             # () int32 insert cursor
  buf_full: jax.Array            # () bool
  env_state: EnvState
  key: jax.Array
  steps: jax.Array


class SAC:
  """SAC trainer bound to a MyoEnv."""

  def __init__(self, env: MyoEnv, config: SACConfig = SACConfig()):
    self.env = env
    self.cfg = config
    self.act_dim = getattr(env, "action_dim", env.model.nu)
    self.actor = Actor(act_dim=self.act_dim, hidden=config.hidden)
    self.q = TwinQ(hidden=config.hidden)
    self.target_entropy = -float(self.act_dim)
    self.a_tx = optax.adam(config.learning_rate)
    self.q_tx = optax.adam(config.learning_rate)
    self.al_tx = optax.adam(config.learning_rate)

  def init(self, seed: int = 0) -> SACState:
    cfg = self.cfg
    key = jax.random.PRNGKey(seed)
    key, k_a, k_q, k_env = jax.random.split(key, 4)
    obs_dim = int(np.prod(jax.eval_shape(self.env.reset, key).obs.shape))
    zo = jnp.zeros((obs_dim,))
    za = jnp.zeros((self.act_dim,))
    actor_params = self.actor.init(k_a, zo)
    q_params = self.q.init(k_q, zo, za)
    log_alpha = jnp.zeros(())
    buf = dict(
        obs=jnp.zeros((cfg.buffer_size, obs_dim)),
        act=jnp.zeros((cfg.buffer_size, self.act_dim)),
        rew=jnp.zeros((cfg.buffer_size,)),
        next_obs=jnp.zeros((cfg.buffer_size, obs_dim)),
        done=jnp.zeros((cfg.buffer_size,)),
    )
    env_state = jax.vmap(self.env.reset)(
        jax.random.split(k_env, cfg.num_envs))
    return SACState(
        actor_params=actor_params, q_params=q_params, q_target=q_params,
        log_alpha=log_alpha,
        actor_opt=self.a_tx.init(actor_params),
        q_opt=self.q_tx.init(q_params),
        alpha_opt=self.al_tx.init(log_alpha),
        buffer=buf, buf_pos=jnp.zeros((), jnp.int32),
        buf_full=jnp.zeros((), bool),
        env_state=env_state, key=key, steps=jnp.zeros((), jnp.int32))

  # ---- one training iteration: collect num_envs transitions + update ----

  def train_step(self, ts: SACState) -> tuple[SACState, dict]:
    cfg = self.cfg
    key, k_act, k_samp = jax.random.split(ts.key, 3)

    # ---- collect one vmapped env step ----
    obs = ts.env_state.obs
    mean, log_std = self.actor.apply(ts.actor_params, obs)
    act, _ = _sample_tanh(mean, log_std, k_act)
    # before learning starts: uniform random actions (SB3 warmup)
    act = jnp.where(ts.steps < cfg.learning_starts,
                    jax.random.uniform(k_act, act.shape, act.dtype, -1, 1),
                    act)
    nxt = jax.vmap(self.env.autoreset_step)(ts.env_state, act)
    rew = nxt.info["rwd_dense"]
    # done excludes horizon truncation (bootstrap through timeouts)
    done = nxt.done.astype(jnp.float32)

    idx = (ts.buf_pos + jnp.arange(cfg.num_envs)) % cfg.buffer_size
    buf = {
        "obs": ts.buffer["obs"].at[idx].set(obs),
        "act": ts.buffer["act"].at[idx].set(act),
        "rew": ts.buffer["rew"].at[idx].set(rew),
        "next_obs": ts.buffer["next_obs"].at[idx].set(nxt.obs),
        "done": ts.buffer["done"].at[idx].set(done),
    }
    buf_pos = (ts.buf_pos + cfg.num_envs) % cfg.buffer_size
    buf_full = ts.buf_full | (ts.buf_pos + cfg.num_envs >= cfg.buffer_size)
    size = jnp.where(buf_full, cfg.buffer_size, buf_pos)

    # ---- gradient updates ----
    def one_update(carry, k):
      (a_p, q_p, q_t, log_alpha, a_opt, q_opt, al_opt) = carry
      k1, k2, k3 = jax.random.split(k, 3)
      mb_idx = jax.random.randint(
          k1, (cfg.batch_size,), 0, jnp.maximum(size, 1))
      mb = {kk: v[mb_idx] for kk, v in buf.items()}
      alpha = jnp.exp(log_alpha)

      # critic
      next_mean, next_ls = self.actor.apply(a_p, mb["next_obs"])
      next_act, next_logp = _sample_tanh(next_mean, next_ls, k2)
      tq1, tq2 = self.q.apply(q_t, mb["next_obs"], next_act)
      target = mb["rew"] + cfg.gamma * (1 - mb["done"]) * (
          jnp.minimum(tq1, tq2) - alpha * next_logp)

      def q_loss_fn(qp):
        q1, q2 = self.q.apply(qp, mb["obs"], mb["act"])
        return 0.5 * (jnp.square(q1 - target).mean()
                      + jnp.square(q2 - target).mean())

      q_loss, q_grads = jax.value_and_grad(q_loss_fn)(q_p)
      q_up, q_opt = self.q_tx.update(q_grads, q_opt, q_p)
      q_p = optax.apply_updates(q_p, q_up)

      # actor
      def a_loss_fn(ap):
        m, ls = self.actor.apply(ap, mb["obs"])
        a, logp = _sample_tanh(m, ls, k3)
        q1, q2 = self.q.apply(q_p, mb["obs"], a)
        return (alpha * logp - jnp.minimum(q1, q2)).mean(), logp

      (a_loss, logp), a_grads = jax.value_and_grad(
          a_loss_fn, has_aux=True)(a_p)
      a_up, a_opt = self.a_tx.update(a_grads, a_opt, a_p)
      a_p = optax.apply_updates(a_p, a_up)

      # temperature
      def al_loss_fn(la):
        return -(jnp.exp(la) * jax.lax.stop_gradient(
            logp + self.target_entropy)).mean()

      al_loss, al_grads = jax.value_and_grad(al_loss_fn)(log_alpha)
      al_up, al_opt = self.al_tx.update(al_grads, al_opt, log_alpha)
      log_alpha = optax.apply_updates(log_alpha, al_up)

      # polyak
      q_t = jax.tree.map(
          lambda t, s: (1 - cfg.tau) * t + cfg.tau * s, q_t, q_p)
      return (a_p, q_p, q_t, log_alpha, a_opt, q_opt, al_opt), dict(
          q_loss=q_loss, a_loss=a_loss, alpha=jnp.exp(log_alpha))

    keys = jax.random.split(k_samp, cfg.updates_per_step)
    carry0 = (ts.actor_params, ts.q_params, ts.q_target, ts.log_alpha,
              ts.actor_opt, ts.q_opt, ts.alpha_opt)
    carry1, metrics = jax.lax.scan(one_update, carry0, keys)
    # freeze updates until learning_starts env steps collected
    do_update = ts.steps >= cfg.learning_starts
    carry = jax.tree.map(
        lambda new, old: jnp.where(do_update, new, old), carry1, carry0)
    (a_p, q_p, q_t, log_alpha, a_opt, q_opt, al_opt) = carry

    new_ts = SACState(
        actor_params=a_p, q_params=q_p, q_target=q_t, log_alpha=log_alpha,
        actor_opt=a_opt, q_opt=q_opt, alpha_opt=al_opt,
        buffer=buf, buf_pos=buf_pos, buf_full=buf_full,
        env_state=nxt, key=key, steps=ts.steps + cfg.num_envs)
    out = dict(
        reward_mean=rew.mean(),
        q_loss=metrics["q_loss"].mean(),
        a_loss=metrics["a_loss"].mean(),
        alpha=metrics["alpha"][-1],
        buffer_size=size)
    return new_ts, out

  # ---- training loop -------------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None, writer=None,
            check_every: int = 50):
    """Non-finite losses abort with metrics.DivergenceError (checked every
    ``check_every`` iters — SAC iterations are single env steps, so a
    per-iteration host sync would serialize the device queue)."""
    from myosuite_mjx_tpu.train import metrics as metrics_mod
    step_fn = jax.jit(self.train_step)
    ts = self.init(seed)
    iters = max(1, total_env_steps // self.cfg.num_envs)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = step_fn(ts)
      sync = (progress is not None or writer is not None
              or (it + 1) % check_every == 0 or it == iters - 1)
      if sync:
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics_mod.check_finite(metrics, where=f"SAC iter {it}")
        metrics["wall"] = time.time() - t0
        metrics["env_steps"] = (it + 1) * self.cfg.num_envs
        if writer is not None:
          writer.write(metrics["env_steps"], metrics)
        if progress is not None:
          history.append(metrics)
          progress(it, metrics)
    return ts, history
