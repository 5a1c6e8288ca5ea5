"""PPO learner: on-device rollout + clipped-surrogate updates.

In-repo replacement for the reference's external trainers — brax PPO
(/root/reference/myosuite/mjx/ppo_continuous_action.py:27-67) and SB3 PPO
(/root/reference/myosuite/agents/sb3_job_script.py:31-131). Defaults follow
the reference configs: MLP [256, 128] policy/value (hydra_myo_sb3_ppo_config
.yaml:30-33), brax-style num_envs/unroll/minibatch layout.

Everything — rollout (lax.scan over the batched env), GAE, minibatch SGD —
lives in one jitted train_step. Multi-chip: shard the env batch over a
``data`` mesh axis (see parallel/mesh.py); gradients all-reduce across cards
automatically under jit-with-shardings.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from myosuite_mjx_tpu.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu.utils import nn, pytree


class ActorCritic:
  """Tanh-MLP actor-critic with state-independent log-std.

  init/min log-std follow the reference NPG job config that solves the
  hand-scale pose tasks (agents/baslines_NPG/.../job_config.yaml:
  init_log_std -0.25, min_log_std -1.0): the floor prevents the
  exploration collapse that stalls muscle-space policies.

  Parameter layout: actor ``Dense_0..Dense_L`` (L = len(hidden)), then
  ``log_std``, then the value tower ``Dense_{L+1}..``.
  """

  def __init__(self, act_dim: int, hidden: tuple = (256, 128),
               init_log_std: float = -0.5, min_log_std: float = -jnp.inf):
    self.act_dim = act_dim
    self.hidden = tuple(hidden)
    self.init_log_std = init_log_std
    self.min_log_std = min_log_std

  def init(self, key, obs):
    sizes = (obs.shape[-1],) + self.hidden
    n = len(self.hidden) + 1
    p = {**nn.mlp_init(key, sizes + (self.act_dim,)),
         **nn.mlp_init(key, sizes + (1,), first=n),
         "log_std": jnp.full((self.act_dim,), self.init_log_std, float)}
    return {"params": p}

  def apply(self, params, obs):
    p = params["params"]
    n = len(self.hidden) + 1
    mean = nn.mlp(p, obs, n, jnp.tanh)
    log_std = jnp.maximum(p["log_std"], self.min_log_std)
    value = nn.mlp(p, obs, n, jnp.tanh, first=n)[..., 0]
    return mean, log_std, value


@dataclasses.dataclass(frozen=True)
class PPOConfig:
  num_envs: int = 128
  unroll_length: int = 50
  num_minibatches: int = 32
  update_epochs: int = 8
  learning_rate: float = 3e-4
  gamma: float = 0.99
  gae_lambda: float = 0.95
  clip_eps: float = 0.2
  vf_coef: float = 0.5
  ent_coef: float = 0.0
  max_grad_norm: float = 0.5
  hidden: tuple = (256, 128)
  # envs are split into this many groups; shuffling/minibatching is
  # group-local so that on a data mesh whose size divides data_groups every
  # gather stays on-shard (no cross-chip all-gather per minibatch) — the
  # single-device program is identical math, so sharded == single holds
  data_groups: int = 8
  # SB3 VecNormalize parity (reference agents/sb3_job_script.py:49-56):
  # running obs standardization and return-scaled reward normalization
  # exploration-noise floor + init (reference NPG hand-pose recipe,
  # agents/baslines_NPG job_config.yaml) — min_log_std > -inf guards
  # against the std collapsing before the task is explored
  init_log_std: float = -0.5
  min_log_std: float = -jnp.inf
  normalize_obs: bool = True
  normalize_reward: bool = True
  norm_clip: float = 10.0


@pytree.dataclass
class RunningNorm:
  """Welford-merged running mean/var (VecNormalize semantics)."""
  mean: jax.Array
  var: jax.Array
  count: jax.Array

  @classmethod
  def create(cls, dim: int | tuple = ()):
    shape = (dim,) if isinstance(dim, int) else dim
    return cls(mean=jnp.zeros(shape), var=jnp.ones(shape),
               count=jnp.asarray(1e-4))

  def update(self, batch: jax.Array) -> "RunningNorm":
    flat = batch.reshape((-1,) + self.mean.shape)
    bmean = flat.mean(axis=0)
    bvar = flat.var(axis=0)
    bcount = flat.shape[0]
    delta = bmean - self.mean
    tot = self.count + bcount
    new_mean = self.mean + delta * bcount / tot
    m2 = (self.var * self.count + bvar * bcount
          + delta * delta * self.count * bcount / tot)
    return RunningNorm(mean=new_mean, var=m2 / tot, count=tot)

  def apply(self, x: jax.Array, clip: float = 10.0) -> jax.Array:
    return jnp.clip((x - self.mean) / jnp.sqrt(self.var + 1e-8),
                    -clip, clip)


@pytree.dataclass
class TrainState:
  params: Any
  opt_state: Any
  env_state: EnvState       # batched [num_envs]
  key: jax.Array
  steps: jax.Array          # total env steps
  obs_norm: RunningNorm
  ret_norm: RunningNorm     # running var of discounted returns
  ret_accum: jax.Array      # [num_envs] running discounted return


def _gaussian_logp(mean, log_std, action):
  var = jnp.exp(2 * log_std)
  return jnp.sum(
      -0.5 * ((action - mean) ** 2 / var + 2 * log_std + jnp.log(2 * jnp.pi)),
      axis=-1)


class PPO:
  """PPO trainer bound to a MyoEnv."""

  def __init__(self, env: MyoEnv, config: PPOConfig = PPOConfig()):
    self.env = env
    self.cfg = config
    self.net = ActorCritic(act_dim=getattr(env, "action_dim", env.model.nu),
                           hidden=config.hidden,
                           init_log_std=config.init_log_std,
                           min_log_std=config.min_log_std)
    self.tx = optax.chain(
        optax.clip_by_global_norm(config.max_grad_norm),
        optax.adam(config.learning_rate),
    )

  # ---- initialization ----------------------------------------------------

  def init(self, seed: int = 0) -> TrainState:
    key = jax.random.PRNGKey(seed)
    key, k_net, k_env = jax.random.split(key, 3)
    obs_dim = int(np.prod(jax.eval_shape(
        self.env.reset, key).obs.shape))
    params = self.net.init(k_net, jnp.zeros((obs_dim,)))
    opt_state = self.tx.init(params)
    env_keys = jax.random.split(k_env, self.cfg.num_envs)
    env_state = jax.vmap(self.env.reset)(env_keys)
    return TrainState(params=params, opt_state=opt_state,
                      env_state=env_state, key=key,
                      steps=jnp.zeros((), jnp.int64)
                      if jax.config.jax_enable_x64
                      else jnp.zeros((), jnp.int32),
                      obs_norm=RunningNorm.create(obs_dim),
                      ret_norm=RunningNorm.create(()),
                      ret_accum=jnp.zeros((self.cfg.num_envs,)))

  # ---- one training iteration -------------------------------------------

  def train_step(self, ts: TrainState) -> tuple[TrainState, dict]:
    cfg = self.cfg
    env = self.env

    def policy_sample(params, obs, key):
      mean, log_std, value = self.net.apply(params, obs)
      act = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
      logp = _gaussian_logp(mean, log_std, act)
      return act, logp, value

    # ---- rollout: scan T steps of the vmapped env ----
    def rollout_body(carry, _):
      env_state, ret_accum, key = carry
      key, k_act = jax.random.split(key)
      obs_raw = env_state.obs
      obs = (ts.obs_norm.apply(obs_raw, cfg.norm_clip)
             if cfg.normalize_obs else obs_raw)
      act, logp, value = policy_sample(ts.params, obs, k_act)
      act_clipped = jnp.clip(act, -1.0, 1.0)
      nxt = jax.vmap(env.autoreset_step)(env_state, act_clipped)
      reward = nxt.info["rwd_dense"]
      done = (nxt.info["terminated"]
              | nxt.info["truncated"]).astype(jnp.float32)
      # running discounted return (VecNormalize reward scaling statistic):
      # accumulate first so the terminal discounted return enters the
      # variance estimate (SB3 computes returns = returns*gamma + reward,
      # updates stats, then zeroes at done), mask for the carry after
      ret_accum = ret_accum * cfg.gamma + reward
      transition = dict(
          obs=obs, obs_raw=obs_raw, act=act, logp=logp, value=value,
          reward=reward, ret_accum=ret_accum, done=done,
          solved=nxt.info["solved"].astype(jnp.float32),
      )
      return (nxt, ret_accum * (1.0 - done), key), transition

    key, k_roll = jax.random.split(ts.key)
    (env_state, ret_accum, _), traj = jax.lax.scan(
        rollout_body, (ts.env_state, ts.ret_accum, k_roll), (),
        length=cfg.unroll_length)

    # ---- normalization statistics (applied from the next rollout on) ----
    obs_norm = (ts.obs_norm.update(traj["obs_raw"])
                if cfg.normalize_obs else ts.obs_norm)
    ret_norm = (ts.ret_norm.update(traj["ret_accum"])
                if cfg.normalize_reward else ts.ret_norm)
    if cfg.normalize_reward:
      traj["reward"] = jnp.clip(
          traj["reward"] / jnp.sqrt(ts.ret_norm.var + 1e-8),
          -cfg.norm_clip, cfg.norm_clip)

    # ---- GAE ----
    last_obs = (ts.obs_norm.apply(env_state.obs, cfg.norm_clip)
                if cfg.normalize_obs else env_state.obs)
    _, _, last_value = self.net.apply(ts.params, last_obs)

    def gae_body(carry, t):
      gae, next_value = carry
      delta = (traj["reward"][t] + cfg.gamma * next_value
               * (1 - traj["done"][t]) - traj["value"][t])
      gae = delta + cfg.gamma * cfg.gae_lambda * (1 - traj["done"][t]) * gae
      return (gae, traj["value"][t]), gae

    T = cfg.unroll_length
    (_, _), advs = jax.lax.scan(
        gae_body, (jnp.zeros_like(last_value), last_value),
        jnp.arange(T - 1, -1, -1))
    advs = advs[::-1]
    returns = advs + traj["value"]

    # ---- flatten batch: group-major [G, ng, ...] (env axis stays leading
    # so the data sharding carries through; shuffles below are group-local)
    G = min(cfg.data_groups, cfg.num_envs)
    if cfg.num_envs % G:
      raise ValueError(f"num_envs={cfg.num_envs} not divisible by "
                       f"data_groups={G}")
    ng = (cfg.num_envs // G) * T
    # largest minibatch count compatible with the group size (== requested
    # for the default 128x50/8-group layout; shrinks gracefully for smoke
    # configs — with a visible warning, since it changes the effective
    # minibatch size and therefore optimization dynamics)
    import math
    num_minibatches = math.gcd(ng, cfg.num_minibatches)
    if num_minibatches != cfg.num_minibatches:
      import warnings
      warnings.warn(
          f"num_minibatches adjusted {cfg.num_minibatches} -> "
          f"{num_minibatches}: group size {ng} (num_envs/data_groups * "
          f"unroll) is not divisible by the requested count",
          stacklevel=2)

    def flat(x):
      x = jnp.moveaxis(x, 0, 1)                    # [B, T, ...]
      return x.reshape((G, ng) + x.shape[2:])

    batch = dict(
        obs=flat(traj["obs"]), act=flat(traj["act"]),
        logp=flat(traj["logp"]), adv=flat(advs), ret=flat(returns),
        value=flat(traj["value"]))

    # ---- minibatch updates (each minibatch spans all groups: every shard
    # contributes its local slice, gradients all-reduce across cards) ----
    def loss_fn(params, mb):
      mean, log_std, value = self.net.apply(params, mb["obs"])
      logp = _gaussian_logp(mean, log_std, mb["act"])
      ratio = jnp.exp(logp - mb["logp"])
      adv = (mb["adv"] - mb["adv"].mean()) / (mb["adv"].std() + 1e-8)
      pg1 = ratio * adv
      pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
      pg_loss = -jnp.minimum(pg1, pg2).mean()
      v_loss = 0.5 * jnp.square(value - mb["ret"]).mean()
      ent = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
      loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
      return loss, dict(pg_loss=pg_loss, v_loss=v_loss)

    mb_size = ng // num_minibatches

    def epoch_body(carry, _):
      params, opt_state, key = carry
      key, k_perm = jax.random.split(key)
      # independent within-group permutations: gathers stay shard-local
      perms = jax.vmap(lambda k: jax.random.permutation(k, ng))(
          jax.random.split(k_perm, G))             # [G, ng]

      def shuffle(v):
        idx = perms.reshape((G, ng) + (1,) * (v.ndim - 2))
        return jnp.take_along_axis(v, idx, axis=1)

      shuf = {k: shuffle(v) for k, v in batch.items()}

      def mb_body(carry, i):
        params, opt_state = carry
        mb = {k: jax.lax.dynamic_slice_in_dim(v, i * mb_size, mb_size,
                                              axis=1)
              for k, v in shuf.items()}
        (loss, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, mb)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

      (params, opt_state), losses = jax.lax.scan(
          mb_body, (params, opt_state), jnp.arange(num_minibatches))
      return (params, opt_state, key), losses.mean()

    (params, opt_state, key), losses = jax.lax.scan(
        epoch_body, (ts.params, ts.opt_state, key), (),
        length=cfg.update_epochs)

    metrics = dict(
        loss=losses.mean(),
        reward_mean=traj["reward"].mean(),
        solved_frac=traj["solved"].mean(),
    )
    new_ts = TrainState(
        params=params, opt_state=opt_state, env_state=env_state, key=key,
        steps=ts.steps + T * cfg.num_envs,
        obs_norm=obs_norm, ret_norm=ret_norm, ret_accum=ret_accum)
    return new_ts, metrics

  # ---- evaluation -----------------------------------------------------

  def eval_step(self, ts: TrainState, num_episodes_steps: int = 100,
                num_envs: int = 32) -> dict:
    """Deterministic-policy evaluation: mean action, fresh envs.

    Returns solved_frac (mean over steps), episode return mean, and the
    success rate at episode ends — the reference's evaluate_success
    contract (env_base.py:744-770) over on-device rollouts.
    """
    cfg = self.cfg
    env = self.env

    def body(carry, _):
      st, cnt, succ, eps = carry
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, _, _ = self.net.apply(ts.params, obs)
      nxt = jax.vmap(env.autoreset_step)(st, jnp.clip(mean, -1.0, 1.0))
      solved = nxt.info["solved"].astype(jnp.float32)
      done = (nxt.info["terminated"]
              | nxt.info["truncated"]).astype(jnp.float32)
      # reference evaluate_success (env_base.py:744-770): an episode
      # succeeds when solved on MORE than `successful_steps`(=5) steps
      cnt = cnt + solved
      succ = succ + done * (cnt > 5.0)
      eps = eps + done
      cnt = cnt * (1.0 - done)
      out = dict(reward=nxt.info["rwd_dense"], solved=solved, done=done)
      return (nxt, cnt, succ, eps), out

    # dedicated eval stream: fold a tag + the step counter into ts.key so
    # eval episodes are decorrelated from the training rollout streams
    # (which split ts.key directly) and differ across eval points
    eval_key = jax.random.fold_in(
        jax.random.fold_in(ts.key, 0x45564C), ts.steps.astype(jnp.uint32))
    keys = jax.random.split(eval_key, num_envs)
    st0 = jax.vmap(env.reset)(keys)
    zeros = jnp.zeros((num_envs,))
    (_, _, succ, eps), tr = jax.lax.scan(
        body, (st0, zeros, zeros, zeros), (), length=num_episodes_steps)
    episodes = jnp.maximum(tr["done"].sum(), 1.0)
    return dict(
        eval_solved_frac=tr["solved"].mean(),
        eval_success=succ.sum() / jnp.maximum(eps.sum(), 1.0),
        eval_reward_mean=tr["reward"].mean(),
        eval_episodes=episodes,
    )

  # ---- training loop -----------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None,
            eval_every: int = 0,
            writer=None):
    """Run training; returns (TrainState, list of metric dicts).

    eval_every > 0 runs a deterministic-policy eval_step every that many
    iterations and merges its metrics into the history. ``writer`` is an
    optional metrics.MetricsWriter. Non-finite losses abort with
    metrics.DivergenceError instead of silently corrupting the run.
    """
    from myosuite_mjx_tpu.train import metrics as metrics_mod
    cfg = self.cfg

    def _prec(fn):
      def wrapped(*a):
        with jax.default_matmul_precision("highest"):
          return fn(*a)
      return wrapped

    step_fn = jax.jit(_prec(self.train_step))
    eval_fn = jax.jit(_prec(functools.partial(
        self.eval_step, num_episodes_steps=min(self.env.horizon * 2, 200))))
    ts = self.init(seed)
    per_iter = cfg.unroll_length * cfg.num_envs
    iters = max(1, total_env_steps // per_iter)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = step_fn(ts)
      if eval_every and ((it + 1) % eval_every == 0 or it == iters - 1):
        metrics = {**metrics, **eval_fn(ts)}
      metrics = {k: float(v) for k, v in metrics.items()}
      metrics_mod.check_finite(metrics, where=f"PPO iter {it}")
      metrics["wall"] = time.time() - t0
      metrics["env_steps"] = (it + 1) * per_iter
      metrics["steps_per_s"] = round((it + 1) * per_iter
                                     / max(metrics["wall"], 1e-9), 1)
      history.append(metrics)
      if writer is not None:
        writer.write(metrics["env_steps"], metrics)
      if progress is not None:
        progress(it, metrics)
    return ts, history
