"""Natural Policy Gradient learner: the algorithm the reference's shipped
baselines were actually trained with.

The reference distributes NPG policies for every myobase task
(/root/reference/myosuite/agents/baslines_NPG/<env>/.../best_policy.pickle,
job configs alongside: policy (32,32), init_log_std -0.25, min_log_std
-1.0, gamma 0.995, GAE 0.97, normalized KL step 0.1, 96 trajectories and
1001 iterations per run — mjrl_job_script.py + NPG hydra configs). Its
training logs show the hand-pose plateau that defeats clipped-surrogate
PPO is escaped by natural-gradient steps within ~20 iterations (~200k
samples; logs/log.csv next to the pickles), which is why this trainer
exists here as a first-class algorithm and not just PPO.

Shape: everything — the vmapped trajectory rollout, GAE, the
conjugate-gradient solve of F^-1 g (Fisher-vector products as double
reverse-mode Hessian-vector products of the sampled KL), the KL-scaled
step, and the time-featured value-function fit — is one jitted
train_step on device. No host round-trips; the CG loop is a
lax.fori_loop over ravel_pytree-flattened parameter vectors.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
from myosuite_mjx_tpu.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu.train.ppo import RunningNorm, _gaussian_logp
from myosuite_mjx_tpu.utils import nn, pytree


class GaussianMLP:
  """mjrl-style policy: tanh MLP mean + per-dim learnable log_std with a
  floor (mjrl/policies/gaussian_mlp.py semantics: min_log_std clamp)."""

  def __init__(self, act_dim: int, hidden: tuple = (32, 32),
               init_log_std: float = -0.25, min_log_std: float = -1.0):
    self.act_dim = act_dim
    self.hidden = tuple(hidden)
    self.init_log_std = init_log_std
    self.min_log_std = min_log_std

  def init(self, key, obs):
    sizes = (obs.shape[-1],) + self.hidden + (self.act_dim,)
    return {"params": {
        **nn.mlp_init(key, sizes),
        "log_std": jnp.full((self.act_dim,), self.init_log_std, float)}}

  def apply(self, params, obs):
    p = params["params"]
    mean = nn.mlp(p, obs, len(self.hidden) + 1, jnp.tanh)
    return mean, jnp.maximum(p["log_std"], self.min_log_std)


class ValueMLP:
  """Baseline with mjrl MLPBaseline's engineered time features
  (mjrl/baselines/mlp_baseline.py): obs, obs^2-style nonlinearity is left
  to the MLP, but the normalized-time polynomial [t, t^2, t^3] is
  appended explicitly — with MC returns and no horizon bootstrap, the
  baseline must be able to represent the remaining-time value ramp."""

  def __init__(self, hidden: tuple = (128, 128)):
    self.hidden = tuple(hidden)

  def init(self, key, obs, tfrac):
    sizes = (obs.shape[-1] + 3,) + self.hidden + (1,)
    return {"params": nn.mlp_init(key, sizes)}

  def apply(self, params, obs, tfrac):
    t = jnp.stack([tfrac, tfrac ** 2, tfrac ** 3], axis=-1)
    x = jnp.concatenate([obs, t], axis=-1)
    return nn.mlp(params["params"], x, len(self.hidden) + 1,
                  jax.nn.relu)[..., 0]


@dataclasses.dataclass(frozen=True)
class NPGConfig:
  num_envs: int = 96            # trajectories per iteration (rl_num_traj)
  step_size: float = 0.1        # normalized KL step (rl_step_size)
  gamma: float = 0.995
  gae_lambda: float = 0.97
  cg_iters: int = 10
  cg_damping: float = 1e-4
  hidden: tuple = (32, 32)
  init_log_std: float = -0.25
  min_log_std: float = -1.0
  vf_hidden: tuple = (128, 128)
  vf_epochs: int = 2
  vf_batch_size: int = 64
  vf_learning_rate: float = 1e-3
  normalize_obs: bool = True
  norm_clip: float = 10.0


@pytree.dataclass
class NPGState:
  params: Any
  vf_params: Any
  vf_opt: Any
  key: jax.Array
  steps: jax.Array
  obs_norm: RunningNorm


class NPG:
  """NPG trainer bound to a MyoEnv; full-episode trajectory sampling."""

  def __init__(self, env: MyoEnv, config: NPGConfig = NPGConfig()):
    self.env = env
    self.cfg = config
    self.horizon = int(env.horizon)
    self.net = GaussianMLP(
        act_dim=getattr(env, "action_dim", env.model.nu),
        hidden=config.hidden, init_log_std=config.init_log_std,
        min_log_std=config.min_log_std)
    self.vf = ValueMLP(hidden=config.vf_hidden)
    self.vf_tx = optax.adam(config.vf_learning_rate)

  # ---- initialization ---------------------------------------------------

  def init(self, seed: int = 0) -> NPGState:
    key = jax.random.PRNGKey(seed)
    key, k_net, k_vf = jax.random.split(key, 3)
    obs_dim = int(np.prod(jax.eval_shape(
        self.env.reset, key).obs.shape))
    params = self.net.init(k_net, jnp.zeros((obs_dim,)))
    vf_params = self.vf.init(k_vf, jnp.zeros((obs_dim,)), jnp.zeros(()))
    return NPGState(params=params, vf_params=vf_params,
                    vf_opt=self.vf_tx.init(vf_params), key=key,
                    steps=jnp.zeros((), jnp.int32),
                    obs_norm=RunningNorm.create(obs_dim))

  # ---- one training iteration ------------------------------------------

  def train_step(self, ts: NPGState) -> tuple[NPGState, dict]:
    cfg = self.cfg
    env = self.env
    T = self.horizon
    N = cfg.num_envs

    # ---- rollout: N fresh episodes of T steps (mjrl trajectory mode) ----
    def rollout_body(carry, t):
      st, live, key = carry
      key, k_act = jax.random.split(key)
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, log_std = self.net.apply(ts.params, obs)
      act = mean + jnp.exp(log_std) * jax.random.normal(
          k_act, mean.shape)
      logp = _gaussian_logp(mean, log_std, act)
      nxt = jax.vmap(env.step)(st, jnp.clip(act, -1.0, 1.0))
      tr = dict(obs=obs, obs_raw=st.obs, act=act, logp=logp,
                reward=nxt.info["rwd_dense"] * live,
                live=live,
                tfrac=jnp.full((N,), t / T),
                solved=nxt.info["solved"].astype(jnp.float32) * live)
      live = live * (1.0 - nxt.done.astype(jnp.float32))
      return (nxt, live, key), tr

    key, k_reset, k_roll = jax.random.split(ts.key, 3)
    st0 = jax.vmap(env.reset)(jax.random.split(k_reset, N))
    # Under ShardedNPG (parallel/mesh.py) nothing in NPGState carries a
    # data sharding — episodes restart fresh each iteration — so the
    # trajectory axis must be pinned here for XLA to distribute the
    # rollout; reductions then all-reduce into the replicated learner.
    mesh = getattr(self, "_mesh", None)
    if mesh is not None:
      from jax.sharding import NamedSharding, PartitionSpec
      sh = NamedSharding(mesh, PartitionSpec("data"))
      st0 = jax.tree.map(
          lambda x: jax.lax.with_sharding_constraint(x, sh)
          if getattr(x, "ndim", 0) >= 1 else x, st0)
    (_, _, _), traj = jax.lax.scan(
        rollout_body, (st0, jnp.ones((N,)), k_roll), jnp.arange(T))

    obs_norm = (ts.obs_norm.update(traj["obs_raw"])
                if cfg.normalize_obs else ts.obs_norm)

    # ---- GAE with the time-featured baseline; no bootstrap past the
    # horizon (mjrl treats truncation as absorbing; the vf's time
    # features absorb the ramp) ----
    values = self.vf.apply(ts.vf_params, traj["obs"], traj["tfrac"])
    values = values * traj["live"]

    def gae_body(carry, t):
      gae = carry
      next_v = jnp.where(t + 1 < T, values[(t + 1) % T], 0.0)
      delta = (traj["reward"][t] + cfg.gamma * next_v - values[t])
      gae = delta + cfg.gamma * cfg.gae_lambda * gae * traj["live"][t]
      return gae, gae

    _, advs = jax.lax.scan(gae_body, jnp.zeros((N,)),
                           jnp.arange(T - 1, -1, -1))
    advs = advs[::-1] * traj["live"]
    # MC-style regression targets for the baseline
    returns = advs + values
    # standardize advantages over the full batch (mjrl compute_advantages
    # normalize=True)
    advs = (advs - advs.mean()) / (advs.std() + 1e-6)
    advs = advs * traj["live"]

    flat_obs = traj["obs"].reshape(N * T, -1)
    flat_act = traj["act"].reshape(N * T, -1)
    flat_logp = traj["logp"].reshape(N * T)
    flat_adv = advs.reshape(N * T)
    flat_live = traj["live"].reshape(N * T)
    flat_tfrac = traj["tfrac"].reshape(N * T)
    flat_ret = returns.reshape(N * T)

    # ---- natural gradient: CG solve of (F + damping I) x = g ----
    theta0, unravel = jax.flatten_util.ravel_pytree(ts.params)

    def surrogate(theta):
      p = unravel(theta)
      mean, log_std = self.net.apply(p, flat_obs)
      logp = _gaussian_logp(mean, log_std, flat_act)
      lr = jnp.exp(logp - flat_logp)
      return jnp.sum(lr * flat_adv * flat_live) / jnp.maximum(
          flat_live.sum(), 1.0)

    g = jax.grad(surrogate)(theta0)

    mean0, log_std0 = self.net.apply(ts.params, flat_obs)
    mean0 = jax.lax.stop_gradient(mean0)
    log_std0 = jax.lax.stop_gradient(log_std0)

    def mean_kl(theta):
      """KL(pi_old || pi_theta) averaged over sampled states."""
      p = unravel(theta)
      mean, log_std = self.net.apply(p, flat_obs)
      var0, var = jnp.exp(2 * log_std0), jnp.exp(2 * log_std)
      kl = jnp.sum(
          log_std - log_std0
          + (var0 + jnp.square(mean0 - mean)) / (2.0 * var) - 0.5,
          axis=-1)
      return jnp.sum(kl * flat_live) / jnp.maximum(flat_live.sum(), 1.0)

    kl_grad = jax.grad(mean_kl)

    def fvp(v):
      # Hessian-vector product of the mean KL == Fisher-vector product at
      # theta0; double reverse-mode via grad of (grad . v)
      return jax.grad(lambda th: jnp.vdot(kl_grad(th), v))(theta0) \
          + cfg.cg_damping * v

    def cg_body(_, carry):
      x, r, p, rr = carry
      fp = fvp(p)
      alpha = rr / jnp.maximum(jnp.vdot(p, fp), 1e-12)
      x = x + alpha * p
      r = r - alpha * fp
      rr_new = jnp.vdot(r, r)
      p = r + (rr_new / jnp.maximum(rr, 1e-12)) * p
      return (x, r, p, rr_new)

    x0 = jnp.zeros_like(g)
    x, _, _, _ = jax.lax.fori_loop(
        0, cfg.cg_iters, cg_body, (x0, g, g, jnp.vdot(g, g)))

    # KL-normalized step: alpha = sqrt(2 * delta / (g^T F^-1 g))
    gHg = jnp.maximum(jnp.vdot(g, x), 1e-12)
    alpha = jnp.sqrt(2.0 * cfg.step_size / gHg)
    theta_new = theta0 + alpha * x
    params = unravel(theta_new)

    # ---- value-function fit (Adam minibatch epochs on MC targets) ----
    def vf_loss(vp, o, tf, r, w):
      v = self.vf.apply(vp, o, tf)
      return jnp.sum(w * jnp.square(v - r)) / jnp.maximum(w.sum(), 1.0)

    n_mb = max(1, (N * T) // cfg.vf_batch_size)

    def vf_epoch(carry, k):
      vp, vo = carry
      perm = jax.random.permutation(k, N * T)

      def mb_body(c, i):
        vp, vo = c
        idx = jax.lax.dynamic_slice_in_dim(
            perm, i * cfg.vf_batch_size, cfg.vf_batch_size)
        loss, grads = jax.value_and_grad(vf_loss)(
            vp, flat_obs[idx], flat_tfrac[idx], flat_ret[idx],
            flat_live[idx])
        up, vo = self.vf_tx.update(grads, vo, vp)
        return (optax.apply_updates(vp, up), vo), loss

      (vp, vo), losses = jax.lax.scan(mb_body, (vp, vo),
                                      jnp.arange(n_mb))
      return (vp, vo), losses.mean()

    key, k_vf = jax.random.split(key)
    (vf_params, vf_opt), vf_losses = jax.lax.scan(
        vf_epoch, (ts.vf_params, ts.vf_opt),
        jax.random.split(k_vf, cfg.vf_epochs))

    ep_ret = traj["reward"].sum(0)           # [N] episode returns
    metrics = dict(
        stoc_pol_mean=ep_ret.mean(),
        reward_mean=(traj["reward"].sum()
                     / jnp.maximum(traj["live"].sum(), 1.0)),
        solved_frac=(traj["solved"].sum()
                     / jnp.maximum(traj["live"].sum(), 1.0)),
        kl_step_alpha=alpha,
        vf_loss=vf_losses.mean(),
        grad_norm=jnp.linalg.norm(g),
    )
    new_ts = NPGState(params=params, vf_params=vf_params, vf_opt=vf_opt,
                      key=key, steps=ts.steps + N * T,
                      obs_norm=obs_norm)
    return new_ts, metrics

  # ---- evaluation -------------------------------------------------------

  def eval_step(self, ts: NPGState, num_envs: int = 32) -> dict:
    """Deterministic-policy fresh-episode eval; reference
    evaluate_success contract (env_base.py:744-770): an episode succeeds
    when solved on more than 5 steps."""
    cfg = self.cfg
    env = self.env

    def body(carry, _):
      st, cnt, rew = carry
      obs = (ts.obs_norm.apply(st.obs, cfg.norm_clip)
             if cfg.normalize_obs else st.obs)
      mean, _ = self.net.apply(ts.params, obs)
      nxt = jax.vmap(env.step)(st, jnp.clip(mean, -1.0, 1.0))
      cnt = cnt + nxt.info["solved"].astype(jnp.float32)
      rew = rew + nxt.info["rwd_dense"]
      return (nxt, cnt, rew), nxt.info["solved"].astype(jnp.float32)

    eval_key = jax.random.fold_in(
        jax.random.fold_in(ts.key, 0x45564C), ts.steps.astype(jnp.uint32))
    st0 = jax.vmap(env.reset)(jax.random.split(eval_key, num_envs))
    zeros = jnp.zeros((num_envs,))
    (_, cnt, rew), solved = jax.lax.scan(
        body, (st0, zeros, zeros), (), length=self.horizon)
    return dict(
        eval_solved_frac=solved.mean(),
        eval_success=(cnt > 5.0).mean(),
        eval_score=rew.mean(),
    )

  # ---- training loop ----------------------------------------------------

  def train(self, total_env_steps: int, seed: int = 0,
            progress: Callable | None = None,
            eval_every: int = 0, writer=None):
    from myosuite_mjx_tpu.train import metrics as metrics_mod
    cfg = self.cfg

    def _prec(fn):
      def wrapped(*a):
        with jax.default_matmul_precision("highest"):
          return fn(*a)
      return wrapped

    step_fn = jax.jit(_prec(self.train_step))
    eval_fn = jax.jit(_prec(functools.partial(self.eval_step)))
    ts = self.init(seed)
    per_iter = cfg.num_envs * self.horizon
    iters = max(1, total_env_steps // per_iter)
    history = []
    t0 = time.time()
    for it in range(iters):
      ts, metrics = step_fn(ts)
      if eval_every and ((it + 1) % eval_every == 0 or it == iters - 1):
        metrics = {**metrics, **eval_fn(ts)}
      metrics = {k: float(v) for k, v in metrics.items()}
      metrics_mod.check_finite(metrics, where=f"NPG iter {it}")
      metrics["wall"] = time.time() - t0
      metrics["env_steps"] = (it + 1) * per_iter
      metrics["steps_per_s"] = round(
          (it + 1) * per_iter / max(metrics["wall"], 1e-9), 1)
      history.append(metrics)
      if writer is not None:
        writer.write(metrics["env_steps"], metrics)
      if progress is not None:
        progress(it, metrics)
    return ts, history
