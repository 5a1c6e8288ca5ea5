"""Distributed runtime: mesh construction + sharded rollout/training.

The reference's only distributed machinery is brax's pmap data-parallelism
(max_devices_per_host=8, /root/reference/myosuite/mjx/ppo_continuous_action
.py:59) and SLURM job farming. Replacement (SURVEY.md §2.4):

* one ``Mesh`` over all GPUs (and hosts) with a single ``data`` axis — env
  batch sharded across it, learner params replicated,
* jit-with-shardings so XLA lowers gradient reductions to all-reduces,
  which it hands to NCCL over NVLink,
* ``jax.distributed.initialize`` for several hosts (one program, all
  hosts).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(devices=None) -> Mesh:
  """1-D mesh with a single ``data`` axis over all (or given) devices."""
  devices = devices if devices is not None else jax.devices()
  return Mesh(np.asarray(devices), ("data",))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
  """Multi-host initialization with explicit plumbing.

  Returns True when running (or now initialized) multi-process, False for
  plain single-host. Configuration comes from the arguments or the standard
  environment (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID,
  or a cluster runtime that auto-configures). Errors are raised, not
  swallowed: a mis-configured multi-host launch must fail loudly rather
  than train on one host silently.
  """
  import os
  if jax.process_count() > 1:
    return True  # already initialized by a prior call / runtime
  env_cfg = any(v in os.environ for v in (
      "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
  explicit = coordinator_address is not None
  if not env_cfg and not explicit and not (num_processes or 0) > 1:
    return False  # single host, nothing to do
  jax.distributed.initialize(
      coordinator_address=coordinator_address,
      num_processes=num_processes,
      process_id=process_id)
  return jax.process_count() > 1


def shard_env_batch(mesh: Mesh, tree):
  """Place a batched pytree with its leading axis split over ``data``."""
  sharding = NamedSharding(mesh, P("data"))
  return jax.tree.map(
      lambda x: jax.device_put(x, sharding) if hasattr(x, "ndim") and x.ndim
      else jax.device_put(x, NamedSharding(mesh, P())), tree)


def replicate(mesh: Mesh, tree):
  sharding = NamedSharding(mesh, P())
  return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


class ShardedPPO:
  """Data-parallel PPO: env batch sharded over the mesh, params replicated.

  Wraps train.ppo.PPO's pure train_step with explicit shardings; XLA inserts
  the psum for gradients (they contract the sharded batch axis into the
  replicated params) as an all-reduce across the cards.
  """

  def __init__(self, ppo, mesh: Mesh | None = None):
    self.ppo = ppo
    self.mesh = mesh or data_mesh()
    n = self.mesh.devices.size
    if ppo.cfg.num_envs % n:
      raise ValueError(
          f"num_envs={ppo.cfg.num_envs} not divisible by mesh size {n}")
    groups = min(ppo.cfg.data_groups, ppo.cfg.num_envs)
    if groups % n:
      raise ValueError(
          f"data_groups={groups} must be a multiple of the mesh size {n} "
          "so minibatch shuffles stay shard-local")

    def _prec(fn):
      def wrapped(*a):
        with jax.default_matmul_precision("highest"):
          return fn(*a)
      return wrapped

    self._step = jax.jit(_prec(ppo.train_step))

  def init(self, seed: int = 0):
    ts = self.ppo.init(seed)
    return self.place(ts)

  def place(self, ts):
    env_state = shard_env_batch(self.mesh, ts.env_state)
    ret_accum = shard_env_batch(self.mesh, ts.ret_accum)
    rest = replicate(
        self.mesh, (ts.params, ts.opt_state, ts.key, ts.steps,
                    ts.obs_norm, ts.ret_norm))
    params, opt_state, key, steps, obs_norm, ret_norm = rest
    return ts.replace(params=params, opt_state=opt_state,
                      env_state=env_state, key=key, steps=steps,
                      obs_norm=obs_norm, ret_norm=ret_norm,
                      ret_accum=ret_accum)

  def train_step(self, ts):
    return self._step(ts)


class ShardedNPG:
  """Data-parallel NPG: trajectories sharded over ``data``, learner
  replicated.

  NPG is full-batch, so the parallel structure is simpler than PPO's:
  every reduction in the update — the policy gradient, the KL
  Hessian-vector products inside CG, advantage statistics — contracts the
  sharded trajectory axis into replicated parameters, which XLA lowers to
  all-reduces across the cards. No shard-local minibatch bookkeeping is needed; the
  value-function fit's gathers are over a [N*T, obs] batch of a tiny MLP.
  """

  def __init__(self, npg, mesh: Mesh | None = None):
    self.npg = npg
    self.mesh = mesh or data_mesh()
    n = self.mesh.devices.size
    if npg.cfg.num_envs % n:
      raise ValueError(
          f"num_envs={npg.cfg.num_envs} not divisible by mesh size {n}")
    npg._mesh = self.mesh  # rollout pins the trajectory-axis sharding

    def _prec(fn):
      def wrapped(*a):
        with jax.default_matmul_precision("highest"):
          return fn(*a)
      return wrapped

    self._step = jax.jit(_prec(npg.train_step))

  def init(self, seed: int = 0):
    return self.place(self.npg.init(seed))

  def place(self, ts):
    rest = replicate(self.mesh, (ts.params, ts.vf_params, ts.vf_opt,
                                 ts.key, ts.steps, ts.obs_norm))
    params, vf_params, vf_opt, key, steps, obs_norm = rest
    return ts.replace(params=params, vf_params=vf_params, vf_opt=vf_opt,
                      key=key, steps=steps, obs_norm=obs_norm)

  def train_step(self, ts):
    return self._step(ts)

  def eval_step(self, ts, **kw):
    return self.npg.eval_step(ts, **kw)
