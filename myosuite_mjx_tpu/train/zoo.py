"""Pretrained-policy zoo: self-contained policy snapshots + loader.

Capability parity with the reference's trained-baselines distribution
(/root/reference/myosuite/agents/__init__.py + sb3 zoo pickles consumed by
utils/examine_env.py --policy_path): a snapshot carries everything needed
to act — network params, architecture, and the observation-normalization
statistics the policy was trained under (without which a VecNormalize-
style policy is garbage at inference) — as one pickle of numpy arrays,
loadable with no trainer state.

Zoo layout: ``train_artifacts/zoo/<env_id>.pkl``; ``load_baseline`` looks
up snapshots by registered env ID. Checked-in snapshots are produced by
``save_snapshot`` from a live ``PPO`` trainer + ``TrainState``.
"""
from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

# Zoo location: env-var override first (mirrors MYOSUITE_TPU_ASSETS) so an
# installed (site-packages) copy of the package can still find a checked-out
# or downloaded zoo; default is the repo-layout path relative to this file.
ZOO_DIR = os.environ.get(
    "MYOSUITE_TPU_ZOO",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "train_artifacts", "zoo"))


def save_snapshot(path: str, ppo, ts, env_id: str) -> dict:
  """Freeze a PPO TrainState into a self-contained policy snapshot."""
  snap = {
      "format": "myosuite_mjx_tpu/policy-v1",
      "env_id": env_id,
      "act_dim": int(ppo.net.act_dim),
      "hidden": tuple(ppo.cfg.hidden),
      "normalize_obs": bool(ppo.cfg.normalize_obs),
      "norm_clip": float(ppo.cfg.norm_clip),
      "params": jax.tree.map(np.asarray, ts.params),
      "obs_mean": np.asarray(ts.obs_norm.mean),
      "obs_var": np.asarray(ts.obs_norm.var),
      "env_steps": int(ts.steps),
  }
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "wb") as f:
    pickle.dump(snap, f)
  return snap


def save_npg_snapshot(path: str, npg, ts, env_id: str) -> dict:
  """Freeze an NPG NPGState into a policy-mlp-v1 snapshot: the GaussianMLP
  mean path becomes explicit (W, b) layers and the running obs
  normalization folds into in_shift/in_scale (with the trainer's ±clip
  recorded as in_clip)."""
  dense = ts.params["params"]
  names = sorted((k for k in dense if k.startswith("Dense_")),
                 key=lambda s: int(s.split("_")[1]))
  layers = [(np.asarray(dense[n]["kernel"]), np.asarray(dense[n]["bias"]))
            for n in names]
  obs_dim = layers[0][0].shape[0]
  if npg.cfg.normalize_obs:
    in_shift = np.asarray(ts.obs_norm.mean)
    in_scale = np.sqrt(np.asarray(ts.obs_norm.var) + 1e-8)
  else:
    in_shift = np.zeros(obs_dim)
    in_scale = np.ones(obs_dim)
  snap = save_mlp_snapshot(
      path, env_id, layers, in_shift, in_scale,
      out_shift=np.zeros(layers[-1][0].shape[1]),
      out_scale=np.ones(layers[-1][0].shape[1]),
      nonlinearity="tanh", source=f"npg@{int(ts.steps)}steps",
      in_clip=float(npg.cfg.norm_clip))
  return snap


def save_mlp_snapshot(path: str, env_id: str, layers: list,
                      in_shift, in_scale, out_shift, out_scale,
                      nonlinearity: str = "tanh",
                      source: str | None = None,
                      in_clip: float | None = None) -> dict:
  """Freeze a plain feedforward policy (e.g. weights imported from a
  reference mjrl/NPG pickle) into a zoo snapshot.

  ``layers`` is a list of (W, b) with W of shape [in, out]; the forward
  pass is the mjrl FCNetwork contract (mjrl/utils/fc_network.py semantics,
  consumed by the reference's examine_env --policy_path rollouts):
  ``h = (obs - in_shift) / (in_scale + 1e-8)`` through hidden
  nonlinearities, then ``out * out_scale + out_shift``.
  """
  snap = {
      "format": "myosuite_mjx_tpu/policy-mlp-v1",
      "env_id": env_id,
      "layers": [(np.asarray(w, np.float32), np.asarray(b, np.float32))
                 for w, b in layers],
      "in_shift": np.asarray(in_shift, np.float32),
      "in_scale": np.asarray(in_scale, np.float32),
      "out_shift": np.asarray(out_shift, np.float32),
      "out_scale": np.asarray(out_scale, np.float32),
      "nonlinearity": nonlinearity,
      "source": source or "",
      "in_clip": in_clip,
  }
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "wb") as f:
    pickle.dump(snap, f)
  return snap


class Policy:
  """Deterministic inference policy from a snapshot: obs -> action.

  ``act`` is a pure jittable function of the observation (normalization
  folded in), so it vmaps over batched envs.
  """

  def __init__(self, snap: dict):
    self.snap = snap
    self.env_id = snap["env_id"]
    self._fmt = snap.get("format", "myosuite_mjx_tpu/policy-v1")
    if self._fmt == "myosuite_mjx_tpu/policy-mlp-v1":
      self._layers = [(jnp.asarray(w), jnp.asarray(b))
                      for w, b in snap["layers"]]
      self._in_shift = jnp.asarray(snap["in_shift"])
      self._in_scale = jnp.asarray(snap["in_scale"])
      self._out_shift = jnp.asarray(snap["out_shift"])
      self._out_scale = jnp.asarray(snap["out_scale"])
      self._in_clip = snap.get("in_clip")
      self._nl = {"tanh": jnp.tanh, "relu": jax.nn.relu}[
          snap.get("nonlinearity", "tanh")]
      return
    from myosuite_mjx_tpu.train.ppo import ActorCritic
    self.net = ActorCritic(act_dim=snap["act_dim"],
                           hidden=tuple(snap["hidden"]))
    self._params = jax.tree.map(jnp.asarray, snap["params"])
    self._mean = jnp.asarray(snap["obs_mean"])
    self._var = jnp.asarray(snap["obs_var"])
    self._norm = bool(snap.get("normalize_obs", False))
    self._clip = float(snap.get("norm_clip", 10.0))

  def act(self, obs: jax.Array, key=None) -> jax.Array:
    with jax.default_matmul_precision("highest"):  # not TF32
      return self._act_impl(obs)

  def _act_impl(self, obs: jax.Array) -> jax.Array:
    if self._fmt == "myosuite_mjx_tpu/policy-mlp-v1":
      x = (obs - self._in_shift) / (self._in_scale + 1e-8)
      if self._in_clip is not None:
        x = jnp.clip(x, -self._in_clip, self._in_clip)
      for w, b in self._layers[:-1]:
        x = self._nl(x @ w + b)
      w, b = self._layers[-1]
      x = (x @ w + b) * self._out_scale + self._out_shift
      return jnp.clip(x, -1.0, 1.0)
    if self._norm:
      obs = jnp.clip((obs - self._mean) / jnp.sqrt(self._var + 1e-8),
                     -self._clip, self._clip)
    mean, _, _ = self.net.apply(self._params, obs)
    return jnp.clip(mean, -1.0, 1.0)

  __call__ = act


def load_policy(path: str) -> Policy:
  """Load a policy snapshot written by ``save_snapshot``.

  Trust note: snapshots are pickles (matching the reference's pickle zoo,
  e.g. agents/baslines_NPG/*.pickle) — unpickling executes code, so only
  load snapshots from sources you trust.
  """
  with open(path, "rb") as f:
    snap = pickle.load(f)
  if not (isinstance(snap, dict) and ("params" in snap
                                      or "layers" in snap)):
    raise ValueError(f"{path} is not a policy snapshot "
                     "(expected dict with 'params' or 'layers')")
  return Policy(snap)


def list_baselines() -> list:
  if not os.path.isdir(ZOO_DIR):
    return []
  return sorted(f[:-4] for f in os.listdir(ZOO_DIR) if f.endswith(".pkl"))


def load_baseline(env_id: str) -> Policy:
  """Load the checked-in pretrained policy for a registered env ID."""
  path = os.path.join(ZOO_DIR, f"{env_id}.pkl")
  if not os.path.isfile(path):
    raise FileNotFoundError(
        f"no zoo baseline for {env_id!r}; available: {list_baselines()}")
  return load_policy(path)
